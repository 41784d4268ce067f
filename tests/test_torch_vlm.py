"""The port's M-RoPE VLM family (qwen2-vl-72b: ``apply_mrope``, three
position ids a token, decode positions apart from the cache length) against
the JAX reference, on the CPU.

Inputs are made from a seed with numpy and go through both packages, at
``reduced_config("qwen2-vl-72b")`` (4 layers, d_model 128, 4 heads of 32,
sections (4, 6, 6), d_ff 256, vocab 512) unless a test says otherwise.
Every reference call is jitted, as the reference's launchers call it: its
M-RoPE frequency table differs between eager and ``jit`` (ROADMAP.md C.14).

* ``jit_freqs`` bitwise against the reference's table under ``jit`` (and
  the eager table, which differs, asserted to differ); ``apply_mrope`` on
  random (B, 3, S) positions whose three ids differ, at qwen2-vl's widths;
* ``init_lm`` leaf by leaf, and ``convert`` both ways;
* ``lm_apply``, ``lm_prefill`` (its cache leaf by leaf) and 4 chained
  ``lm_decode_step``s on both kernel planes under a Qwen2-VL image layout
  (text, a 2 x 3 x 4 grid of reserved-id vision tokens at (s + frame,
  s + row, s + col), text from the largest id + 1), whose decode positions
  run behind the cache length, beside a text-only row; a decode that takes
  the cache length for the positions misses;
* the text-only default (ROADMAP.md C.15) against the reference given the
  broadcast positions, where its own default fails;
* ``serve`` (text-only and with an image) against the reference launcher's
  loop, the command line, ``lm_loss`` gradients and two ``launch/train``
  steps against the reference's launcher.

Tolerances: logits within ``LOGIT_TOL`` absolute, the caches within
``LAYER_TOL`` of their largest |value|, each constant's measurement beside
it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_vlm.py

rewrites ``src/repro_torch/data/golden_serve_qwen2_vl.json``: the
reference's qwen2-vl-72b at full width with its first 2 layers (seed 0, one
2048-token request: 64 text tokens, a 1 x 32 x 32 image grid, 960 text
tokens; 8 greedy steps at positions 1056 + i while the cache length runs
from 2048) and, from a second process, the port's CPU gap to it on the
reference's weights, which sets the card's tolerance (``chip_smoke.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.ft.runner import TrainRunner as JRunner
from repro.launch import train as jtrain_launch
from repro.layers.common import apply_mrope as j_apply_mrope
from repro.models import decode as jdecode
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.ft.runner import TrainRunner
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_launch
from repro_torch.launch.serve import serve, vlm_layout
from repro_torch.layers.common import apply_mrope, jit_freqs
from repro_torch.models import lm as tlm
from repro_torch.models.decode import lm_decode_step, lm_prefill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_qwen2_vl.json")
ARCH = "qwen2-vl-72b"
SHD = AxisRules(None)
PLANES = (ops.TORCH, ops.KERNEL)
LOGIT_TOL = 1e-5  # absolute, logits of std 0.93 (measured 2.6e-6 under the image layout)
LAYER_TOL = 1e-5  # of the cache's largest |value| (measured 8.0e-7)
ROPE_TOL = 1e-6  # absolute, apply_mrope on inputs of std 1 (measured 4.8e-7: the rotation's rounding)
VAL_TOL = 1e-5  # losses, as tests/test_torch_train.py holds them
GRAD_TOL = 1e-5  # of each gradient leaf's largest |value|, as tests/test_torch_train.py holds them
B, S, STEPS = 2, 40, 4  # requests, prompt tokens, decode steps after them
IMAGE = (6, (2, 3, 4))  # row 0's image: 6 text tokens, then 2 frames of 3 x 4 (24 tokens), 10 text tokens
# the golden run: full width, the first 2 layers; 64 text tokens, a 1 x 32 x 32 image grid, 960 text tokens
GOLDEN_LAYERS = 2
GOLDEN_RUN = dict(seed=0, batch=1, prompt_len=2048, gen_len=8)
GOLDEN_IMAGE = (64, (1, 32, 32))
# leaves the card's init is checked on, in the port's names: (name, layer, corner); the biases are zeros
GOLDEN_LEAVES = (("embed", None, "head"), ("lm_head", None, "tail"), ("layers/attn/wq", 0, "head"),
                 ("layers/attn/wk", 1, "tail"), ("layers/attn/wv", 0, "tail"), ("layers/attn/wo", 1, "head"),
                 ("layers/mlp/wg", 0, "head"), ("layers/mlp/wu", 1, "head"), ("layers/mlp/wd", 1, "tail"))


def _leaves(tree, prefix=""):
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _close_to_max(got, want, rel, name):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(float(np.abs(want).max()), 1e-30), (name, gap)


def _jax_params(cfg, seed=0):
    return unzip_params(jlm.init_lm(jax.random.PRNGKey(seed), cfg, jnp.float32))[0]


def qwen2_vl_positions(n, image=None):
    """(3, n) position ids and the next id, written out as Qwen2-VL's
    ``get_rope_index`` walks a sequence (independent of ``vlm_layout``): a
    text token takes (p, p, p) and p += 1; an image (offset, (t, h, w))
    takes (s + i, s + j, s + k) over its grid in row-major order, then
    p = s + max(t, h, w)."""
    out, p, i = [], 0, 0
    while i < n:
        if image is not None and i == image[0]:
            t, h, w = image[1]
            out += [(p + a, p + b, p + c) for a in range(t) for b in range(h) for c in range(w)]
            p += max(t, h, w)
            i += t * h * w
        else:
            out.append((p, p, p))
            p += 1
            i += 1
    return np.array(out, np.int32).T, p


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (as in
    ``tests/test_torch_ssm.py``: tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced():
    """(port cfg, reference cfg, reference params, the port's LM holding them)."""
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    jparams = _jax_params(jcfg)
    return cfg, jcfg, jparams, convert.lm_params_from_numpy(jparams, cfg, device="cpu")


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta,Dh,n_eager", [(1e6, 128, 25), (1e4, 128, 19), (1e6, 32, 5)])
def test_jit_freqs_is_the_reference_table_under_jit(theta, Dh, n_eager):
    """``apply_mrope``'s ``1 / theta ** (arange(0, Dh, 2) / Dh)``
    (``src/repro/layers/common.py:104``) under ``jit``, which XLA computes
    as ``pow(theta, -e)``: the port's ``jit_freqs`` bitwise.  The eager
    table differs in ``n_eager`` bands (measured), and so does torch's
    ``1 / theta ** e`` (asserted, so that a change of XLA's rewrite shows)."""
    f = lambda: 1.0 / (theta ** (jnp.arange(0, Dh, 2, dtype=jnp.float32) / Dh))  # noqa: E731
    want = np.asarray(jax.jit(f)())
    np.testing.assert_array_equal(jit_freqs(Dh, theta).numpy(), want)
    assert int((np.asarray(f()) != want).sum()) == n_eager
    naive = (1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float32) / Dh))).numpy()
    assert (naive != want).any()


@pytest.mark.parametrize("Dh,sections,S", [(128, (16, 24, 24), 2080), (32, (4, 6, 6), 300)])
def test_apply_mrope_matches_reference(Dh, sections, S):
    """x (2, S, 3, Dh) of std 1 at random (2, 3, S) positions up to S + 20
    whose three ids differ, qwen2-vl's widths and the reduced ones, against
    the jitted reference within ``ROPE_TOL``; sections that do not split
    Dh / 2 bands raise."""
    rng = np.random.default_rng(Dh)
    x = rng.standard_normal((2, S, 3, Dh)).astype(np.float32)
    pos = rng.integers(0, S + 20, (2, 3, S)).astype(np.int32)
    assert (pos[:, 0] != pos[:, 1]).mean() > 0.9
    want = np.asarray(jax.jit(lambda x, p: j_apply_mrope(x, p, sections, 1e6))(x, pos))
    got = apply_mrope(torch.tensor(x), torch.tensor(pos), sections, 1e6).numpy()
    np.testing.assert_allclose(got, want, atol=ROPE_TOL, rtol=0)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.tensor(x), torch.tensor(pos), (4, 6, 5), 1e6)


def test_vlm_layout_is_qwen2_vl_get_rope_index():
    """``vlm_layout`` against the walk of ``qwen2_vl_positions``: the golden
    run's layout (text resumes at 96, decode at 1056), a video-like grid, an
    image at either end and none; an image that does not fit raises."""
    ids, mask, nxt = vlm_layout(2048, GOLDEN_IMAGE)
    want, want_next = qwen2_vl_positions(2048, GOLDEN_IMAGE)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert (nxt, want_next) == (1056, 1056) and int(mask.sum()) == 1024 and bool(mask[64:1088].all())
    assert ids[:, 1088].tolist() == [96] * 3 and ids[:, 64 + 33].tolist() == [64, 65, 65]
    for n, image in ((40, IMAGE), (30, (0, (1, 5, 6))), (30, (6, (3, 2, 4))), (12, None)):
        ids, mask, nxt = vlm_layout(n, image)
        want, want_next = qwen2_vl_positions(n, image)
        np.testing.assert_array_equal(ids.numpy(), want)
        assert nxt == want_next and int(mask.sum()) == (0 if image is None else int(np.prod(image[1])))
    with pytest.raises(ValueError, match="does not fit"):
        vlm_layout(20, (0, (1, 4, 6)))


# ---------------------------------------------------------------------------
# Config, init, convert
# ---------------------------------------------------------------------------


def test_parameter_count():
    """One qwen2-vl-72b layer holds 877,684,736 parameters (QKV biases,
    SwiGLU), the embedding and untied head 2,491,416,576; the config's
    analytic count leaves out only the final norm.  Held on the reduced
    model's tensors, then on the full config's numbers."""
    small = reduced_config(ARCH)
    model = tlm.init_lm(prng.prng_key(0), small, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == small.param_count() + small.d_model
    cfg = get_config(ARCH)[0]
    one = dataclasses.replace(cfg, n_layers=1).param_count() - dataclasses.replace(cfg, n_layers=0).param_count()
    assert (one, 2 * cfg.vocab_size * cfg.d_model) == (877_684_736, 2_491_416_576)
    assert dataclasses.replace(cfg, n_layers=12).param_count() + cfg.d_model == 13_023_641_600
    assert (cfg.mrope_sections, cfg.head_dim, cfg.n_rep, cfg.rope_theta) == ((16, 24, 24), 128, 8, 1e6)
    tlm.check_ported(cfg)


def test_init_lm_matches_reference_leaf_by_leaf(reduced):
    """Every leaf bitwise, through ``convert`` both ways (the QKV biases
    among them)."""
    cfg, _, jparams, model = reduced
    mine = tlm.init_lm(prng.prng_key(0), cfg, device="cpu")
    got = dict(_leaves(convert.lm_params_to_numpy(mine)))
    want = dict(_leaves(jparams))
    assert sorted(got) == sorted(want) and "layers/attn/bk" in want and "lm_head" in want
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(w), err_msg=name)
    back = dict(_leaves(convert.lm_params_to_numpy(model)))
    for name, w in want.items():
        np.testing.assert_array_equal(back[name], np.asarray(w), err_msg=name)
    assert sorted(mine.state_dict()) == sorted(convert.unstack_tree(jparams, cfg.n_layers))


# ---------------------------------------------------------------------------
# The model under an image layout: the reference's runs, shared
# ---------------------------------------------------------------------------


def _layout_batch(cfg, seed):
    """Tokens (B, S + STEPS) and positions (B, 3, S + STEPS): row 0 holds
    ``IMAGE`` (its tokens the reserved last id), row 1 is text only; the
    STEPS tokens after the prompt take each row's next ids, which for row 0
    run behind the cache length."""
    rng = np.random.default_rng(seed)
    n = S + STEPS
    toks = rng.integers(0, cfg.vocab_size - 1, (B, n)).astype(np.int32)
    ids0, nxt0 = qwen2_vl_positions(S, IMAGE)
    toks[0, IMAGE[0]:IMAGE[0] + int(np.prod(IMAGE[1]))] = cfg.vocab_size - 1
    pos = np.zeros((B, 3, n), np.int32)
    pos[0, :, :S], pos[0, :, S:] = ids0, nxt0 + np.arange(STEPS)
    pos[1] = np.arange(n)
    assert nxt0 < S  # row 0 decodes at positions behind its cache slots
    return toks, pos


@pytest.fixture(scope="module")
def reference_run(reduced):
    """The jitted reference: ``lm_apply`` over all S + STEPS tokens, the
    prefill of the first S (logits, cache), STEPS teacher-forced decode
    steps at their (B, 3) positions, and the same steps without positions
    (the reference then takes the cache length)."""
    _, jcfg, jparams, _ = reduced
    toks, pos = _layout_batch(jcfg, 0)
    run = {"tokens": toks, "positions": pos}
    run["apply"] = np.asarray(jax.jit(lambda p, b: jlm.lm_apply(p, jcfg, SHD, b))(
        jparams, {"tokens": toks, "positions": pos}))
    lg, cache0 = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=S + STEPS))(
        jparams, {"tokens": toks[:, :S], "positions": pos[:, :, :S]})
    run["prefill"], run["cache"] = np.asarray(lg), jax.tree.map(np.asarray, cache0)
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, jcfg, SHD, c, b))
    for key, with_pos in (("decode", True), ("decode_at_len", False)):
        cache, run[key] = cache0, []
        for i in range(STEPS):
            b = {"token": toks[:, S + i]}
            if with_pos:
                b["positions"] = pos[:, :, S + i]
            lg, cache = step(jparams, cache, b)
            run[key].append(np.asarray(lg))
    return run


@pytest.mark.parametrize("plane", PLANES)
def test_forward_prefill_and_decode_under_an_image_layout(reduced, reference_run, plane):
    """The forward, the prefill (its cache leaf by leaf) and 4 decode steps
    whose (B, 3) positions are not the cache slot (row 0), against the
    reference's, and decode against the reference's forward.  The same
    steps given no positions take the cache length as the reference's do:
    row 0 then misses the forward by far, row 1 (text only) meets it."""
    cfg, _, _, model = reduced
    run = reference_run
    toks, pos = torch.tensor(run["tokens"]), torch.tensor(run["positions"])
    got = tlm.lm_apply(model, cfg, {"tokens": toks, "positions": pos}, plane=plane).numpy()
    np.testing.assert_allclose(got, run["apply"], atol=LOGIT_TOL, rtol=0)
    tl, tc = lm_prefill(model, cfg, {"tokens": toks[:, :S], "positions": pos[:, :, :S]}, pad_to=S + STEPS, plane=plane)
    np.testing.assert_allclose(tl.numpy(), run["prefill"], atol=LOGIT_TOL, rtol=0)
    for name, w in _leaves({k: v for k, v in run["cache"].items() if k != "len"}):
        _close_to_max(dict(_leaves({k: v for k, v in tc.items() if k != "len"}))[name], w, LAYER_TOL, name)
    cache0 = convert.map_tree(lambda t: t.clone(), {k: v for k, v in tc.items() if k != "len"})
    for i in range(STEPS):
        tl, tc = lm_decode_step(model, cfg, tc, {"token": toks[:, S + i], "positions": pos[:, :, S + i]})
        np.testing.assert_allclose(tl.numpy(), run["decode"][i], atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(tl.numpy(), run["apply"][:, S + i], atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
    assert tc["len"] == S + STEPS
    tc = dict(cache0, len=S)
    for i in range(STEPS):
        tl, tc = lm_decode_step(model, cfg, tc, {"token": toks[:, S + i]})
        np.testing.assert_allclose(tl.numpy(), run["decode_at_len"][i], atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
        assert np.abs(tl[0].numpy() - run["apply"][0, S + i]).max() > 1e-2
        np.testing.assert_allclose(tl[1].numpy(), run["apply"][1, S + i], atol=LOGIT_TOL, rtol=0)


def test_text_only_default_positions(reduced):
    """Without positions the port takes the text-only layout, 0..S-1 for
    each id (ROADMAP.md C.15): its forward and prefill equal the reference's
    given those positions explicitly, and its decode the reference's, which
    falls back to the cache length.  The reference's own default is (B, S),
    which its ``apply_mrope`` reads as (..., 3, S): at B = 4 it fails."""
    cfg, jcfg, jparams, model = reduced
    n = 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, n + 1)).astype(np.int32)
    pos = np.broadcast_to(np.arange(n + 1, dtype=np.int32)[None, None], (4, 3, n + 1))
    want = np.asarray(jax.jit(lambda p, b: jlm.lm_apply(p, jcfg, SHD, b))(jparams, {"tokens": toks, "positions": pos}))
    jl, jc = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=n + 1))(
        jparams, {"tokens": toks[:, :n], "positions": pos[:, :, :n]})
    jl2, _ = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))(jparams, jc, toks[:, n])
    with pytest.raises((ValueError, TypeError)):
        jax.jit(lambda p, t: jlm.lm_apply(p, jcfg, SHD, {"tokens": t}))(jparams, toks)
    got = tlm.lm_apply(model, cfg, {"tokens": torch.tensor(toks)}).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(toks[:, :n])}, pad_to=n + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    tl, _ = lm_decode_step(model, cfg, tc, {"token": torch.tensor(toks[:, n])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl2), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), want[:, n], atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def _reference_serve(jcfg, jparams, Bn, P, G, image=None):
    """The reference launcher's loop at seed 0 (``repro/launch/serve.py``:
    prompts of ``randint(PRNGKey(1))``, positions arange (B, 3, P), decode
    positions P + i); with an image, its tokens and positions put in as
    ``qwen2_vl_positions`` lays them out.  Returns prompts, tokens (B, G),
    logits (G, B, V)."""
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (Bn, P), 0, jcfg.vocab_size))
    ids, nxt = qwen2_vl_positions(P, image)
    if image is not None:
        prompts[:, image[0]:image[0] + int(np.prod(image[1]))] = jcfg.vocab_size - 1
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=P + G))(
        jparams, {"tokens": prompts, "positions": np.broadcast_to(ids[None], (Bn, 3, P))})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, jcfg, SHD, c, b))
    tok = jnp.argmax(logits, -1)
    toks, steps = [tok], [logits]
    for i in range(G - 1):
        logits, cache = step(jparams, cache, {"token": tok, "positions": jnp.full((Bn, 3), nxt + i, jnp.int32)})
        tok = jnp.argmax(logits, -1)
        toks.append(tok)
        steps.append(logits)
    return prompts, np.stack([np.asarray(t) for t in toks], 1), np.stack([np.asarray(s) for s in steps])


@pytest.mark.parametrize("image", [None, (2, (1, 2, 3))], ids=["text", "image"])
def test_serve_matches_reference_loop(reduced, image):
    """``serve`` on the seed-0 weights on both planes against the reference
    launcher's loop: 2 requests of 12-token prompts, 5 tokens each; text
    only (the reference's own serve), and with a 1 x 2 x 3 image at 2."""
    cfg, jcfg, jparams, model = reduced
    Bn, P, G = 2, 12, 5
    prompts, toks, logits = _reference_serve(jcfg, jparams, Bn, P, G, image)
    ids, _ = qwen2_vl_positions(P, image)
    for plane in PLANES:
        res = serve(cfg, batch=Bn, prompt_len=P, gen_len=G, page_size=8, seed=0, device="cpu", plane=plane,
                    params=model, image=image)
        np.testing.assert_array_equal(res.prompts.numpy(), prompts)
        np.testing.assert_array_equal(res.positions.numpy(), np.broadcast_to(ids[None], (Bn, 3, P)))
        np.testing.assert_array_equal(res.tokens.numpy(), toks)
        np.testing.assert_allclose(res.logits.numpy(), logits, atol=LOGIT_TOL, rtol=0)


def test_serve_cli_runs_qwen2_vl(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen-len", "3",
                    "--layers", "2"])
    out = capsys.readouterr().out
    assert "arch=qwen2-vl-72b" in out and "[serve] ok" in out
    with pytest.raises(ValueError, match="no M-RoPE"):
        serve(reduced_config("stablelm-1.6b"), batch=1, prompt_len=8, gen_len=2, device="cpu", image=(0, (1, 2, 2)))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_lm_loss_and_grads_match_reference(reduced):
    """``lm_loss`` over 2 x 40 tokens under the image layout, every block
    checkpointed, and its gradients: the loss within ``VAL_TOL`` (measured
    9.5e-7), each gradient leaf within ``GRAD_TOL`` of its largest |value|
    (measured 1.0e-6)."""
    _, _, jparams, _ = reduced
    cfg, jcfg = (dataclasses.replace(c, remat="full") for c in (reduced_config(ARCH), jreduced_config(ARCH)))
    toks, pos = _layout_batch(cfg, 9)
    batch = {"tokens": toks[:, :S], "labels": toks[:, :S], "positions": pos[:, :, :S]}
    wl, wg = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(p, jcfg, SHD, batch)))(jparams)
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    loss = tlm.lm_loss(model, cfg, {k: torch.tensor(v) for k, v in batch.items()})
    assert abs(float(loss.detach()) - float(wl)) <= VAL_TOL
    grads = convert.stack_named(dict(zip(named, torch.autograd.grad(loss, list(named.values())))), cfg)
    got, want = dict(_leaves(grads)), dict(_leaves(wg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        _close_to_max(got[name], w, GRAD_TOL, name)


def _recording(runner_cls, batches, outs):
    """``runner_cls`` that keeps every batch it draws and the run's result."""
    class Recording(runner_cls):
        def __init__(self, step, init_state, next_batch, data_init, **kw):
            def record(ds):
                ds, b = next_batch(ds)
                batches.append({k: np.asarray(v) for k, v in b.items()})
                return ds, b
            super().__init__(step, init_state, record, data_init, **kw)

        def run(self, n_steps, log_every=10):
            out = runner_cls.run(self, n_steps, log_every)
            outs.append(out)
            return out
    return Recording


def test_train_launcher_matches_reference_launcher(monkeypatch, capsys):
    """Two steps of ``launch/train --arch qwen2-vl-72b --reduced`` against
    the reference's launcher with the same flags: every batch's tokens,
    labels and positions (the text-only layout) bitwise, losses within
    ``VAL_TOL``."""
    flags = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq", "16"]
    jb, jo, tb, to = [], [], [], []
    monkeypatch.setattr(jtrain_launch, "TrainRunner", _recording(JRunner, jb, jo))
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    jtrain_launch.main()
    monkeypatch.setattr(train_launch, "TrainRunner", _recording(TrainRunner, tb, to))
    train_launch.main(flags + ["--device", "cpu"])
    assert "arch=qwen2-vl-72b" in capsys.readouterr().out
    assert len(jb) == len(tb) == 2
    for want, got in zip(jb, tb):
        assert sorted(want) == sorted(got) == ["labels", "positions", "tokens"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["positions"][1, 2], np.arange(16))
    np.testing.assert_allclose(to[0]["losses"], jo[0]["losses"], atol=VAL_TOL, rtol=0)


# ---------------------------------------------------------------------------
# The golden file
# ---------------------------------------------------------------------------


def test_golden_file_matches_the_port_draws():
    """The golden file's prompt is the port's ``randint(PRNGKey(1))`` with
    its image's tokens the reserved last id, its positions are
    ``vlm_layout``'s, its steps are self-consistent, and its tolerance is
    10x the port's CPU gap."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg, _ = get_config(ARCH)
    assert g["arch"] == ARCH and (g["n_layers"], g["d_model"]) == (GOLDEN_LAYERS, cfg.d_model)
    assert {k: g[k] for k in GOLDEN_RUN} == GOLDEN_RUN and g["image"] == [GOLDEN_IMAGE[0], list(GOLDEN_IMAGE[1])]
    Bn, P = g["batch"], g["prompt_len"]
    ids, mask, nxt = vlm_layout(P, GOLDEN_IMAGE)
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (Bn, P), 0, cfg.vocab_size).masked_fill(
        mask, cfg.vocab_size - 1)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    np.testing.assert_array_equal(ids.numpy(), np.array(g["positions"]))
    assert g["decode_positions"] == [nxt + i for i in range(g["gen_len"] - 1)] and nxt == 1056
    assert len(g["steps"]) == g["gen_len"] == len(g["tokens"][0])
    for s, step in enumerate(g["steps"]):
        for b in range(Bn):
            assert step["top_ids"][b][0] == g["tokens"][b][s]
            assert step["lse"][b] >= step["max"][b] == step["top_logits"][b][0]
    assert [(n, layer) for n, layer, _ in GOLDEN_LEAVES] == [(k.split("@")[0], v["layer"]) for k, v in
                                                               g["leaves"].items()]
    assert g["tolerance"]["logits"] == max(10 * g["port_cpu_gap"]["logits"], 1e-6)


def _step_record(logits):
    lf = np.asarray(logits, np.float32)
    top = np.argsort(-lf, axis=-1, kind="stable")[:, :8]
    m = lf.max(-1)
    lse = m + np.log(np.exp(lf - m[:, None]).sum(-1, dtype=np.float64))
    return {"top_ids": top.tolist(), "top_logits": np.take_along_axis(lf, top, -1).astype(float).tolist(),
            "max": m.astype(float).tolist(), "lse": lse.astype(float).tolist()}


def _abs_sum(a):
    """float64 sum of |a| over a large array, a slab at a time."""
    flat = np.asarray(a).reshape(-1)
    return float(sum(np.abs(flat[i:i + (1 << 24)]).sum(dtype=np.float64) for i in range(0, flat.size, 1 << 24)))


def _golden_cfg(get):
    return dataclasses.replace(get(ARCH)[0], n_layers=GOLDEN_LAYERS)


def _golden_request(vocab):
    """The golden request, as the reference draws it: (prompts (1, P),
    positions (1, 3, P), decode positions (G - 1,))."""
    r = GOLDEN_RUN
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(r["seed"] + 1), (r["batch"], r["prompt_len"]), 0, vocab))
    off, grid = GOLDEN_IMAGE
    prompts[:, off:off + int(np.prod(grid))] = vocab - 1
    ids, nxt = qwen2_vl_positions(r["prompt_len"], GOLDEN_IMAGE)
    return prompts, ids[None], nxt + np.arange(r["gen_len"] - 1)


def write_golden():
    """The reference at full width, its first 2 layers: prefill and greedy
    decode of the golden request; then the port's CPU gap in a second
    process."""
    cfg_j = _golden_cfg(jget_config)
    r = GOLDEN_RUN
    P, G = r["prompt_len"], r["gen_len"]
    t0 = time.time()
    params = _jax_params(cfg_j, r["seed"])
    print(f"reference init: {time.time() - t0:.1f} s", flush=True)
    prompts, positions, dec_pos = _golden_request(cfg_j.vocab_size)
    t0 = time.time()
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, cfg_j, SHD, b, pad_to=P + G))(
        params, {"tokens": prompts, "positions": positions})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, cfg_j, SHD, c, b))
    steps, toks = [np.asarray(logits)], [np.asarray(jnp.argmax(logits, -1))]
    for i in range(G - 1):
        logits, cache = step(params, cache, {"token": jnp.asarray(toks[-1]),
                                             "positions": np.full((r["batch"], 3), dec_pos[i], np.int32)})
        steps.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    assert int(cache["len"]) == P + G - 1
    del cache
    print(f"reference prefill + {G - 1} steps: {time.time() - t0:.1f} s", flush=True)
    leaves = {}
    for name, layer, corner in GOLDEN_LEAVES:
        a = params
        for part in name.split("/"):
            a = a[part]
        a = np.asarray(a if layer is None else a[layer])
        rows = a.reshape(-1, a.shape[-1])
        sample = rows[:2, :8] if corner == "head" else rows[-2:, -8:]
        leaves[f"{name}@{layer}"] = {"layer": layer, "corner": corner, "sample": sample.astype(float).tolist(),
                                     "abs_sum": _abs_sum(a)}
        del a, rows
    del params
    out = {
        "what": "JAX reference, qwen2-vl-72b at full width with the depth cut to n_layers, float32, on the CPU, "
                "jitted: init_lm(PRNGKey(seed)); one request, randint(PRNGKey(seed + 1), (batch, prompt_len), 0, "
                "vocab) with the image's tokens set to the last vocabulary id, at Qwen2-VL's M-RoPE positions "
                "(text, then the image grid at (s + frame, s + row, s + col), then text from the largest id + 1); "
                "lm_prefill(pad_to=prompt_len + gen_len), then greedy lm_decode_step with (batch, 3) positions "
                "decode_positions[i] while the cache length runs from prompt_len; step 0 is the prefill's "
                "last-token logits; leaves are named as the port names them (name@layer)",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_vlm.py",
        "arch": ARCH, "n_layers": GOLDEN_LAYERS, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size,
        "depth_cut": "80 -> 2 layers: the reference builds the whole parameter tree on the CPU, 0.878 B float32 "
                     "parameters a layer beside 2.49 B of embedding and head (17.0 GB at 2 layers)",
        **r, "dtype": "float32", "image": [GOLDEN_IMAGE[0], list(GOLDEN_IMAGE[1])],
        "prompts": prompts.tolist(),
        "positions": positions[0].tolist(),
        "decode_positions": dec_pos.tolist(),
        "tokens": np.stack(toks, 1).tolist(),
        "steps": [_step_record(s) for s in steps],
        "top1_top2_margin_min": [float(np.min(np.diff(np.sort(s, -1)[:, -2:], axis=-1))) for s in steps],
        "leaves": leaves,
    }
    with open(GOLDEN, "w") as f:
        json.dump(out, f)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "steps.npy"), np.stack(steps))
        print(f"wrote {GOLDEN}; measuring the port's CPU gap in a new process", flush=True)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap", d], env=env, check=True)


def _reference_weights_in_the_port(cfg_j, cfg, seed):
    """The reference's weights (its ``init_lm``) as the port's LM through
    ``convert``, one leaf at a time, each reference leaf freed once copied
    (the whole tree twice would not fit beside each other)."""
    tree = _jax_params(cfg_j, seed)
    state = {}
    for path in [p for p, _ in _leaves(tree)]:
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node[p]
        sub = {parts[-1]: node.pop(parts[-1])}
        for p in reversed(parts[:-1]):
            sub = {p: sub}
        state.update(convert.unstack_tree(sub, cfg.n_layers, "cpu"))
        del sub
    return tlm.lm_from_state(cfg, state)


def _port_cpu_gap(d):
    """The port on the CPU (torch plane) with the reference's weights, the
    golden request and its positions: its gap to the reference's logits
    (each step teacher-forced with the reference's tokens), into the golden
    file."""
    with open(GOLDEN) as f:
        g = json.load(f)
    t0 = time.time()
    model = _reference_weights_in_the_port(_golden_cfg(jget_config), _golden_cfg(get_config), g["seed"])
    cfg = model.cfg
    print(f"reference weights in the port: {time.time() - t0:.1f} s", flush=True)
    ref_steps = np.load(os.path.join(d, "steps.npy"))
    prompts = torch.tensor(g["prompts"], dtype=torch.int32)
    positions = torch.tensor(g["positions"], dtype=torch.int32)[None]
    P, G = g["prompt_len"], g["gen_len"]
    t0 = time.time()
    with torch.inference_mode():
        tl, tc = lm_prefill(model, cfg, {"tokens": prompts, "positions": positions}, pad_to=P + G, plane=ops.TORCH)
        gaps = [float(np.abs(tl.numpy() - ref_steps[0]).max())]
        for s in range(1, G):
            step = {"token": torch.tensor(g["tokens"], dtype=torch.int32)[:, s - 1],
                    "positions": torch.full((g["batch"], 3), g["decode_positions"][s - 1], dtype=torch.int32)}
            tl, tc = lm_decode_step(model, cfg, tc, step)
            gaps.append(float(np.abs(tl.numpy() - ref_steps[s]).max()))
    print(f"port (CPU, torch plane): {time.time() - t0:.1f} s; logit gaps {gaps}", flush=True)
    g["port_cpu_gap"] = {"logits": max(gaps)}
    g["port_cpu_logit_gap_per_step"] = gaps
    g["port_cpu_gap_note"] = ("max |port - reference| over every logit of each step (the port on the CPU, torch "
                              "plane, with the reference's weights through convert, teacher-forced with the "
                              "reference's tokens at the golden positions)")
    # the card is held to 10x the CPU's gap (the rule of the other golden files), no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in g["port_cpu_gap"].items()}
    with open(GOLDEN, "w") as f:
        json.dump(g, f)
    print(f"port on the CPU: gap {g['port_cpu_gap']}; tolerance {g['tolerance']}")


if __name__ == "__main__":
    sys.exit(_port_cpu_gap(sys.argv[2]) if sys.argv[1:2] == ["--port-gap"] else write_golden())
