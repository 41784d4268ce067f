"""The port's encoder-decoder family (whisper-small: the audio encoder, the
decoder with cross-attention, their caches) against the JAX reference, on
the CPU.

Inputs are made from a seed with numpy and go through both packages, at
``reduced_config("whisper-small")`` (2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, d_ff 256, vocab 512, 24 frames) unless a test
says otherwise:

* ``prng.normal`` bitwise against ``jax.random.normal`` (the frames'
  draw), over whisper-small's (2, 1500, 768) and every uniform it can draw;
  XLA's CPU ``sin`` and ``cos`` (``prng.sinf``/``cosf``) on a grid;
  ``sinusoidal_positions`` at (1500, 768) and (448, 768) and the decode
  step's ``_encdec_pos`` bitwise against the reference under ``jit``;
* ``init_lm`` leaf by leaf, ``xattn`` equal to ``attn`` on both sides
  (ROADMAP.md C.13) and in storage of its own;
* ``lm_apply`` (``encode_audio``, the decoder), ``lm_prefill`` (its cache
  leaf by leaf) and 8 chained ``lm_decode_step``s on both kernel planes, at
  24 frames and at whisper's 1500 (where the reference's encoder takes
  ``flash_attention_xla``'s two chunks over a ragged 1500), against the
  reference's prefill and decode and its ``lm_apply`` on the longer
  sequence; the same with ``xattn`` redrawn so that it differs from
  ``attn``; ``attention_op(causal=False)`` against the Pallas kernel in
  interpret mode at a ragged S;
* ``serve`` and the ``--arch whisper-small`` command line on the CPU;
  ``lm_loss`` and its gradients, three ``build_train_step`` steps on the
  launcher's frames batches; ``convert``'s encoder and decoder stacks both
  ways and checkpoints written by each package, opened by the other.

Tolerances: logits within ``LOGIT_TOL`` absolute, the caches within
``LAYER_TOL`` of their largest |value|, each constant's measurement beside
it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_whisper.py

rewrites ``src/repro_torch/data/golden_serve_whisper.json``: the
reference's whisper-small at full width and depth (seed 0, one request of
1500 frames, a 224-token prompt, 8 greedy steps) and, from a second
process, the port's CPU gap to it on the reference's weights, which sets
the card's tolerance (``chip_smoke.py``).
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

from repro.checkpoint import restore_checkpoint as jrestore, save_checkpoint as jsave
from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.layers.common import sinusoidal_positions as j_sinusoidal_positions
from repro.models import decode as jdecode
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataState, make_pipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import serve
from repro_torch.layers.common import sinusoid_at, sinusoidal_positions
from repro_torch.models import lm as tlm
from repro_torch.models.decode import init_cache, lm_decode_step, lm_prefill
from repro_torch.train.steps import build_train_step, frames_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_whisper.json")
ARCH = "whisper-small"
SHD = AxisRules(None)
PLANES = (ops.TORCH, ops.KERNEL)
LOGIT_TOL = 1e-5  # absolute, logits of std 0.93 (measured 2.4e-6 at 24 frames, 1.9e-6 at 1500)
LAYER_TOL = 1e-5  # of the cache's largest |value| (measured 5.1e-7)
B, S, STEPS = 2, 10, 8  # requests, prompt tokens, decode steps after them
FRAMES = (24, 1500)  # the reduced config's frames and whisper's 30-second window
# the decoder's key biases: softmax ignores a shift shared by all keys, and the decoder has no rotary, so their
# gradient is 0 in exact arithmetic and rounding noise (1e-9) in both packages: held absolutely, not to their size
NOISE_GRADS = ("dec_layers/attn/bk", "dec_layers/xattn/bk")
# the golden run: whisper-small whole (12 + 12 layers), one 30-second window, half the text context as a prompt
GOLDEN_RUN = dict(seed=0, batch=1, prompt_len=224, gen_len=8)
# leaves the card's init is checked on, in the port's names: (name, layer, corner)
GOLDEN_LEAVES = (("embed", None, "head"), ("lm_head", None, "tail"), ("enc_layers/attn/wq", 0, "head"),
                 ("enc_layers/mlp/wd", 11, "tail"), ("dec_layers/attn/wk", 0, "head"),
                 ("dec_layers/xattn/wq", 5, "tail"), ("dec_layers/xattn/wv", 11, "head"),
                 ("dec_layers/mlp/wu", 3, "head"))


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


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


def _inputs(cfg, n_tok, T, seed):
    """(tokens (B, n_tok) int32, frames (B, T, D) float32) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(np.int32),
            rng.standard_normal((B, T, cfg.d_model)).astype(np.float32))


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
# The draws: frames, sinusoids
# ---------------------------------------------------------------------------


def test_normal_is_bitwise_jax():
    """The serve's frames draw at whisper-small's (2, 1500, 768), and odd
    shapes from folded keys (the chunked path too)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 1500, 768), jnp.float32))
    got = prng.normal(prng.prng_key(1), (2, 1500, 768)).numpy()
    np.testing.assert_array_equal(got, want)
    for seed, step, shape in ((7, 3, (3, 24, 128)), (-5, 0, (1001,)), (2**31 - 1, 9, (4, 5, 6))):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = prng.normal(prng.fold_in(prng.prng_key(seed), step), shape, chunk=997).numpy()
        np.testing.assert_array_equal(got, want)


def test_normal_over_every_uniform():
    """``normal`` maps 32 random bits through their top 23 (the uniform's
    mantissa): all 2**23 of them, bitwise the reference's ``sqrt2 *
    erf_inv(u)`` under ``jit`` (``erf_inv``'s square root in its tails is
    correctly rounded there; torch's float32 one on the CPU is not)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    f = jax.jit(lambda u: np.float32(np.sqrt(2)) * jax.lax.erf_inv(u))
    sqrt2 = float(np.float32(np.sqrt(2)))
    for start in range(0, 2**23, 2**21):
        bits = torch.arange(start, start + 2**21, dtype=torch.int64) << 9
        u = prng.uniform_from_bits(bits, float(lo), 1.0)
        got = (prng.erf_inv(u) * sqrt2).numpy()
        np.testing.assert_array_equal(got, np.asarray(f(u.numpy())))


def test_sinf_cosf_are_xla_sin_cos():
    """Every 401st float32 in [0, 1600] (the sinusoid's angles go to 1499)
    and some negatives: glibc's two range reductions (|y| < 120 and above)
    and its polynomials, bitwise XLA's CPU ``sin``/``cos``; ``torch.sin``
    differs on 0.5 % of them (measured), most of them tiny, where both are
    exact."""
    x = np.arange(0, np.float32(1600).view(np.int32), 401, dtype=np.int32).view(np.float32)
    x = np.concatenate([x, -x[::37], np.float32([0.0, 1e-30, 2**-13, 0.7499, 0.75, 119.99, 120.0])])
    t = torch.tensor(x)
    np.testing.assert_array_equal(prng.sinf(t).numpy(), np.asarray(jax.jit(jnp.sin)(x)))
    np.testing.assert_array_equal(prng.cosf(t).numpy(), np.asarray(jax.jit(jnp.cos)(x)))
    assert (torch.sin(t).numpy() != np.asarray(jax.jit(jnp.sin)(x))).mean() > 0.001


@pytest.mark.parametrize("n_pos,d", [(1500, 768), (448, 768), (24, 128)])
def test_sinusoidal_positions_bitwise_under_jit(n_pos, d):
    """The encoder's table (1500 frames) and the decoder's (448, Whisper's
    text context) at full width, bitwise the reference's under ``jit``,
    where XLA folds ``1 / pow(10000, e)`` into ``pow(10000, -e)``.  Called
    eagerly, the reference's own table differs from that by up to 1.3e-4
    (an ulp of a third of the bands, times the position): asserted, so that
    a change of XLA's rewrite shows here."""
    want = np.asarray(jax.jit(lambda: j_sinusoidal_positions(n_pos, d))())
    got = sinusoidal_positions(n_pos, d).numpy()
    np.testing.assert_array_equal(got, want)
    eager = np.asarray(j_sinusoidal_positions(n_pos, d))
    assert 0 < np.abs(eager - want).max() <= 1.3e-4


def test_encdec_pos_is_the_tables_row():
    """The decode step's sinusoid at each of the 448 positions, bitwise the
    reference's ``_encdec_pos`` under ``jit`` and the table's row."""
    d = 768
    f = jax.jit(jax.vmap(lambda p: jdecode._encdec_pos(None, p, jnp.zeros((1, 1, d), jnp.float32))[0, 0]))
    want = np.asarray(f(jnp.arange(448, dtype=jnp.int32)))
    got = sinusoid_at(torch.arange(448, dtype=torch.float32), d).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sinusoidal_positions(448, d).numpy())


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _xattn_is_attn(tree):
    """Every decoder layer's cross-attention leaves equal its self-attention's."""
    dec = tree["dec_layers"]
    return all(np.array_equal(np.asarray(dec["xattn"][k]), np.asarray(dec["attn"][k])) for k in dec["attn"])


def test_init_lm_matches_reference_leaf_by_leaf(reduced):
    """The encoder's layer keys ``split(name_key(key, "enc"), L_enc)``, the
    decoder's ``split(name_key(key, "dec"), L)``; ``xattn`` drawn as
    ``attn`` (C.13) on both sides, held in storage of its own."""
    cfg, _, jparams, _ = reduced
    model = tlm.init_lm(prng.prng_key(0), cfg, device="cpu")
    got = dict(_leaves(convert.lm_params_to_numpy(model)))
    want = dict(_leaves(jparams))
    assert sorted(got) == sorted(want) and "enc_layers/mlp/bu" in want and "dec_layers/norm_x/bias" in want
    assert "layers/attn/wq" not in want and "enc_norm/scale" in want
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert _ulp(got[name], w).max() == 0, name
    assert _xattn_is_attn(jparams) and _xattn_is_attn(convert.lm_params_to_numpy(model))
    for layer in model.dec_layers:
        for name in ("wq", "wk", "wv", "wo", "bq", "bo"):
            a, x = getattr(layer.attn, name), getattr(layer.xattn, name)
            assert a is not x and a.untyped_storage().data_ptr() != x.untyped_storage().data_ptr(), name


def test_parameter_count():
    """whisper-small holds 278,143,488 parameters; the config's analytic
    count (the reference's formula) leaves out the biases and takes two
    norm vectors a layer: 9D + F short a decoder layer, 7D + F an encoder
    layer, 4D for the final and encoder norms.  Held on the reduced model's
    tensors, then on the full config's numbers."""
    def real(c):
        return c.param_count() + c.n_layers * (9 * c.d_model + c.d_ff) + c.n_enc_layers * (7 * c.d_model + c.d_ff) \
            + 4 * c.d_model
    small = reduced_config(ARCH)
    model = tlm.init_lm(prng.prng_key(0), small, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == real(small)
    cfg = get_config(ARCH)[0]
    assert (cfg.param_count(), real(cfg)) == (277_919_232, 278_143_488)
    assert (cfg.d_model, cfg.n_layers, cfg.n_enc_layers, cfg.n_heads, cfg.head_dim, cfg.enc_seq_len) == (
        768, 12, 12, 12, 64, 1500)
    tlm.check_ported(cfg)


def test_init_cache_takes_the_encoder_decoder_layout():
    cfg = reduced_config(ARCH)
    c = init_cache(cfg, 3, 40)
    assert c["len"] == 0 and sorted(c) == ["cross_k", "cross_v", "len", "self"]
    assert c["self"]["k"].shape == (cfg.n_layers, 3, 40, cfg.n_kv_heads, cfg.head_dim)
    assert c["cross_v"].shape == (cfg.n_layers, 3, cfg.enc_seq_len, cfg.n_kv_heads, cfg.head_dim)
    want = jax.tree.map(np.asarray, unzip_params(jdecode.init_cache(jreduced_config(ARCH), 3, 40))[0])
    got = {k: v for k, v in c.items() if k != "len"}
    assert {n: w.shape for n, w in _leaves(want) if n != "len"} == {n: tuple(g.shape) for n, g in _leaves(got)}


# ---------------------------------------------------------------------------
# The model: the reference's runs, shared by the tests below
# ---------------------------------------------------------------------------


def _redrawn(jparams, seed=11):
    """The reference tree with every decoder layer's ``xattn`` leaf redrawn
    from numpy (the same scale), so that it differs from ``attn``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jparams)
    x = tree["dec_layers"]["xattn"]
    for k, a in x.items():
        x[k] = (rng.standard_normal(a.shape) * max(float(np.abs(a).std()), 0.02)).astype(np.float32)
    assert not _xattn_is_attn(tree)
    return tree


def _reference_run(jcfg, jparams, T, seed):
    """Tokens (B, S + STEPS) and frames (B, T, D); the reference's prefill
    logits and cache over the first S tokens, its teacher-forced decode
    logits and its ``lm_apply`` over all S + STEPS tokens."""
    jcfg = dataclasses.replace(jcfg, enc_seq_len=T)
    toks, frames = _inputs(jcfg, S + STEPS, T, seed)
    lg, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=S + STEPS))(
        jparams, {"tokens": toks[:, :S], "frames": frames})
    run = {"tokens": toks, "frames": frames, "prefill": np.asarray(lg), "cache": jax.tree.map(np.asarray, cache),
           "decode": []}
    step = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))
    for i in range(STEPS):
        lg, cache = step(jparams, cache, toks[:, S + i])
        run["decode"].append(np.asarray(lg))
    run["apply"] = np.asarray(jax.jit(lambda p, b: jlm.lm_apply(p, jcfg, SHD, b))(
        jparams, {"tokens": toks, "frames": frames}))
    return run


@pytest.fixture(scope="module")
def reference_runs(reduced):
    """The seed's weights at each of FRAMES, and the redrawn ``xattn`` at 24."""
    _, jcfg, jparams, _ = reduced
    out = {T: _reference_run(jcfg, jparams, T, T) for T in FRAMES}
    tree = _redrawn(jparams)
    out["redrawn"] = dict(_reference_run(jcfg, tree, FRAMES[0], 5), params=tree)
    return out


def _port_run(model, cfg, run, plane):
    """The port's prefill of S tokens, then STEPS teacher-forced decode steps:
    (prefill logits, the prefill's cache (copied), [decode logits])."""
    cfg = dataclasses.replace(cfg, enc_seq_len=run["frames"].shape[1])
    batch = {"tokens": torch.tensor(run["tokens"][:, :S]), "frames": torch.tensor(run["frames"])}
    tl, tc = lm_prefill(model, cfg, batch, pad_to=S + STEPS, plane=plane)
    cache0 = convert.map_tree(lambda t: t.clone(), {k: v for k, v in tc.items() if k != "len"})
    assert tc["len"] == S
    steps = []
    for i in range(STEPS):
        lg, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(run["tokens"][:, S + i])})
        steps.append(lg.numpy())
    assert tc["len"] == S + STEPS
    return tl.numpy(), cache0, steps


def _check_run(model, cfg, run, plane):
    """Forward, prefill (its cache leaf by leaf) and decode against the
    reference's run, and decode against the reference's forward."""
    cfg_t = dataclasses.replace(cfg, enc_seq_len=run["frames"].shape[1])
    got = tlm.lm_apply(model, cfg_t, {"tokens": torch.tensor(run["tokens"]), "frames": torch.tensor(run["frames"])},
                       plane=plane).numpy()
    assert got.shape == run["apply"].shape == (B, S + STEPS, cfg.vocab_size)
    np.testing.assert_allclose(got, run["apply"], atol=LOGIT_TOL, rtol=0)
    tl, cache, steps = _port_run(model, cfg, run, plane)
    np.testing.assert_allclose(tl, run["prefill"], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tl, run["apply"][:, S - 1], atol=LOGIT_TOL, rtol=0)
    want = dict(_leaves({k: v for k, v in run["cache"].items() if k != "len"}))
    got = dict(_leaves(cache))
    assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "self/k", "self/v"]
    for name, w in want.items():
        _close_to_max(got[name], w, LAYER_TOL, name)
    for i, g in enumerate(steps):
        np.testing.assert_allclose(g, run["decode"][i], atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
        if i < STEPS - 1:  # the forward's logits at the token this step decodes
            np.testing.assert_allclose(g, run["apply"][:, S + i], atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("T", FRAMES)
def test_forward_prefill_and_decode_match_reference(reduced, reference_runs, plane, T):
    """At 1500 frames the reference's encoder takes ``flash_attention_xla``
    (a chunk of 1024 keys and a ragged one of 476), the port's kernel plane
    ``attention_op`` (``flash_attention``'s plain version on the CPU) and
    its torch plane ``naive_attention``; the cross-attention takes
    ``flash_attention_xla`` on both sides."""
    cfg, _, _, model = reduced
    _check_run(model, cfg, reference_runs[T], plane)


@pytest.mark.parametrize("plane", PLANES)
def test_cross_attention_that_differs_from_self_attention(reduced, reference_runs, plane):
    """C.13 makes seed-built weights blind to a port that swaps or ties a
    decoder layer's two attentions: with ``xattn`` redrawn, the forward,
    prefill and decode still meet the reference's."""
    cfg = reduced[0]
    run = reference_runs["redrawn"]
    model = convert.lm_params_from_numpy(run["params"], cfg, device="cpu")
    assert not torch.equal(model.dec_layers[0].xattn.wq, model.dec_layers[0].attn.wq)
    _check_run(model, cfg, run, plane)


def test_encode_audio_takes_the_kernel_once_per_layer(reduced):
    """``encode_audio`` on the kernel plane reaches ``attention_op`` non-causal
    once per encoder layer, and a prefill once more per decoder layer
    (causal); ``TRAIN`` takes the reference's route (``naive_attention`` up to
    512 frames, ``flash_attention_xla`` above) and meets the kernel plane."""
    cfg, _, _, model = reduced
    calls = []
    real = ops.attention_op

    def spy(q, k, v, *, causal=True, plane=ops.AUTO):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal, plane=plane)

    toks, frames = _inputs(cfg, S, FRAMES[0], 3)
    ops.attention_op = spy
    try:
        enc = tlm.encode_audio(model, cfg, torch.tensor(frames), plane=ops.KERNEL)
        assert calls == [(FRAMES[0], FRAMES[0], False)] * cfg.n_enc_layers
        calls.clear()
        lm_prefill(model, cfg, {"tokens": torch.tensor(toks), "frames": torch.tensor(frames)}, plane=ops.KERNEL)
        assert calls == [(FRAMES[0], FRAMES[0], False)] * cfg.n_enc_layers + [(S, S, True)] * cfg.n_layers
        calls.clear()
        train = tlm.encode_audio(model, cfg, torch.tensor(frames), plane=tlm.TRAIN)
        assert calls == []
    finally:
        ops.attention_op = real
    _close_to_max(train, enc, 1e-6, "encoder states, TRAIN against the kernel plane")


def test_attention_op_not_causal_matches_pallas_at_a_ragged_length():
    """The encoder's call, (B, S, H, Dh) in, not causal, at a ragged S = 300
    and Dh 64: the port's ``attention_op`` on both planes against the
    reference's Pallas ``flash_attention`` in interpret mode (128-blocks, the
    TPU kernel's own tiles), within 1e-5."""
    rng = np.random.default_rng(300)
    q, k, v = (rng.standard_normal((1, 300, 2, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_flash_attention(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)), causal=False,
                                        interpret=True)).transpose(0, 2, 1, 3)
    for plane in PLANES:
        got = ops.attention_op(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=False, plane=plane)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5, err_msg=plane)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def _reference_serve(jcfg, jparams, Bn, P, G):
    """The reference launcher's loop at seed 0: prompts, frames, tokens
    (B, G), logits (G, B, V)."""
    key = jax.random.PRNGKey(1)
    prompts = jax.random.randint(key, (Bn, P), 0, jcfg.vocab_size)
    frames = jax.random.normal(key, (Bn, jcfg.enc_seq_len, jcfg.d_model))
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=P + G))(
        jparams, {"tokens": prompts, "frames": frames})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, jcfg, SHD, c, b))
    tok = jnp.argmax(logits, -1)
    toks, steps = [tok], [logits]
    for _ in range(G - 1):
        logits, cache = step(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, -1)
        toks.append(tok)
        steps.append(logits)
    return (np.asarray(prompts), np.asarray(frames), np.stack([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(s) for s in steps]))


def test_serve_matches_reference_loop(reduced):
    """``serve`` on the seed-0 weights on both planes against the reference
    launcher's loop: 3 requests of 24 frames, 12-token prompts, 6 tokens
    each; the frames are ``normal(PRNGKey(1))`` bitwise."""
    cfg, jcfg, jparams, model = reduced
    Bn, P, G = 3, 12, 6
    prompts, frames, toks, logits = _reference_serve(jcfg, jparams, Bn, P, G)
    for plane in PLANES:
        res = serve(cfg, batch=Bn, prompt_len=P, gen_len=G, page_size=8, seed=0, device="cpu", plane=plane,
                    params=model)
        np.testing.assert_array_equal(res.prompts.numpy(), prompts)
        np.testing.assert_array_equal(res.frames.numpy(), frames)
        np.testing.assert_array_equal(res.tokens.numpy(), toks)
        np.testing.assert_allclose(res.logits.numpy(), logits, atol=LOGIT_TOL, rtol=0)


def test_serve_cli_runs_whisper(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "arch=whisper-small" in out and "[serve] ok" in out


# ---------------------------------------------------------------------------
# Training, conversion and checkpoints
# ---------------------------------------------------------------------------


def test_lm_loss_and_grads_match_reference(reduced):
    """``lm_loss`` over 2 x 16 tokens and 24 frames, every block
    checkpointed (the encoder's too), and its gradients: the loss within
    1e-5 (measured 4.8e-7), each gradient leaf within 2e-5 of its largest
    |value| (measured 1.2e-6), the ``NOISE_GRADS`` within 1e-8 (measured
    2.4e-9)."""
    _, _, jparams, _ = reduced
    cfg, jcfg = (dataclasses.replace(c, remat="full") for c in (reduced_config(ARCH), jreduced_config(ARCH)))
    toks, frames = _inputs(cfg, 16, cfg.enc_seq_len, 12)
    batch = {"tokens": toks, "labels": toks, "frames": frames}
    wl, wg = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(p, jcfg, SHD, batch)))(jparams)
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    loss = tlm.lm_loss(model, cfg, {k: torch.tensor(v) for k, v in batch.items()})
    assert abs(float(loss.detach()) - float(wl)) <= 1e-5
    grads = convert.stack_named(dict(zip(named, torch.autograd.grad(loss, list(named.values())))), cfg)
    got, want = dict(_leaves(grads)), dict(_leaves(wg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name in NOISE_GRADS:
            assert np.abs(got[name].numpy() - np.asarray(w)).max() <= 1e-8, name
        else:
            _close_to_max(got[name], w, 2e-5, name)


def test_train_steps_on_frames_batches_match_reference(reduced):
    """Three AdamW ``build_train_step`` steps on the training launcher's
    batches (the pipeline's tokens, ``normal(fold_in(PRNGKey(7), step))``
    frames): the frames bitwise, losses within 1e-5 (measured 4.8e-7), every
    parameter within 1e-6 absolute, as ``tests/test_torch_train.py`` holds
    them (measured 4.0e-7, on the ``NOISE_GRADS``' biases, which AdamW moves
    by their noise);
    one step moves ``xattn`` off ``attn`` in both packages (C.13: the two
    are separate leaves)."""
    from repro.data.pipeline import make_pipeline as jmake_pipeline

    cfg, jcfg, jparams, _ = reduced
    Bn, seq = 2, 16
    jstep, jopt = jsteps.build_train_step(jcfg, SHD, "adamw")
    jstep = jax.jit(jstep)
    jinit, jnext = jmake_pipeline(jcfg.vocab_size, Bn, seq)
    tstep, topt = build_train_step(cfg, "adamw")
    tinit, tnext = make_pipeline(cfg.vocab_size, Bn, seq, device="cpu")
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    jp, js, jd, td = jparams, jopt.init(jparams), jinit(), tinit()
    ts = topt.init(dict(model.named_parameters()))
    for step in range(3):
        jd, jb = jnext(jd)
        jb["frames"] = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(7), jd.step), (Bn, jcfg.enc_seq_len,
                                                                                              jcfg.d_model))
        td, tb = tnext(td)
        tb["frames"] = frames_batch(cfg, Bn, td.step, "cpu")
        np.testing.assert_array_equal(tb["frames"].numpy(), np.asarray(jb["frames"]))
        jp, js, jm = jstep(jp, js, jnp.int32(step), jb)
        model, ts, tm = tstep(model, ts, step, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5, step
    got = dict(_leaves(convert.lm_params_to_numpy(model)))
    for name, w in _leaves(jp):
        np.testing.assert_allclose(got[name], np.asarray(w), atol=1e-6, rtol=0, err_msg=name)
    for tree in (jax.tree.map(np.asarray, jp), convert.lm_params_to_numpy(model)):
        assert not _xattn_is_attn(tree)


def test_convert_maps_the_encoder_and_decoder_stacks_both_ways(reduced):
    """``enc_layers/…[l]`` is ``enc_layers.{l}.…`` and ``dec_layers/…[l]``
    ``dec_layers.{l}.…``, for the params and an optimizer state."""
    cfg, _, jparams, model = reduced
    named = convert.unstack_tree(jparams, cfg.n_layers)
    assert sorted(named) == sorted(model.state_dict())
    np.testing.assert_array_equal(named["enc_layers.1.mlp.wd"].numpy(), jparams["enc_layers"]["mlp"]["wd"][1])
    np.testing.assert_array_equal(named["dec_layers.1.xattn.wk"].numpy(), jparams["dec_layers"]["xattn"]["wk"][1])
    back = convert.stack_named(named, cfg)
    for (gn, g), (wn, w) in zip(sorted(_leaves(back)), sorted(_leaves(jparams))):
        assert gn == wn
        np.testing.assert_array_equal(g.numpy(), w)
    again = convert.opt_state_from_tree(convert.opt_state_to_tree({"m": named, "v": named}, cfg), cfg, device="cpu")
    assert all(torch.equal(again["m"][k], v) for k, v in named.items())


def test_whisper_checkpoints_open_in_either_package(tmp_path):
    """The port's bundle after one AdamW step goes to disk and the reference
    restores it; the reference's bundle goes to disk and the port restores
    it: every leaf bitwise."""
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    step, opt = build_train_step(cfg, "adamw")
    jp = _jax_params(jcfg)
    model = convert.lm_params_from_numpy(jp, cfg, device="cpu")
    state = opt.init(dict(model.named_parameters()))
    toks, frames = _inputs(cfg, 16, cfg.enc_seq_len, 5)
    model, state, _ = step(model, state, 0, {"tokens": torch.tensor(toks), "labels": torch.tensor(toks),
                                             "frames": torch.tensor(frames)})
    bundle = convert.bundle_to_tree(model, state, DataState(1, 0), 1)
    save_checkpoint(str(tmp_path / "port"), 1, bundle)
    _, jopt = jsteps.build_train_step(jcfg, SHD, "adamw")
    proto = {"params": jp, "opt": jopt.init(jp), "data": {"step": 0, "seed": 0}, "step": 0}
    s, tree = jrestore(str(tmp_path / "port"), proto)
    assert s == 1
    flat = dict(tckpt._flatten(bundle))
    assert "['params']['enc_layers']['attn']['wq']" in flat and "['opt']['v']['dec_layers']['xattn']['bo']" in flat
    for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(np.asarray(leaf), flat[jax.tree_util.keystr(k)].numpy())

    jsave(str(tmp_path / "ref"), 3, {"params": jp, "opt": jopt.init(jp),
                                    "data": {"step": jnp.int32(3), "seed": jnp.int32(0)}, "step": jnp.int32(3)})
    s, ttree = restore_checkpoint(str(tmp_path / "ref"))
    s2, tmodel, tstate, data = convert.bundle_from_tree(ttree, cfg, device="cpu")
    assert s == s2 == 3 and data == (3, 0) and set(tstate) == {"m", "v"}
    assert len(tmodel.enc_layers) == cfg.n_enc_layers and not hasattr(tmodel, "layers")
    back = dict(_leaves(convert.lm_params_to_numpy(tmodel)))
    for name, w in _leaves(jp):
        np.testing.assert_array_equal(back[name], np.asarray(w), err_msg=name)


# ---------------------------------------------------------------------------
# The golden file
# ---------------------------------------------------------------------------


def test_golden_file_matches_the_port_draws():
    """The golden file's prompts and frames are the port's draws from
    PRNGKey(1), its steps are self-consistent, and its tolerance is 10x the
    port's CPU gap."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg, _ = get_config(ARCH)
    assert g["arch"] == ARCH and (g["n_layers"], g["n_enc_layers"], g["d_model"]) == (12, 12, cfg.d_model)
    assert {k: g[k] for k in GOLDEN_RUN} == GOLDEN_RUN and g["enc_seq_len"] == cfg.enc_seq_len
    Bn, P = g["batch"], g["prompt_len"]
    key = prng.prng_key(g["seed"] + 1)
    np.testing.assert_array_equal(prng.randint(key, (Bn, P), 0, cfg.vocab_size).numpy(), np.array(g["prompts"]))
    frames = prng.normal(key, (Bn, cfg.enc_seq_len, cfg.d_model))
    rows = frames.reshape(-1, cfg.d_model)
    np.testing.assert_array_equal(rows[:2, :8].numpy(), np.float32(g["frames"]["head"]))
    np.testing.assert_array_equal(rows[-2:, -8:].numpy(), np.float32(g["frames"]["tail"]))
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


def _reference_leaf(params, name, layer):
    """The reference tree's leaf for a port name (``enc_layers/…`` or
    ``dec_layers/…`` at ``layer``)."""
    a = params
    for part in name.split("/"):
        a = a[part]
    return np.asarray(a if layer is None else a[layer])


def write_golden():
    """The reference's whisper-small, whole: prefill and greedy decode; then
    the port's CPU gap in a second process."""
    cfg_j = jget_config(ARCH)[0]
    r = GOLDEN_RUN
    Bn, P, G = r["batch"], r["prompt_len"], r["gen_len"]
    t0 = time.time()
    params = _jax_params(cfg_j, r["seed"])
    print(f"reference init: {time.time() - t0:.1f} s", flush=True)
    key = jax.random.PRNGKey(r["seed"] + 1)
    prompts = jax.random.randint(key, (Bn, P), 0, cfg_j.vocab_size)
    frames = jax.random.normal(key, (Bn, cfg_j.enc_seq_len, cfg_j.d_model))
    t0 = time.time()
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, cfg_j, SHD, b, pad_to=P + G))(
        params, {"tokens": prompts, "frames": frames})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, cfg_j, SHD, c, b))
    steps, toks = [np.asarray(logits)], [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(G - 1):
        logits, cache = step(params, cache, {"token": jnp.asarray(toks[-1])})
        steps.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    del cache
    print(f"reference prefill + {G - 1} steps: {time.time() - t0:.1f} s", flush=True)
    leaves = {}
    for name, layer, corner in GOLDEN_LEAVES:
        a = _reference_leaf(params, name, layer)
        rows = a.reshape(-1, a.shape[-1])
        sample = rows[:2, :8] if corner == "head" else rows[-2:, -8:]
        leaves[f"{name}@{layer}"] = {"layer": layer, "corner": corner, "sample": sample.astype(float).tolist(),
                                     "abs_sum": float(np.abs(a).sum(dtype=np.float64))}
    del params
    f_rows = np.asarray(frames).reshape(-1, cfg_j.d_model)
    out = {
        "what": "JAX reference, whisper-small at full width and depth (12 encoder and 12 decoder layers), float32, "
                "on the CPU: init_lm(PRNGKey(seed)), prompts randint(PRNGKey(seed + 1), (batch, prompt_len), 0, "
                "vocab), frames normal(PRNGKey(seed + 1), (batch, enc_seq_len, d_model)), lm_prefill (the encoder "
                "over the frames, the decoder over the prompt), then greedy lm_decode_step; step 0 is the "
                "prefill's last-token logits; leaves are named as the port names them (name@layer), the frames' "
                "corners are those of (batch * enc_seq_len, d_model) rows",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_whisper.py",
        "arch": ARCH, "n_layers": cfg_j.n_layers, "n_enc_layers": cfg_j.n_enc_layers, "d_model": cfg_j.d_model,
        "vocab_size": cfg_j.vocab_size, "enc_seq_len": cfg_j.enc_seq_len,
        **r, "dtype": "float32",
        "prompts": np.asarray(prompts).tolist(),
        "frames": {"head": f_rows[:2, :8].astype(float).tolist(), "tail": f_rows[-2:, -8:].astype(float).tolist(),
                   "abs_sum": float(np.abs(f_rows).sum(dtype=np.float64))},
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


def _port_cpu_gap(d):
    """The port on the CPU (torch plane) with the reference's weights, tokens
    and frames: its gap to the reference's logits (each step teacher-forced
    with the reference's tokens), into the golden file."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg_j, cfg = jget_config(ARCH)[0], get_config(ARCH)[0]
    t0 = time.time()
    model = convert.lm_params_from_numpy(_jax_params(cfg_j, g["seed"]), cfg, device="cpu")
    print(f"reference weights in the port: {time.time() - t0:.1f} s", flush=True)
    ref_steps = np.load(os.path.join(d, "steps.npy"))
    key = prng.prng_key(g["seed"] + 1)
    prompts = torch.tensor(g["prompts"], dtype=torch.int32)
    frames = prng.normal(key, (g["batch"], cfg.enc_seq_len, cfg.d_model))
    P, G = g["prompt_len"], g["gen_len"]
    t0 = time.time()
    with torch.inference_mode():
        tl, tc = lm_prefill(model, cfg, {"tokens": prompts, "frames": frames}, pad_to=P + G, plane=ops.TORCH)
        gaps = [float(np.abs(tl.numpy() - ref_steps[0]).max())]
        for s in range(1, G):
            tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(g["tokens"], dtype=torch.int32)[:, s - 1]})
            gaps.append(float(np.abs(tl.numpy() - ref_steps[s]).max()))
    print(f"port (CPU, torch plane): {time.time() - t0:.1f} s; logit gaps {gaps}", flush=True)
    g["port_cpu_gap"] = {"logits": max(gaps)}
    g["port_cpu_logit_gap_per_step"] = gaps
    g["port_cpu_gap_note"] = ("max |port - reference| over every logit of each step (the port on the CPU, torch "
                              "plane, with the reference's weights through convert, teacher-forced with the "
                              "reference's tokens)")
    # the card is held to 10x the CPU's gap (the rule of the other golden files), no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in g["port_cpu_gap"].items()}
    with open(GOLDEN, "w") as f:
        json.dump(g, f)
    print(f"port on the CPU: gap {g['port_cpu_gap']}; tolerance {g['tolerance']}")


if __name__ == "__main__":
    sys.exit(_port_cpu_gap(sys.argv[2]) if sys.argv[1:2] == ["--port-gap"] else write_golden())
