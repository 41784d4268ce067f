"""The port's Mamba-1 SSM family (``layers/scan``, ``layers/ssm``,
falcon-mamba-7b) against the JAX reference, on the CPU.

Inputs are made from a seed with numpy and go through both packages, at
``reduced_config("falcon-mamba-7b")`` (4 layers, d_model 128, d_inner 256,
N 8, dt_rank 8, vocab 512) unless a test says otherwise:

* ``init_ssm`` leaf by leaf, and at full width the transcendental leaves
  ``dt_bias`` and ``A_log``; ``init_lm``'s whole tree;
* ``associative_scan`` against ``jax.lax.associative_scan`` at lengths 1,
  2, 3, 13, 64 and 2048, and ``_ssm_core`` over channel chunks bitwise the
  whole run;
* ``apply_ssm`` with and without its state, ``apply_ssm_step`` chained from
  a prefill's state; ``lm_apply``, ``lm_prefill`` then ``lm_decode_step``,
  and ``serve`` on both kernel planes; prefill then decode against the
  port's own forward on the longer sequence;
* 3 AdamW ``build_train_step`` steps under ``remat`` "none", "full" and
  "save_attn"; checkpoints written by each package, opened by the other;
* the short-prompt ``ValueError`` (ROADMAP.md C.10).

Tolerances, from what was measured here (XLA's CPU backend contracts
``b1 * a2 + b2`` and the conv's taps into fused multiply-adds under jit,
and its ``exp``, ``log1p`` and dots round otherwise than PyTorch's):
init within 2 ulp (measured: bitwise); the scan bitwise against lax's
eager scan (the same tree of products, each rounded once) and within
1e-6 of the largest |value| against its jitted one (measured 1.3e-7);
layer outputs within ``LAYER_TOL`` of their largest |value|; logits within
``LOGIT_TOL`` absolute; training as ``tests/test_torch_train.py`` holds
it.  Each constant's comment gives its measurement.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm.py

rewrites ``src/repro_torch/data/golden_serve_falcon_mamba.json``: the
reference's falcon-mamba-7b at full width, 2 layers (seed 0, one prompt of
2048 tokens, 8 greedy steps) and, from a second process, the port's CPU
gap to it on the reference's weights, which sets the card's tolerance
(``chip_smoke.py``).
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
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import restore_checkpoint as jrestore, save_checkpoint as jsave
from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.layers import ssm as jssm
from repro.models import decode as jdecode
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataState
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.layers import ssm as tssm
from repro_torch.layers.scan import associative_scan
from repro_torch.models import lm as tlm
from repro_torch.models.decode import init_cache, lm_decode_step, lm_prefill
from repro_torch.train.steps import build_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_falcon_mamba.json")
ARCH = "falcon-mamba-7b"
SHD = AxisRules(None)
PLANES = (ops.TORCH, ops.KERNEL)
LAYER_TOL = 1e-5  # of the output's largest |value| (measured 1.1e-6: the state h after a 4-layer prefill)
LOGIT_TOL = 1e-5  # absolute, logits of std 0.88 (measured 4.1e-6 for the forward, 3.0e-6 for a decode step)
# the golden run: full width, depth cut to 2 layers (743 M float32 parameters on the CPU), the main path's
# prompt length, so the scan runs all 11 levels
GOLDEN_LAYERS = 2
GOLDEN_RUN = dict(seed=0, batch=1, prompt_len=2048, gen_len=8)
# leaves the card's init is checked on: (name, layer, corner)
GOLDEN_LEAVES = (("embed", None, "head"), ("lm_head", None, "tail"), ("layers/ssm/in_proj", 0, "head"),
                 ("layers/ssm/x_proj", 0, "head"), ("layers/ssm/dt_proj", 0, "tail"),
                 ("layers/ssm/dt_bias", 0, "head"), ("layers/ssm/A_log", 0, "tail"),
                 ("layers/ssm/conv_w", 0, "head"), ("layers/ssm/out_proj", 0, "tail"))


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _close_to_max(got, want, rel, name):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, name
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(float(np.abs(want).max()), 1e-30), (name, gap)


def _jax_params(cfg, seed=0):
    return unzip_params(jlm.init_lm(jax.random.PRNGKey(seed), cfg, jnp.float32))[0]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores, where a thread pool per
    worker loses far more to contention than it gains at these sizes."""
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


def _layer_params(reduced, layer=1):
    """Layer ``layer``'s SSM leaves: (reference dict, the port's SSM)."""
    _, _, jparams, model = reduced
    return {k: v[layer] for k, v in jparams["layers"]["ssm"].items()}, model.layers[layer].ssm


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def test_init_ssm_matches_reference():
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    want = unzip_params(jssm.init_ssm(key, jcfg, jnp.float32))[0]
    got = tssm.init_ssm(prng.fold_in(prng.prng_key(3), 5), cfg)
    assert set(want) == {n for n, _ in got.named_parameters()} == set(tssm.SSM.NAMES)
    for name, w in want.items():
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert _ulp(g.numpy(), w).max() <= 2, name  # measured: bitwise equal


def test_init_ssm_transcendental_leaves_at_full_width():
    """``dt_bias`` (XLA's CPU exp, exp, log, op by op) and ``A_log`` at
    falcon-mamba's d_inner 8192, N 16: the reference's eager expressions
    (a jitted evaluation fuses them and differs by up to 96 ulp)."""
    cfg = get_config(ARCH)[0]
    di, N = cfg.d_inner, cfg.ssm_state
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    u = jax.random.uniform(jssm.name_key(key, "dt_bias"), (di,), jnp.float32)
    want_dt = jnp.log(jnp.exp(jnp.exp(u * (jnp.log(0.1) - jnp.log(0.001)) + jnp.log(0.001))) - 1.0 + 1e-9)
    want_a = jnp.log(jnp.broadcast_to(jnp.arange(1, N + 1, dtype=jnp.float32), (di, N)))
    # d_inner 8192 from a narrow d_model: the two leaves depend on d_inner and N only, the projections stay small
    narrow = dataclasses.replace(cfg, d_model=1, ssm_expand=8192, ssm_dt_rank=1)
    got = tssm.init_ssm(prng.fold_in(prng.prng_key(0), 7), narrow)
    assert narrow.d_inner == di and got.dt_bias.shape == (di,) and got.A_log.shape == (di, N)
    assert _ulp(got.dt_bias.numpy(), want_dt).max() <= 2  # measured: bitwise equal
    assert _ulp(got.A_log.numpy(), want_a).max() <= 2


def test_init_lm_matches_reference_leaf_by_leaf(reduced):
    cfg, _, jparams, _ = reduced
    model = tlm.init_lm(prng.prng_key(0), cfg, device="cpu")
    got = dict(_leaves(convert.lm_params_to_numpy(model)))
    want = dict(_leaves(jparams))
    assert sorted(got) == sorted(want) and "layers/ssm/A_log" in want and "layers/norm/scale" in want
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert _ulp(got[name], w).max() <= 2, name  # measured: bitwise equal


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------


def jssm_combine(c1, c2):
    """The reference's combine (``_ssm_core``'s inner function)."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


@pytest.mark.parametrize("n", [1, 2, 3, 13, 64, 2048])
def test_associative_scan_matches_lax(n):
    """Bitwise against lax's eager scan on (a, b) whose products stay normal
    (a in [0.96, 1): XLA flushes subnormals, PyTorch keeps them); within
    1e-6 of the largest |value| against the jitted scan at the SSM's own
    decays (jit contracts ``b1 * a2 + b2`` into fused multiply-adds)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.96, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    got = associative_scan(tssm._combine, (torch.tensor(a), torch.tensor(b)), dim=1)
    want = jax.lax.associative_scan(jssm_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a = np.exp(-rng.uniform(0.0, 0.5, (2, n, 3, 4))).astype(np.float32)
    got = associative_scan(tssm._combine, (torch.tensor(a), torch.tensor(b)), dim=-3)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(jssm_combine, (a, b), axis=1))(a, b)
    for g, w in zip(got, want):
        _close_to_max(g, w, 1e-6, f"n={n}")  # measured 1.3e-7


def test_associative_scan_rejects_unequal_lengths():
    with pytest.raises(ValueError, match="differ"):
        associative_scan(tssm._combine, (torch.zeros(2, 5), torch.zeros(2, 4)), dim=1)


@pytest.mark.parametrize("chunk", [1, 7, 64, 255])
def test_chunked_core_is_bitwise_the_whole_run(reduced, chunk):
    """The channels are independent: ``_ssm_core`` over chunks of d_inner
    channels (a chunk that does not divide 256 included) equals one chunk
    of all of them bit for bit, y and the final state."""
    cfg = reduced[0]
    _, p = _layer_params(reduced)
    rng = np.random.default_rng(chunk)
    B, S, di, R, N = 2, 37, cfg.d_inner, cfg.ssm_dt_rank, cfg.ssm_state
    x_c = torch.tensor(rng.standard_normal((B, S, di)).astype(np.float32))
    dt_r = torch.tensor(rng.standard_normal((B, S, R)).astype(np.float32))
    Bs, Cs = (torch.tensor(rng.standard_normal((B, S, N)).astype(np.float32)) for _ in range(2))
    y0, h0 = tssm._ssm_core(p, x_c, dt_r, Bs, Cs, chunk=di)
    y1, h1 = tssm._ssm_core(p, x_c, dt_r, Bs, Cs, chunk=chunk)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    assert tssm.SCAN_CHUNK_ELEMS // (4 * 2048 * 16) == 2048  # the main path runs 4 chunks of falcon-mamba's 8192


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


def test_apply_ssm_matches_reference(reduced):
    cfg, jcfg = reduced[:2]
    jp, p = _layer_params(reduced)
    x = np.random.default_rng(4).standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jssm.apply_ssm(p, jcfg, SHD, x))(jp, x))
    got = tssm.apply_ssm(p, cfg, torch.tensor(x))
    _close_to_max(got, want, LAYER_TOL, "apply_ssm")
    wy, wst = jax.jit(lambda p, x: jssm.apply_ssm(p, jcfg, SHD, x, return_state=True))(jp, x)
    gy, gst = tssm.apply_ssm(p, cfg, torch.tensor(x), return_state=True)
    assert torch.equal(gy, got)
    _close_to_max(gst["h"], wst["h"], LAYER_TOL, "h")
    assert gst["h"].dtype == torch.float32 and gst["conv"].shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    _close_to_max(gst["conv"], wst["conv"], LAYER_TOL, "conv")


def test_ssm_steps_chained_from_a_prefill_state(reduced):
    """Five decode steps of the layer, each fed the last step's state, from
    a 6-token prefill's state: the port's in-place cache against the
    reference's functional one."""
    cfg, jcfg = reduced[:2]
    jp, p = _layer_params(reduced, 2)
    x = np.random.default_rng(5).standard_normal((3, 11, cfg.d_model)).astype(np.float32)
    _, jc = jax.jit(lambda p, x: jssm.apply_ssm(p, jcfg, SHD, x, return_state=True))(jp, x[:, :6])
    _, st = tssm.apply_ssm(p, cfg, torch.tensor(x[:, :6]), return_state=True)
    cache = tssm.init_ssm_cache(cfg, 3)
    cache["h"].copy_(st["h"])
    cache["conv"].copy_(st["conv"])
    jstep = jax.jit(lambda p, x, c: jssm.apply_ssm_step(p, jcfg, SHD, x, c))
    for t in range(6, 11):
        wy, jc = jstep(jp, x[:, t : t + 1], jc)
        h_before = cache["h"]
        gy, out = tssm.apply_ssm_step(p, cfg, torch.tensor(x[:, t : t + 1]), cache)
        assert out is cache and cache["h"] is h_before  # written in place
        _close_to_max(gy, wy, LAYER_TOL, f"step {t}")
        _close_to_max(cache["h"], jc["h"], LAYER_TOL, f"h {t}")
        _close_to_max(cache["conv"], jc["conv"], LAYER_TOL, f"conv {t}")


@pytest.mark.parametrize("S", [1, 2])
def test_prompts_shorter_than_the_conv_window_raise(reduced, S):
    """The reference keeps a conv tail of S < K - 1 tokens, which its decode
    step then fails on (ROADMAP.md C.10); the port refuses the prefill."""
    cfg, _, _, model = reduced
    toks = torch.tensor(_tokens(cfg, (2, S), 9))
    with pytest.raises(ValueError, match="K - 1 = 3"):
        lm_prefill(model, cfg, {"tokens": toks})
    with pytest.raises(ValueError, match="K - 1"):
        serve(cfg, batch=1, prompt_len=S, gen_len=2, device="cpu", params=model)
    tlm.lm_apply(model, cfg, {"tokens": toks})  # a forward without a state takes any length


def test_record_splits_the_layer_by_step_in_a_trace(reduced):
    """While a ``Record`` is open, each SSM call's steps are profiler ranges
    (what chip_smoke.py splits the layer's time by); without one, none."""
    from torch.profiler import ProfilerActivity, profile

    cfg, _, _, model = reduced
    toks = torch.tensor(_tokens(cfg, (2, 16), 3))
    steps = {"ssm:in_proj", "ssm:conv", "ssm:x_proj/dt", "ssm:scan", "ssm:out_proj"}
    for recording in (True, False):
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
            if recording:
                with tssm.Record():
                    _, cache = lm_prefill(model, cfg, {"tokens": toks})
                    lm_decode_step(model, cfg, cache, {"token": toks[:, 0]})
            else:
                tlm.lm_apply(model, cfg, {"tokens": toks})
        names = [e.name for e in prof.events() if e.name.startswith("ssm:")]
        if recording:
            assert set(names) == steps and tssm.Record.current is None
            assert all(names.count(n) == 2 * cfg.n_layers for n in steps - {"ssm:x_proj/dt"})
        else:
            assert names == []


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", PLANES)
def test_lm_apply_matches_reference(reduced, plane):
    cfg, jcfg, jparams, model = reduced
    toks = _tokens(cfg, (2, 40), 1)
    want = np.asarray(jax.jit(lambda p, t: jlm.lm_apply(p, jcfg, SHD, {"tokens": t}))(jparams, toks))
    got = tlm.lm_apply(model, cfg, {"tokens": torch.tensor(toks)}, plane=plane).numpy()
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("plane", PLANES)
def test_prefill_and_decode_match_reference(reduced, plane):
    cfg, jcfg, jparams, model = reduced
    B, P = 2, 24
    toks = _tokens(cfg, (B, P + 4), 2)
    jl, jc = jax.jit(lambda p, t: jdecode.lm_prefill(p, jcfg, SHD, {"tokens": t}, pad_to=P + 8))(jparams, toks[:, :P])
    tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(toks[:, :P])}, pad_to=P + 8, plane=plane)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    L, di, N, K = cfg.n_layers, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    assert tc["layers"]["h"].shape == (L, B, di, N) and tc["layers"]["conv"].shape == (L, B, K - 1, di)
    for name in ("h", "conv"):
        _close_to_max(tc["layers"][name], jc["layers"][name], LAYER_TOL, name)
    jstep = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))
    for i in range(4):  # teacher-forced
        t = toks[:, P + i]
        jl, jc = jstep(jparams, jc, t)
        tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(t)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
        assert tc["len"] == int(jc["len"]) == P + i + 1


@pytest.mark.parametrize("plane", PLANES)
def test_prefill_decode_match_forward(reduced, plane):
    """Prefill then decode steps (the recurrence one token at a time) equal
    the forward's logits (the scan over the whole sequence)."""
    cfg, _, _, model = reduced
    toks = torch.tensor(_tokens(cfg, (2, 9), 3))
    full = tlm.lm_apply(model, cfg, {"tokens": toks}, plane=plane)
    lg, cache = lm_prefill(model, cfg, {"tokens": toks[:, :5]}, plane=plane)
    np.testing.assert_allclose(lg.numpy(), full[:, 4].numpy(), atol=LOGIT_TOL, rtol=0)
    for t in range(5, 9):
        lg, cache = lm_decode_step(model, cfg, cache, {"token": toks[:, t]})
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=LOGIT_TOL, rtol=0, err_msg=f"step {t}")


def test_init_cache_takes_the_ssm_shapes():
    cfg = reduced_config(ARCH)
    c = init_cache(cfg, 3, 99)
    assert c["len"] == 0 and set(c["layers"]) == {"h", "conv"}
    assert c["layers"]["h"].shape == (cfg.n_layers, 3, cfg.d_inner, cfg.ssm_state)
    assert c["layers"]["h"].dtype == torch.float32
    assert c["layers"]["conv"].shape == (cfg.n_layers, 3, cfg.ssm_conv - 1, cfg.d_inner)


def _reference_serve(jcfg, B, P, G):
    """The reference launcher's loop at seed 0: prompts, tokens (B, G), logits (G, B, V)."""
    params = _jax_params(jcfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, P), 0, jcfg.vocab_size)
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=P + G))(params, {"tokens": prompts})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, jcfg, SHD, c, b))
    tok = jnp.argmax(logits, -1)
    toks, steps = [tok], [logits]
    for _ in range(G - 1):
        logits, cache = step(params, cache, {"token": tok})
        tok = jnp.argmax(logits, -1)
        toks.append(tok)
        steps.append(logits)
    return np.asarray(prompts), np.stack([np.asarray(t) for t in toks], 1), np.stack([np.asarray(s) for s in steps])


@pytest.mark.parametrize("plane", PLANES)
def test_serve_matches_reference_loop(reduced, plane):
    """``serve`` on the seed-0 weights (the reference's, which the port's
    ``init_lm`` draws bitwise) against the reference launcher's loop."""
    cfg, jcfg, _, model = reduced
    B, P, G = 3, 20, 6
    prompts, toks, logits = _reference_serve(jcfg, B, P, G)
    res = serve(cfg, batch=B, prompt_len=P, gen_len=G, page_size=8, seed=0, device="cpu", plane=plane, params=model)
    np.testing.assert_array_equal(res.prompts.numpy(), prompts)
    np.testing.assert_array_equal(res.tokens.numpy(), toks)
    np.testing.assert_allclose(res.logits.numpy(), logits, atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# Training and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full", "save_attn"])
def test_train_step_matches_reference(reduced, remat):
    """3 AdamW steps (``tests/test_torch_train.py``'s tolerances: loss
    within 1e-5, ``grad_norm`` 1e-5 relative, parameters 1e-6 absolute, m
    and v within 1e-5 of each leaf's largest value)."""
    _, _, jparams, _ = reduced
    cfg, jcfg = (dataclasses.replace(c, remat=remat) for c in (reduced_config(ARCH), jreduced_config(ARCH)))
    jstep, jopt = jsteps.build_train_step(jcfg, SHD, "adamw")
    jstep = jax.jit(jstep)
    tstep, topt = build_train_step(cfg, "adamw")
    jp, js = jparams, jopt.init(jparams)
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    ts = topt.init(dict(model.named_parameters()))
    rng = np.random.default_rng(12)
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        jp, js, jm = jstep(jp, js, jnp.int32(step), {"tokens": toks, "labels": toks})
        model, ts, tm = tstep(model, ts, step, {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)})
        assert tm["step"] == int(jm["step"]) == step + 1
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5, step
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        got = dict(_leaves(convert.lm_params_to_numpy(model)))
        for name, w in _leaves(jp):
            np.testing.assert_allclose(got[name], np.asarray(w), atol=1e-6, rtol=0, err_msg=f"step {step} {name}")
        state = dict(_leaves(convert.opt_state_to_tree(ts)))
        for name, w in _leaves(js):
            _close_to_max(state[name], w, 1e-5, f"step {step} {name}")


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_save_attn_saves_the_weight_products(reduced):
    """``save_attn`` keeps the products with the weights (``mm``: in_proj,
    x_proj, dt_proj, out_proj, the head) and recomputes the rest in the
    backward: the SSM has no batched product (its readout
    ``bsdn,bsn->bsd`` is a product and a sum, recomputed as JAX's
    ``checkpoint_dots_with_no_batch_dims`` recomputes that einsum), so the
    backward runs the same products as without rematerialisation, and
    "full" recomputes the weight products as well."""
    cfg, _, jparams, _ = reduced
    toks = torch.tensor(_tokens(cfg, (2, 64), 0))
    counts = {}
    for remat in ("none", "save_attn", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        model = convert.lm_params_from_numpy(jparams, c, device="cpu").requires_grad_(True)
        loss = tlm.lm_loss(model, c, {"tokens": toks, "labels": toks})
        with _CountMatmuls() as mode:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[remat] = mode.counts
    assert counts["save_attn"] == counts["none"] and counts["none"]["bmm"] == 0
    # "full" recomputes in_proj, x_proj and dt_proj of each block (a non-reentrant checkpoint stops recomputing
    # once it holds what the backward needs, before out_proj)
    assert counts["full"]["mm"] == counts["none"]["mm"] + 3 * cfg.n_layers


def test_ssm_checkpoints_open_in_either_package(tmp_path):
    """The port's bundle after one AdamW step goes to disk and the reference
    restores it; the reference's bundle goes to disk and the port restores
    it: SSM leaves bitwise."""
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    step, opt = build_train_step(cfg, "adamw")
    jp = _jax_params(jcfg)
    model = convert.lm_params_from_numpy(jp, cfg, device="cpu")
    state = opt.init(dict(model.named_parameters()))
    toks = torch.tensor(_tokens(cfg, (2, 16), 5))
    model, state, _ = step(model, state, 0, {"tokens": toks, "labels": toks})
    bundle = convert.bundle_to_tree(model, state, DataState(1, 0), 1)
    save_checkpoint(str(tmp_path / "port"), 1, bundle)
    _, jopt = jsteps.build_train_step(jcfg, SHD, "adamw")
    proto = {"params": jp, "opt": jopt.init(jp), "data": {"step": 0, "seed": 0}, "step": 0}
    s, tree = jrestore(str(tmp_path / "port"), proto)
    assert s == 1
    flat = dict(tckpt._flatten(bundle))
    assert "['params']['layers']['ssm']['A_log']" in flat and "['opt']['v']['layers']['ssm']['dt_bias']" in flat
    for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(np.asarray(leaf), flat[jax.tree_util.keystr(k)].numpy())

    js = jopt.init(jp)
    jsave(str(tmp_path / "ref"), 3, {"params": jp, "opt": js, "data": {"step": jnp.int32(3), "seed": jnp.int32(0)},
                                    "step": jnp.int32(3)})
    s, ttree = restore_checkpoint(str(tmp_path / "ref"))
    s2, tmodel, tstate, data = convert.bundle_from_tree(ttree, cfg, device="cpu")
    assert s == s2 == 3 and data == (3, 0) and set(tstate) == {"m", "v"}
    assert isinstance(tmodel.layers[0].ssm, tssm.SSM)
    back = dict(_leaves(convert.lm_params_to_numpy(tmodel)))
    for name, w in _leaves(jp):
        np.testing.assert_array_equal(back[name], np.asarray(w), err_msg=name)


# ---------------------------------------------------------------------------
# Configs and the golden file
# ---------------------------------------------------------------------------


def test_check_ported_takes_ssm(reduced):
    for cfg in (get_config(ARCH)[0], reduced_config(ARCH)):
        tlm.check_ported(cfg)
        assert cfg.is_ssm and set(cfg.layer_kinds()) == {"ssm"}
    cfg = get_config(ARCH)[0]
    assert (cfg.d_model, cfg.d_inner, cfg.n_layers, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_dt_rank, cfg.vocab_size) == (
        4096, 8192, 64, 16, 4, 256, 65024)
    # the config's analytic count takes two norms per SSM block and no conv_b, and no final norm
    real = cfg.param_count() + cfg.n_layers * (cfg.d_inner - cfg.d_model) + cfg.d_model
    assert (cfg.param_count(), real) == (7_272_398_848, 7_272_665_088)
    small, _, _, model = reduced
    assert sum(p.numel() for p in model.parameters()) == (
        small.param_count() + small.n_layers * (small.d_inner - small.d_model) + small.d_model)


def test_golden_file_matches_the_port_draws():
    """The golden file's prompts are the port's ``randint(PRNGKey(1))``, its
    steps are self-consistent, and its tolerance is 10x the port's CPU gap."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg, _ = get_config(ARCH)
    assert g["arch"] == ARCH and g["n_layers"] == GOLDEN_LAYERS and g["d_model"] == cfg.d_model
    assert {k: g[k] for k in GOLDEN_RUN} == GOLDEN_RUN
    B, P = g["batch"], g["prompt_len"]
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (B, P), 0, cfg.vocab_size)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    assert len(g["steps"]) == g["gen_len"] == len(g["tokens"][0])
    for s, step in enumerate(g["steps"]):
        for b in range(B):
            assert step["top_ids"][b][0] == g["tokens"][b][s]
            assert step["lse"][b] >= step["max"][b] == step["top_logits"][b][0]
    assert [n for n, _, _ in GOLDEN_LEAVES] == list(g["leaves"])
    assert g["tolerance"]["logits"] == max(10 * g["port_cpu_gap"]["logits"], 1e-6)


# ---------------------------------------------------------------------------
# The golden file (full width, reference on the CPU)
# ---------------------------------------------------------------------------


def _step_record(logits):
    lf = np.asarray(logits, np.float32)
    top = np.argsort(-lf, axis=-1, kind="stable")[:, :8]
    m = lf.max(-1)
    lse = m + np.log(np.exp(lf - m[:, None]).sum(-1, dtype=np.float64))
    return {"top_ids": top.tolist(), "top_logits": np.take_along_axis(lf, top, -1).astype(float).tolist(),
            "max": m.astype(float).tolist(), "lse": lse.astype(float).tolist()}


def _golden_cfg(get):
    return dataclasses.replace(get(ARCH)[0], n_layers=GOLDEN_LAYERS)


def write_golden():
    """The reference at full width, 2 layers: prefill and greedy decode;
    then the port's CPU gap in a second process."""
    cfg_j = _golden_cfg(jget_config)
    r = GOLDEN_RUN
    B, P, G = r["batch"], r["prompt_len"], r["gen_len"]
    t0 = time.time()
    params = _jax_params(cfg_j, r["seed"])
    print(f"reference init: {time.time() - t0:.1f} s", flush=True)
    prompts = jax.random.randint(jax.random.PRNGKey(r["seed"] + 1), (B, P), 0, cfg_j.vocab_size)
    t0 = time.time()
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, cfg_j, SHD, b, pad_to=P + G))(params, {"tokens": prompts})
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
        a = params
        for part in name.split("/"):
            a = a[part]
        a = np.asarray(a if layer is None else a[layer])
        rows = a.reshape(-1, a.shape[-1])
        sample = rows[:2, :8] if corner == "head" else rows[-2:, -8:]
        leaves[name] = {"layer": layer, "corner": corner, "sample": sample.astype(float).tolist(),
                        "abs_sum": float(np.abs(a).sum(dtype=np.float64))}
    del params
    out = {
        "what": "JAX reference, falcon-mamba-7b at full width with the depth cut to n_layers, float32, on the CPU: "
                "init_lm(PRNGKey(seed)), prompts randint(PRNGKey(seed + 1), (batch, prompt_len), 0, vocab), "
                "lm_prefill (the associative scan over all prompt_len tokens), then greedy lm_decode_step; "
                "step 0 is the prefill's last-token logits",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm.py",
        "arch": ARCH, "n_layers": GOLDEN_LAYERS, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size,
        "depth_cut": "64 -> 2 layers: the reference builds the whole parameter tree on the CPU (2 layers: 743 M "
                     "float32 parameters, 2.97 GB); the card checks the first two layers of its 64-layer model",
        **r, "dtype": "float32",
        "prompts": np.asarray(prompts).tolist(),
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
    """The port on the CPU (torch plane) with the reference's weights and
    tokens: its gap to the reference's logits (each step teacher-forced
    with the reference's tokens), into the golden file."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg_j, cfg = _golden_cfg(jget_config), _golden_cfg(get_config)
    t0 = time.time()
    model = convert.lm_params_from_numpy(_jax_params(cfg_j, g["seed"]), cfg, device="cpu")
    print(f"reference weights in the port: {time.time() - t0:.1f} s", flush=True)
    ref_steps = np.load(os.path.join(d, "steps.npy"))
    prompts = torch.tensor(g["prompts"], dtype=torch.int32)
    P, G = g["prompt_len"], g["gen_len"]
    t0 = time.time()
    with torch.inference_mode():
        tl, tc = lm_prefill(model, cfg, {"tokens": prompts}, pad_to=P + G, plane=ops.TORCH)
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
