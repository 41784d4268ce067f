"""The port's hybrid family (``layers/rglru``, local attention, the window's
ring cache, recurrentgemma-2b) against the JAX reference, on the CPU.

Inputs are made from a seed with numpy and go through both packages, at
``reduced_config("recurrentgemma-2b")`` (5 layers: rglru, rglru, attn,
then a tail of rglru, rglru; d_model and rnn_width 128, 4 heads of 32 on 1
kv head, window W = 16, vocab 512) unless a test says otherwise:

* ``init_rglru`` leaf by leaf, ``lam`` at full width (2560 channels, XLA's
  CPU ``pow`` and ``log``), and the hybrid ``init_lm``'s whole tree;
* ``apply_rglru`` with and without its state, ``apply_rglru_step`` chained
  from a prefill's state; ``local_attention_xla`` at S in {W, W + 4, 2W,
  2W + 8};
* ``lm_apply``, then ``lm_prefill`` + ``lm_decode_step`` on both kernel
  planes: against the reference's prefill cache leaf by leaf and its decode
  logits at S in {W - 6, W, 2W}, and against the reference's ``lm_apply``
  at S in {W + 4, 2W + 8}, where the reference's own decode misses
  (ROADMAP.md C.12: its prefill leaves the window's tokens in other slots
  than its decode expects);
* ``serve`` and the ``--arch recurrentgemma-2b`` command line on the CPU;
  the short-prompt ``ValueError`` (ROADMAP.md C.10); ``lm_loss`` and its
  gradients under ``remat`` "full"; ``convert``'s groups and tail both ways
  and checkpoints written by each package, opened by the other.

Tolerances, from what was measured here (XLA's CPU backend contracts the
scan's ``b1 * a2 + b2`` and the conv's taps into fused multiply-adds under
jit, and its ``exp``, ``tanh`` and dots round otherwise than PyTorch's):
init within 2 ulp (measured: bitwise, ``lam`` included); layer outputs
within ``LAYER_TOL`` of their largest |value|; logits within
``LOGIT_TOL`` absolute.  Each constant's comment gives its measurement.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_hybrid.py

rewrites ``src/repro_torch/data/golden_serve_recurrentgemma.json``: the
reference's recurrentgemma-2b at full width, 3 layers (the first group;
seed 0, one prompt of 2048 tokens, 8 greedy steps) and, from a second
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
from repro.layers import attention as jattn
from repro.layers import rglru as jrglru
from repro.models import decode as jdecode
from repro.models import lm as jlm
from repro.sharding import AxisRules, name_key as jname_key, unzip_params
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataState
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import serve
from repro_torch.layers import attention as tattn
from repro_torch.layers import rglru as trglru
from repro_torch.models import lm as tlm
from repro_torch.models.decode import init_cache, lm_decode_step, lm_prefill
from repro_torch.train.steps import build_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_recurrentgemma.json")
ARCH = "recurrentgemma-2b"
SHD = AxisRules(None)
PLANES = (ops.TORCH, ops.KERNEL)
W = 16  # the reduced config's window
STEPS = 8  # decode steps after each prompt: past the ring's wrap for every S below
LAYER_TOL = 1e-5  # of the output's largest |value| (measured 2.4e-7 for the layer, 1.7e-6 for the prefill cache)
LOGIT_TOL = 2e-5  # absolute, logits of std 0.88 (measured 8.1e-6 for the forward, 7.0e-6 for a decode step)
# the golden run: full width, depth cut to the first group of 3 layers (1.50 B float32 parameters on the CPU),
# the main path's prompt length, so the window (2048) holds the whole prompt and decode wraps the ring
GOLDEN_LAYERS = 3
GOLDEN_RUN = dict(seed=0, batch=1, prompt_len=2048, gen_len=8)
# leaves the card's init is checked on, in the port's names: (name, layer, corner)
GOLDEN_LEAVES = (("embed", None, "head"), ("lm_head", None, "tail"), ("layers/rglru/w_in", 0, "head"),
                 ("layers/rglru/lam", 0, "head"), ("layers/rglru/lam", 1, "tail"), ("layers/rglru/conv_w", 1, "head"),
                 ("layers/rglru/w_out", 0, "tail"), ("layers/mlp/wg", 1, "head"), ("layers/attn/wq", 2, "head"),
                 ("layers/attn/wk", 2, "tail"), ("layers/mlp/wd", 2, "tail"))


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists (the hybrid's tail is a list)."""
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _close_to_max(got, want, rel, name):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(float(np.abs(want).max()), 1e-30), (name, gap)


def _jax_params(cfg, seed=0):
    return unzip_params(jlm.init_lm(jax.random.PRNGKey(seed), cfg, jnp.float32))[0]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


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


def _layer_params(reduced, layer=0):
    """Layer ``layer``'s RG-LRU leaves (an rglru layer of the first group):
    (reference dict, the port's RGLRU)."""
    _, jcfg, jparams, model = reduced
    P = len(jcfg.block_pattern)
    l, j = divmod(layer, P)
    grp = jparams["groups"][f"g{j}_rglru"]["rglru"]
    return {k: v[l] for k, v in grp.items()}, model.layers[layer].rglru


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def test_init_rglru_matches_reference():
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    want = unzip_params(jrglru.init_rglru(key, jcfg, jnp.float32))[0]
    got = trglru.init_rglru(prng.fold_in(prng.prng_key(3), 5), cfg)
    assert set(want) == {n for n, _ in got.named_parameters()} == set(trglru.RGLRU.NAMES)
    for name, w in want.items():
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert _ulp(g.numpy(), w).max() <= 2, name  # measured: bitwise equal


def test_lam_at_full_width():
    """``lam`` = log(p / (1 - p)), p = u ** (1/8), over recurrentgemma's 2560
    channels: the reference's eager expression, whose ``pow`` is glibc's
    ``powf`` (``prng.powf``; a float64 pow rounded to float32 differs on 3
    channels, which the cancellation in 1 - p turns into up to 18 ulp of
    ``lam``)."""
    cfg = get_config(ARCH)[0]
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    u = jax.random.uniform(jname_key(key, "lam"), (cfg.rnn_width,), jnp.float32, 0.9, 0.999)
    want = np.asarray(jnp.log(u ** (1.0 / 8.0) / (1.0 - u ** (1.0 / 8.0))))
    np.testing.assert_array_equal(prng.powf(torch.tensor(np.asarray(u)), 0.125).numpy(), np.asarray(u ** 0.125))
    # lam depends on rnn_width only: the projections stay small at a narrow d_model
    narrow = dataclasses.replace(cfg, d_model=1)
    got = trglru.init_rglru(prng.fold_in(prng.prng_key(0), 7), narrow).lam.numpy()
    assert got.shape == (2560,)
    assert _ulp(got, want).max() <= 2  # measured: bitwise equal


def test_init_lm_matches_reference_leaf_by_leaf(reduced):
    """The hybrid's layer keys: group j's layer l from ``split(name_key(key,
    f"grp{j}"), n_full)[l]``, tail layer i from ``name_key(key, f"tail{i}")``."""
    cfg, _, jparams, _ = reduced
    model = tlm.init_lm(prng.prng_key(0), cfg, device="cpu")
    got = dict(_leaves(convert.lm_params_to_numpy(model)))
    want = dict(_leaves(jparams))
    assert sorted(got) == sorted(want) and "groups/g2_attn/attn/wq" in want and "tail/1/rglru/lam" in want
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert _ulp(got[name], w).max() <= 2, name  # measured: bitwise equal


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------


def test_apply_rglru_matches_reference(reduced):
    cfg, jcfg = reduced[:2]
    jp, p = _layer_params(reduced)
    x = np.random.default_rng(4).standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jrglru.apply_rglru(p, jcfg, SHD, x))(jp, x))
    got = trglru.apply_rglru(p, cfg, torch.tensor(x))
    _close_to_max(got, want, LAYER_TOL, "apply_rglru")
    wy, wst = jax.jit(lambda p, x: jrglru.apply_rglru(p, jcfg, SHD, x, return_state=True))(jp, x)
    gy, gst = trglru.apply_rglru(p, cfg, torch.tensor(x), return_state=True)
    assert torch.equal(gy, got)
    assert gst["h"].dtype == torch.float32 and gst["conv"].shape == (2, cfg.ssm_conv - 1, cfg.rnn_width)
    _close_to_max(gst["h"], wst["h"], LAYER_TOL, "h")
    _close_to_max(gst["conv"], wst["conv"], LAYER_TOL, "conv")


def test_rglru_steps_chained_from_a_prefill_state(reduced):
    """Five decode steps of the layer, each fed the last step's state, from
    a 6-token prefill's state: the port's in-place cache against the
    reference's functional one."""
    cfg, jcfg = reduced[:2]
    jp, p = _layer_params(reduced, 1)
    x = np.random.default_rng(5).standard_normal((3, 11, cfg.d_model)).astype(np.float32)
    _, jc = jax.jit(lambda p, x: jrglru.apply_rglru(p, jcfg, SHD, x, return_state=True))(jp, x[:, :6])
    _, st = trglru.apply_rglru(p, cfg, torch.tensor(x[:, :6]), return_state=True)
    cache = trglru.init_rglru_cache(cfg, 3)
    cache["h"].copy_(st["h"])
    cache["conv"].copy_(st["conv"])
    jstep = jax.jit(lambda p, x, c: jrglru.apply_rglru_step(p, jcfg, SHD, x, c))
    for t in range(6, 11):
        wy, jc = jstep(jp, x[:, t : t + 1], jc)
        h_before = cache["h"]
        gy, out = trglru.apply_rglru_step(p, cfg, torch.tensor(x[:, t : t + 1]), cache)
        assert out is cache and cache["h"] is h_before  # written in place
        _close_to_max(gy, wy, LAYER_TOL, f"step {t}")
        _close_to_max(cache["h"], jc["h"], LAYER_TOL, f"h {t}")
        _close_to_max(cache["conv"], jc["conv"], LAYER_TOL, f"conv {t}")


@pytest.mark.parametrize("S", [W, W + 4, 2 * W, 2 * W + 8])
def test_local_attention_matches_reference(S):
    """Chunks of W queries against [previous chunk, own chunk], masked to the
    window: at one chunk (``naive_attention`` masked to it), a padded last
    chunk, two whole chunks and a padded third (within 1e-6 of the largest
    |value|; measured 2.1e-7)."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((2, S, 4, 32)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda q, k, v: jattn.local_attention_xla(q, k, v, window=W))(q, k, v))
    got = tattn.local_attention_xla(torch.tensor(q), torch.tensor(k), torch.tensor(v), window=W)
    _close_to_max(got, want, 1e-6, f"S={S}")
    full = tattn.naive_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True, window=W)
    _close_to_max(got, full, 1e-6, f"S={S} against the whole masked product")


@pytest.mark.parametrize("S", [1, 2])
def test_prompts_shorter_than_the_conv_window_raise(reduced, S):
    """The reference keeps a conv tail of S < K - 1 tokens, which its decode
    step then fails on with a broadcast error (ROADMAP.md C.10); the port
    refuses the prefill."""
    cfg, _, _, model = reduced
    toks = torch.tensor(_tokens(cfg, (2, S), 9))
    with pytest.raises(ValueError, match="K - 1 = 3"):
        lm_prefill(model, cfg, {"tokens": toks})
    with pytest.raises(ValueError, match="K - 1"):
        serve(cfg, batch=1, prompt_len=S, gen_len=2, device="cpu", params=model)
    tlm.lm_apply(model, cfg, {"tokens": toks})  # a forward without a state takes any length


def test_record_splits_the_layer_by_step_in_a_trace(reduced):
    """While an ``rglru.Record`` is open, each RG-LRU call's steps are
    profiler ranges (what chip_smoke.py splits the layer's time by); without
    one, none; it is another record than ``ssm.Record``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.layers import ssm as tssm

    cfg, _, _, model = reduced
    toks = torch.tensor(_tokens(cfg, (2, 8), 3))
    steps = {"rglru:in/gate proj", "rglru:conv", "rglru:gates", "rglru:scan", "rglru:out_proj"}
    n_rglru = cfg.layer_kinds().count("rglru")
    for recording in (True, False):
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
            if recording:
                with trglru.Record():
                    assert tssm.Record.current is None
                    _, cache = lm_prefill(model, cfg, {"tokens": toks})
                    lm_decode_step(model, cfg, cache, {"token": toks[:, 0]})
            else:
                tlm.lm_apply(model, cfg, {"tokens": toks})
        names = [e.name for e in prof.events() if e.name.startswith("rglru:")]
        if recording:
            assert set(names) == steps and trglru.Record.current is None
            assert all(names.count(n) == 2 * n_rglru for n in steps)
        else:
            assert names == []


# ---------------------------------------------------------------------------
# The model: the reference's runs, shared by the tests below
# ---------------------------------------------------------------------------

B = 2
PREFIX_S = (W - 6, W, 2 * W)  # the reference's cache and decode meet the port's
C12_S = (W + 4, 2 * W + 8)  # C.12: the reference's decode misses, its lm_apply is the contract


@pytest.fixture(scope="module")
def reference_runs(reduced):
    """For each prompt length S: the tokens (B, S + STEPS), the reference's
    prefill logits and cache, its decode logits (teacher-forced) and, for
    C12_S, its ``lm_apply`` logits over all S + STEPS tokens."""
    _, jcfg, jparams, _ = reduced
    step = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))
    out = {}
    for S in PREFIX_S + C12_S:
        toks = _tokens(jcfg, (B, S + STEPS), S)
        lg, cache = jax.jit(lambda p, t: jdecode.lm_prefill(p, jcfg, SHD, {"tokens": t}, pad_to=S + STEPS))(
            jparams, toks[:, :S])
        run = {"tokens": toks, "prefill": np.asarray(lg), "cache": jax.tree.map(np.asarray, cache), "decode": []}
        for i in range(STEPS):
            lg, cache = step(jparams, cache, toks[:, S + i])
            run["decode"].append(np.asarray(lg))
        if S in C12_S:
            run["apply"] = np.asarray(jax.jit(lambda p, t: jlm.lm_apply(p, jcfg, SHD, {"tokens": t}))(jparams, toks))
        out[S] = run
    return out


def _port_run(model, cfg, toks, S, plane):
    """The port's prefill of S tokens, then STEPS teacher-forced decode steps:
    (prefill logits, the prefill's cache (copied), [decode logits])."""
    tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(toks[:, :S])}, pad_to=S + STEPS, plane=plane)
    cache0 = convert.map_tree(lambda t: t.clone(), {k: v for k, v in tc.items() if k != "len"})
    assert tc["len"] == S
    steps = []
    for i in range(STEPS):
        lg, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(toks[:, S + i])})
        steps.append(lg.numpy())
    assert tc["len"] == S + STEPS
    return tl.numpy(), cache0, steps


@pytest.mark.parametrize("plane", PLANES)
def test_lm_apply_matches_reference(reduced, reference_runs, plane):
    """The forward over 2W + 8 + STEPS tokens: local attention past the window."""
    cfg, _, _, model = reduced
    run = reference_runs[2 * W + 8]
    got = tlm.lm_apply(model, cfg, {"tokens": torch.tensor(run["tokens"])}, plane=plane).numpy()
    assert got.shape == run["apply"].shape == (B, 2 * W + 8 + STEPS, cfg.vocab_size)
    np.testing.assert_allclose(got, run["apply"], atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("S", PREFIX_S)
def test_prefill_cache_and_decode_match_reference(reduced, reference_runs, plane, S):
    """Where the prompt fits the window or fills whole windows, the port's
    prefill cache equals the reference's leaf by leaf (the window's ring of
    W slots, the RG-LRU states) and its decode logits the reference's, past
    the ring's wrap."""
    cfg, _, _, model = reduced
    run = reference_runs[S]
    tl, cache, steps = _port_run(model, cfg, run["tokens"], S, plane)
    np.testing.assert_allclose(tl, run["prefill"], atol=LOGIT_TOL, rtol=0)
    want = dict(_leaves({k: v for k, v in run["cache"].items() if k != "len"}))
    got = dict(_leaves(cache))
    assert sorted(got) == sorted(want) and "groups/g2_attn/k" in want and "tail/0/h" in want
    assert want["groups/g2_attn/k"].shape == (1, B, W, cfg.n_kv_heads, cfg.head_dim)
    for name, w in want.items():
        _close_to_max(got[name], w, LAYER_TOL, name)
    for i, (g, w) in enumerate(zip(steps, run["decode"])):
        np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=0, err_msg=f"S={S} step {i}")


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("S", C12_S)
def test_decode_past_a_partial_window_matches_the_forward(reduced, reference_runs, plane, S):
    """ROADMAP.md C.12: for S > W and S mod W != 0 the reference's prefill
    leaves token S - W + i in slot i, which its decode then overwrites out of
    order, so its decode misses its own ``lm_apply`` on the longer sequence
    (asserted, so that this test notices a fix of the reference).  The port
    puts token p at slot p mod W and meets that contract."""
    cfg, _, _, model = reduced
    run = reference_runs[S]
    ref_miss = max(float(np.abs(d - run["apply"][:, S + i]).max()) for i, d in enumerate(run["decode"]))
    assert ref_miss > 0.1, ref_miss  # measured: the 8 steps off by 0.61-1.26 (S = 20), 0.36-1.78 (S = 40)
    tl, cache, steps = _port_run(model, cfg, run["tokens"], S, plane)
    np.testing.assert_allclose(tl, run["apply"][:, S - 1], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tl, run["prefill"], atol=LOGIT_TOL, rtol=0)
    for i, g in enumerate(steps):
        np.testing.assert_allclose(g, run["apply"][:, S + i], atol=LOGIT_TOL, rtol=0, err_msg=f"S={S} step {i}")
    # the ring holds the window's last W tokens, token p at slot p mod W: the reference's slots rolled by S mod W
    ref_k = torch.tensor(run["cache"]["groups"]["g2_attn"]["k"])
    _close_to_max(cache["groups"]["g2_attn"]["k"], torch.roll(ref_k, S % W, dims=2), LAYER_TOL, "the ring's k")


def test_init_cache_takes_the_hybrid_layout():
    """Without calling the reference's ``init_cache`` (which raises NameError
    on a hybrid, ROADMAP.md C.11): its groups and tail, a ring of
    min(W, s_max) slots."""
    cfg = reduced_config(ARCH)
    for s_max, slots in ((99, W), (10, 10)):
        c = init_cache(cfg, 3, s_max)
        assert c["len"] == 0 and sorted(c["groups"]) == ["g0_rglru", "g1_rglru", "g2_attn"] and len(c["tail"]) == 2
        assert c["groups"]["g2_attn"]["k"].shape == (1, 3, slots, cfg.n_kv_heads, cfg.head_dim)
        for entry in (c["groups"]["g0_rglru"], c["tail"][1]):
            assert entry["h"].shape == (1, 3, cfg.rnn_width) and entry["h"].dtype == torch.float32
            assert entry["conv"].shape == (1, 3, cfg.ssm_conv - 1, cfg.rnn_width)
    with pytest.raises(NameError):
        jdecode.init_cache(jreduced_config(ARCH), 3, 99)


def _reference_serve(jcfg, jparams, Bn, P, G):
    """The reference launcher's loop at seed 0: prompts, tokens (B, G), logits (G, B, V)."""
    prompts = jax.random.randint(jax.random.PRNGKey(1), (Bn, P), 0, jcfg.vocab_size)
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=P + G))(
        jparams, {"tokens": prompts})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, jcfg, SHD, c, b))
    tok = jnp.argmax(logits, -1)
    toks, steps = [tok], [logits]
    for _ in range(G - 1):
        logits, cache = step(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, -1)
        toks.append(tok)
        steps.append(logits)
    return np.asarray(prompts), np.stack([np.asarray(t) for t in toks], 1), np.stack([np.asarray(s) for s in steps])


def test_serve_matches_reference_loop(reduced):
    """``serve`` on the seed-0 weights on both planes against the reference
    launcher's loop, 3 prompts of 2W tokens (whole windows: C.12 does not
    bite) and 6 tokens each, past the ring's wrap."""
    cfg, jcfg, jparams, model = reduced
    Bn, P, G = 3, 2 * W, 6
    prompts, toks, logits = _reference_serve(jcfg, jparams, Bn, P, G)
    for plane in PLANES:
        res = serve(cfg, batch=Bn, prompt_len=P, gen_len=G, page_size=8, seed=0, device="cpu", plane=plane,
                    params=model)
        np.testing.assert_array_equal(res.prompts.numpy(), prompts)
        np.testing.assert_array_equal(res.tokens.numpy(), toks)
        np.testing.assert_allclose(res.logits.numpy(), logits, atol=LOGIT_TOL, rtol=0)


def test_serve_cli_runs_the_hybrid(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "20", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-2b" in out and "[serve] ok" in out


# ---------------------------------------------------------------------------
# Training, conversion and checkpoints
# ---------------------------------------------------------------------------


def test_lm_loss_and_grads_match_reference_under_full_remat(reduced):
    """``lm_loss`` over 2 x (2W + 8) tokens (local attention on the training
    route) and its gradients, every block checkpointed: the loss within
    1e-5 (measured 4.8e-7), each gradient leaf within 2e-5 of its largest
    |value| (measured 8.2e-6, on the gate weights ``wa``)."""
    _, _, jparams, _ = reduced
    cfg, jcfg = (dataclasses.replace(c, remat="full") for c in (reduced_config(ARCH), jreduced_config(ARCH)))
    toks = _tokens(cfg, (2, 2 * W + 8), 12)
    batch = {"tokens": toks, "labels": toks}
    wl, wg = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(p, jcfg, SHD, batch)))(jparams)
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    loss = tlm.lm_loss(model, cfg, {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)})
    assert abs(float(loss.detach()) - float(wl)) <= 1e-5
    grads = convert.stack_named(dict(zip(named, torch.autograd.grad(loss, list(named.values())))), cfg)
    got = dict(_leaves(grads))
    want = dict(_leaves(wg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        _close_to_max(got[name], w, 2e-5, name)


def test_convert_maps_groups_and_tail_both_ways(reduced):
    """``groups/g{j}_{kind}/…[l]`` is ``layers.{3l + j}.…`` and ``tail[i]``
    is ``layers.{3 n_full + i}.…``, for the params and an optimizer state."""
    cfg, _, jparams, model = reduced
    named = convert.unstack_tree(jparams, cfg.n_layers)
    assert sorted(named) == sorted(model.state_dict())
    np.testing.assert_array_equal(named["layers.2.attn.wq"].numpy(), jparams["groups"]["g2_attn"]["attn"]["wq"][0])
    np.testing.assert_array_equal(named["layers.4.rglru.lam"].numpy(), jparams["tail"][1]["rglru"]["lam"])
    back = convert.stack_named(named, cfg)
    assert isinstance(back["tail"], list) and len(back["tail"]) == 2
    for (gn, g), (wn, w) in zip(sorted(_leaves(back)), sorted(_leaves(jparams))):
        assert gn == wn
        np.testing.assert_array_equal(g.numpy(), w)
    state = {"m": named, "v": named}
    tree = convert.opt_state_to_tree(state, cfg)
    again = convert.opt_state_from_tree(tree, cfg, device="cpu")
    assert set(again) == {"m", "v"} and all(torch.equal(again["m"][k], v) for k, v in named.items())


def test_hybrid_checkpoints_open_in_either_package(tmp_path):
    """The port's bundle after one AdamW step goes to disk and the reference
    restores it; the reference's bundle goes to disk and the port restores
    it: every leaf bitwise, the tail's list entries included."""
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
    assert "['params']['tail'][1]['rglru']['lam']" in flat and "['opt']['m']['groups']['g2_attn']['attn']['wk']" in flat
    for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(np.asarray(leaf), flat[jax.tree_util.keystr(k)].numpy())

    js = jopt.init(jp)
    jsave(str(tmp_path / "ref"), 3, {"params": jp, "opt": js, "data": {"step": jnp.int32(3), "seed": jnp.int32(0)},
                                    "step": jnp.int32(3)})
    s, ttree = restore_checkpoint(str(tmp_path / "ref"))
    s2, tmodel, tstate, data = convert.bundle_from_tree(ttree, cfg, device="cpu")
    assert s == s2 == 3 and data == (3, 0) and set(tstate) == {"m", "v"}
    assert isinstance(tmodel.layers[4].rglru, trglru.RGLRU) and isinstance(ttree["params"]["tail"], list)
    back = dict(_leaves(convert.lm_params_to_numpy(tmodel)))
    for name, w in _leaves(jp):
        np.testing.assert_array_equal(back[name], np.asarray(w), err_msg=name)


# ---------------------------------------------------------------------------
# Configs and the golden file
# ---------------------------------------------------------------------------


def test_check_ported_takes_the_hybrid(reduced):
    for cfg in (get_config(ARCH)[0], reduced_config(ARCH)):
        tlm.check_ported(cfg)
        assert cfg.is_hybrid and cfg.layer_kinds()[:3] == ("rglru", "rglru", "attn")
    cfg = get_config(ARCH)[0]
    assert (cfg.d_model, cfg.rnn_width, cfg.n_layers, cfg.head_dim, cfg.local_window, cfg.vocab_size) == (
        2560, 2560, 26, 256, 2048, 256000)
    # the model holds 3,314,096,640 parameters; the config's analytic count takes two matrices for geglu's MLP
    # (init_mlp builds three: D x F short a layer), 2W for the RG-LRU's conv_b, gates and lam (6W: 4W short a
    # rglru layer) and no final norm
    D, F, Wr = cfg.d_model, cfg.d_ff, cfg.rnn_width
    n_rglru = cfg.layer_kinds().count("rglru")
    real = cfg.param_count() + cfg.n_layers * D * F + n_rglru * 4 * Wr + D
    assert (cfg.param_count(), real) == (2_802_728_960, 3_314_096_640)
    small, _, _, model = reduced
    n_small = small.layer_kinds().count("rglru")
    assert sum(p.numel() for p in model.parameters()) == (
        small.param_count() + small.n_layers * small.d_model * small.d_ff + n_small * 4 * small.rnn_width
        + small.d_model)
    with pytest.raises(NotImplementedError, match="pattern"):
        tlm.check_ported(dataclasses.replace(small, block_pattern=("ssm", "attn")))


def test_golden_file_matches_the_port_draws():
    """The golden file's prompts are the port's ``randint(PRNGKey(1))``, its
    steps are self-consistent, and its tolerance is 10x the port's CPU gap."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg, _ = get_config(ARCH)
    assert g["arch"] == ARCH and g["n_layers"] == GOLDEN_LAYERS and g["d_model"] == cfg.d_model
    assert {k: g[k] for k in GOLDEN_RUN} == GOLDEN_RUN
    Bn, P = g["batch"], g["prompt_len"]
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (Bn, P), 0, cfg.vocab_size)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    assert len(g["steps"]) == g["gen_len"] == len(g["tokens"][0])
    for s, step in enumerate(g["steps"]):
        for b in range(Bn):
            assert step["top_ids"][b][0] == g["tokens"][b][s]
            assert step["lse"][b] >= step["max"][b] == step["top_logits"][b][0]
    assert [(n, layer) for n, layer, _ in GOLDEN_LEAVES] == [(k.split("@")[0], v["layer"]) for k, v in
                                                               g["leaves"].items()]
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


def _reference_leaf(params, cfg, name, layer):
    """The reference tree's leaf for a port name (``layers/…`` at ``layer``)."""
    parts = name.split("/")
    if layer is None:
        a = params
    else:
        P = len(cfg.block_pattern)
        l, j = divmod(layer, P)
        a = params["groups"][f"g{j}_{cfg.block_pattern[j]}"]
        parts = parts[1:]
    for part in parts:
        a = a[part]
    return np.asarray(a if layer is None else a[l])


def write_golden():
    """The reference at full width, 3 layers: prefill and greedy decode;
    then the port's CPU gap in a second process."""
    cfg_j = _golden_cfg(jget_config)
    r = GOLDEN_RUN
    Bn, P, G = r["batch"], r["prompt_len"], r["gen_len"]
    t0 = time.time()
    params = _jax_params(cfg_j, r["seed"])
    print(f"reference init: {time.time() - t0:.1f} s", flush=True)
    prompts = jax.random.randint(jax.random.PRNGKey(r["seed"] + 1), (Bn, P), 0, cfg_j.vocab_size)
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
        a = _reference_leaf(params, cfg_j, name, layer)
        rows = a.reshape(-1, a.shape[-1])
        sample = rows[:2, :8] if corner == "head" else rows[-2:, -8:]
        leaves[f"{name}@{layer}"] = {"layer": layer, "corner": corner, "sample": sample.astype(float).tolist(),
                                     "abs_sum": float(np.abs(a).sum(dtype=np.float64))}
    del params
    out = {
        "what": "JAX reference, recurrentgemma-2b at full width with the depth cut to n_layers, float32, on the "
                "CPU: init_lm(PRNGKey(seed)), prompts randint(PRNGKey(seed + 1), (batch, prompt_len), 0, vocab), "
                "lm_prefill (the RG-LRU scan over all prompt_len tokens, attention within the 2048-token window), "
                "then greedy lm_decode_step on the window's ring; step 0 is the prefill's last-token logits; "
                "leaves are named as the port names them (name@layer)",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_hybrid.py",
        "arch": ARCH, "n_layers": GOLDEN_LAYERS, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size,
        "depth_cut": "26 -> 3 layers, the first group (rglru, rglru, attn): the reference builds the whole parameter "
                     "tree on the CPU; a first-group layer's key does not depend on the number of groups "
                     "(split(k, n)[0] is the same for every n), so the card checks the first three layers of its "
                     "26-layer model",
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
