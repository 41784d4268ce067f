"""The port's MoE family (``layers/moe``, llama4-scout and kimi-k2) against
the JAX reference, on the CPU.

Inputs are made from a seed with numpy and go through both packages:

* ``init_moe``'s leaves in ulp, ``_capacity`` over a grid, ``_route``
  (ids equal, gates within 1e-6, lower index first on an exact tie);
* ``moe_local`` at capacity factors 1.0 and 1.25 and top_k 1, 2, 4, where
  the reference drops assignments and the port drops the same ones, and
  two expert shards that sum to the whole;
* ``lm_apply``, ``lm_prefill``, ``lm_decode_step`` and ``serve`` on both
  kernel planes at ``reduced_config`` of both MoE archs;
* 3 ``build_train_step`` steps (AdamW for llama4, with microbatches and
  with capacity dropping; ``momentum_bf16`` for kimi, its config's), and
  ``save_attn`` recomputing the experts' batched products;
* checkpoints of an MoE model written by each package, opened by the other.

Tolerances, from what was measured here (float32 sums in another order):
MoE outputs within 1e-5 of their largest |value| (measured 5.3e-7); logits
within 5e-5 absolute (measured 9.8e-6: the reduced experts' weights have
std 0.44, fan_in = E = 4, so the residual stream is several times the
dense config's); the training tolerances of ``tests/test_torch_train.py``
(parameters within 1e-6: measured 4.0e-7), except for the top-1 router's
optimizer state, held absolutely (``ROUTER_ABS``), and bf16 momentum,
within one bf16 step of each leaf's largest value (measured 4.7e-3 of
it: a float32 sum that rounds to the other bf16 neighbour near the top of
the leaf's range) and unequal on at most 1 % of it (measured 0.78 %, one
element of a 128-element norm).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe.py

rewrites ``src/repro_torch/data/golden_serve_llama4_scout.json``: the
reference's llama4-scout at full width, 2 layers (seed 0, 2 prompts of 256
tokens, 8 greedy steps), its routing per layer, and, from a second process,
the port's CPU gap to it on the reference's weights, which sets the card's
tolerances (``chip_smoke.py``).
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
from repro.layers import moe as jmoe
from repro.layers.common import apply_norm as japply_norm
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
from repro_torch.layers import moe as tmoe
from repro_torch.launch.serve import serve
from repro_torch.models import lm as tlm
from repro_torch.models.decode import lm_decode_step, lm_prefill
from repro_torch.train.steps import build_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_llama4_scout.json")
LLAMA4, KIMI = "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"
ARCHS = (LLAMA4, KIMI)
SHD = AxisRules(None)
PLANES = (ops.TORCH, ops.KERNEL)
MOE_TOL = 1e-5  # of the output's largest |value|
LOGIT_TOL = 5e-5
# the golden run: full width, depth cut to 2 layers (about 25 GB of float32 parameters on the CPU)
GOLDEN_LAYERS = 2
GOLDEN_RUN = dict(seed=0, batch=2, prompt_len=256, gen_len=8)
# leaves the card's init is checked on: (name, layer, corner) over layers 0 and 1, the embedding and the head
GOLDEN_LEAVES = (("embed", None, "head"), ("lm_head", None, "head"), ("layers/attn/wq", 0, "head"),
                 ("layers/moe/wr", 0, "head"), ("layers/moe/wg", 0, "head"), ("layers/attn/wo", 1, "tail"),
                 ("layers/moe/wu", 1, "tail"), ("layers/moe/wd", 1, "tail"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores, where a thread pool per
    worker loses far more to contention than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    """(port cfg, reference cfg, reference params, the port's LM holding them)."""
    cfg, jcfg = reduced_config(request.param), jreduced_config(request.param)
    jparams = _jax_params(jcfg)
    return cfg, jcfg, jparams, convert.lm_params_from_numpy(jparams, cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _cfgs(arch=LLAMA4, **kw):
    """(port, reference) reduced configs with ``kw`` replaced in both."""
    return (dataclasses.replace(reduced_config(arch), **kw), dataclasses.replace(jreduced_config(arch), **kw))


def _moe_params(cfg, seed, n_experts=None, tie=None):
    """Router and expert weights from numpy: (numpy dict, the port's MoE).
    ``tie`` = (a, b) makes router columns a and b equal."""
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, n_experts or cfg.n_experts
    p = {"wr": rng.standard_normal((D, E)).astype(np.float32) / np.sqrt(D),
         "wg": rng.standard_normal((E, D, F)).astype(np.float32) / np.sqrt(D),
         "wu": rng.standard_normal((E, D, F)).astype(np.float32) / np.sqrt(D),
         "wd": rng.standard_normal((E, F, D)).astype(np.float32) / np.sqrt(F)}
    if tie is not None:
        p["wr"][:, tie[1]] = p["wr"][:, tie[0]]
    return p, tmoe.MoE({k: torch.tensor(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_matches_reference(arch):
    cfg, jcfg = reduced_config(arch), jreduced_config(arch)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    want = unzip_params(jmoe.init_moe(key, jcfg, jnp.float32))[0]
    got = tmoe.init_moe(prng.fold_in(prng.prng_key(3), 5), cfg)
    assert set(want) == {n for n, _ in got.named_parameters()} == {"wr", "wg", "wu", "wd"}
    for name, w in want.items():
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert _ulp(g.numpy(), w).max() <= 2, name  # measured: bitwise equal
    # fan_in is shape[0] = E for the (E, D, F) experts, as in the reference: std 0.88 / sqrt(E)
    assert abs(float(got.wg.std()) - 0.88 / np.sqrt(cfg.n_experts)) < 0.02


@pytest.mark.parametrize("E", [4, 16, 384])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_capacity_matches_reference(E, k):
    for T in (1, 2, 3, 4, 7, 64, 255, 512, 2048, 8192):
        for cf in (1.0, 1.25, 2.0, 8.0):
            cfg, jcfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf)
            assert tmoe._capacity(cfg, T) == jmoe._capacity(jcfg, T, E), (T, E, k, cf)
    cfg, _ = get_config(LLAMA4)
    assert tmoe._capacity(cfg, 4 * 2048) == 640 and tmoe._capacity(cfg, 512) == 40
    assert tmoe._capacity(cfg, 4) == 4  # a decode step of 4 tokens: no top-1 token can drop


@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_matches_reference(k):
    cfg, jcfg = _cfgs(n_experts=8, top_k=k)
    p, m = _moe_params(cfg, 10 + k)
    x = np.random.default_rng(k).standard_normal((300, cfg.d_model)).astype(np.float32)
    jg, ji = jmoe._route(jcfg, p["wr"], x)
    tg, ti, _ = tmoe._route(cfg, m.wr, torch.tensor(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    if k == 1:
        assert (tg == 1.0).all()  # p / p


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_ties_take_the_lower_index_first(k):
    """Two equal router columns give exactly equal probabilities for every
    token; ``lax.top_k`` puts the lower index first, and so must the port."""
    cfg, jcfg = _cfgs(n_experts=8, top_k=k)
    p, m = _moe_params(cfg, 20, tie=(2, 5))
    x = np.random.default_rng(21).standard_normal((400, cfg.d_model)).astype(np.float32)
    jg, ji = jmoe._route(jcfg, p["wr"], x)
    tg, ti, _ = tmoe._route(cfg, m.wr, torch.tensor(x))
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    # the tie was met, and every pick of expert 5 comes after a pick of its twin, expert 2
    assert (ji == 2).any(-1).sum() > 0
    for row in ji[(ji == 5).any(-1)]:
        assert 2 in row and list(row).index(2) < list(row).index(5), row


def _reference_keep(idx, T, k, C, e0, n_local):
    """The reference's dispatch rule restated: an assignment in flat
    (token, slot) order is kept iff it is local and fewer than C earlier
    assignments went to its expert."""
    seen = np.zeros(n_local, np.int64)
    keep = np.zeros(T * k, bool)
    for a, e in enumerate(np.asarray(idx).reshape(-1)):
        le = e - e0
        if 0 <= le < n_local:
            keep[a] = seen[le] < C
            seen[le] += 1
    return keep


@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_moe_local_drops_what_the_reference_drops(cf, k):
    cfg, jcfg = _cfgs(n_experts=8, top_k=k, capacity_factor=cf, d_model=64, d_ff=96)
    p, m = _moe_params(cfg, 30 + k)
    m = tmoe.MoE({n: torch.tensor(v) for n, v in p.items()})
    # tokens leaning toward expert 3's router column, so that it overflows its capacity
    x = np.random.default_rng(31).standard_normal((3, 40, cfg.d_model)).astype(np.float32)
    x += 1.5 * p["wr"][:, 3] / np.linalg.norm(p["wr"][:, 3])
    T = 120
    want = np.asarray(jmoe._moe_local(jcfg, p, x, jnp.int32(0), 8))
    got = tmoe.moe_local(m, cfg, torch.tensor(x), 0, 8).numpy()
    _close_to_max(got, want, MOE_TOL, f"k={k} cf={cf}")
    _, ji = jmoe._route(jcfg, p["wr"], x.reshape(T, -1))
    C = jmoe._capacity(jcfg, T, 8)
    keep_ref = _reference_keep(ji, T, k, C, 0, 8)
    _, ti, _ = tmoe._route(cfg, m.wr, torch.tensor(x).reshape(T, -1))
    keep, dest, C_port = tmoe._slots(cfg, ti, T, 0, 8)
    assert C_port == C
    assert (~keep_ref).sum() > 0, "the case must drop assignments in the reference"
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    kept = dest[keep].numpy()
    assert len(set(kept.tolist())) == len(kept) and (kept < 8 * C).all() and (dest[~keep] == 8 * C).all()
    # a token whose every assignment dropped gets exactly zero from both
    none_kept = ~keep_ref.reshape(T, k).any(-1)
    zero_ref = (want.reshape(T, -1) == 0).all(-1)
    np.testing.assert_array_equal(zero_ref, none_kept)
    np.testing.assert_array_equal((got.reshape(T, -1) == 0).all(-1), none_kept)
    if k == 1:
        assert none_kept.sum() == (~keep_ref).sum() > 0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_moe_shards_match_reference_and_sum_to_the_whole(k):
    """Experts [0, 2) and [2, 4) as two shards, each against the
    reference's ``_moe_local`` for that shard; their sum is the whole
    layer's output (bitwise for k <= 2, where a token's two contributions
    add in either order to the same float)."""
    cfg, jcfg = _cfgs(n_experts=4, top_k=k, capacity_factor=1.0, d_model=64, d_ff=96)
    p, m = _moe_params(cfg, 40 + k)
    x = np.random.default_rng(41).standard_normal((2, 50, cfg.d_model)).astype(np.float32)
    whole = tmoe.apply_moe(m, cfg, torch.tensor(x))
    parts = []
    for e0 in (0, 2):
        ps = {"wr": p["wr"], **{n: p[n][e0:e0 + 2] for n in ("wg", "wu", "wd")}}
        want = np.asarray(jmoe._moe_local(jcfg, ps, x, jnp.int32(e0), 2))
        got = tmoe.moe_local(tmoe.MoE({n: torch.tensor(v) for n, v in ps.items()}), cfg, torch.tensor(x), e0, 2)
        _close_to_max(got, want, MOE_TOL, f"shard {e0}")
        parts.append(got)
    if k <= 2:
        assert torch.equal(parts[0] + parts[1], whole)
    else:
        _close_to_max(parts[0] + parts[1], whole, 1e-6, "sum of shards")
    np.testing.assert_allclose(whole.numpy(), np.asarray(jmoe.apply_moe(p, jcfg, SHD, x)), atol=MOE_TOL *
                               float(np.abs(whole.numpy()).max()), rtol=0)


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------


def test_init_lm_matches_reference_leaf_by_leaf():
    """The port's ``init_lm`` from the seed.  kimi-k2's reduced config draws
    the same tensors as llama4-scout's (init reads no field in which they
    differ), so one arch covers both; the models below reuse these weights
    through ``convert`` rather than drawing them again."""
    cfg, jcfg = reduced_config(LLAMA4), jreduced_config(LLAMA4)
    init_fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size", "n_experts",
                   "mlp_act", "norm", "qkv_bias", "mlp_bias", "tie_embeddings")
    kimi = reduced_config(KIMI)
    assert all(getattr(cfg, f) == getattr(kimi, f) for f in init_fields)
    mine = dict(_leaves(convert.lm_params_to_numpy(tlm.init_lm(prng.prng_key(0), cfg, device="cpu"))))
    want = dict(_leaves(_jax_params(jcfg)))
    assert sorted(mine) == sorted(want) and "layers/moe/wg" in want and "layers/mlp/wg" not in want
    for name, w in want.items():
        assert mine[name].shape == w.shape, name
        assert _ulp(mine[name], w).max() <= 2, name  # measured: bitwise equal


def test_params_round_trip(reduced):
    cfg, _, jparams, model = reduced
    back = dict(_leaves(convert.lm_params_to_numpy(model)))
    assert sorted(back) == sorted(n for n, _ in _leaves(jparams))
    for name, w in _leaves(jparams):
        np.testing.assert_array_equal(back[name], np.asarray(w), err_msg=name)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + cfg.d_model  # + the final norm
    assert isinstance(model.layers[0].moe, tmoe.MoE) and not hasattr(model.layers[0], "mlp")


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
    B, P, pad = 2, 24, 32
    toks = _tokens(cfg, (B, P + 3), 2)
    jl, jc = jax.jit(lambda p, t: jdecode.lm_prefill(p, jcfg, SHD, {"tokens": t}, pad_to=pad))(jparams, toks[:, :P])
    tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(toks[:, :P])}, pad_to=pad, plane=plane)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][name].numpy(), np.asarray(jc["layers"][name]), atol=LOGIT_TOL, rtol=0)
    jstep = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))
    for i in range(3):  # teacher-forced: each step's MoE call routes B = 2 tokens, as the reference's
        t = toks[:, P + i]
        jl, jc = jstep(jparams, jc, t)
        tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(t)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
        assert tc["len"] == int(jc["len"]) == P + i + 1


@pytest.mark.parametrize("plane", PLANES)
def test_prefill_decode_match_forward(reduced, plane):
    """As the reference's own smoke test: the reduced configs' capacity
    factor 8 drops nothing, so prefill then one decode step equal the
    forward's logits."""
    cfg, _, _, model = reduced
    toks = torch.tensor(_tokens(cfg, (2, 5), 3))
    full = tlm.lm_apply(model, cfg, {"tokens": toks}, plane=plane)
    lg_p, cache = lm_prefill(model, cfg, {"tokens": toks[:, :4]}, pad_to=8, plane=plane)
    np.testing.assert_allclose(lg_p.numpy(), full[:, 3].numpy(), atol=LOGIT_TOL, rtol=0)
    lg_d, _ = lm_decode_step(model, cfg, cache, {"token": toks[:, 4]})
    np.testing.assert_allclose(lg_d.numpy(), full[:, 4].numpy(), atol=LOGIT_TOL, rtol=0)


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
    ``init_lm`` draws bitwise: see above) against the reference launcher's loop."""
    cfg, jcfg, _, model = reduced
    B, P, G = 3, 20, 6
    prompts, toks, logits = _reference_serve(jcfg, B, P, G)
    res = serve(cfg, batch=B, prompt_len=P, gen_len=G, page_size=8, seed=0, device="cpu", plane=plane, params=model)
    np.testing.assert_array_equal(res.prompts.numpy(), prompts)
    np.testing.assert_array_equal(res.tokens.numpy(), toks)
    np.testing.assert_allclose(res.logits.numpy(), logits, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("plane", PLANES)
def test_moe_routing_matches_the_reference_per_layer(plane):
    """What a ``Record`` keeps of a prefill (what chip_smoke.py holds the
    card to, layer by layer) against the reference's blocks at capacity
    factor 1.0, where every layer drops: router logits, loads, dropped
    assignments and margins."""
    cfg, jcfg = _cfgs(LLAMA4, capacity_factor=1.0)
    jparams = _jax_params(jcfg)
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    toks = _tokens(cfg, (3, 48), 7)
    want, want_logits = _reference_routing(jparams, jcfg, jnp.asarray(toks))
    with torch.inference_mode(), tmoe.Record() as rec:
        lm_prefill(model, cfg, {"tokens": torch.tensor(toks)}, pad_to=56, plane=plane)
    assert len(rec.calls) == cfg.n_layers and all(r["dropped"] > 0 for r in want)
    for call, ref, ref_logits in zip(rec.calls, want, want_logits):
        stats = tmoe.route_stats(cfg, call)
        np.testing.assert_allclose(call["logits"].numpy(), ref_logits, atol=1e-5, rtol=0)
        assert (stats["loads"], stats["dropped"], stats["capacity"]) == (ref["loads"], ref["dropped"], ref["capacity"])
        assert abs(stats["margin"] - ref["margin"]) <= 1e-6


def test_record_splits_the_layer_by_step_in_a_trace():
    """While a ``Record`` is open, each MoE call's four steps are profiler
    ranges (what chip_smoke.py splits the layer's time by), once per layer;
    without one, the trace holds none and nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile

    cfg = reduced_config(LLAMA4)
    model = tlm.init_lm(prng.prng_key(0), cfg, device="cpu")
    toks = torch.tensor(_tokens(cfg, (2, 16), 3))
    steps = {"moe:router", "moe:dispatch", "moe:expert products", "moe:combine"}
    for recording in (True, False):
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
            if recording:
                with tmoe.Record() as rec:
                    tlm.lm_apply(model, cfg, {"tokens": toks}, plane=ops.TORCH)
            else:
                tlm.lm_apply(model, cfg, {"tokens": toks}, plane=ops.TORCH)
        names = [e.name for e in prof.events() if e.name.startswith("moe:")]
        if recording:
            assert set(names) == steps and all(names.count(n) == cfg.n_layers for n in steps)
            assert len(rec.calls) == cfg.n_layers and tmoe.Record.current is None
            assert all(c["logits"].shape == (32, cfg.n_experts) and c["ids"].shape == (32, cfg.top_k)
                       for c in rec.calls)
        else:
            assert names == []


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _check_state(cfg, opt, got, want, step):
    """Optimizer state against the reference's: AdamW's m and v within
    1e-5 of each leaf's largest value; at top_k = 1 the router's leaves
    absolutely (its gradient is about 0 there, where the gate is p / p);
    bf16 momentum within one bf16 step of the leaf's largest value, unequal
    on at most 1 % of a leaf."""
    got, want = dict(_leaves(convert.opt_state_to_tree(got))), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if name.endswith("moe/wr") and cfg.top_k == 1:
            assert float(np.abs(_np32(g) - _np32(w)).max()) <= ROUTER_ABS, (step, name)
        elif opt == "adamw":
            _close_to_max(g, w, 1e-5, f"step {step} {name}")
        else:
            assert g.dtype == torch.bfloat16, name
            g, w = _np32(g), _np32(w)
            assert float(np.abs(g - w).max()) <= 2.0**-7 * np.abs(w).max(), (step, name)
            assert (g != w).mean() <= 0.01, (step, name, (g != w).mean())


ROUTER_ABS = 1e-9  # the top-1 router's m and v, absolute (measured: m 4.8e-11, v 7e-21; its gradients are noise)
TRAIN_CASES = {  # id: (arch, optimizer, batch shape, config changes)
    "llama4_adamw": (LLAMA4, "adamw", (2, 32), {}),
    "llama4_adamw_micro2": (LLAMA4, "adamw", (2, 2, 32), {"microbatch": 2}),
    "llama4_adamw_dropping": (LLAMA4, "adamw", (2, 32), {"capacity_factor": 1.0}),
    "kimi_momentum_bf16": (KIMI, "momentum_bf16", (2, 32), {}),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_reference(case):
    arch, opt, shape, kw = TRAIN_CASES[case]
    cfg, jcfg = _cfgs(arch, **kw)
    assert opt == cfg.optimizer or arch == LLAMA4
    jparams = _jax_params(jcfg)
    jstep, jopt = jsteps.build_train_step(jcfg, SHD, opt)
    jstep = jax.jit(jstep)
    tstep, topt = build_train_step(cfg, opt)
    jp, js = jparams, jopt.init(jparams)
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    ts = topt.init(dict(model.named_parameters()))
    rng = np.random.default_rng(12)
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        jp, js, jm = jstep(jp, js, jnp.int32(step), {"tokens": toks, "labels": toks})
        model, ts, tm = tstep(model, ts, step, {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)})
        assert tm["step"] == int(jm["step"]) == step + 1
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5, step
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        got = dict(_leaves(convert.lm_params_to_numpy(model)))
        for name, w in _leaves(jp):
            np.testing.assert_allclose(got[name], np.asarray(w), atol=1e-6, rtol=0, err_msg=f"step {step} {name}")
        _check_state(cfg, opt, ts, js, step)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_save_attn_recomputes_the_experts_batched_products():
    """``save_attn`` keeps the products with the weights (``mm``, the router
    among them) and recomputes the batched ones in the backward: the
    attention's two and the experts' three per block, as JAX's
    ``checkpoint_dots_with_no_batch_dims`` recomputes the experts' einsums."""
    cfg, jcfg = _cfgs(LLAMA4)
    jparams = _jax_params(jcfg)
    toks = torch.tensor(_tokens(cfg, (2, 64), 0))
    counts = {}
    for remat in ("none", "save_attn"):
        c = dataclasses.replace(cfg, remat=remat)
        model = convert.lm_params_from_numpy(jparams, c, device="cpu").requires_grad_(True)
        loss = tlm.lm_loss(model, c, {"tokens": toks, "labels": toks})
        with _CountMatmuls() as mode:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[remat] = mode.counts
    assert counts["save_attn"]["mm"] == counts["none"]["mm"]
    assert counts["save_attn"]["bmm"] == counts["none"]["bmm"] + 5 * cfg.n_layers


def test_moe_checkpoints_open_in_either_package(tmp_path):
    """The port's bundle after one AdamW step (llama4) goes to disk and the
    reference restores it; the reference's bundle after one bf16-momentum
    step (kimi) goes to disk and the port restores it: MoE leaves bitwise."""
    cfg, jcfg = reduced_config(LLAMA4), jreduced_config(LLAMA4)
    step, opt = build_train_step(cfg, "adamw")
    jp = _jax_params(jcfg)
    model = convert.lm_params_from_numpy(jp, cfg, device="cpu")
    state = opt.init(dict(model.named_parameters()))
    toks = torch.tensor(_tokens(cfg, (2, 16), 5))
    model, state, _ = step(model, state, 0, {"tokens": toks, "labels": toks})
    save_checkpoint(str(tmp_path / "port"), 1, convert.bundle_to_tree(model, state, DataState(1, 0), 1))
    _, jopt = jsteps.build_train_step(jcfg, SHD, "adamw")
    proto = {"params": jp, "opt": jopt.init(jp), "data": {"step": 0, "seed": 0}, "step": 0}
    s, tree = jrestore(str(tmp_path / "port"), proto)
    assert s == 1
    flat = dict(tckpt._flatten(convert.bundle_to_tree(model, state, DataState(1, 0), 1)))
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert "['params']['layers']['moe']['wg']" in flat and "['opt']['m']['layers']['moe']['wr']" in flat
    for k, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), flat[jax.tree_util.keystr(k)].numpy())

    kcfg, kjcfg = reduced_config(KIMI), jreduced_config(KIMI)
    jstep, jopt = jsteps.build_train_step(kjcfg, SHD, "momentum_bf16")
    jp = _jax_params(kjcfg)
    ktoks = _tokens(kcfg, (2, 16), 6)
    jp, js, _ = jax.jit(jstep)(jp, jopt.init(jp), jnp.int32(0), {"tokens": ktoks, "labels": ktoks})
    jsave(str(tmp_path / "ref"), 1, {"params": jp, "opt": js, "data": {"step": jnp.int32(1), "seed": jnp.int32(0)},
                                    "step": jnp.int32(1)})
    s, ttree = restore_checkpoint(str(tmp_path / "ref"))
    s2, kmodel, kstate, data = convert.bundle_from_tree(ttree, kcfg, device="cpu")
    assert s == s2 == 1 and data == (1, 0) and set(kstate) == {"m"}
    back = dict(_leaves(convert.lm_params_to_numpy(kmodel)))
    for name, w in _leaves(jp):
        np.testing.assert_array_equal(back[name], np.asarray(w), err_msg=name)
    m = dict(_leaves(convert.opt_state_to_tree(kstate)))
    for name, w in _leaves(js):
        assert m[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(m[name].float().numpy(), np.asarray(w).astype(np.float32), err_msg=name)
    assert "m/layers/moe/wd" in m


# ---------------------------------------------------------------------------
# Configs and the golden file
# ---------------------------------------------------------------------------


def test_check_ported_takes_moe():
    for arch in ARCHS:
        tlm.check_ported(get_config(arch)[0])
        tlm.check_ported(reduced_config(arch))


def test_golden_file_matches_the_port_draws():
    """The golden file's prompts are the port's ``randint(PRNGKey(1))``, its
    steps are self-consistent, its routing per layer adds up, and its
    tolerances are 10x the port's CPU gaps."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg, _ = get_config(LLAMA4)
    assert g["arch"] == LLAMA4 and g["n_layers"] == GOLDEN_LAYERS and g["d_model"] == cfg.d_model
    B, P = g["batch"], g["prompt_len"]
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (B, P), 0, cfg.vocab_size)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    assert len(g["steps"]) == g["gen_len"] == len(g["tokens"][0])
    for s, step in enumerate(g["steps"]):
        for b in range(B):
            assert step["top_ids"][b][0] == g["tokens"][b][s]
            assert step["lse"][b] >= step["max"][b] == step["top_logits"][b][0]
    C = tmoe._capacity(cfg, B * P)
    assert len(g["routing"]) == GOLDEN_LAYERS
    for r in g["routing"]:
        assert sum(r["loads"]) == B * P * cfg.top_k and r["capacity"] == C
        assert r["dropped"] == sum(max(n - C, 0) for n in r["loads"])
    for name in ("logits", "router_logits"):
        assert g["tolerance"][name] == max(10 * g["port_cpu_gap"][name], 1e-6)


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


def _abs_sum(a):
    """float64 sum of |a| over a large array, a slab at a time."""
    flat = np.asarray(a).reshape(-1)
    return float(sum(np.abs(flat[i:i + (1 << 24)]).sum(dtype=np.float64) for i in range(0, flat.size, 1 << 24)))


def _golden_cfg(get):
    return dataclasses.replace(get(LLAMA4)[0], n_layers=GOLDEN_LAYERS)


def _reference_routing(params, cfg, prompts):
    """Per layer of the reference's prefill: the MoE input's router logits,
    loads, dropped count and smallest top-k / next margin; the block bodies
    are the reference's own (``_attn_full``, ``apply_norm``, ``apply_moe``)."""
    T = prompts.shape[0] * prompts.shape[1]

    @jax.jit
    def layer(lp, x, positions):
        x = x + jlm._attn_full(lp["attn"], cfg, SHD, japply_norm(cfg.norm, lp["norm1"], x), positions)
        h = japply_norm(cfg.norm, lp["norm2"], x)
        logits = jnp.einsum("td,de->te", h.reshape(T, -1).astype(jnp.float32), lp["moe"]["wr"].astype(jnp.float32))
        _, idx = jmoe._route(cfg, lp["moe"]["wr"], h.reshape(T, -1))
        y = jmoe.apply_moe(lp["moe"], cfg, SHD, h)
        return x + y, logits, idx, (y.reshape(T, -1) == 0).all(-1).sum()

    x = jlm.embed_tokens(params, cfg, SHD, prompts)
    positions = jnp.broadcast_to(jnp.arange(prompts.shape[1])[None], prompts.shape)
    out, logits_all = [], []
    C = jmoe._capacity(cfg, T, cfg.n_experts)
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        x, logits, idx, zero_rows = layer(lp, x, positions)
        del lp
        probs = np.sort(np.asarray(jax.nn.softmax(logits, -1)), -1)[:, ::-1]
        loads = np.bincount(np.asarray(idx).reshape(-1), minlength=cfg.n_experts)
        dropped = int(np.maximum(loads - C, 0).sum())
        if cfg.top_k == 1:
            assert int(zero_rows) == dropped  # a dropped token's MoE row is exactly zero
        k = cfg.top_k
        out.append({"loads": loads.tolist(), "dropped": dropped, "capacity": C,
                    "margin": float((probs[:, k - 1] - probs[:, k]).min())})
        logits_all.append(np.asarray(logits))
    return out, np.stack(logits_all)


def write_golden():
    """The reference at full width, 2 layers: routing per layer, prefill and
    greedy decode; then the port's CPU gap in a second process."""
    cfg_j = _golden_cfg(jget_config)
    r = GOLDEN_RUN
    B, P, G = r["batch"], r["prompt_len"], r["gen_len"]
    t0 = time.time()
    params = _jax_params(cfg_j, r["seed"])
    print(f"reference init: {time.time() - t0:.1f} s", flush=True)
    prompts = jax.random.randint(jax.random.PRNGKey(r["seed"] + 1), (B, P), 0, cfg_j.vocab_size)
    t0 = time.time()
    routing, router_logits = _reference_routing(params, cfg_j, prompts)
    print(f"reference routing: {time.time() - t0:.1f} s: {routing}", flush=True)
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
        leaves[name] = {
            "layer": layer, "corner": corner, "sample": sample.astype(float).tolist(), "abs_sum": _abs_sum(a)}
        del a, rows
    del params
    out = {
        "what": "JAX reference, llama4-scout-17b-a16e at full width with the depth cut to n_layers, float32, on the "
                "CPU: init_lm(PRNGKey(seed)), prompts randint(PRNGKey(seed + 1), (batch, prompt_len), 0, vocab), "
                "lm_prefill(pad_to=prompt_len + gen_len), then greedy lm_decode_step; step 0 is the prefill's "
                "last-token logits.  routing: per layer of the prefill (one MoE call of batch * prompt_len "
                "tokens), assignments per expert, dropped assignments, capacity, and the smallest margin between "
                "a token's top-k and next router probability",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe.py",
        "arch": LLAMA4, "n_layers": GOLDEN_LAYERS, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size,
        "depth_cut": "48 -> 2 layers: the reference builds the whole parameter tree on the CPU, 2.08 B float32 "
                     "parameters a layer beside 2.07 B of embedding and head (24.9 GB at 2 layers)",
        **r, "dtype": "float32",
        "prompts": np.asarray(prompts).tolist(),
        "tokens": np.stack(toks, 1).tolist(),
        "steps": [_step_record(s) for s in steps],
        "top1_top2_margin_min": [float(np.min(np.diff(np.sort(s, -1)[:, -2:], axis=-1))) for s in steps],
        "routing": routing,
        "leaves": leaves,
    }
    with open(GOLDEN, "w") as f:
        json.dump(out, f)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "steps.npy"), np.stack(steps))
        np.save(os.path.join(d, "router_logits.npy"), router_logits)
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
    """The port on the CPU (torch plane) with the reference's weights and
    tokens: its gaps to the reference's logits (each step teacher-forced
    with the reference's tokens) and router logits, into the golden file."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg_j, cfg = _golden_cfg(jget_config), _golden_cfg(get_config)
    t0 = time.time()
    model = _reference_weights_in_the_port(cfg_j, cfg, g["seed"])
    print(f"reference weights in the port: {time.time() - t0:.1f} s", flush=True)
    ref_steps, ref_router = np.load(os.path.join(d, "steps.npy")), np.load(os.path.join(d, "router_logits.npy"))
    prompts = torch.tensor(g["prompts"], dtype=torch.int32)
    P, G = g["prompt_len"], g["gen_len"]
    t0 = time.time()
    with torch.inference_mode():
        with tmoe.Record() as rec:
            tl, tc = lm_prefill(model, cfg, {"tokens": prompts}, pad_to=P + G, plane=ops.TORCH)
        routing = [tmoe.route_stats(cfg, call) for call in rec.calls]
        router_gap = max(float(np.abs(c["logits"].numpy() - ref_router[i]).max()) for i, c in enumerate(rec.calls))
        gaps = [float(np.abs(tl.numpy() - ref_steps[0]).max())]
        for s in range(1, G):
            tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(g["tokens"], dtype=torch.int32)[:, s - 1]})
            gaps.append(float(np.abs(tl.numpy() - ref_steps[s]).max()))
    print(f"port (CPU, torch plane): {time.time() - t0:.1f} s; logit gaps {gaps}; router-logit gap {router_gap}; "
          f"routing {routing}", flush=True)
    for mine, ref in zip(routing, g["routing"]):
        if ref["margin"] > 10 * router_gap:
            assert (mine["loads"], mine["dropped"]) == (ref["loads"], ref["dropped"]), (mine, ref)
    g["port_cpu_gap"] = {"logits": max(gaps), "router_logits": router_gap}
    g["port_cpu_logit_gap_per_step"] = gaps
    g["port_cpu_routing"] = routing
    g["port_cpu_gap_note"] = ("max |port - reference| over every logit of each step (the port on the CPU, torch "
                              "plane, with the reference's weights through convert, teacher-forced with the "
                              "reference's tokens) and over the router logits of every prefill layer")
    # the card is held to 10x the CPU's gaps (the rule of the other golden files), no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in g["port_cpu_gap"].items()}
    with open(GOLDEN, "w") as f:
        json.dump(g, f)
    print(f"port on the CPU: gaps {g['port_cpu_gap']}; tolerances {g['tolerance']}")


if __name__ == "__main__":
    sys.exit(_port_cpu_gap(sys.argv[2]) if sys.argv[1:2] == ["--port-gap"] else write_golden())
