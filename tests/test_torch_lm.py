"""The port's LM serving path against the JAX reference, on the CPU.

Weights: the port's ``init_lm`` rebuilds the reference's ``init_lm`` from
the seed (threefry, ``truncated_normal`` with XLA's ``erf_inv``), compared
leaf by leaf in ulp.  Model: the reference's parameters, handed over as
numpy (``convert.lm_params_from_numpy``), go through the port's
``lm_apply``, ``lm_prefill``, ``lm_decode_step`` and ``serve`` on both
kernel planes at ``reduced_config("stablelm-1.6b")`` (4 layers, d_model
128), and must agree with the reference within 1e-5 in float32 (both run
float32 products of the same operands in another summation order: the
gaps measured here are below 2e-6).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm.py

rewrites ``src/repro_torch/data/golden_serve_stablelm.json``: the
reference's full-width stablelm-1.6b (seed 0 weights, 2 prompts of 256
tokens, 8 greedy steps), which ``chip_smoke.py`` holds the port to on the
card, plus the gap between the port (on the CPU, same weights, same
tokens) and the reference at full width.
"""
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.models import decode as jdecode
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import PageTable, serve
from repro_torch.models.decode import lm_decode_step, lm_prefill
from repro_torch.models.lm import check_ported, init_lm, lm_apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_stablelm.json")
ARCH = "stablelm-1.6b"
SHD = AxisRules(None)
TOL = 1e-5  # float32, both planes (see the module docstring)
PLANES = (ops.TORCH, ops.KERNEL)


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
    """Elementwise distance in float32 ulp (same-sign values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _jax_params(cfg, seed=0):
    return unzip_params(jlm.init_lm(jax.random.PRNGKey(seed), cfg, jnp.float32))[0]


@pytest.fixture(scope="module")
def reduced():
    """(port cfg, reference cfg, reference params, the port's LM holding them)."""
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    jparams = _jax_params(jcfg)
    return cfg, jcfg, jparams, convert.lm_params_from_numpy(jparams, cfg, device="cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# Weights from the seed
# ---------------------------------------------------------------------------


def test_erf_inv_matches_xla():
    from jax._src.lax import special as jspecial

    x = np.linspace(-0.99999, 0.99999, 400_001).astype(np.float32)
    got = prng.erf_inv(torch.tensor(x)).numpy()
    want = np.asarray(jax.jit(jspecial.erf_inv)(x))
    d = _ulp(got, want)
    # measured: 2 of these 400001 points differ, by 1 ulp (float64 emulation of XLA's FMAs)
    assert d.max() <= 1 and (d > 0).sum() <= 40, (d.max(), (d > 0).sum())


@pytest.mark.parametrize("seed,shape", [(0, (128, 384)), (7, (1000,)), (-3, (37, 5)), (2**31 - 1, (3, 4, 5))])
def test_truncated_normal_matches_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, shape, jnp.float32))
    got = prng.truncated_normal(prng.fold_in(prng.prng_key(seed), 11), -2.0, 2.0, shape, chunk=4099).numpy()
    assert got.shape == want.shape
    d = _ulp(got, want)
    assert d.max() <= 2, d.max()  # measured: bitwise equal on every element of these cases
    assert (got > -2).all() and (got < 2).all()


def test_init_lm_matches_reference_leaf_by_leaf(reduced):
    cfg, _, jparams, _ = reduced
    mine = convert.lm_params_to_numpy(init_lm(prng.prng_key(0), cfg, device="cpu"))
    want = dict(_leaves(jparams))
    got = dict(_leaves(mine))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        assert _ulp(got[name], w).max() <= 2, name  # measured: bitwise equal


def test_params_round_trip(reduced):
    cfg, _, jparams, model = reduced
    back = dict(_leaves(convert.lm_params_to_numpy(model)))
    for name, w in _leaves(jparams):
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    names = {n for n, _ in model.named_parameters()}
    assert {"embed", "lm_head", "final_norm.scale", "final_norm.bias", "layers.3.attn.wq", "layers.0.mlp.wd"} <= names


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", PLANES)
def test_lm_apply_matches_reference(reduced, plane):
    cfg, jcfg, jparams, model = reduced
    toks = _tokens(cfg, 2, 40, 1)
    want = np.asarray(jax.jit(lambda p, t: jlm.lm_apply(p, jcfg, SHD, {"tokens": t}))(jparams, toks))
    got = lm_apply(model, cfg, {"tokens": torch.tensor(toks)}, plane=plane).numpy()
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("plane", PLANES)
def test_prefill_and_decode_match_reference(reduced, plane):
    cfg, jcfg, jparams, model = reduced
    B, P, pad = 2, 24, 32
    toks = _tokens(cfg, B, P + 3, 2)
    jl, jc = jax.jit(lambda p, t: jdecode.lm_prefill(p, jcfg, SHD, {"tokens": t}, pad_to=pad))(jparams, toks[:, :P])
    tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(toks[:, :P])}, pad_to=pad, plane=plane)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert tc["len"] == int(jc["len"]) == P
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == jc["layers"][name].shape == (cfg.n_layers, B, pad, 4, 32)
        np.testing.assert_allclose(tc["layers"][name].numpy(), np.asarray(jc["layers"][name]), atol=TOL, rtol=0)
    jstep = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))
    for i in range(3):  # teacher-forced, so both sides see the same tokens
        t = toks[:, P + i]
        jl, jc = jstep(jparams, jc, t)
        tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(t)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0, err_msg=f"step {i}")
        assert tc["len"] == int(jc["len"]) == P + i + 1
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["layers"][name].numpy(), np.asarray(jc["layers"][name]), atol=TOL, rtol=0)


@pytest.mark.parametrize("plane", PLANES)
def test_prefill_decode_match_forward(reduced, plane):
    """The port against itself, as the reference's own test: prefill of Tp
    tokens then one decode step equal the full forward's logits."""
    cfg, _, _, model = reduced
    toks = torch.tensor(_tokens(cfg, 2, 5, 3))
    Tp = 4
    full = lm_apply(model, cfg, {"tokens": toks}, plane=plane)
    lg_p, cache = lm_prefill(model, cfg, {"tokens": toks[:, :Tp]}, pad_to=Tp + 4, plane=plane)
    np.testing.assert_allclose(lg_p.numpy(), full[:, Tp - 1].numpy(), atol=TOL, rtol=0)
    lg_d, cache2 = lm_decode_step(model, cfg, cache, {"token": toks[:, Tp]})
    np.testing.assert_allclose(lg_d.numpy(), full[:, Tp].numpy(), atol=TOL, rtol=0)
    assert cache2["len"] == Tp + 1


def _reference_serve(jcfg, B, P, G):
    """The reference launcher's loop (``repro.launch.serve.main``) at seed 0:
    tokens (B, G) and each step's logits (G, B, V)."""
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
    cfg, jcfg, _, _ = reduced
    B, P, G = 3, 20, 6
    prompts, toks, logits = _reference_serve(jcfg, B, P, G)
    res = serve(cfg, batch=B, prompt_len=P, gen_len=G, page_size=8, seed=0, device="cpu", plane=plane)
    assert res.plane == plane
    np.testing.assert_array_equal(res.prompts.numpy(), prompts)
    np.testing.assert_array_equal(res.tokens.numpy(), toks)
    np.testing.assert_allclose(res.logits.numpy(), logits, atol=TOL, rtol=0)
    assert res.pages_used == B * ((P + G) // 8 + 1) and res.pages_used_after_release == 0


VARIANTS = {
    "gqa_rmsnorm": dict(n_kv_heads=2, norm="rmsnorm", rope_pct=1.0),
    "parallel_bias": dict(parallel_block=True, qkv_bias=True, mlp_bias=True, norm="layernorm_nobias"),
    "sq_relu_tied": dict(mlp_act="sq_relu", mlp_bias=True, tie_embeddings=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_variants_match_reference(variant):
    """The dense mechanisms beyond stablelm's (GQA, rmsnorm, parallel
    blocks, biases, 2-matrix MLPs, tied embeddings) on a reduced config."""
    kw = VARIANTS[variant]
    cfg = dataclasses.replace(reduced_config(ARCH), **kw)
    jcfg = dataclasses.replace(jreduced_config(ARCH), **kw)
    jparams = _jax_params(jcfg, seed=5)
    mine = dict(_leaves(convert.lm_params_to_numpy(init_lm(prng.prng_key(5), cfg, device="cpu"))))
    for name, w in _leaves(jparams):
        assert _ulp(mine[name], w).max() <= 2, name
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    toks = _tokens(cfg, 2, 9, 4)
    want = np.asarray(jlm.lm_apply(jparams, jcfg, SHD, {"tokens": toks}))
    jl, jc = jdecode.lm_prefill(jparams, jcfg, SHD, {"tokens": toks[:, :8]}, pad_to=12)
    jl2, _ = jdecode.lm_decode_step(jparams, jcfg, SHD, jc, {"token": toks[:, 8]})
    for plane in PLANES:
        got = lm_apply(model, cfg, {"tokens": torch.tensor(toks)}, plane=plane).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(toks[:, :8])}, pad_to=12, plane=plane)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        tl2, _ = lm_decode_step(model, cfg, tc, {"token": torch.tensor(toks[:, 8])})
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# Entry points, families, the page table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [  # every family's own branch went with its port (kw0-kw2); a hybrid of other kinds stays
    pytest.param(dict(block_pattern=("attn", "ssm"), local_window=16), id="attn-ssm-hybrid"),
])
def test_unported_families_raise(kw):
    cfg = dataclasses.replace(reduced_config(ARCH), **kw)
    with pytest.raises(NotImplementedError, match="is not ported"):
        check_ported(cfg)
    with pytest.raises(NotImplementedError, match="is not ported"):
        init_lm(prng.prng_key(0), cfg, device="cpu")


def test_attn_rglru_pattern_matches_reference():
    """A hybrid of another pattern than recurrentgemma's: (attn, rglru) over
    stablelm's reduced widths (layernorm, swiglu, partial rotary), window
    16, two full groups and no tail.  Init leaf by leaf; the forward over 20
    tokens (local attention past the window), a 16-token prefill and 4
    decode steps past the ring's wrap, on both planes."""
    kw = dict(block_pattern=("attn", "rglru"), local_window=16)
    cfg = dataclasses.replace(reduced_config(ARCH), **kw)
    jcfg = dataclasses.replace(jreduced_config(ARCH), **kw)
    check_ported(cfg)
    jparams = _jax_params(jcfg, seed=5)
    assert jparams["tail"] == [] and sorted(jparams["groups"]) == ["g0_attn", "g1_rglru"]
    want_tree = {k: v for k, v in jparams.items() if k != "tail"}
    mine = convert.lm_params_to_numpy(init_lm(prng.prng_key(5), cfg, device="cpu"))
    assert mine.pop("tail") == []
    mine = dict(_leaves(mine))
    assert sorted(mine) == sorted(k for k, _ in _leaves(want_tree))
    for name, w in _leaves(want_tree):
        assert _ulp(mine[name], w).max() <= 2, name  # measured: bitwise equal
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    toks = _tokens(cfg, 2, 20, 4)
    want = np.asarray(jax.jit(lambda p, t: jlm.lm_apply(p, jcfg, SHD, {"tokens": t}))(jparams, toks))
    jl, jc = jax.jit(lambda p, t: jdecode.lm_prefill(p, jcfg, SHD, {"tokens": t}, pad_to=20))(jparams, toks[:, :16])
    jstep = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))
    jsteps = []
    for t in range(16, 20):
        jl2, jc = jstep(jparams, jc, toks[:, t])
        jsteps.append(np.asarray(jl2))
    for plane in PLANES:
        got = lm_apply(model, cfg, {"tokens": torch.tensor(toks)}, plane=plane).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(toks[:, :16])}, pad_to=20, plane=plane)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        for i, t in enumerate(range(16, 20)):
            tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(toks[:, t])})
            np.testing.assert_allclose(tl.numpy(), jsteps[i], atol=TOL, rtol=0, err_msg=f"{plane} step {i}")


def test_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    cfg = reduced_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(prng.prng_key(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, batch=1, prompt_len=4, gen_len=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_numpy({}, cfg)


def test_only_ported_configs_are_listed():
    """The port lists every arch of the reference, in its order, each config
    the reference's; an arch that neither has raises ``KeyError``."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        cfg, over = get_config(arch)
        jcfg, jover = jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and over == jover, arch
        assert dataclasses.asdict(reduced_config(arch)) == dataclasses.asdict(jreduced_config(arch)), arch
        assert cfg.param_count() == jcfg.param_count() and cfg.active_param_count() == jcfg.active_param_count()
    assert get_config(ARCH)[0].param_count() == 1_644_265_472
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("qwen2.5-33b")


def test_page_table_nowait_claims():
    pt = PageTable(16)
    a = pt.alloc(5, 0, prng.prng_key(100))
    assert len(set(a.tolist())) == 5 and pt.used == 5 and set(pt.locks[a].tolist()) == {1}
    b = pt.alloc(5, 1, prng.prng_key(101))
    assert not set(a.tolist()) & set(b.tolist()) and pt.used == 10
    pt.free(a)
    assert pt.used == 5
    with pytest.raises(ValueError, match="distinct"):
        PageTable(4).alloc(5, 0, prng.prng_key(0))
    full = PageTable(6)
    full.alloc(5, 0, prng.prng_key(3))
    with pytest.raises(RuntimeError, match="exhausted"):
        full.alloc(2, 1, prng.prng_key(4))  # one free page left: every 2-page claim conflicts
    big = PageTable(4 * 4 * 131)  # the full serving config's table: requests claim free pages only
    claims = [big.alloc(131, b, prng.prng_key(100 + b)) for b in range(4)]
    assert big.used == 4 * 131 and len(set(torch.cat(claims).tolist())) == 4 * 131


def test_serve_main_takes_no_reduced(capsys):
    from repro_torch.launch import serve as serve_mod

    n = flash_attention.launches
    serve_mod.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen-len", "3", "--plane", "kernel"])
    out = capsys.readouterr().out
    assert "params=787,456" in out and "[serve] ok" in out
    assert flash_attention.launches == n  # the CPU ran the plain version
    with pytest.raises(SystemExit):
        serve_mod.main(["--reduced=no"])


def test_golden_file_matches_the_port_draws():
    """The golden file's prompts are the port's ``randint(PRNGKey(1))``, and
    its steps are self-consistent (logsumexp >= max >= every top-8 logit)."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg, _ = get_config(ARCH)
    B, P = g["batch"], g["prompt_len"]
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (B, P), 0, cfg.vocab_size)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    assert len(g["steps"]) == g["gen_len"] == len(g["tokens"][0])
    for s, step in enumerate(g["steps"]):
        for b in range(B):
            assert step["top_ids"][b][0] == g["tokens"][b][s]
            assert step["lse"][b] >= step["max"][b] == step["top_logits"][b][0]
            assert step["top_logits"][b] == sorted(step["top_logits"][b], reverse=True)


# ---------------------------------------------------------------------------
# The golden file (full width, reference on the CPU)
# ---------------------------------------------------------------------------


def _step_record(logits):
    lf = np.asarray(logits, np.float32)
    top = np.argsort(-lf, axis=-1, kind="stable")[:, :8]
    m = lf.max(-1)
    lse = m + np.log(np.exp(lf - m[:, None]).sum(-1, dtype=np.float64))
    return {
        "top_ids": top.tolist(),
        "top_logits": np.take_along_axis(lf, top, -1).astype(float).tolist(),
        "max": m.astype(float).tolist(),
        "lse": lse.astype(float).tolist(),
    }


def write_golden(B=2, P=256, G=8, seed=0):
    """Reference at full width, then the port on the CPU from the same
    weights and the same tokens: its gap goes into the file too."""
    cfg_j, _ = jget_config(ARCH)
    t0 = time.time()
    params = _jax_params(cfg_j, seed)
    print(f"reference init: {time.time() - t0:.1f} s", flush=True)
    prompts = jax.random.randint(jax.random.PRNGKey(seed + 1), (B, P), 0, cfg_j.vocab_size)
    t0 = time.time()
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, cfg_j, SHD, b, pad_to=P + G))(params, {"tokens": prompts})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, cfg_j, SHD, c, b))
    steps, toks = [np.asarray(logits)], [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(G - 1):
        logits, cache = step(params, cache, {"token": jnp.asarray(toks[-1])})
        steps.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    print(f"reference prefill + {G - 1} steps: {time.time() - t0:.1f} s", flush=True)
    del cache
    leaves = {}  # samples and sums of |w| of whole tensors (a layer's, for stacked leaves)
    for name, layer, corner in (("embed", None, "head"), ("lm_head", None, "head"),
                                ("layers/attn/wq", 0, "head"), ("layers/mlp/wd", cfg_j.n_layers - 1, "tail")):
        a = params
        for part in name.split("/"):
            a = a[part]
        a = np.asarray(a if layer is None else a[layer])
        sample = a[:2, :8] if corner == "head" else a[-2:, -8:]
        leaves[name] = {"layer": layer, "corner": corner, "sample": sample.astype(float).tolist(),
                        "abs_sum": float(np.abs(a.astype(np.float64)).sum())}

    cfg = get_config(ARCH)[0]
    t0 = time.time()
    model = convert.lm_params_from_numpy(params, cfg, device="cpu")
    del params
    with torch.inference_mode():
        tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(np.asarray(prompts))}, pad_to=P + G, plane=ops.TORCH)
        gaps = [float(np.abs(tl.numpy() - steps[0]).max())]
        for s in range(1, G):
            tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(toks[s - 1])})
            gaps.append(float(np.abs(tl.numpy() - steps[s]).max()))
    print(f"port (CPU, torch plane) prefill + {G - 1} steps: {time.time() - t0:.1f} s; gaps {gaps}", flush=True)
    margins = [float(np.min(np.diff(np.sort(s, -1)[:, -2:], axis=-1))) for s in steps]
    out = {
        "what": "JAX reference, stablelm-1.6b at full width, float32, on the CPU: init_lm(PRNGKey(seed)), "
                "prompts randint(PRNGKey(seed + 1), (batch, prompt_len), 0, vocab), lm_prefill(pad_to=prompt_len "
                "+ gen_len), then greedy lm_decode_step; step 0 is the prefill's last-token logits",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm.py",
        "arch": ARCH, "seed": seed, "batch": B, "prompt_len": P, "gen_len": G, "dtype": "float32",
        "prompts": np.asarray(prompts).tolist(),
        "tokens": np.stack(toks, 1).tolist(),
        "steps": [_step_record(s) for s in steps],
        "top1_top2_margin_min": margins,
        "leaves": leaves,
        "port_cpu_max_abs_logit_gap": gaps,
        "port_cpu_gap_note": "max |port - reference| over all logits of each step, the port on the CPU (torch plane) "
                             "with the reference's weights (convert.lm_params_from_numpy), teacher-forced with the "
                             "reference's tokens",
    }
    with open(GOLDEN, "w") as f:
        json.dump(out, f)
    print(f"wrote {GOLDEN}: tokens {out['tokens']}, margins {margins}")


if __name__ == "__main__":
    sys.exit(write_golden())
