"""The port's LM training path against the JAX reference, on the CPU.

At ``reduced_config("stablelm-1.6b")`` (4 layers, d_model 128, vocab 512)
the reference's parameters go through the port (``convert``), and numpy
inputs made from a seed go through both packages:

* ``naive_attention`` and ``flash_attention_xla`` (values, and gradients
  against ``jax.vjp``), causal and windowed, at 1536 keys (two KV chunks,
  the second short);
* ``xent_loss`` and ``lm_loss`` at S = 128 and S = 1100 (two loss chunks,
  ``flash_attention_xla`` in every block), values and the gradient of every
  leaf, under ``remat`` "none", "full" and "save_attn";
* ``build_train_step`` for 3 steps with AdamW, ``momentum_bf16`` and a
  microbatched (3-D) batch: losses, ``grad_norm``, parameters and optimizer
  state after each step.

Tolerances, each from what was measured here (float32 sums in another
order: XLA's CPU backend and PyTorch's): values within 1e-5 absolute
(measured below 1e-6); gradients within 1e-5 of each leaf's largest
gradient (measured 1.8e-6); ``grad_norm`` within 1e-6 relative (measured
4e-7), and 1e-5 for gradients accumulated in bfloat16 (measured 1.6e-6:
the float32 sums tip some bf16 roundings); AdamW's ``m`` and ``v`` within 1e-5 of each leaf's largest value
(measured 1.3e-6: they inherit the gradients' rounding); parameters within
1e-6 absolute (measured 4.3e-7, against 3-step updates of 2e-5: AdamW's
``m / sqrt(v)`` amplifies the rounding of near-zero gradients); bf16
momentum within 2**-8 of each leaf's largest value, one bf16 step of a
value half that size, and unequal on at most 1 % of its elements
(measured: 1.5e-3 of the largest, on 0.23 % of the elements, where a
float32 sum rounds to the other bf16 neighbour and the next steps carry
it), 3 % when the gradients too are accumulated in bfloat16 (three more
roundings a step; measured 1.2 % of a 512-element leaf).  Step counters are
exact.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py

rewrites ``src/repro_torch/data/golden_train_stablelm.json``: the
reference's training run at stablelm-1.6b's full width (depth cut to
``GOLDEN_LAYERS``), which ``chip_smoke.py`` holds the port to on the card,
then, in a separate process, the port's gap to it on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.data import pipeline as jpipeline
from repro.layers import attention as jattn
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.data.pipeline import make_pipeline
from repro_torch.kernels import ops
from repro_torch.layers import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.train.golden import GOLDEN_TRAIN as GOLDEN, port_run, rel_gaps, train_record
from repro_torch.train.steps import build_decode_step, build_prefill, build_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "stablelm-1.6b"
SHD = AxisRules(None)
VAL_TOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest |gradient|
# the golden run: full width on the main path's route (S = 2048: two KV chunks of flash_attention_xla in
# every block, two loss chunks), depth cut so that the reference's CPU step holds a fraction of the full
# model's memory
GOLDEN_LAYERS = 4
GOLDEN_RUN = dict(seed=0, batch=1, seq=2048, steps=3, optimizer="adamw")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores, where a thread pool per
    worker loses far more to contention than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """Every element within ``rel`` of the leaf's largest |value|."""
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= rel * scale, (name, gap, scale)


@pytest.fixture(scope="module")
def reduced():
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    jparams = unzip_params(jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32))[0]
    return cfg, jcfg, jparams


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["naive_attention", "flash_attention_xla"])
@pytest.mark.parametrize("Sq,Sk,window,q_offset", [(1536, 1536, 0, 0), (1536, 1536, 300, 0), (200, 200, 37, 0),
                                                  (96, 1536, 0, 1440)])
def test_attention_matches_reference_values_and_grads(fn, Sq, Sk, window, q_offset):
    rng = np.random.default_rng(Sq + window)
    q, ct = (rng.standard_normal((1, Sq, 4, 32)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, Sk, 4, 32)).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    want, vjp = jax.vjp(lambda a, b, c: getattr(jattn, fn)(a, b, c, **kw), q, k, v)
    want_grads = vjp(ct)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = getattr(tattn, fn)(tq, tk, tv, **kw)
    got.backward(torch.tensor(ct))
    np.testing.assert_allclose(_np32(got), np.asarray(want), atol=VAL_TOL, rtol=0)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        _close_to_max(t.grad, w, GRAD_TOL, f"d{name}")


def test_flash_attention_xla_equals_naive_in_the_port():
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((2, 700, 4, 32)).astype(np.float32)) for _ in range(3))
    for window in (0, 100):
        a = tattn.flash_attention_xla(q, k, v, causal=True, window=window, chunk=256)
        b = tattn.naive_attention(q, k, v, causal=True, window=window)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=VAL_TOL, rtol=0)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def test_xent_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 33, 512)) * 3).astype(np.float32)
    labels = rng.integers(0, 512, (2, 33)).astype(np.int32)
    mask = (rng.random((2, 33)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = float(jlm.xent_loss(logits, labels, m))
        got = float(tlm.xent_loss(torch.tensor(logits), torch.tensor(labels), None if m is None else torch.tensor(m)))
        assert abs(got - want) <= VAL_TOL, (got, want)


@pytest.mark.parametrize("S", [128, 1100])
def test_lm_loss_and_grads_match_reference_under_every_remat(reduced, S):
    cfg, jcfg, jparams = reduced
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jb = {"tokens": toks, "labels": toks}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)}
    first = None
    for remat in ("none", "full", "save_attn"):
        jc, c = dataclasses.replace(jcfg, remat=remat), dataclasses.replace(cfg, remat=remat)
        want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(p, jc, SHD, jb)))(jparams)
        model = convert.lm_params_from_numpy(jparams, c, device="cpu").requires_grad_(True)
        loss = tlm.lm_loss(model, c, tb)
        named = dict(model.named_parameters())
        grads = convert.stack_named(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
        loss = loss.detach()
        assert abs(float(loss) - float(want_loss)) <= VAL_TOL, (remat, float(loss), float(want_loss))
        want = dict(_leaves(want_grads))
        got = dict(_leaves(grads))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            _close_to_max(got[name], w, GRAD_TOL, f"{remat} {name}")
        if first is None:
            first = (float(loss), got)
        else:  # recomputation repeats the same float32 operations: bitwise the same
            assert float(loss) == first[0]
            for name, g in got.items():
                assert torch.equal(g, first[1][name]), (remat, name)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_save_attn_recomputes_attention_not_weight_products(reduced):
    """``full`` recomputes every product in the backward; ``save_attn``
    keeps the weight products (``mm``) and recomputes only the batched
    attention products (``bmm``), as ``checkpoint_dots_with_no_batch_dims``."""
    cfg, _, jparams = reduced
    toks = torch.tensor(np.random.default_rng(0).integers(0, 512, (2, 64)).astype(np.int32))
    counts = {}
    for remat in ("none", "full", "save_attn"):
        c = dataclasses.replace(cfg, remat=remat)
        model = convert.lm_params_from_numpy(jparams, c, device="cpu").requires_grad_(True)
        loss = tlm.lm_loss(model, c, {"tokens": toks, "labels": toks})
        with _CountMatmuls() as mode:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[remat] = mode.counts
    # full recomputes each block's weight products up to the last one its backward needs (6 of 7)
    assert counts["full"]["mm"] == counts["none"]["mm"] + 6 * cfg.n_layers
    assert counts["save_attn"]["mm"] == counts["none"]["mm"]
    assert counts["full"]["bmm"] == counts["save_attn"]["bmm"] > counts["none"]["bmm"]


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _check_opt_state(opt, got, want, bf16_grads=False):
    got, want = dict(_leaves(convert.opt_state_to_tree(got))), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if opt == "adamw":
            _close_to_max(g, w, 1e-5, name)
            continue
        assert g.dtype == torch.bfloat16 and str(np.asarray(w).dtype) == "bfloat16", name
        g, w = _np32(g), _np32(w)
        # one bf16 step of a value half the leaf's largest: a rounding that the float32 sums tip at one step
        # carries over into the next steps' smaller sums
        gap = float(np.abs(g - w).max())
        assert gap <= 2.0**-8 * np.abs(w).max(), (name, gap)
        assert (g != w).mean() <= (0.03 if bf16_grads else 0.01), (name, (g != w).mean())


@pytest.mark.parametrize("opt,shape", [("adamw", (2, 64)), ("momentum_bf16", (2, 64)), ("adamw", (3, 2, 64)),
                                       ("momentum_bf16", (2, 2, 64))],
                         ids=["adamw", "momentum_bf16", "adamw_micro3", "momentum_bf16_micro2"])
def test_train_step_matches_reference(reduced, opt, shape):
    cfg, jcfg, jparams = reduced
    jstep, jopt = jsteps.build_train_step(jcfg, SHD, opt)
    jstep = jax.jit(jstep)
    tstep, topt = build_train_step(cfg, opt)
    jp, js = jparams, jopt.init(jparams)
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    ts = topt.init(dict(model.named_parameters()))
    rng = np.random.default_rng(11)
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        jp, js, jm = jstep(jp, js, jnp.int32(step), {"tokens": toks, "labels": toks})
        model, ts, tm = tstep(model, ts, step, {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)})
        assert tm["step"] == int(jm["step"]) == step + 1
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= VAL_TOL, step
        bf16_grads = opt != "adamw" and len(shape) == 3  # accumulated in bfloat16
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5 if bf16_grads else 1e-6)
        got = dict(_leaves(convert.lm_params_to_numpy(model)))
        for name, w in _leaves(jp):
            np.testing.assert_allclose(got[name], np.asarray(w), atol=1e-6, rtol=0, err_msg=f"step {step} {name}")
        _check_opt_state(opt, ts, js, bf16_grads)


def test_prefill_and_decode_builders_match_reference(reduced):
    cfg, jcfg, jparams = reduced
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jc = jsteps.build_prefill(jcfg, SHD)(jparams, {"tokens": toks[:, :8]})
    jl2, _ = jsteps.build_decode_step(jcfg, SHD)(jparams, jc, {"token": toks[:, 8]})
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    with torch.inference_mode():
        tl, tc = build_prefill(cfg)(model, {"tokens": torch.tensor(toks[:, :8])})
        tl2, _ = build_decode_step(cfg)(model, tc, {"token": torch.tensor(toks[:, 8])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=VAL_TOL, rtol=0)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=VAL_TOL, rtol=0)


def test_train_step_turns_parameters_trainable(reduced):
    cfg, _, jparams = reduced
    model = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())  # built frozen, for serving
    step, opt = build_train_step(cfg)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    step(model, opt.init(dict(model.named_parameters())), 0, {"tokens": toks, "labels": toks})
    assert all(p.requires_grad for p in model.parameters())


def test_attention_op_kernel_plane_refuses_inputs_that_require_grad():
    """The kernel has no backward: on the kernel plane, inputs that autograd
    would differentiate are refused (the check sits before the CPU's plain
    version), and the training route never reaches the kernel."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 16, 2, 32)).astype(np.float32)) for _ in range(3))
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*TRAIN"):
        ops.attention_op(qg, k, v, plane=ops.KERNEL)
    with torch.no_grad():
        ops.attention_op(qg, k, v, plane=ops.KERNEL)
    ops.attention_op(q, k, v, plane=ops.KERNEL)
    ops.attention_op(qg, k, v, plane=ops.TORCH).sum().backward()
    assert qg.grad is not None


# ---------------------------------------------------------------------------
# The golden file (full width, reference on the CPU)
# ---------------------------------------------------------------------------


def _golden_cfg(get):
    return dataclasses.replace(get(ARCH)[0], n_layers=GOLDEN_LAYERS)


def test_golden_train_file_matches_the_port_pipeline():
    """The golden file's batches are the port's pipeline draws at full
    vocabulary, its config the cut stablelm-1.6b, and its CPU gaps inside
    the tolerances the card is held to."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg = _golden_cfg(get_config)
    assert g["arch"] == ARCH and g["n_layers"] == GOLDEN_LAYERS and g["d_model"] == cfg.d_model
    assert g["vocab_size"] == cfg.vocab_size and {k: g[k] for k in GOLDEN_RUN} == GOLDEN_RUN
    assert g["seq"] - 1 > 1024  # the main path's route: flash_attention_xla over 2 KV chunks, 2 loss chunks
    init, nxt = make_pipeline(cfg.vocab_size, g["batch"], g["seq"], seed=g["seed"], device="cpu")
    state = init()
    for step in range(g["steps"]):
        state, b = nxt(state)
        assert b["tokens"].tolist() == g["tokens"][step], step
    gap, tol = g["port_cpu_gap"], g["tolerance"]
    for key in ("loss", "grad_norm", "leaf_sums"):
        assert tol[key] >= 10 * gap[key], key


def _port_cpu_run():
    """The port on the CPU as the card runs it (``golden.port_run``), in a
    process of its own."""
    g = json.load(open(GOLDEN))
    rec, _ = port_run(g, device="cpu")
    gap = rel_gaps(rec, g)
    g["port_cpu_gap"] = gap
    # the card is held to 10x the CPU's gap (the serving golden file's margin was 12x), and no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in gap.items()}
    with open(GOLDEN, "w") as f:
        json.dump(g, f)
    print(f"port on the CPU: gaps {gap}; tolerances {g['tolerance']}")


def write_golden():
    cfg_j = _golden_cfg(jget_config)
    r = GOLDEN_RUN
    t0 = time.time()
    params = unzip_params(jlm.init_lm(jax.random.PRNGKey(r["seed"]), cfg_j, jnp.float32))[0]
    step_fn, opt = jsteps.build_train_step(cfg_j, SHD, r["optimizer"])
    step_fn = jax.jit(step_fn, donate_argnums=(0, 1))
    state = opt.init(params)
    init, nxt = jpipeline.make_pipeline(cfg_j.vocab_size, r["batch"], r["seq"], seed=r["seed"])
    ds = init()
    losses, gnorms, tokens = [], [], []
    for step in range(r["steps"]):
        ds, b = nxt(ds)
        tokens.append(np.asarray(b["tokens"]).tolist())
        params, state, m = step_fn(params, state, jnp.int32(step), b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        print(f"reference step {step}: loss {losses[-1]} grad_norm {gnorms[-1]} ({time.time() - t0:.1f} s)", flush=True)
    out = {
        "what": "JAX reference on the CPU: stablelm-1.6b at full width, depth cut to n_layers, float32; "
                "init_lm(PRNGKey(seed)), make_pipeline(vocab, batch, seq, seed=seed), build_train_step "
                "(optimizer) for `steps` steps; losses and grad_norms per step, float64 sums of named leaves "
                "of the parameters, m and v after the last step",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py",
        "arch": ARCH, "n_layers": GOLDEN_LAYERS, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size,
        "depth_cut": "24 -> 4 layers: the reference's full-depth step holds five float32 copies of 1.64 B "
                     "parameters on the CPU (parameters, gradients, clipped gradients, m and v: about 33 GB); "
                     "4 layers hold 0.62 B; the card's timed run trains the full depth",
        **r, "dtype": "float32", "tokens": tokens,
        **train_record(losses, gnorms, params, state),
    }
    del params, state
    with open(GOLDEN, "w") as f:
        json.dump(out, f)
    print(f"wrote {GOLDEN} ({time.time() - t0:.1f} s); measuring the port's CPU gap in a new process", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap"], env=env, check=True)


if __name__ == "__main__":
    sys.exit(_port_cpu_run() if sys.argv[1:] == ["--port-gap"] else write_golden())
