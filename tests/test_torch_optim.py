"""The port's optimizers and gradient compression against the JAX
reference, on the CPU.

A small parameter tree with a stacked leaf (``layers/w``, the port's
``layers.{i}.w``) and numpy gradients made from a seed go through both
packages' ``adamw``, ``momentum_bf16`` and ``with_error_feedback`` for
three steps.  ``wsd_schedule`` and the AdamW bias corrections are float32
on both sides: the schedule is exact, and the rest is held within 2 ulp
(XLA's CPU backend contracts some multiply-adds that PyTorch rounds twice,
ROADMAP.md C.6).  ``compressed_psum`` over 4 participants is held bitwise
against the reference's under ``shard_map`` on 4 forced host devices, in
a subprocess: the sum is exact int32 on one shared int8 grid.
"""
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _tree(seed, scale=1.0):
    """The reference's tree and the port's name map of the same values."""
    rng = np.random.default_rng(seed)
    tree = {"embed": rng.standard_normal((6, 5)).astype(np.float32) * scale,
            "final_norm": {"scale": rng.standard_normal((5,)).astype(np.float32) * scale},
            "layers": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32) * scale,
                       "b": rng.standard_normal((3, 5)).astype(np.float32) * scale}}
    return tree, convert.unstack_tree(tree, 3)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_wsd_schedule_matches_reference():
    for peak, kw in ((3e-4, {}), (1e-2, dict(warmup=7, decay_start=20, total=50))):
        want = jopt.wsd_schedule(peak, **kw)
        got = topt.wsd_schedule(peak, **kw)
        for step in (0, 1, 6, 7, 50, 99, 100, 101, 9_999, 10_000, 15_000, 19_999, 20_000, 25_000):
            w, g = np.float32(want(jnp.int32(step))), got(step)
            assert g.dtype == np.float32 and g == w, (peak, step, g, w)


def test_leaf_order_is_the_references():
    ref, named = _tree(0)
    order = [n for group in topt.leaf_order(named) for n in group]
    assert order == ["embed", "final_norm.scale", "layers.0.b", "layers.1.b", "layers.2.b",
                     "layers.0.w", "layers.1.w", "layers.2.w"]
    want = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert want == ["['embed']", "['final_norm']['scale']", "['layers']['b']", "['layers']['w']"]


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    ref, named = _tree(1, scale=3.0)
    want, want_gn = jopt.clip_by_global_norm(ref, max_norm)
    got, gn = topt.clip_by_global_norm(named, max_norm)
    assert _ulp(float(gn), float(want_gn)).max() <= 2
    got_t = dict(_leaves(convert.stack_named(got)))
    for name, w in _leaves(want):
        assert _ulp(_f32(got_t[name]), w).max() <= 2, name
    bf = {n: t.to(torch.bfloat16) for n, t in named.items()}
    clipped, _ = topt.clip_by_global_norm(bf, max_norm)
    assert all(t.dtype == torch.bfloat16 for t in clipped.values())


@pytest.mark.parametrize("name", ["adamw", "momentum_bf16"])
@pytest.mark.parametrize("feedback", [False, True])
def test_optimizer_updates_match_reference(name, feedback):
    """Three steps of the same gradients through both packages' optimizer,
    with and without error feedback (whose residual carries across steps)."""
    params_ref, params = _tree(2)
    want_opt = jcomp.with_error_feedback(jopt.make_optimizer(name, peak_lr=1e-2), feedback)
    got_opt = tcomp.with_error_feedback(topt.make_optimizer(name, peak_lr=1e-2), feedback)
    ws, gs = want_opt.init(params_ref), got_opt.init(params)
    assert sorted(p for p, _ in _leaves(convert.opt_state_to_tree(gs))) == sorted(p for p, _ in _leaves(ws))
    for step in range(3):
        g_ref, g = _tree(10 + step, scale=0.5)
        params_ref, ws, want_gn = want_opt.update(g_ref, ws, params_ref, jnp.int32(step))
        params, gs, gn = got_opt.update(g, gs, params, step)
        assert _ulp(float(gn), float(want_gn)).max() <= 2, step
        got_p = dict(_leaves(convert.stack_named(params)))
        for n, w in _leaves(params_ref):
            assert _ulp(_f32(got_p[n]), w).max() <= 2, (step, n)
        got_s = dict(_leaves(convert.opt_state_to_tree(gs)))
        for n, w in _leaves(ws):
            if str(np.asarray(w).dtype) == "bfloat16":
                assert got_s[n].dtype == torch.bfloat16
                np.testing.assert_array_equal(_f32(got_s[n]), _f32(w), err_msg=n)
            else:
                assert _ulp(_f32(got_s[n]), w).max() <= 2, (step, n)


@pytest.mark.parametrize("name", ["adamw", "momentum_bf16"])
@pytest.mark.parametrize("feedback", [False, True])
def test_opt_state_tree_round_trip(name, feedback):
    """``opt_state_to_tree`` and ``opt_state_from_tree`` invert each other
    on every optimizer's state, wrapped or not, by the state's key names."""
    params_ref, params = _tree(2)
    opt = tcomp.with_error_feedback(topt.make_optimizer(name, peak_lr=1e-2), feedback)
    state = opt.update(_tree(10, scale=0.5)[1], opt.init(params), params, 0)[1]
    tree = convert.opt_state_to_tree(state)
    assert sorted(p for p, _ in _leaves(tree)) == sorted(
        p for p, _ in _leaves(jcomp.with_error_feedback(jopt.make_optimizer(name), feedback).init(params_ref)))
    back = convert.opt_state_from_tree(tree, types.SimpleNamespace(n_layers=3), device="cpu")
    assert dict(_leaves(back)).keys() == dict(_leaves(state)).keys()
    for n, t in _leaves(state):
        got = dict(_leaves(back))[n]
        assert got.dtype == t.dtype and torch.equal(got, t), n
    with pytest.raises(KeyError, match="count"):
        convert.opt_state_to_tree({**state, "count": {}})


def test_quantize_int8_matches_reference():
    x = (np.random.default_rng(3).standard_normal(257) * 3).astype(np.float32)
    x[5] = 0.5 * np.abs(x).max() / 127 * 3  # a value at a half step: rounds half to even on both sides
    wq, ws = jcomp.quantize_int8(x)
    q, s = tcomp.quantize_int8(torch.tensor(x))
    assert q.dtype == torch.int8 and float(s) == float(ws)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(tcomp.dequantize_int8(q, s).numpy(), np.asarray(jcomp.dequantize_int8(wq, ws)))
    assert float((tcomp.dequantize_int8(q, s) - torch.tensor(x)).abs().max()) <= float(s) * 0.5 + 1e-6
    zq, zs = tcomp.quantize_int8(torch.zeros(4))
    assert float(zs) == np.float32(1e-12) and not zq.any()


_PSUM = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
from repro.optim.compression import compressed_psum

x = np.load(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()[:4]), ("pod",))
f = shard_map(lambda xs: compressed_psum(xs[0], "pod")[None], mesh=mesh, in_specs=P("pod"), out_specs=P("pod"))
print(json.dumps(np.asarray(f(x)).tolist()))
"""


def test_compressed_psum_matches_reference_shard_map(tmp_path):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 300)) * np.array([[0.1], [2.0], [0.5], [7.0]])).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PSUM, str(tmp_path / "x.npy")], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.array(json.loads(out.stdout.strip().splitlines()[-1]), np.float32)
    assert all((row == want[0]).all() for row in want)  # every participant receives the same sum
    got = tcomp.compressed_psum([torch.tensor(r) for r in x])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want[0])
    np.testing.assert_allclose(got.numpy(), x.sum(0), atol=4 * 7.0 * 4 / 127)  # within a grid step a part


def test_opt_state_specs_mirror_param_specs():
    specs = {"embed": ("vocab", None)}
    assert topt.opt_state_specs("adamw", specs) == jopt.opt_state_specs("adamw", specs)
    assert topt.opt_state_specs("momentum_bf16", specs) == jopt.opt_state_specs("momentum_bf16", specs)
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")
