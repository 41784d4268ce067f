"""The port's LM forward, loss and training step on a mesh against the JAX
reference's jitted runs, on the CPU.

The reference runs in two subprocesses side by side, each with 4 forced
host devices (the main test process must keep seeing one device,
``tests/conftest.py``), on
``make_host_mesh(d, m)`` and ``AxisRules(mesh, SHARDING_OVERRIDES)``; the
port runs on ``make_host_mesh(d, m, devices=("cpu",) * (d * m))``.  The
same inputs, made with numpy from a seed, and the same weights (the
reference's ``init_lm(PRNGKey(0))``, carried across by ``convert``) go
through both:

* llama4-scout at ``reduced_config`` on (1, 1), (1, 4) and (2, 2):
  ``lm_apply``'s logits and its routing per layer and data shard,
  ``lm_loss`` and the gradient of every leaf, and 3 AdamW steps of
  ``build_train_step``; then one step of a microbatched (2, B/2, S) batch
  on (2, 2);
* kimi-k2 (top-2) on (2, 2): 3 steps with its config's ``momentum_bf16``;
* stablelm-1.6b on (1, 4): ``lm_loss`` and every gradient, ``embed``'s
  among them (the reference's vocab-sharded lookup).

Both MoE configs run at the full configs' capacity factor 1.25
(``dataclasses.replace`` on both sides): the reduced configs' 8.0 drops
nothing, so per-data-shard routing could not show.  At (2, 2) each data
shard routes its own tokens at the capacity of its own T, and the
reference's (2, 2) routing drops a different number of assignments than
its (1, 1) routing (asserted).

Tolerances, those of ``tests/test_torch_train.py`` and
``tests/test_torch_moe.py`` for the unsharded step: losses within 1e-5
absolute, logits within 5e-5 absolute, gradients within 1e-5 of each
leaf's largest |gradient|, ``grad_norm`` within 1e-5 relative, parameters
within 1e-6 absolute, AdamW's m and v within 1e-5 of each leaf's largest
value, at top-1 the router's m and v within 1e-9 absolute (``ROUTER_ABS``:
its gradient is rounding noise, the gate being p / p) and so its gradient
within ``ROUTER_ABS`` / (1 - b1) = 1e-8 absolute, the first step's m that
``ROUTER_ABS`` admits; bf16 momentum within 2**-7 of each leaf's largest
value and unequal on at most 1 % of it; routing (loads and drops per layer
and data shard) and step counters exact.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_mesh_train.py

rewrites ``src/repro_torch/data/golden_train_llama4_scout_mesh.json``: the
reference's ``value_and_grad`` of ``lm_loss`` at llama4-scout's full width
(1 of 48 layers) on each mesh that fits this machine's memory, one process
per mesh, then the port's CPU gap to it in another process (this file with
``--port-gap``, through ``repro_torch.train.golden``), which sets the
card's tolerances (``chip_smoke.py``).
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
from torch.profiler import profile

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.models import lm as jlm
from repro.sharding import unzip_params
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import moe as tmoe
from repro_torch.models import lm as tlm
from repro_torch.sharding import AxisRules
from repro_torch.train import golden as tgolden
from repro_torch.train.steps import build_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA4, KIMI, STABLELM = "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "stablelm-1.6b"
MOE_KW = {"capacity_factor": 1.25}  # the full configs' capacity factor
MESHES = ((1, 1), (1, 4), (2, 2))
B, S = 4, 32  # the llama4 cases' batch
# name: (arch, (data, model), config replacements, what runs, optimizer, each train step's batch shape)
CASES = {
    **{f"llama4_{d}x{m}": (LLAMA4, (d, m), MOE_KW, ("apply", "grad", "train"), "adamw", (3, B, S))
       for d, m in MESHES},
    "llama4_2x2_micro": (LLAMA4, (2, 2), MOE_KW, ("train",), "adamw", (1, 2, B // 2, S)),
    "kimi_2x2": (KIMI, (2, 2), MOE_KW, ("train",), "momentum_bf16", (3, B, S)),
    "stablelm_1x4": (STABLELM, (1, 4), {}, ("grad",), None, None),
}
VAL_TOL = 1e-5
LOGIT_TOL = 5e-5
GRAD_TOL = 1e-5  # of each leaf's largest |gradient|
ROUTER_ABS = 1e-9  # the top-1 router's m and v, absolute (tests/test_torch_moe.py)
ROUTER_GRAD_ABS = ROUTER_ABS / (1 - 0.9)  # the top-1 router's gradient: the first step's m that ROUTER_ABS admits

_REFERENCE = r'''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.launch.mesh import make_host_mesh
from repro.layers import moe
from repro.layers.common import apply_norm
from repro.models import lm
from repro.sharding import AxisRules, unzip_params
from repro.train import steps

assert len(jax.devices()) == 4, jax.devices()
inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
out = {}

def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v

def routing(params, cfg, shd, toks):
    """Per layer of the forward, the reference's layers replayed: loads and
    drops of each data shard at its own capacity."""
    B, S = toks.shape
    n_b = shd.axis_sizes["data"] if shd.resolve(P("batch"), (B,))[0] is not None else 1

    @jax.jit
    def layer(lp, x, positions):
        x = x + lm._attn_full(lp["attn"], cfg, shd, apply_norm(cfg.norm, lp["norm1"], x), positions)
        h = apply_norm(cfg.norm, lp["norm2"], x)
        _, idx = moe._route(cfg, lp["moe"]["wr"], h.reshape(B * S, -1))
        return x + moe.apply_moe(lp["moe"], cfg, shd, h), idx

    x = lm.embed_tokens(params, cfg, shd, toks)
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    loads, drops = [], []
    for i in range(cfg.n_layers):
        x, idx = layer(jax.tree.map(lambda a: a[i], params["layers"]), x, positions)
        ids = np.asarray(idx).reshape(n_b, -1)
        C = moe._capacity(cfg, ids.shape[1] // cfg.top_k, cfg.n_experts)
        per = np.stack([np.bincount(r, minlength=cfg.n_experts) for r in ids])
        loads.append(per)
        drops.append(np.maximum(per - C, 0).sum(-1))
    return np.stack(loads), np.stack(drops)

for name, (arch, (d, m), kw, what, opt_name, shape) in spec.items():
    cfg = dataclasses.replace(reduced_config(arch), **kw)
    params = unzip_params(lm.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32))[0]
    shd = AxisRules(make_host_mesh(d, m), get_config(arch)[1])
    if "apply" in what:
        toks = inp[name + "/tokens"]
        out[name + "/logits"] = np.asarray(jax.jit(lambda p, b: lm.lm_apply(p, cfg, shd, b))(params, {"tokens": toks}))
        out[name + "/loads"], out[name + "/drops"] = routing(params, cfg, shd, jnp.asarray(toks))
    if "grad" in what:
        b = {"tokens": inp[name + "/tokens"], "labels": inp[name + "/tokens"]}
        loss, grads = jax.jit(jax.value_and_grad(lambda p: lm.lm_loss(p, cfg, shd, b)))(params)
        out[name + "/loss"] = np.asarray(loss)
        for path, g in leaves(grads):
            out[name + "/grad/" + path] = np.asarray(g)
    if "train" in what:
        step, opt = steps.build_train_step(cfg, shd, opt_name)
        step = jax.jit(step)
        p, s = params, opt.init(params)
        for i, toks in enumerate(inp[name + "/train"]):
            p, s, mt = step(p, s, jnp.int32(i), {"tokens": toks, "labels": toks})
            pre = f"{name}/train/{i}/"
            out[pre + "loss"], out[pre + "grad_norm"], out[pre + "step"] = map(
                np.asarray, (mt["loss"], mt["grad_norm"], mt["step"]))
            for path, v in leaves(p):
                out[pre + "params/" + path] = np.asarray(v)
            for path, v in leaves(s):  # bfloat16 momentum as float32 (exact)
                out[pre + "opt/" + path] = np.asarray(v, np.float32)
np.savez(sys.argv[2], **out)
print("REFERENCE MESH TRAIN OK")
'''


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
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
    gap = float(np.abs(got - want).max())
    assert gap <= rel * max(float(np.abs(want).max()), 1e-30), (name, gap)


def _cfgs(name):
    """(port, reference) configs of a case, its replacements made in both."""
    arch, _, kw = CASES[name][:3]
    return dataclasses.replace(reduced_config(arch), **kw), dataclasses.replace(jreduced_config(arch), **kw)


def _rules(name, **kw):
    """The port's ``AxisRules`` of a case's mesh, every shard on the CPU."""
    arch, (d, m) = CASES[name][:2]
    return AxisRules(make_host_mesh(d, m, devices=("cpu",) * (d * m)), get_config(arch)[1])


def _inputs():
    """Each case's tokens (the forward and the loss) and train batches, from
    numpy at a seed of the arch and shape: the meshes of one arch see the
    same inputs."""
    inp = {}
    for name, (arch, _, _, what, _, shape) in CASES.items():
        V = reduced_config(arch).vocab_size
        if "apply" in what or "grad" in what:
            tok_shape = (B, S) if arch != STABLELM else (2, 64)
            inp[name + "/tokens"] = np.random.default_rng([26, V, *tok_shape]).integers(0, V, tok_shape).astype(np.int32)
        if "train" in what:
            inp[name + "/train"] = np.random.default_rng([27, V, *shape]).integers(0, V, shape).astype(np.int32)
    return inp


# the reference's cases in two subprocesses of about equal time, run side by side
REFERENCE_GROUPS = (("llama4_1x1", "llama4_1x4", "stablelm_1x4"), ("llama4_2x2", "llama4_2x2_micro", "kimi_2x2"))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The inputs, and the reference's subprocesses on 4 forced host
    devices, started here so that they run while the port does
    (``reference``)."""
    assert sorted(sum(REFERENCE_GROUPS, ())) == sorted(CASES)
    d = tmp_path_factory.mktemp("mesh_train")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d / "in.npz"), str(d / f"out{i}.npz"),
                               json.dumps({n: CASES[n] for n in group})], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i, group in enumerate(REFERENCE_GROUPS)]
    yield inp, procs, d
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def jparams():
    """Each arch's reference weights, ``init_lm(PRNGKey(0))`` at its case config."""
    out = {}
    for name in CASES:
        arch = CASES[name][0]
        if arch not in out:
            out[arch] = unzip_params(jlm.init_lm(jax.random.PRNGKey(0), _cfgs(name)[1], jnp.float32))[0]
    return out


def _grads(model, cfg, batch, shd):
    """(loss, the reference's tree of gradients) of ``lm_loss`` on ``shd``."""
    model.requires_grad_(True)
    loss = tlm.lm_loss(model, cfg, batch, shd=shd)
    named = dict(model.named_parameters())
    return loss.detach(), convert.stack_named(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))


@pytest.fixture(scope="module")
def port_runs(started, jparams):
    """Every case through the port on its mesh: the forward with its
    ``Record`` (per data shard: ``route_stats`` of ``split_call``), the
    loss and gradients, and each train step's metrics, parameters and
    optimizer state."""
    inp = started[0]
    runs = {}
    for name, (arch, _, _, what, opt, shape) in CASES.items():
        cfg, _ = _cfgs(name)
        shd, jp, r = _rules(name), jparams[arch], {}
        if "apply" in what:
            model = convert.lm_params_from_numpy(jp, cfg, device="cpu")
            with torch.inference_mode(), tmoe.Record() as rec:
                r["logits"] = tlm.lm_apply(model, cfg, {"tokens": torch.tensor(inp[name + "/tokens"])}, shd=shd)
            r["routing"] = [[tmoe.route_stats(cfg, c) for c in tmoe.split_call(call)] for call in rec.calls]
        if "grad" in what:
            toks = torch.tensor(inp[name + "/tokens"])
            r["loss"], r["grads"] = _grads(convert.lm_params_from_numpy(jp, cfg, device="cpu"), cfg,
                                           {"tokens": toks, "labels": toks}, shd)
        if "train" in what:
            step, opt_spec = build_train_step(cfg, opt, shd=shd)
            model = convert.lm_params_from_numpy(jp, cfg, device="cpu")
            state = opt_spec.init(dict(model.named_parameters()))
            r["train"] = []
            with tmoe.Record() as rec:
                for i, toks in enumerate(inp[name + "/train"]):
                    toks = torch.tensor(toks)
                    model, state, m = step(model, state, i, {"tokens": toks, "labels": toks})
                    # copies: the next step updates the tensors in place, and numpy views would follow
                    opt_tree = dict(_leaves(convert.opt_state_to_tree(state)))
                    r["train"].append((m, {k: np.array(v) for k, v in _leaves(convert.lm_params_to_numpy(model))},
                                       {k: np.array(_np32(v)) for k, v in opt_tree.items()},
                                       {k: v.dtype for k, v in opt_tree.items()}))
            r["train_calls"] = rec.calls
        runs[name] = r
    return runs


@pytest.fixture(scope="module")
def reference(started, port_runs):
    """(inputs, the reference's outputs), once the port's runs are done."""
    inp, procs, d = started
    ref = {}
    for i, proc in enumerate(procs):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REFERENCE MESH TRAIN OK" in out, err[-4000:]
        ref.update(np.load(d / f"out{i}.npz"))
    return inp, ref


APPLY = [n for n, c in CASES.items() if "apply" in c[3]]
GRAD = [n for n, c in CASES.items() if "grad" in c[3]]
TRAIN = [n for n, c in CASES.items() if "train" in c[3]]


@pytest.mark.parametrize("name", APPLY)
def test_forward_on_a_mesh_matches_the_reference(reference, port_runs, name):
    """``lm_apply(..., shd=...)``'s logits within 5e-5, and what each
    layer routed: each data shard's loads and drops at its own capacity
    equal to the reference's sharded forward's."""
    _, ref = reference
    cfg, _ = _cfgs(name)
    run = port_runs[name]
    np.testing.assert_allclose(run["logits"].numpy(), ref[name + "/logits"], atol=LOGIT_TOL, rtol=0)
    assert len(run["routing"]) == cfg.n_layers
    loads = [[s["loads"] for s in layer] for layer in run["routing"]]
    drops = [[s["dropped"] for s in layer] for layer in run["routing"]]
    assert loads == ref[name + "/loads"].tolist()
    assert drops == ref[name + "/drops"].tolist()
    n_b = CASES[name][1][0]
    assert all(s["capacity"] == tmoe._capacity(cfg, B // n_b * S) for layer in run["routing"] for s in layer)


def test_per_data_shard_capacity_shows_at_2x2(reference, port_runs):
    """The reference's (2, 2) forward drops a different number of
    assignments than its (1, 1) forward (each data shard routes its own T
    at its own capacity), and (1, 4) drops what (1, 1) drops; the port's
    logits part between (1, 1) and (2, 2) as the reference's do."""
    _, ref = reference
    whole, split = ref["llama4_1x1/drops"].sum(-1), ref["llama4_2x2/drops"].sum(-1)
    assert whole.tolist() != split.tolist(), (whole, split)
    assert ref["llama4_1x4/drops"].tolist() == ref["llama4_1x1/drops"].tolist()
    assert not np.allclose(ref["llama4_1x1/logits"], ref["llama4_2x2/logits"], atol=LOGIT_TOL)
    assert not torch.allclose(port_runs["llama4_1x1"]["logits"], port_runs["llama4_2x2"]["logits"], atol=LOGIT_TOL)


@pytest.mark.parametrize("name", GRAD)
def test_loss_and_grads_on_a_mesh_match_the_reference(reference, port_runs, name):
    """``lm_loss(..., shd=...)`` within 1e-5 and every gradient leaf within
    1e-5 of its largest |value| (the top-1 router's absolutely): the
    gradients through the expert-parallel branch (to the router from every
    shard, to each shard's expert slices) and, on stablelm's (1, 4), through
    the reference's vocab-sharded lookup into ``embed``."""
    _, ref = reference
    cfg, _ = _cfgs(name)
    run = port_runs[name]
    assert abs(float(run["loss"]) - float(ref[name + "/loss"])) <= VAL_TOL
    want = {k[len(name) + 6:]: v for k, v in ref.items() if k.startswith(name + "/grad/")}
    got = dict(_leaves(run["grads"]))
    assert sorted(got) == sorted(want) and "embed" in got
    for path, w in want.items():
        if path.endswith("moe/wr") and cfg.top_k == 1:
            assert float(np.abs(_np32(got[path]) - w).max()) <= ROUTER_GRAD_ABS, path
        else:
            _close_to_max(got[path], w, GRAD_TOL, path)


def _check_state(cfg, opt, got, dtypes, ref, pre, step):
    """Optimizer state as ``tests/test_torch_moe.py`` holds it."""
    want = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if path.endswith("moe/wr") and cfg.top_k == 1:
            assert float(np.abs(g - w).max()) <= ROUTER_ABS, (step, path)
        elif opt == "adamw":
            _close_to_max(g, w, 1e-5, f"step {step} {path}")
        else:
            assert dtypes[path] == torch.bfloat16, path
            assert float(np.abs(g - w).max()) <= 2.0**-7 * np.abs(w).max(), (step, path)
            assert (g != w).mean() <= 0.01, (step, path, (g != w).mean())


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_on_a_mesh_matches_the_reference(reference, port_runs, name):
    """``build_train_step(cfg, opt, shd=...)`` step by step: loss,
    ``grad_norm``, the step counter, every parameter and the optimizer
    state; a microbatched batch splits each microbatch over the data
    shards (``shd.resolve(P("batch"), (B_micro,))``: one ``Record`` call a
    layer and microbatch, at the capacity of B_micro / 2 rows)."""
    _, ref = reference
    cfg, _ = _cfgs(name)
    _, (d, _), _, _, opt, shape = CASES[name]
    for i, (m, params, state, dtypes) in enumerate(port_runs[name]["train"]):
        pre = f"{name}/train/{i}/"
        assert m["step"] == int(ref[pre + "step"]) == i + 1
        assert abs(float(m["loss"]) - float(ref[pre + "loss"])) <= VAL_TOL, i
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref[pre + "grad_norm"]), rtol=1e-5)
        for path, w in ((k[len(pre) + 7:], v) for k, v in ref.items() if k.startswith(pre + "params/")):
            np.testing.assert_allclose(params[path], w, atol=1e-6, rtol=0, err_msg=f"step {i} {path}")
        _check_state(cfg, opt, state, dtypes, ref, pre + "opt/", i)
    calls = port_runs[name]["train_calls"]
    n_micro = shape[1] if len(shape) == 4 else 1
    rows = shape[-2] // d  # each call's rows a data shard
    assert len(calls) == shape[0] * n_micro * cfg.n_layers
    assert all(c["capacity"] == tmoe._capacity(cfg, rows * S) and c.get("batch_shards", 1) == d for c in calls)


@pytest.mark.parametrize("mesh", [None, (2, 2)], ids=["no_mesh", "2x2"])
@pytest.mark.parametrize("shape", [(B, S), (2, B // 2, S)], ids=["batch", "micro2"])
def test_record_counts_each_moe_call_once_under_remat(jparams, mesh, shape):
    """Under ``remat="full"`` the backward recomputes every block, MoE
    included: a ``Record`` open around a train step still holds one call a
    layer and microbatch (a mesh's call the batch shards' routing joined),
    and the profiler sees one ``moe:`` range of each step a call."""
    cfg = dataclasses.replace(_cfgs("llama4_1x1")[0], remat="full")
    shd = None if mesh is None else AxisRules(make_host_mesh(*mesh, devices=("cpu",) * 4), get_config(LLAMA4)[1])
    model = convert.lm_params_from_numpy(jparams[LLAMA4], cfg, device="cpu")
    step, opt = build_train_step(cfg, "adamw", shd=shd)
    state = opt.init(dict(model.named_parameters()))
    toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, shape).astype(np.int32))
    with profile() as prof, tmoe.Record() as rec:
        step(model, state, 0, {"tokens": toks, "labels": toks})
    n_calls = cfg.n_layers * (shape[0] if len(shape) == 3 else 1)
    assert len(rec.calls) == n_calls
    assert all(c.get("batch_shards", 1) == (1 if mesh is None else 2) for c in rec.calls)
    names = [e.name for e in prof.events() if e.name.startswith("moe:")]
    for s in ("router", "dispatch", "expert products", "combine"):
        assert names.count("moe:" + s) == n_calls * (1 if mesh is None else mesh[0] * mesh[1]), s


def test_meshes_without_expert_parallelism_compute_what_none_computes(jparams):
    """``shd=None``, a (1, 1) mesh and a 3-way model axis that 4 experts
    do not divide all take the one-call MoE: loss and gradients bitwise."""
    cfg, _ = _cfgs("llama4_1x1")
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    runs = [_grads(convert.lm_params_from_numpy(jparams[LLAMA4], cfg, device="cpu"), cfg, batch, shd)
            for shd in (None, _rules("llama4_1x1"), AxisRules(make_host_mesh(1, 3, devices=("cpu",) * 3), {}))]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for path, g in _leaves(grads):
            assert torch.equal(g, dict(_leaves(runs[0][1]))[path]), path


# ---------------------------------------------------------------------------
# The golden file (full width, reference on the CPU)
# ---------------------------------------------------------------------------


def test_golden_mesh_file_matches_the_port():
    """The golden file's tokens are the port's ``randint(PRNGKey(seed + 1))``,
    its config the cut llama4-scout at full width, its per-shard routing
    adds up at each mesh's capacity, and its tolerances are 10x the port's
    CPU gaps (no tighter than 1e-6)."""
    with open(tgolden.GOLDEN_TRAIN_MESH) as f:
        g = json.load(f)
    cfg = tgolden.file_config(g, get_config)
    assert g["arch"] == LLAMA4 and cfg.d_model == 5120 and cfg.vocab_size == 202048 and cfg.n_layers == 1
    assert g["capacity_factor"] == cfg.capacity_factor == 1.25
    np.testing.assert_array_equal(tgolden.mesh_tokens(g, "cpu").numpy(), np.array(g["tokens"]))
    T = g["batch"] * g["seq"]
    for mesh, rec in g["meshes"].items():
        d = int(mesh.split("x")[0])
        for layer in rec["routing"]:
            assert len(layer) == d
            for shard in layer:
                assert sum(shard["loads"]) == T // d * cfg.top_k and shard["capacity"] == tmoe._capacity(cfg, T // d)
                assert shard["dropped"] == sum(max(n - shard["capacity"], 0) for n in shard["loads"])
    for key, gap in g["port_cpu_gap"].items():
        assert g["tolerance"][key] == max(10 * gap, 1e-6), key


_GOLDEN_REFERENCE = r'''
import dataclasses, json, os, resource, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import param_structs
from repro.layers import moe
from repro.layers.common import apply_norm
from repro.models import lm
from repro.sharding import AxisRules, unzip_params

spec = json.loads(sys.argv[1])
d, m = spec["mesh"]
cfg0, rules = get_config(spec["arch"])
cfg = dataclasses.replace(cfg0, n_layers=spec["n_layers"])
shd = AxisRules(make_host_mesh(d, m), rules)
B, S = spec["batch"], spec["seq"]
toks = jax.random.randint(jax.random.PRNGKey(spec["seed"] + 1), (B, S), 0, cfg.vocab_size)
batch = {"tokens": toks, "labels": toks}

def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v

def loss_and_grad_sums(p):
    # the loss, the global gradient norm, and float32 sums of each gradient leaf (and of |g|) over its last axis,
    # which the host sums in float64: no gradient leaves the program
    loss, g = jax.value_and_grad(lambda q: lm.lm_loss(q, cfg, shd, batch))(p)
    sq = sum(jnp.sum(jnp.square(v)) for _, v in leaves(g))
    return loss, jnp.sqrt(sq), {k: (v.sum(-1), jnp.abs(v).sum(-1)) for k, v in leaves(g)}

# compiled on the parameters' shapes and layouts first: a mesh whose program does not fit this machine is left out
# before anything is allocated
shapes, specs, shardings = param_structs(cfg, shd, jnp.float32)
structs = jax.tree.map(lambda v, s: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=s), shapes, shardings)
t0 = time.time()
compiled = jax.jit(loss_and_grad_sums).lower(structs).compile()
ma = compiled.memory_analysis()
need = (ma.argument_size_in_bytes + ma.temp_size_in_bytes + ma.output_size_in_bytes) * d * m / 1e9
avail = [int(l.split()[1]) for l in open("/proc/meminfo") if l.startswith("MemAvailable")][0] / 2**20
print(f"compiled in {time.time() - t0:.1f} s: {need:.1f} GB over the {d * m} devices, {avail:.1f} GB available",
      flush=True)
if need > avail - spec["margin_gb"]:
    json.dump({"compiled_gb": need, "available_gb": avail}, open(sys.argv[2], "w"))
    sys.exit(3)

t0 = time.time()
tree = lm.init_lm(jax.random.PRNGKey(spec["seed"]), cfg, jnp.float32)
values = unzip_params(tree)[0]
del tree
# each leaf laid out by its logical spec, as a launcher places it (no device holds a replica of a sharded leaf),
# one leaf at a time, each unsharded leaf freed once placed
flat, treedef = jax.tree.flatten(values)
del values
for i, sh in enumerate(jax.tree.leaves(shardings)):
    flat[i] = jax.device_put(flat[i], sh)
params = jax.tree.unflatten(treedef, flat)
del flat
print(f"init: {time.time() - t0:.1f} s", flush=True)
t0 = time.time()
loss, gnorm, sums = compiled(params)
loss = float(loss)
print(f"value_and_grad: {time.time() - t0:.1f} s, loss {loss}", flush=True)
leaf_sums = {k: {"sum": float(np.asarray(s, np.float64).sum()), "abs_sum": float(np.asarray(a, np.float64).sum())}
             for k, (s, a) in sums.items()}

# routing per layer and data shard: the reference's blocks replayed to each MoE's input
n_b = shd.axis_sizes["data"] if shd.resolve(P("batch"), (B,))[0] is not None else 1

@jax.jit
def embed(p):
    return lm.embed_tokens(p, cfg, shd, toks)

@jax.jit
def layer(layers, i, x, positions):
    lp = jax.tree.map(lambda a: a[i], layers)
    x = x + lm._attn_full(lp["attn"], cfg, shd, apply_norm(cfg.norm, lp["norm1"], x), positions)
    h = apply_norm(cfg.norm, lp["norm2"], x)
    logits = jnp.einsum("td,de->te", h.reshape(B * S, -1).astype(jnp.float32), lp["moe"]["wr"].astype(jnp.float32))
    return x + moe.apply_moe(lp["moe"], cfg, shd, h), logits

x = embed(params)
positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
routing, router_logits = [], []
for i in range(cfg.n_layers):
    x, logits = layer(params["layers"], i, x, positions)
    logits = np.asarray(logits)
    router_logits.append(logits)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    _, idx = jax.lax.top_k(jnp.asarray(probs), cfg.top_k)
    ranked = np.sort(probs, -1)[:, ::-1]
    C = moe._capacity(cfg, B * S // n_b, cfg.n_experts)
    shards = []
    for ids, r in zip(np.asarray(idx).reshape(n_b, -1), ranked.reshape(n_b, -1, cfg.n_experts)):
        loads = np.bincount(ids, minlength=cfg.n_experts)
        shards.append({"loads": loads.tolist(), "dropped": int(np.maximum(loads - C, 0).sum()), "capacity": C,
                       "margin": float((r[:, cfg.top_k - 1] - r[:, cfg.top_k]).min())})
    routing.append(shards)
np.save(sys.argv[3], np.stack(router_logits))
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
json.dump({"loss": loss, "grad_norm": float(gnorm), "leaf_sums": leaf_sums, "routing": routing,
           "compiled_gb": need, "peak_rss_gb": peak, "tokens": np.asarray(toks).tolist()}, open(sys.argv[2], "w"))
print(f"mesh {d}x{m}: peak RSS {peak:.1f} GB", flush=True)
'''


GOLDEN_MARGIN_GB = 6  # what the writer leaves free of the memory available when a mesh's program starts


def write_golden():
    """The reference at llama4-scout's full width, ``tgolden.MESH_RUN``'s
    layers, one process per mesh (each its own peak), then the port's CPU
    gap in another process."""
    import tempfile

    r = tgolden.MESH_RUN
    cfg_j = tgolden.file_config({"arch": LLAMA4, **r}, jget_config)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    meshes, left_out, tokens = {}, {}, None
    tmp = tempfile.mkdtemp(prefix="golden_mesh_")
    for d, m in r["meshes"]:
        path = os.path.join(tmp, f"{d}x{m}.json")
        t0 = time.time()
        spec = json.dumps({"arch": LLAMA4, "mesh": [d, m], "margin_gb": GOLDEN_MARGIN_GB,
                           **{k: r[k] for k in ("seed", "n_layers", "batch", "seq")}})
        done = subprocess.run([sys.executable, "-c", _GOLDEN_REFERENCE, spec, path,
                               os.path.join(tmp, f"{d}x{m}_router.npy")], env=env)
        if done.returncode == 3:  # the compiled program does not fit this machine's memory
            left_out[f"{d}x{m}"] = json.load(open(path))
            print(f"mesh {d}x{m}: left out, {left_out[f'{d}x{m}']}", flush=True)
            continue
        assert done.returncode == 0, f"mesh {d}x{m}: the reference's run failed (rc {done.returncode})"
        rec = json.load(open(path))
        tokens = rec.pop("tokens")
        meshes[f"{d}x{m}"] = dict(rec, seconds=round(time.time() - t0, 1))
        print(f"mesh {d}x{m}: loss {rec['loss']} grad_norm {rec['grad_norm']} ({time.time() - t0:.1f} s)", flush=True)
    peaks = {k: round(v["peak_rss_gb"], 1) for k, v in meshes.items()}
    needs = {k: round(v["compiled_gb"], 1) for k, v in {**meshes, **left_out}.items()}
    out = {
        "what": "JAX reference on the CPU with 4 forced host devices: llama4-scout-17b-a16e at full width with the "
                "depth cut to n_layers, float32, init_lm(PRNGKey(seed)) laid out by its logical specs on "
                "AxisRules(make_host_mesh(d, m), SHARDING_OVERRIDES), tokens = labels = randint(PRNGKey(seed + 1), "
                "(batch, seq), 0, vocab); for each mesh one jitted value_and_grad of lm_loss: the loss, the global "
                "gradient norm, the float64 sum and |sum| of every gradient leaf (of float32 sums over its last "
                "axis), and per layer and data shard the expert loads, dropped assignments, capacity and smallest "
                "top-k / next router-probability margin",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_mesh_train.py",
        "arch": LLAMA4, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size,
        "capacity_factor": cfg_j.capacity_factor, **{k: v for k, v in r.items() if k != "meshes"},
        "dtype": "float32", "optimizer_on_the_card": "momentum_bf16",
        "depth_cut": "48 -> 1 layer: one layer is 2.08 B float32 parameters beside 2.07 B of embedding and head "
                     "(16.6 GB); with their gradients 33 GB, and an AdamW step's five float32 copies 83 GB, more "
                     "than the 62 GB of the machine that writes this file.  The reference's compiled program "
                     f"(arguments, temporaries and outputs over the 4 host devices, GB): {needs}; its measured "
                     f"peak RSS per mesh written (GB): {peaks}; a mesh whose program exceeds the memory available "
                     f"less {GOLDEN_MARGIN_GB} GB is left out (meshes_left_out) and held on the CPU at the reduced "
                     "configs only (tests/test_torch_mesh_train.py)",
        "meshes_left_out": left_out,
        "tokens": tokens, "meshes": meshes,
    }
    with open(tgolden.GOLDEN_TRAIN_MESH, "w") as f:
        json.dump(out, f)
    print(f"wrote {tgolden.GOLDEN_TRAIN_MESH}; measuring the port's CPU gap in a new process", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap", tmp], env=env, check=True)


def _reference_weights_in_the_port(cfg_j, cfg, seed):
    """The reference's weights (its ``init_lm``) as the port's LM through
    ``convert``, one leaf at a time, each reference leaf freed once copied."""
    tree = unzip_params(jlm.init_lm(jax.random.PRNGKey(seed), cfg_j, jnp.float32))[0]
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


def _port_cpu_gap(tmp):
    """The port on the CPU with the reference's weights and tokens, on each
    of the file's meshes (every shard on the CPU): its gaps to the
    reference's loss, gradient norm and leaf sums, and to its router logits;
    routing held where the margin allows.  The largest gap of each family
    over the meshes sets the card's tolerance at 10x."""
    with open(tgolden.GOLDEN_TRAIN_MESH) as f:
        g = json.load(f)
    cfg = tgolden.file_config(g)
    t0 = time.time()
    model = _reference_weights_in_the_port(tgolden.file_config(g, jget_config), cfg, g["seed"])
    print(f"reference weights in the port: {time.time() - t0:.1f} s", flush=True)
    tokens = tgolden.mesh_tokens(g, "cpu")
    assert tokens.tolist() == g["tokens"]
    per_mesh = {}
    for mesh, want in g["meshes"].items():
        t0 = time.time()
        rec, calls = tgolden.grad_record(model, cfg, {"tokens": tokens, "labels": tokens},
                                         tgolden.mesh_rules(g, mesh, "cpu"))
        ref_router = np.load(os.path.join(tmp, f"{mesh}_router.npy"))
        router_gap = max(float(np.abs(c["logits"].numpy() - ref_router[i]).max()) for i, c in enumerate(calls))
        gaps = dict(tgolden.grad_gaps(rec, want, cfg), router_logits=router_gap)
        checks = tgolden.routing_checks(rec["routing"], want["routing"], router_gap)
        bad = [c for c in checks if c["held"] and not c["equal"]]
        assert not bad, bad
        per_mesh[mesh] = {"gaps": gaps, "routing": rec["routing"], "seconds": round(time.time() - t0, 1)}
        print(f"mesh {mesh}: port loss {rec['loss']} grad_norm {rec['grad_norm']}; gaps {gaps}; routing held "
              f"{sum(c['held'] for c in checks)} of {len(checks)} ({time.time() - t0:.1f} s)", flush=True)
    g["port_cpu_gap"] = {k: max(m["gaps"][k] for m in per_mesh.values()) for k in next(iter(per_mesh.values()))["gaps"]}
    g["port_cpu_per_mesh"] = per_mesh
    g["port_cpu_gap_note"] = ("the port on the CPU (every shard on the CPU, one thread pool) with the reference's "
                              "weights through convert: relative gaps of the loss and the gradient norm, of each "
                              "leaf's sum and |sum| against its |sum|, and max |port - reference| of the router "
                              "logits; the largest over the meshes")
    # the card is held to 10x the CPU's gaps (the rule of the other golden files), no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in g["port_cpu_gap"].items()}
    with open(tgolden.GOLDEN_TRAIN_MESH, "w") as f:
        json.dump(g, f)
    print(f"port on the CPU: gaps {g['port_cpu_gap']}; tolerances {g['tolerance']}")


if __name__ == "__main__":
    sys.exit(_port_cpu_gap(sys.argv[2]) if sys.argv[1:2] == ["--port-gap"] else write_golden())
