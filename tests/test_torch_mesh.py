"""The port's mesh layer (``sharding.AxisRules``, ``launch/{mesh,specs,
dryrun}``) against the JAX reference's, on the CPU.

* Spec trees: ``param_structs`` and ``cache_structs`` (every prefill and
  decode shape) of all 10 archs at their full configs, leaf paths,
  shapes, dtypes and logical specs equal to the reference's
  (``jax.eval_shape``: neither side draws or allocates).
* Resolution: one subprocess with 512 forced host devices, where the
  reference resolves every leaf on the 16 x 16 and 2 x 16 x 16 production
  meshes under each arch's ``rules_for`` each shape: the port's resolved
  specs, shard shapes of the parameters, cache and inputs, and
  ``per_device_param_bytes`` equal them exactly.
* The dry run: ``python -m repro_torch.launch.dryrun --mesh both`` without
  a card writes 80 records and no ``error``, every ``skip`` where the
  reference's ``cell_supported`` skips; ``--append`` skips the cells done.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES, cell_supported as jcell_supported, get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import decode as jdecode
from repro.sharding import AxisRules as JAxisRules
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.sharding import P, AxisRules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_SHAPES = tuple(n for n, s in SHAPES.items() if s.kind != "train")
MESHES = {"16x16": False, "2x16x16": True}

_REFERENCE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import SHAPES, get_config
from repro.launch import specs
from repro.launch.dryrun import per_device_param_bytes, rules_for
from repro.launch.mesh import make_production_mesh
from repro.models import decode
from repro.sharding import AxisRules

def leaves(tree, prefix=()):
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(map(str, prefix + (k,))), v

def resolved(shd, shapes, specs_tree):
    return {path: [list(shd.resolve(sp, tuple(sh.shape))), list(shd.sharding(sp, tuple(sh.shape)).shard_shape(
        tuple(sh.shape)))] for (path, sh), (_, sp) in zip(leaves(shapes), leaves(specs_tree))}

out = {}
for arch in json.loads(sys.argv[2]):
    cfg, overrides = get_config(arch)
    if cfg.is_hybrid:  # the reference's init_cache names an undefined n_full (ROADMAP.md C.11)
        decode.n_full = cfg.n_layers // len(cfg.block_pattern)
    p_shapes, p_specs, _ = specs.param_structs(cfg, AxisRules(None))
    out[arch] = {"per_device_param_bytes": per_device_param_bytes(cfg, overrides)}
    for mesh_name, multi in (("16x16", False), ("2x16x16", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for name, shape in SHAPES.items():
            shd = AxisRules(mesh, rules_for(cfg, shape, overrides))
            rec = {"params": resolved(shd, p_shapes, p_specs)}
            batch, shards = specs.input_specs(cfg, shape, shd)
            rec["inputs"] = {k: list(shards[k].shard_shape(tuple(batch[k].shape))) for k in batch}
            if shape.kind != "train":
                c_shapes, c_specs, _ = specs.cache_structs(cfg, shape, AxisRules(None))
                rec["cache"] = resolved(shd, c_shapes, c_specs)
            out[arch][mesh_name + "/" + name] = rec
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("REFERENCE RESOLUTION OK")
'''


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(map(str, prefix + (k,))), v


def _jdtype(x):
    return str(x.dtype).replace("torch.", "")


def _same_structs(got_shapes, got_specs, want_shapes, want_specs):
    """Leaf paths, shapes, dtypes and logical specs of the port's trees
    against the reference's (``ShapeDtypeStruct`` s and ``PartitionSpec`` s)."""
    want = {p: (tuple(s.shape), str(s.dtype)) for p, s in _leaves(want_shapes)}
    got = {p: (tuple(t.shape), _jdtype(t)) for p, t in _leaves(got_shapes)}
    assert got == want
    assert all(t.device.type == "meta" for _, t in _leaves(got_shapes))
    want_sp = {p: tuple(s) for p, s in _leaves(want_specs)}
    got_sp = dict(_leaves(got_specs))
    assert all(isinstance(s, P) for s in got_sp.values())
    assert {p: tuple(s) for p, s in got_sp.items()} == want_sp


def _hybrid_n_full(monkeypatch, cfg):
    """The reference's ``init_cache`` names an undefined ``n_full`` for a
    hybrid (ROADMAP.md C.11): it raises, and runs once its module holds
    the group count its own prefill uses."""
    with pytest.raises(NameError):
        jdecode.init_cache(cfg, 1, 8)
    monkeypatch.setattr(jdecode, "n_full", cfg.n_layers // len(cfg.block_pattern), raising=False)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_structs_match_the_reference_at_full_width(arch):
    cfg, jcfg = get_config(arch)[0], jget_config(arch)[0]
    want_shapes, want_specs, none = jspecs.param_structs(jcfg, JAxisRules(None))
    got_shapes, got_specs, got_none = specs.param_structs(cfg, AxisRules(None))
    assert none is None and got_none is None
    _same_structs(got_shapes, got_specs, want_shapes, want_specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_structs_match_the_reference_at_every_serving_shape(arch, monkeypatch):
    cfg, jcfg = get_config(arch)[0], jget_config(arch)[0]
    if cfg.is_hybrid:
        _hybrid_n_full(monkeypatch, jcfg)
    for name in SERVE_SHAPES:
        want_shapes, want_specs, _ = jspecs.cache_structs(jcfg, JSHAPES[name], JAxisRules(None))
        got_shapes, got_specs, _ = specs.cache_structs(cfg, SHAPES[name], AxisRules(None))
        _same_structs(got_shapes, got_specs, want_shapes, want_specs)


@pytest.fixture(scope="module")
def reference_resolution(tmp_path_factory):
    """The reference's resolved specs and shard shapes on both production
    meshes: one subprocess with 512 forced host devices."""
    out = tmp_path_factory.mktemp("mesh") / "resolved.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(out), json.dumps(ARCH_IDS)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE RESOLUTION OK" in r.stdout, r.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _resolved(shd, shapes, specs_tree):
    shards = shd.resolve_tree(shapes, specs_tree)
    return {path: [list(sd.spec), list(sd.shard_shape)] for path, sd in _leaves(shards)}


def _json(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolution_matches_the_reference_on_the_production_meshes(reference_resolution, arch):
    """Every leaf's resolved spec and shard shape (parameters, cache,
    inputs) under ``rules_for`` each shape on 16 x 16 and 2 x 16 x 16, and
    ``per_device_param_bytes``, exactly the reference's."""
    want = reference_resolution[arch]
    cfg, overrides = get_config(arch)
    assert dryrun.per_device_param_bytes(cfg, overrides) == want["per_device_param_bytes"]
    p_shapes, p_specs = specs.param_structs(cfg, AxisRules(None))[:2]
    for mesh_name, multi in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        assert {d.type for d in mesh.devices.flat} == {"meta"} and mesh.size == (512 if multi else 256)
        for name, shape in SHAPES.items():
            w = want[mesh_name + "/" + name]
            shd = AxisRules(mesh, dryrun.rules_for(cfg, shape, overrides))
            assert _json(_resolved(shd, p_shapes, p_specs)) == w["params"], (mesh_name, name)
            batch, shards = specs.input_specs(cfg, shape, shd)
            assert _json({k: list(shards[k].shard_shape) for k in batch}) == w["inputs"], (mesh_name, name)
            if shape.kind != "train":
                c_shapes, c_specs, _ = specs.cache_structs(cfg, shape, AxisRules(None))
                assert _json(_resolved(shd, c_shapes, c_specs)) == w["cache"], (mesh_name, name)


def test_axis_rules_resolve_as_the_reference():
    """Shape-aware resolution on small meshes: trailing axes dropped until
    the dimension divides, an axis taken once, batch composing with pod,
    rules overridden; ``constrain`` the identity."""
    from types import SimpleNamespace

    cases = [(P("batch", None), (8, 3)), (P("batch", "heads"), (6, 12)), (P(("embed", "fsdp"), "ff"), (16, 24)),
             (P("expert", "fsdp", None), (16, 7, 3)), (P("heads", "kv_heads"), (4, 4)), (P("vocab", None), (7, 4)),
             (P(None, "batch", "kv_seq", None, None), (2, 4, 30, 1, 8)), (P(), ())]
    for shape, axes in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        # the reference's resolution reads only the mesh's axis names and sizes
        jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
        mesh = Mesh(np.full(shape, torch.device("cpu"), dtype=object), axes)
        for rules in ({}, {"fsdp": ("data",)}, {"kv_seq": None, "heads": ("data", "model")}):
            j, t = JAxisRules(jmesh, rules), AxisRules(mesh, rules)
            for spec, dims in cases:
                assert tuple(t.resolve(spec, dims)) == tuple(j.resolve(spec, dims)), (shape, rules, spec)
                assert tuple(t.resolve(spec)) == tuple(j.resolve(spec)), (shape, rules, spec)
    x = torch.ones(2, 3)
    assert AxisRules(make_host_mesh(1, 2, devices=("cpu",) * 2)).constrain(x, "batch", None) is x
    assert tuple(AxisRules(None).resolve(P("batch"), (4,))) == ()


def test_host_mesh_takes_repeated_devices():
    mesh = make_host_mesh(2, 2, devices=("cpu",) * 4)
    assert mesh.shape == (2, 2) and mesh.axis_names == ("data", "model") and mesh.size == 4
    assert mesh.device(data=1, model=0) == torch.device("cpu")
    with pytest.raises(ValueError):
        make_host_mesh(1, 4, devices=("cpu",) * 3)
    shd = AxisRules(mesh)
    assert shd.shard_devices("model") == [torch.device("cpu")] * 2 and shd.shard_devices(None) == [torch.device("cpu")]


def test_dryrun_cli_writes_every_cell_without_a_card(tmp_path):
    """``python -m repro_torch.launch.dryrun --mesh both``: 80 records (10
    archs x 4 shapes x 2 meshes), no ``error``, a ``skip`` exactly where the
    reference's ``cell_supported`` says so; each ``ok`` record's
    per-device total the sum of its parts.  Then ``--append`` over a file
    that holds some cells runs only the others."""
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both", "--out", str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    with open(out) as f:
        recs = json.load(f)
    assert len(recs) == 80
    assert {(x["arch"], x["shape"], x["mesh"]) for x in recs} == {
        (a, s, m) for a in ARCH_IDS for s in SHAPES for m in MESHES}
    for rec in recs:
        ok, why = jcell_supported(jget_config(rec["arch"])[0], JSHAPES[rec["shape"]])
        assert rec["status"] == ("ok" if ok else "skip"), rec
        if not ok:
            assert rec["reason"] == why
            continue
        assert rec["n_devices"] == (512 if rec["mesh"] == "2x16x16" else 256)
        parts = [k for k in rec if k.endswith("_bytes_per_device")]
        want = {"params", "input", "opt_state" if rec["kind"] == "train" else "cache"}
        assert {k[: -len("_bytes_per_device")] for k in parts} == want
        assert rec["per_device_bytes"] == sum(rec[k] for k in parts)
    n_skip = sum(r["status"] == "skip" for r in recs)
    assert f"dryrun complete: {80 - n_skip} ok, {n_skip} skip, 0 error" in r.stdout

    part = tmp_path / "part.json"
    with open(part, "w") as f:
        json.dump([x for x in recs if x["arch"] != "whisper-small"], f)
    assert dryrun.main(["--mesh", "both", "--out", str(part), "--append"]) == 0
    with open(part) as f:
        again = json.load(f)
    assert len(again) == 80 and again[:72] == [x for x in recs if x["arch"] != "whisper-small"]
    assert [(x["arch"], x["shape"], x["mesh"]) for x in again[72:]] == [
        (x["arch"], x["shape"], x["mesh"]) for x in recs if x["arch"] == "whisper-small"]
