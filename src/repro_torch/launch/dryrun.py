"""Dry run of every (arch x shape x mesh) cell on the production meshes
(port of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --mesh both --out dryrun_results.json

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's cost and memory analyses.  The port has no
compiler: its dry run lays the cell's parameters, optimizer state (train),
cache (prefill, decode) and inputs out on the logical production mesh
(``launch.mesh.make_production_mesh``, ``meta`` devices) under the cell's
rules (``rules_for``), and reports each device's bytes of them, on
``meta`` tensors only: it needs no card, draws nothing and allocates
nothing.  The fields only XLA gives
(``compile_s``, ``cost``, ``memory``, ``per_device_bytes_est``, the HLO
collectives) and ``--calibrate`` are not produced.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import numpy as np

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import cache_structs, input_specs, param_structs
from repro_torch.optim import make_optimizer, opt_state_specs
from repro_torch.sharding import AxisRules

# sequence-parallel prefill rules: weights replicate over `model`; the sequence dim shards instead
SEQ_PAR_RULES = {
    "seq": ("model",),
    "heads": None,
    "kv_heads": None,
    "ff": None,
    "fsdp": ("data",),
}


def rules_for(cfg, shape, overrides):
    if shape.kind == "prefill" and cfg.seq_parallel_prefill:
        return {**overrides, **SEQ_PAR_RULES}
    if shape.kind in ("prefill", "decode") and not cfg.serve_fsdp:
        # no FSDP at serve time (it would gather weights every step)
        return {**overrides, "fsdp": None}
    return overrides


def device_bytes(shapes, shards) -> int:
    """Bytes one device holds of a tree of meta tensors under their
    shardings (each leaf's shard shape times its item size)."""
    if isinstance(shards, dict):
        return sum(device_bytes(shapes[k], v) for k, v in shards.items())
    if isinstance(shards, list):
        return sum(device_bytes(a, b) for a, b in zip(shapes, shards))
    return int(np.prod(shards.shard_shape)) * shapes.element_size()


def _opt_structs(optimizer, p_shapes):
    """The optimizer's state over the parameter tree, as meta tensors in
    the tree's layout: ``optimizer.init`` on the tree's leaves by path."""
    flat = {"/".join(map(str, path)): t for path, t in convert._leaves(p_shapes)}
    return {k: _rebuild(p_shapes, (), named) for k, named in optimizer.init(flat).items()}


def _rebuild(node, path, named):
    if isinstance(node, list):
        return [_rebuild(v, path + (i,), named) for i, v in enumerate(node)]
    if isinstance(node, dict):
        return {k: _rebuild(v, path + (k,), named) for k, v in node.items()}
    return named["/".join(map(str, path))]


def per_device_param_bytes(cfg, overrides) -> int:
    """Exact per-device parameter bytes on the single-pod mesh under the resolved shardings."""
    shd = AxisRules(make_production_mesh(multi_pod=False), overrides)
    p_shapes, _, p_shards = param_structs(cfg, shd)
    return device_bytes(p_shapes, p_shards)


def lay_out_cell(arch_id: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """Lay one cell's state out on the production mesh: per-device bytes by part."""
    cfg, overrides = get_config(arch_id)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    shd = AxisRules(mesh, rules_for(cfg, shape, overrides))
    p_shapes, p_specs, p_shards = param_structs(cfg, shd)
    batch, b_shards = input_specs(cfg, shape, shd)
    out = {"n_devices": mesh.size, "params_bytes_per_device": device_bytes(p_shapes, p_shards),
           "input_bytes_per_device": device_bytes(batch, b_shards)}
    if shape.kind == "train":
        opt_shapes = _opt_structs(make_optimizer(cfg.optimizer), p_shapes)
        o_shards = shd.resolve_tree(opt_shapes, opt_state_specs(cfg.optimizer, p_specs))
        out["opt_state_bytes_per_device"] = device_bytes(opt_shapes, o_shards)
    else:
        c_shapes, _, c_shards = cache_structs(cfg, shape, shd)
        out["cache_bytes_per_device"] = device_bytes(c_shapes, c_shards)
    out["per_device_bytes"] = sum(v for k, v in out.items() if k.endswith("_bytes_per_device"))
    return out


def run_cell(arch_id: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    cfg, _ = get_config(arch_id)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    t0 = time.perf_counter()
    try:
        rec.update(lay_out_cell(arch_id, shape_name, multi_pod), status="ok")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if key in done:
                    continue
                print(f"=== dryrun {key} ===", flush=True)
                rec = run_cell(arch, shape, mp)
                extra = rec.get("reason") or rec.get("error") or ""
                print(f"    -> {rec['status']} {extra}", flush=True)
                if rec["status"] == "ok":
                    print(f"    per device: {rec['per_device_bytes']:,} bytes "
                          f"(params {rec['params_bytes_per_device']:,})", flush=True)
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"dryrun complete: {n_ok} ok, {n_skip} skip, {n_err} error -> {args.out}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
