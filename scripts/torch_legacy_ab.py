#!/usr/bin/env python3
"""The port's legacy PRNG mode against its default mode on one NVIDIA card.

    python3 scripts/torch_legacy_ab.py           # the two modes in turns
    python3 scripts/torch_legacy_ab.py --phase   # chip_smoke.py's legacy phase alone

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Without ``--phase``: ``chip_smoke.phase_profile`` of MVCC/YCSB and
NOWAIT/SmallBank (codes 0, 63, 21, 42, kernel plane) in the order default,
legacy, legacy, default, then whole full-size runs of the same specs in the
order default, legacy, legacy, default, default, legacy; each line names its
mode, and the runs print their walls and counters.  With ``--phase``: the
default-mode runs whose walls ``chip_smoke.phase_legacy`` prints beside its
own (both main paths on both planes, four node shards of NOWAIT hybrid 63),
then the phase.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def default_walls(counted):
    """Wall s of the default-mode runs ``phase_legacy`` sets its own beside."""
    from repro_torch import api

    walls = {}
    for protocol, workload, golden_file in cs.PATHS:
        path = f"{protocol}/{workload}"
        res, got = cs.counted_run(cs.main_path_spec(protocol, workload, "kernel"), counted)
        cs.check_launches(path, protocol, res, got)
        cs.golden_counters(path, res, golden_file)
        walls[path] = res.wall_s
        walls[f"{path} torch"] = api.run(cs.main_path_spec(protocol, workload, "torch")).wall_s
    spec = api.ExperimentSpec(protocol="nowait", workload="smallbank", configs=[{"hybrid": 63}], kernel_plane="kernel",
                              layout="node", devices=cs.NODE_DEVICES)
    walls[cs.NODE_NOWAIT] = api.run(spec).row["wall_s"]
    return walls


def in_turns():
    from repro_torch import api
    from repro_torch.core import prng

    for protocol, workload in (("mvcc", "ycsb"), ("nowait", "smallbank")):
        for partitionable in (True, False, False, True):
            cs.log(f"== profile {protocol}/{workload} {'default' if partitionable else 'legacy'}")
            with prng.threefry_partitionable(partitionable):
                cs.phase_profile(protocol, workload, cs.CODES)
    for protocol, workload in (("mvcc", "ycsb"), ("nowait", "smallbank")):
        for partitionable in (True, False, False, True, True, False):
            with prng.threefry_partitionable(partitionable):
                res = api.run(cs.main_path_spec(protocol, workload, "kernel"))
            cs.log(f"== run {protocol}/{workload} {'default' if partitionable else 'legacy'}: {res.wall_s:.3f} s "
                   f"{[(r['commits'], r['aborts']) for r in res.rows]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_legacy_ab: CUDA is not available; this runs on an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.mvcc_version_select import mvcc_version_select

    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    _build.build()
    if "--phase" in sys.argv[1:]:
        counted = (lock_arbiter, multi_read, mvcc_version_select, flash_attention)
        walls = default_walls(counted)
        cs.log("default walls " + json.dumps(walls))
        t0 = time.perf_counter()
        launches = cs.phase_legacy(counted, walls)
        cs.log(f"phase_legacy wall {time.perf_counter() - t0:.1f} s")
        cs.log(json.dumps(launches))
    else:
        in_turns()
    return 0


if __name__ == "__main__":
    sys.exit(main())
