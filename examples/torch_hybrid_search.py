"""Exhaustive hybrid-protocol search (paper §5's expert/common interface)
on the PyTorch/CUDA port (port of ``examples/hybrid_search.py``).

Enumerates all 2^6 stage-primitive codings for a protocol x workload and
prints the ranking: "solid evidence of the best hybrid design instead of
guess and try" (paper).  Common users: run with defaults.  Expert users:
pass --code to evaluate one specific design.

    PYTHONPATH=src python examples/torch_hybrid_search.py --protocol sundial --workload smallbank --top 8
    PYTHONPATH=src python examples/torch_hybrid_search.py --device cpu --ticks 16

The reference runs one ``run_cell`` per code; here the 64 codes are ONE
``repro_torch.api`` plan, a single bucket that runs as one batched tick
loop (its rows equal the sequential cells', bitwise in the counters).  The
cell is the reference's: 4 nodes x 40 co-routines, 65536 records a node,
80 warm-up ticks (60 co-routines for --code, as ``run_cell``'s default).
"""
from __future__ import annotations

import argparse
import os
import sys

# runnable as `python examples/torch_hybrid_search.py` from a checkout
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.api import ExperimentSpec, all_hybrid_codes, run  # noqa: E402
from repro_torch.core.costmodel import N_HYBRID_STAGES, STAGE_NAMES  # noqa: E402

CELL = dict(n_nodes=4, coroutines=40, records_per_node=65536, warmup=80)


def search(protocol: str = "sundial", workload: str = "smallbank", ticks: int = 160, *, device: str = "cuda",
           codes=None, **cell):
    """Every code's row (``codes``: all 64 by default, in bitmask order),
    one batched ``api.run`` at the reference's cell (``cell`` overrides)."""
    codes = all_hybrid_codes() if codes is None else codes
    spec = ExperimentSpec(protocol=protocol, workload=workload, configs=[{"hybrid": c} for c in codes], ticks=ticks,
                          device=device, **dict(CELL, **cell))
    return run(spec).rows


def rank(rows):
    """The reference's ranking: (throughput, latency, code) tuples sorted
    best first."""
    return sorted(((m["throughput_mtps"], m["avg_latency_us"], m["hybrid"]) for m in rows), reverse=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", default="sundial")
    ap.add_argument("--workload", default="smallbank")
    ap.add_argument("--code", default=None, help="e.g. 010110 (1 = one-sided per stage)")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=160)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    stages = ",".join(STAGE_NAMES[:N_HYBRID_STAGES])
    if args.code:
        code = tuple(int(c) for c in args.code)
        (m,) = search(args.protocol, args.workload, args.ticks, device=args.device, codes=[code], coroutines=60)
        print(f"code={args.code} ({stages})")
        print(f"  throughput={m['throughput_mtps'] * 1e3:.1f} Ktps latency={m['avg_latency_us']:.2f}us "
              f"aborts={m['abort_rate']:.3f}")
        return [m]

    rows = search(args.protocol, args.workload, args.ticks, device=args.device)
    print(f"  searched {len(rows)}/{2 ** N_HYBRID_STAGES} in one batched run ({rows[0]['wall_s']:.2f} s)")
    results = rank(rows)
    print(f"top {args.top} hybrid designs for {args.protocol} on {args.workload} (stages: {stages}):")
    for thr, lat, code in results[: args.top]:
        print(f"  code={code}  {thr * 1e3:8.1f} Ktps  {lat:6.2f} us")
    print(f"worst: code={results[-1][2]}  {results[-1][0] * 1e3:.1f} Ktps")
    return rows


if __name__ == "__main__":
    main()
