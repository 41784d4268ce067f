"""A/B of two trees of the port on the card: what one batched tick costs.

    python3 scripts/torch_tick_ab.py A_DIR B_DIR [--ticks 40]

A_DIR and B_DIR are checkouts of the repository, each holding
``src/repro_torch``.  Each is run in a process of its own, in the order
A B B A, and each run profiles NOWAIT/SmallBank and MVCC/YCSB on the kernel
plane with ``chip_smoke.phase_profile`` of THIS tree (the same measurement
for both): hybrid 63 alone (G = 1), then the four codes {0, 63, 21, 42}
as one bucket (G = 4).  Each profile prints one ``profile:`` JSON line:
wall ms per tick, device busy ms per tick, the device's idle share, device
operations and top-level host operations per tick.  The card's name and
power limit come first.  Needs the card and nvcc; each tree builds its
kernels into its own ``build/``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
from repro_torch.kernels import _build
_build.build()
for protocol, workload in (("nowait", "smallbank"), ("mvcc", "ycsb")):
    for codes in ((63,), chip_smoke.CODES):
        chip_smoke.phase_profile(protocol, workload, codes, n_ticks={ticks})
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="tree A (a checkout of the repository)")
    ap.add_argument("b", help="tree B")
    ap.add_argument("--ticks", type=int, default=40, help="ticks timed, then ticks traced, per profile")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for label, tree in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
        src = os.path.join(os.path.abspath(tree), "src")
        print(f"--- {label}: {src}", flush=True)
        code = CHILD.format(root=ROOT, src=src, ticks=args.ticks)
        subprocess.run([sys.executable, "-c", code], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
