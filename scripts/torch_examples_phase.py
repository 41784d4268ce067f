#!/usr/bin/env python3
"""``chip_smoke.py``'s examples phase alone, on one NVIDIA card.

    python3 scripts/torch_examples_phase.py

Builds the kernels, then runs ``chip_smoke.phase_examples``: the user entry
points (``examples/torch_{quickstart,hybrid_search,txn_serving,train_lm}.py``
and ``scripts/torch_dev_smoke.py --fast``) at their own defaults against
``golden_examples.json``, each path's launches counted, the first calls of
each kernel signature held to the plain versions and timed.  About 4
minutes with the build; the quick check of a change to an entry point
before the whole smoke.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_examples_phase: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.mvcc_version_select import mvcc_version_select

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(card)
    t0 = time.perf_counter()
    _build.build()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, _, _ = cs.phase_examples((lock_arbiter, multi_read, mvcc_version_select, flash_attention))
    cs.log(f"phase_examples: {time.perf_counter() - t0:.1f} s, launches {launches}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
