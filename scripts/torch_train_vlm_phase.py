#!/usr/bin/env python3
"""``chip_smoke.py``'s M-RoPE VLM training phase (``train vlm``) alone, on
one NVIDIA card.

    python3 scripts/torch_train_vlm_phase.py

Runs ``chip_smoke.phase_train_vlm``: qwen2-vl-72b at full width, 1 of its
80 layers, against its golden gradient file (one 2048-token request with a
1 x 32 x 32 image grid), then 3 AdamW steps of 2 accumulated microbatches
of 1 x 2048 (``chip_smoke.TRAIN_VLM``) and one profiled beside its bound.
No hand-written kernel lies on this path, so nothing is built.  The quick
check of a change to the VLM training path, the optimizer or the
accumulation before the whole smoke.
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
        print("torch_train_vlm_phase: CUDA is not available", file=sys.stderr)
        return 1
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
    got = cs.phase_train_vlm((lock_arbiter, multi_read, mvcc_version_select, flash_attention))
    cs.log(f"phase_train_vlm: {time.perf_counter() - t0:.1f} s, launches {got}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
