#!/usr/bin/env python3
"""``chip_smoke.py``'s kimi-k2 serving phase alone, on one NVIDIA card.

    python3 scripts/torch_kimi_phase.py

Builds the kernels, holds ``flash_attention`` against its plain version at
kimi-k2-1t-a32b's prefill call (B 1, H 64 after the GQA repeat, S 2048,
Dh 112, causal) and times it beside SDPA (``chip_smoke.flash_timing``), then
runs ``chip_smoke.phase_serve_kimi``: the model at full width, 1 of its 61
layers (77.5 GB of float32 weights), against its golden file, profiled, and
served on both planes.  The quick check of a change to the kimi path before
the whole smoke.
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
        print("torch_kimi_phase: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.mvcc_version_select import mvcc_version_select
    from repro_torch.kernels.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(card)
    t0 = time.perf_counter()
    _build.build()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(0)
    cfg = get_config(cs.KIMI_ARCH)[0]
    B, S = cs.KIMI_SERVE["batch"], cs.KIMI_SERVE["prompt_len"]
    q, k, v = cs.attn_inputs(B, cfg.n_heads, S, S, cfg.head_dim, torch.float32, gen, bshd=True)
    err = float((flash_attention(q, k, v, causal=True) - flash_attention_ref(q, k, v, causal=True)).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"flash_attention at kimi-k2's call: max |err| {err}")
    del q, k, v
    cs.flash_timing(gen, f"{cs.KIMI_SERVE_PATH}, max |err| vs plain {err:.3e}", B, cfg.n_heads, S, cfg.head_dim)
    t0 = time.perf_counter()
    got = cs.phase_serve_kimi((lock_arbiter, multi_read, mvcc_version_select, flash_attention))
    cs.log(f"phase_serve_kimi: {time.perf_counter() - t0:.1f} s, launches {got}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
