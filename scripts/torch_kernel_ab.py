"""A/B of hand-written CUDA kernel sources on the card, in one process.

    python3 scripts/torch_kernel_ab.py lock_arbiter A.cu B.cu [...]
    python3 scripts/torch_kernel_ab.py flash_attention A.cu B.cu [...]

Builds every source as the named kernel (its C entry point and argument
types from ``repro_torch.kernels._build``), holds each against the plain
version on every input, then times them graph-replayed in the order
A B ... B A.  Inputs:

* ``lock_arbiter``: the arbitration batches of both RCC main paths
  (kernel plane, hybrid 63, the last 40 of 60 ticks), and G = 1 batches at
  M = 480 and 2400 with keys uniform over 262144 records or all on one key;
* ``flash_attention``: the serving shape (B = 4, H = 32, S = 2048, Dh = 64,
  causal, float32, (B, S, H, Dh) views), checked within 1e-5.

Prints the card's name and power limit first.  Needs the card and nvcc;
builds into ``build/kernel_ab/``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def build(kernel, sources):
    from repro_torch.kernels import _build

    out_dir = os.path.join(ROOT, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    names = [os.path.splitext(os.path.basename(s))[0] for s in sources]
    if len(set(names)) != len(names):
        raise SystemExit("torch_kernel_ab: give sources distinct file names")
    procs = {n: subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{n}.so"), s],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, s in zip(names, sources)}
    fns = {}
    for n, p in procs.items():
        text, _ = p.communicate()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(n, line.strip())
        if p.returncode:
            raise SystemExit(f"torch_kernel_ab: {n} failed to build")
        sym, argtypes = _build.SIGNATURES[kernel]
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"{n}.so")), sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[n] = fn
    return fns


def arbiter_sets():
    """name -> list of (keys, hi, lo, active) batches on the card."""
    import torch

    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import ops

    sets, orig = {}, ops.lock_arbiter
    for protocol, workload in (("nowait", "smallbank"), ("mvcc", "ycsb")):
        got = []
        ops.lock_arbiter = lambda *a: (got.append([t.clone() for t in a]), orig(*a))[1]
        try:
            spec = cs.main_path_spec(protocol, workload, "kernel", codes=(63,))
            api.execute(api.plan(dataclasses.replace(spec, ticks=40, warmup=20)))
        finally:
            ops.lock_arbiter = orig
        sets[f"{protocol}/{workload} (M={got[-1][0].shape[1]})"] = got[-40:]
    gen = torch.Generator().manual_seed(0)
    for M in (480, 2400):
        sets[f"uniform keys, M={M}"] = [cs.arbiter_case(1, M, 262144, gen)]
        sets[f"one key, M={M}"] = [cs.arbiter_case(1, M, 1, gen)]
    return sets


def ab_lock_arbiter(fns):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ref import lock_arbiter_ref

    def call(f, args):
        keys, hi, lo, act = args
        won = torch.empty(keys.shape, dtype=torch.bool, device="cuda")
        err = f(keys.data_ptr(), hi.data_ptr(), lo.data_ptr(), act.data_ptr(), won.data_ptr(), None,
                keys.shape[0], keys.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return won

    for name, batches in arbiter_sets().items():
        for n, f in fns.items():
            bad = sum(int((call(f, b).cpu() != lock_arbiter_ref(*(t.cpu() for t in b))).sum()) for b in batches)
            if bad:
                raise AssertionError(f"{n} disagrees with the plain version on {name}: {bad} mismatches")
        ms = {n: [] for n in fns}
        for n in list(fns) + list(fns)[::-1]:
            it = iter(range(10**9))
            ms[n].append(cs.time_graph_ms(lambda: call(fns[n], batches[next(it) % len(batches)]), reps=200))
        print(f"lock_arbiter {name}: 0 mismatches over {len(batches)} batches; ms/call graph-replayed: "
              + ", ".join(f"{n} {' '.join(f'{t:.6f}' for t in v)}" for n, v in ms.items()), flush=True)


def ab_flash_attention(fns):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = cs.attn_inputs(4, 32, 2048, 2048, 64, torch.float32, torch.Generator().manual_seed(0), bshd=True)
    want = flash_attention_ref(q, k, v, causal=True)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, want) for s in t.stride()[:3]))

    def call(f):
        out = torch.empty_like(want)
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 4, 32, 2048, 2048, 64, strides,
                1.0 / math.sqrt(64), 1, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out

    for n, f in fns.items():
        err = float((call(f) - want).abs().max())
        if err > 1e-5 * (1 + float(want.abs().max())):
            raise AssertionError(f"{n} disagrees with the plain version: max |err| {err}")
    ms = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        ms[n].append(cs.time_graph_ms(lambda: call(fns[n]), reps=10))
    print("flash_attention (B=4, H=32, S=2048, Dh=64, causal, float32): within 1e-5; ms/call graph-replayed: "
          + ", ".join(f"{n} {' '.join(f'{t:.6f}' for t in v)}" for n, v in ms.items()), flush=True)


def main(argv):
    import torch

    if len(argv) < 2 or argv[0] not in ("lock_arbiter", "flash_attention"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    fns = build(argv[0], argv[1:])
    (ab_lock_arbiter if argv[0] == "lock_arbiter" else ab_flash_attention)(fns)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
