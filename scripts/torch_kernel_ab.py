"""A/B of hand-written CUDA kernel sources on the card, in one process.

    python3 scripts/torch_kernel_ab.py lock_arbiter A.cu B.cu [...]
    python3 scripts/torch_kernel_ab.py flash_attention A.cu B.cu [...]
    python3 scripts/torch_kernel_ab.py multi_read A.cu B.cu [...]
    python3 scripts/torch_kernel_ab.py mvcc_version_select A.cu B.cu [...]

Builds every source as the named kernel (its C entry point and argument
types from ``repro_torch.kernels._build``, or, for a source that exports
the parent tree's entry point instead, :data:`PARENT_ABI`), holds each
against the plain version on every input, then times them graph-replayed
in the order A B ... B A.  Inputs:

* ``lock_arbiter``: the arbitration batches of both RCC main paths
  (kernel plane, hybrid 63, the last 40 of 60 ticks), and G = 1 batches at
  M = 480 and 2400 with keys uniform over 262144 records or all on one key;
* ``flash_attention``: the serving shape (B = 4, H = 32, S = 2048, Dh = 64,
  causal, float32, (B, S, H, Dh) views), checked within 1e-5;
* ``multi_read``: the ``gather_many`` calls of both RCC main paths (kernel
  plane, hybrid 63, 60 ticks), the last 40 of each array set.
  A source with this tree's interface is timed as ``ops.gather_many``
  issues it (one launch over the store arrays in place); one with the
  parent's single-table interface as the parent issued it (the arrays
  concatenated into one packed table, one launch, column views);
* ``mvcc_version_select``: the fused version reads of the MVCC·YCSB main
  path (NOWAIT·SmallBank picks no versions), the last 40 with and the last
  40 without the lock.
  A source with this tree's interface is timed as ``ops.version_read``
  issues it (one launch); one with the parent's per-op interface as the
  parent's pick, op for op: the wts and lock pairs gathered through packed
  tables (with this tree's ``multi_read``), the copies, then the pick.

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

_P = ctypes.c_void_p
# the parent tree's C entry points of the kernels whose interface changed
PARENT_ABI = {
    # table, keys, out, R, A, M, stream
    "multi_read": ("rt_multi_read", [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]),
    # wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi, lock_lo, found, slot, ok, M, S, stream (all per op)
    "mvcc_version_select": ("rt_mvcc_version_select", [_P] * 9 + [ctypes.c_longlong, ctypes.c_int, _P]),
}


def build(kernel, sources):
    """label -> (C entry point, "this tree" or "parent"), one per source,
    all nvcc processes at once."""
    from repro_torch.kernels import _build

    out_dir = os.path.join(ROOT, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    bases = [os.path.basename(s) for s in sources]
    labels = bases if len(set(bases)) == len(bases) else list(sources)
    if len(set(labels)) != len(labels):
        raise SystemExit("torch_kernel_ab: give distinct sources")
    outs = [os.path.join(out_dir, f"{i}_{os.path.splitext(b)[0]}.so") for i, b in enumerate(bases)]
    procs = {n: subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", o, s],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, o, s in zip(labels, outs, sources)}
    fns = {}
    for (n, p), o in zip(procs.items(), outs):
        text, _ = p.communicate()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "stack" in line or "error" in line.lower():
                print(n, line.strip())
        if p.returncode:
            raise SystemExit(f"torch_kernel_ab: {n} failed to build")
        lib = ctypes.CDLL(o)
        (sym, argtypes), abi = _build.SIGNATURES[kernel], "this tree"
        if not hasattr(lib, sym) and kernel in PARENT_ABI:
            (sym, argtypes), abi = PARENT_ABI[kernel], "parent"
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[n] = (fn, abi)
        print(f"{n}: {sym} ({abi}'s interface)", flush=True)
    return fns


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def checked(err):
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def ab_times(fns, call, batches, reps):
    """ms per call graph-replayed, in the order A B ... B A, cycling through
    the batches: label -> [ms, ms]."""
    import chip_smoke as cs

    ms = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        it = iter(range(10**9))
        ms[n].append(cs.time_graph_ms(lambda: call(fns[n], batches[next(it) % len(batches)]), reps=reps))
    return ", ".join(f"{n} {' '.join(f'{t:.6f}' for t in v)}" for n, v in ms.items())


def captured(protocol, workload, attr):
    """The arguments of every ``repro_torch.kernels.ops.<attr>`` call in 60
    ticks (20 of warm-up) of a main path (kernel plane, hybrid 63), cloned,
    in the order of the calls; the modes keep the last 40 of each kind."""
    import torch

    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import ops

    got, orig = [], getattr(ops, attr)

    def spy(*a, **k):
        got.append([[t.clone() for t in x] if isinstance(x, (list, tuple)) else
                    (x.clone() if isinstance(x, torch.Tensor) else x) for x in a])
        return orig(*a, **k)

    setattr(ops, attr, spy)
    try:
        spec = cs.main_path_spec(protocol, workload, "kernel", codes=(63,))
        api.execute(api.plan(dataclasses.replace(spec, ticks=40, warmup=20)))
    finally:
        setattr(ops, attr, orig)
    return got


def arbiter_sets():
    """name -> list of (keys, hi, lo, active) batches on the card."""
    import torch

    import chip_smoke as cs

    sets = {}
    for protocol, workload in (("nowait", "smallbank"), ("mvcc", "ycsb")):
        got = captured(protocol, workload, "lock_arbiter")[-40:]
        sets[f"{protocol}/{workload} (M={got[-1][0].shape[1]})"] = got
    gen = torch.Generator().manual_seed(0)
    for M in (480, 2400):
        sets[f"uniform keys, M={M}"] = [cs.arbiter_case(1, M, 262144, gen)]
        sets[f"one key, M={M}"] = [cs.arbiter_case(1, M, 1, gen)]
    return sets


def ab_lock_arbiter(fns):
    import torch

    from repro_torch.kernels.ref import lock_arbiter_ref

    def call(f, args):
        keys, hi, lo, act = args
        won = torch.empty(keys.shape, dtype=torch.bool, device="cuda")
        checked(f[0](keys.data_ptr(), hi.data_ptr(), lo.data_ptr(), act.data_ptr(), won.data_ptr(), None,
                     keys.shape[0], keys.shape[1], stream()))
        return won

    for name, batches in arbiter_sets().items():
        for n, f in fns.items():
            bad = sum(int((call(f, b).cpu() != lock_arbiter_ref(*(t.cpu() for t in b))).sum()) for b in batches)
            if bad:
                raise AssertionError(f"{n} disagrees with the plain version on {name}: {bad} mismatches")
        print(f"lock_arbiter {name}: 0 mismatches over {len(batches)} batches; ms/call graph-replayed: "
              + ab_times(fns, call, batches, 200), flush=True)


def this_tree(fn, kernel):
    """Make ``fn`` the entry point that this tree's wrapper of ``kernel``
    launches (the wrapper loads each entry point once and keeps it)."""
    from repro_torch.kernels import _build

    _build._FNS[_build.SIGNATURES[kernel][0]] = fn


def gather_call(f, batch):
    """One gather of ``batch`` = (arrays, keys (N, K)) as the source's
    interface has it issued: this tree's ``ops.gather_many`` (one launch,
    in place), or the parent's (a packed table, one launch, column views).
    Returns the per-array results."""
    import torch

    from repro_torch.kernels import ops

    fn, abi = f
    arrs, keys = batch
    if abi == "this tree":
        this_tree(fn, "multi_read")
        return ops.gather_many(arrs, keys, plane=ops.KERNEL)
    kf = keys.reshape(-1)
    M, R = kf.shape[0], arrs[0].shape[0]
    cols = [a.reshape(R, -1) for a in arrs]
    table = cols[0].contiguous() if len(cols) == 1 else torch.cat(cols, dim=1)
    out = torch.empty((M, table.shape[1]), dtype=torch.int32, device="cuda")
    checked(fn(table.data_ptr(), kf.data_ptr(), out.data_ptr(), R, table.shape[1], M, stream()))
    outs, pos = [], 0
    for a, c in zip(arrs, cols):
        outs.append(out[:, pos:pos + c.shape[1]].reshape(tuple(keys.shape) + tuple(a.shape[1:])))
        pos += c.shape[1]
    return tuple(outs)


def ab_multi_read(fns):
    import torch

    from repro_torch.kernels.ref import gather_many_ref

    for protocol, workload in (("nowait", "smallbank"), ("mvcc", "ycsb")):
        sets = {}
        for arrs, keys in captured(protocol, workload, "gather_many"):
            name = f"{protocol}/{workload} (M={keys.numel()}, widths {[math.prod(a.shape[1:]) for a in arrs]})"
            sets.setdefault(name, []).append((arrs, keys))
        for name, batches in sets.items():
            batches = batches[-40:]
            for n, f in fns.items():
                for b in batches:
                    want = gather_many_ref(b[0], b[1].reshape(-1))
                    if not all(torch.equal(g.reshape(-1), w.reshape(-1)) for g, w in zip(gather_call(f, b), want)):
                        raise AssertionError(f"{n} disagrees with the plain version on {name}")
            print(f"multi_read {name}: exact over {len(batches)} batches; ms/call graph-replayed: "
                  + ab_times(fns, gather_call, batches, 200), flush=True)


def pick_call(f, batch):
    """One version pick of ``batch`` = (wts_hi, wts_lo, keys, ctts_hi,
    ctts_lo, lock_hi, lock_lo) as the source's interface has it issued:
    this tree's ``ops.version_read`` (one fused launch), or the parent's
    sequence (packed gathers, copies, per-op pick).  Returns (found, slot,
    ok or None) flat."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops

    fn, abi = f
    wh, wl, keys, ch, cl, lh, ll = batch
    if abi == "this tree":
        this_tree(fn, "mvcc_version_select")
        return tuple(None if t is None else t.reshape(-1) for t in ops.version_read(*batch)[:3])
    (N, K), S = keys.shape, wh.shape[1]
    M = N * K
    found = torch.empty((M,), dtype=torch.bool, device="cuda")
    slot = torch.empty((M,), dtype=torch.int32, device="cuda")
    ok = torch.empty((M,), dtype=torch.bool, device="cuda")
    vh, vl = cs.packed_gather((wh, wl), keys)
    z = torch.zeros((N, K), dtype=torch.int32, device="cuda")
    gh, gl = cs.packed_gather((lh, ll), keys) if lh is not None else (z, z)
    args = [a.contiguous() for a in (vh.reshape(-1, S), vl.reshape(-1, S), ch[:, None].expand(N, K).reshape(-1),
                                     cl[:, None].expand(N, K).reshape(-1), gh.reshape(-1), gl.reshape(-1))]
    checked(fn(*(a.data_ptr() for a in args), found.data_ptr(), slot.data_ptr(), ok.data_ptr(), M, S, stream()))
    return found, slot, ok if lh is not None else None


def ab_mvcc_version_select(fns):
    import torch

    from repro_torch.kernels.ref import version_read_ref

    sets = {}
    for args in captured("mvcc", "ycsb", "version_read"):
        args = list(args) + [None] * (7 - len(args))
        lock = "with" if args[5] is not None else "without"
        name = f"mvcc/ycsb (M={args[2].numel()}, S={args[0].shape[1]}, {lock} the lock)"
        sets.setdefault(name, []).append(args)
    for name, batches in sets.items():
        batches = batches[-40:]
        for n, f in fns.items():
            for b in batches:
                want = version_read_ref(*b)[:3]
                if not all(w is None or torch.equal(g, w.reshape(-1)) for g, w in zip(pick_call(f, b), want)):
                    raise AssertionError(f"{n} disagrees with the plain version on {name}")
        print(f"mvcc_version_select {name}: exact over {len(batches)} batches; ms/call graph-replayed: "
              + ab_times(fns, pick_call, batches, 200), flush=True)


def ab_flash_attention(fns):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = cs.attn_inputs(4, 32, 2048, 2048, 64, torch.float32, torch.Generator().manual_seed(0), bshd=True)
    want = flash_attention_ref(q, k, v, causal=True)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, want) for s in t.stride()[:3]))

    def call(f, _):
        out = torch.empty_like(want)
        checked(f[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 4, 32, 2048, 2048, 64, strides,
                     1.0 / math.sqrt(64), 1, 0, stream()))
        return out

    for n, f in fns.items():
        err = float((call(f, None) - want).abs().max())
        if err > 1e-5 * (1 + float(want.abs().max())):
            raise AssertionError(f"{n} disagrees with the plain version: max |err| {err}")
    print("flash_attention (B=4, H=32, S=2048, Dh=64, causal, float32): within 1e-5; ms/call graph-replayed: "
          + ab_times(fns, call, [None], 10), flush=True)


def main(argv):
    import torch

    modes = {"lock_arbiter": ab_lock_arbiter, "flash_attention": ab_flash_attention, "multi_read": ab_multi_read,
             "mvcc_version_select": ab_mvcc_version_select}
    if len(argv) < 2 or argv[0] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    modes[argv[0]](build(argv[0], argv[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
