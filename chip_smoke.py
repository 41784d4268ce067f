#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card and
``nvcc``.  In order, one line (or block) per phase:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the hand-written CUDA kernels built from ``src/repro_torch/kernels/csrc``
   (one nvcc process per source, all at once);
3. each kernel held against its plain PyTorch version on the card (the
   RCC kernels exactly; ``flash_attention`` within 1e-5 in float32 and
   3e-2 in bfloat16) at every main path's shapes and at edge cases, then,
   at each main path's shapes, its device time per call (calls captured in
   a CUDA graph, replayed between CUDA events), its time per call as the
   host issues them eagerly, its bound, the plain version's times and a
   library call's times (``flash_attention``: SDPA; ``multi_read``: the
   per-array ``a[keys]`` of the torch plane).  ``multi_read`` and
   ``mvcc_version_select`` are timed as the whole ops-level call
   (``ops.gather_many``, ``ops.version_read``), which the profiler must see
   as one launch, beside the parent tree's sequence for the same call
   rebuilt op for op with this tree's kernels (a packed-table gather; the
   gathers, copies and per-op pick); then one tick of each RCC main path
   (NOWAIT/SmallBank and MVCC/YCSB, hybrid 63, kernel plane) timed bare
   and traced with torch.profiler: wall time, device busy time, device
   operations, ``torch.cat`` launches and top-level host operations per
   tick (and, for YCSB, the share of its sequential key de-duplication);
4. the RCC main paths: ``repro_torch.api.run`` at the full ExperimentSpec
   defaults (4 nodes x 60 co-routines, 65536 records per node, 400 + 80
   ticks) for hybrid codes {0, 63, 21, 42} on the ``"kernel"`` plane, with
   the kernels' launch counts, for NOWAIT/SmallBank and then MVCC/YCSB
   (16-word records, 10 ops per txn, 4 version slots);
5. the same specs on the ``"torch"`` plane (MVCC/YCSB for hybrid 63 only),
   whose counters must be equal;
6. phase 4's counters against the JAX reference's golden files;
7. the LM serving path, stablelm-1.6b at full width in float32 with TF32
   off: ``init_lm`` from seed 0 on the card (checked against the reference's
   weights), a 2 x 256-token, 8-step run against the JAX reference's
   full-width golden file, a profiled prefill and decode step (device busy
   time and idle share), then the main path ``serve`` (4 prompts of 2048
   tokens, 32 tokens each) on the ``"kernel"`` plane, whose prefill must
   launch ``flash_attention`` once per layer, and on the ``"torch"`` plane,
   whose prefill logits and decided greedy tokens must agree.

It prints a JSON line of kernel measurements (each kernel's times are the
mean over its main-path launches; ``by_path`` holds them per main path),
then, last, one JSON line
``{"ok": true, "device": {...}}``.  Any mismatch or fault raises: the exit
code is then not 0 and the last line is not printed.  Without CUDA it
exits 1 at once.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CODES = (0, 63, 21, 42)
# main paths: (protocol, workload, golden file, the torch plane's codes)
PATHS = (
    ("nowait", "smallbank", "golden_nowait_smallbank.json", CODES),
    ("mvcc", "ycsb", "golden_mvcc_ycsb.json", (63,)),
)
# kernel launches per tick on each path's kernel plane: one multi_read per gather_many (GATHERS) and
# one mvcc_version_select per fused version read (PICKS)
PER_TICK = {
    "nowait": {"lock_arbiter": 1, "multi_read": 2, "mvcc_version_select": 0, "flash_attention": 0},
    "mvcc": {"lock_arbiter": 1, "multi_read": 5, "mvcc_version_select": 3, "flash_attention": 0},
}
R_RECORDS = 4 * 65536  # the RCC main paths' store rows
# each main path's gather_many calls per tick on the kernel plane: (N, K, {what: (the arrays' shapes
# after R, calls per tick)}).  MVCC: the read effect's rts_hi; the rts pair of the read and lock
# effects' Cond W1 checks and try_lock's lock pair; the commit's wts_hi|wts_lo|ver
GATHERS = {
    "nowait/smallbank": (240, 2, {"lock_hi|lock_lo": (((), ()), 1), "data|ver (rw 2)": (((2,), ()), 1)}),
    "mvcc/ycsb": (240, 10, {"rts_hi": (((),), 1), "rts or lock pair": (((), ()), 3),
                            "wts_hi|wts_lo|ver": (((4,), (4,), ()), 1)}),
}
# the MVCC main path's fused version reads per tick: ((N, K, S), {with the lock: reads per tick}):
# the read and rts effects check the lock, the lock effect does not
PICKS = {"mvcc/ycsb": ((240, 10, 4), {True: 2, False: 1})}
# H100 SXM peaks: the HBM3 rate (NVIDIA data sheet), and the INT32 issue rate
# that bounds integer compares and selects: 132 SMs x 64 INT32 lanes per SM x
# 1.98 GHz boost clock = 16.7e12 ops/s (the data sheet's 67 TFLOP/s float32
# counts an FMA as two flops on 128 FP32 lanes per SM; a Hopper SM has 64
# INT32 lanes)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 FMA outside the tensor cores (NVIDIA data sheet, H100 SXM): the flash_attention bound
FP32_FLOPS_PER_S = 67e12
# the LM serving main path: stablelm-1.6b at full width, float32
SERVE = dict(batch=4, prompt_len=2048, gen_len=32, page_size=16)
SERVE_PATH = "serve/stablelm-1.6b"
# logits tolerance of the serving phase (absolute; logits have std 0.88).  The port
# on the CPU is within 7.9e-6 of the JAX reference at full width (the golden file's
# port_cpu_max_abs_logit_gap); 1e-4 leaves 12x that for the card's other summation
# order (cuBLAS float32 products, the kernel's online softmax).  Greedy tokens must
# agree wherever the top-1/top-2 margin exceeds 10x this.
LOGIT_TOL = 1e-4


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, *, reps=200, warm=10):
    """Milliseconds per call as the host issues them back to back: CUDA
    events around ``reps`` eager calls (launch and host overheads included)."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, *, reps=100):
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, so no host work is timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops, ops_per_s=INT32_OPS_PER_S):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the card's peak rate for their type (integer
    operations by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


I32_WORDS = (-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1)


def arbiter_case(G, M, n_keys, gen, *, ties=False, pad=False, extremes=False):
    """A random arbitration batch (narrow hi, so lo often decides; 70 %
    active); ``ties`` makes pairs share (hi, lo), ``pad`` adds a tail of
    inactive -1 keys, ``extremes`` draws keys, hi and lo from the int32
    extremes; n_keys = 1 puts every request on one key."""
    import torch

    keys = torch.randint(0, max(n_keys, 1), (G, M), generator=gen, dtype=torch.int32)
    hi = torch.randint(-3, 4, (G, M), generator=gen, dtype=torch.int32)  # narrow: lo decides
    lo = torch.stack([torch.randperm(M, generator=gen) for _ in range(G)]).to(torch.int32) if M else \
        torch.zeros((G, 0), dtype=torch.int32)
    if ties:
        lo = lo // 2  # pairs share (hi, lo): several winners per key
    if extremes:
        words = torch.tensor(I32_WORDS, dtype=torch.int32)
        keys, hi, lo = (words[torch.randint(0, len(I32_WORDS), (G, M), generator=gen)] for _ in range(3))
    act = torch.rand((G, M), generator=gen) < 0.7
    if pad and M:
        keys[:, -max(1, M // 4):] = -1
        act[:, -max(1, M // 4):] = False
    return [t.cuda() for t in (keys, hi, lo, act)]


def timed(fn, plain, library=None):
    """Device ms per call (graph-replayed) and ms per call issued eagerly,
    for a kernel, its plain version and, where there is one, a library call."""
    t = {"ms": time_graph_ms(fn), "plain_ms": time_graph_ms(plain),
         "host_ms": time_ms(fn), "plain_host_ms": time_ms(plain)}
    t["library_ms"] = time_graph_ms(library) if library else None
    t["library_host_ms"] = time_ms(library) if library else None
    return t


def mix(parts):
    """The launch-weighted mean of timing rows: [(weight, row), ...]; a
    key that some row lacks (None) stays None; bound_by is that of the
    largest weighted bound."""
    total = sum(w for w, _ in parts)
    out = {}
    for k, v in parts[0][1].items():
        if isinstance(v, (int, float)) and all(r.get(k) is not None for _, r in parts):
            out[k] = sum(w * r[k] for w, r in parts) / total
        elif k != "bound_by":
            out[k] = v if len(parts) == 1 else None
    out["bound_by"] = max(parts, key=lambda p: p[0] * p[1]["bound_ms"])[1]["bound_by"]
    return out


def phase_kernels():
    """Each kernel against its plain version on the card, exactly, at every
    main path's shapes and at edge cases, then timed at each main path's
    shapes.  Returns the kernels' measurement rows (without ``launches``),
    each with ``by_path``: its numbers at each main path's shapes."""
    import torch

    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.ref import lock_arbiter_ref

    gen = torch.Generator().manual_seed(0)
    rows = []

    # lock_arbiter: G = 1, M = N*K over 262144 records (NOWAIT 480, MVCC 2400)
    worst = 0
    cases = [
        dict(G=1, M=480, n_keys=262144), dict(G=1, M=480, n_keys=64), dict(G=1, M=480, n_keys=64, ties=True),
        dict(G=1, M=2400, n_keys=262144), dict(G=1, M=2400, n_keys=262144, ties=True),
        dict(G=1, M=2400, n_keys=262144, pad=True), dict(G=1, M=2400, n_keys=600, ties=True),
        dict(G=3, M=37, n_keys=9, pad=True), dict(G=3, M=1, n_keys=1), dict(G=1, M=0, n_keys=1),
        dict(G=1, M=2048, n_keys=300, ties=True), dict(G=2, M=2048, n_keys=40, pad=True),
        # one hot key, with and without exact ties; int32 extremes; the global-memory table (M > 4096)
        dict(G=1, M=2400, n_keys=1), dict(G=1, M=2400, n_keys=1, ties=True),
        dict(G=1, M=2400, n_keys=0, extremes=True), dict(G=2, M=480, n_keys=0, extremes=True, pad=True),
        dict(G=2, M=12000, n_keys=262144), dict(G=2, M=12000, n_keys=50, ties=True, pad=True),
    ]
    for c in cases:
        args = arbiter_case(c["G"], c["M"], c["n_keys"], gen, ties=c.get("ties", False), pad=c.get("pad", False),
                            extremes=c.get("extremes", False))
        got = lock_arbiter(*args)
        # the reference's (G, M, M) pair tensor at M = 12000 is 288 MB a group: take it a group at a time
        want = torch.cat([lock_arbiter_ref(*(a[g:g + 1] for a in args)) for g in range(c["G"])]) if c["M"] > 4096 \
            else lock_arbiter_ref(*args)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        worst = max(worst, bad)
        log(f"  lock_arbiter {c}: {bad} mismatches, {int(want.sum())} winners")
        if bad:
            raise AssertionError(f"lock_arbiter disagrees with its plain version at {c}")
    by_path = {}
    for path, M in (("nowait/smallbank", 480), ("mvcc/ycsb", 2400)):
        args = arbiter_case(1, M, 262144, gen)
        t = timed(lambda: lock_arbiter(*args), lambda: lock_arbiter_ref(*args))
        # the function's least work: one pass over 3 int32 + 1 bool in and 1 bool out per request
        t["bound_ms"], t["bound_by"] = bound_ms(M * 14, 0)
        log(f"lock_arbiter ({path}: G=1, M={M}): {t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued "
            f"eagerly), plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), "
            f"bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
        by_path[path] = dict(t, M=M)
    rows.append(dict(
        name="lock_arbiter", route="cuda", source="src/repro_torch/kernels/csrc/lock_arbiter.cu",
        replaces="src/repro/kernels/lock_arbiter.py:41", max_abs_err=float(worst), by_path=by_path,
    ))

    rows.append(phase_multi_read(gen))
    rows.append(phase_version_select(gen))
    rows.append(phase_flash(gen))
    return rows


def version_case(M, S, gen, kind="random"):
    """A version-select batch: narrow words (ties, empty slots, ctts equal
    to a wts all occur), or one edge case."""
    import torch

    def ints(*shape, lo=-2, hi=3):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    wh, wl, ch, cl, lh, ll = ints(M, S), ints(M, S), ints(M), ints(M), ints(M, lo=-1, hi=2), ints(M, lo=-1, hi=2)
    if kind == "empty":
        wh.zero_()
        wl.zero_()
    elif kind == "ctts_eq" and M:
        pick = torch.randint(0, S, (M,), generator=gen)
        ch, cl = wh[torch.arange(M), pick].clone(), wl[torch.arange(M), pick].clone()
    elif kind == "ties":  # slots 1 .. S//2 tie on the winning pair: the first (slot 1) must win
        wh[:, : S // 2 + 1], wl[:, : S // 2 + 1] = 1, 1
        wh[:, 0] = 0
        ch.fill_(1)
        cl.fill_(2)
    elif kind == "lock_eq":
        lh, ll = ch.clone(), cl.clone()
    elif kind == "extremes":
        words = torch.tensor([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], dtype=torch.int32)
        wh, wl = (words[torch.randint(0, 7, (M, S), generator=gen)] for _ in range(2))
        ch, cl, lh, ll = (words[torch.randint(0, 7, (M,), generator=gen)] for _ in range(4))
    elif kind == "engine":  # the main path's inputs: (hi, lo) = (clock, slot id + 1), slot 0 seeded (0, 1)
        wh = torch.randint(0, 400, (M, S), generator=gen, dtype=torch.int32)
        wl = torch.randint(1, 241, (M, S), generator=gen, dtype=torch.int32)
        wh[:, 0], wl[:, 0] = 0, 1
        ch = torch.randint(0, 400, (M,), generator=gen, dtype=torch.int32)
        cl = torch.randint(1, 241, (M,), generator=gen, dtype=torch.int32)
        free = torch.rand((M,), generator=gen) < 0.8
        lh = torch.where(free, 0, torch.randint(0, 400, (M,), generator=gen, dtype=torch.int32))
        ll = torch.where(free, 0, torch.randint(1, 241, (M,), generator=gen, dtype=torch.int32))
    return [t.cuda() for t in (wh, wl, ch, cl, lh, ll)]


def read_case(R, N, K, S, gen, kind="narrow"):
    """A fused version read's inputs on the card: the store's wts (R, S) and
    lock (R,) words, keys (N, K) in [-3, R+3) and one ctts pair per row of
    keys.  ``narrow`` words (empty slots, ties, ctts == wts, lock == ctts
    all occur), ``engine`` the main path's (hi, lo) = (clock, slot id + 1)
    words, ``extremes`` int32 extremes, ``ties`` slots 1 .. S//2 tied on
    the winning pair, ``empty`` every slot (0, 0); ``unaligned`` narrow
    words in views 4 bytes past a 16-byte boundary (the scalar path)."""
    import torch

    def ints(*shape, lo=-1, hi=3):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    wh, wl, lh, ll, ch, cl = ints(R, S), ints(R, S), ints(R), ints(R), ints(N), ints(N)
    if kind == "engine":
        wh, wl = ints(R, S, lo=0, hi=400), ints(R, S, lo=1, hi=241)
        wh[:, 0], wl[:, 0] = 0, 1
        ch, cl = ints(N, lo=0, hi=400), ints(N, lo=1, hi=241)
        free = torch.rand((R,), generator=gen) < 0.8
        lh, ll = torch.where(free, 0, ints(R, lo=0, hi=400)), torch.where(free, 0, ints(R, lo=1, hi=241))
    elif kind == "extremes":
        words = torch.tensor(I32_WORDS, dtype=torch.int32)
        wh, wl = (words[torch.randint(0, 7, (R, S), generator=gen)] for _ in range(2))
        lh, ll = (words[torch.randint(0, 7, (R,), generator=gen)] for _ in range(2))
        ch, cl = (words[torch.randint(0, 7, (N,), generator=gen)] for _ in range(2))
    elif kind == "ties":
        wh[:, : S // 2 + 1], wl[:, : S // 2 + 1] = 1, 1
        wh[:, 0] = 0
        ch.fill_(1)
        cl.fill_(2)
    elif kind == "empty":
        wh.zero_()
        wl.zero_()
    keys = torch.randint(-3, R + 3, (N, K), generator=gen, dtype=torch.int32).cuda()
    wh, wl, lh, ll, ch, cl = (t.cuda() for t in (wh, wl, lh, ll, ch, cl))
    if kind == "unaligned":
        wh, wl, lh, ll = (unaligned(t) for t in (wh, wl, lh, ll))
    return wh, wl, lh, ll, keys, ch, cl


def unaligned(t):
    """``t``'s values in storage that starts 4 bytes past a 16-byte
    boundary: a contiguous view that the 16-byte paths must refuse."""
    import torch

    flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


def packed_gather(arrs, keys):
    """The parent tree's ``ops.gather_many`` on the kernel plane, op for op,
    with this tree's kernel: the whole store arrays concatenated into one
    packed (R, A) table, one one-array gather, column views shaped like
    the keys."""
    import torch

    from repro_torch.kernels.multi_read import multi_read

    R = arrs[0].shape[0]
    cols = [a.reshape(R, -1) for a in arrs]
    table = cols[0].contiguous() if len(cols) == 1 else torch.cat(cols, dim=1)
    out = multi_read(table, keys.reshape(-1).contiguous())
    outs, pos = [], 0
    for a, c in zip(arrs, cols):
        outs.append(out[:, pos:pos + c.shape[1]].reshape(tuple(keys.shape) + tuple(a.shape[1:])))
        pos += c.shape[1]
    return tuple(outs)


def parent_pick(wh, wl, keys, ch, cl, lh=None, ll=None):
    """The parent tree's kernel-plane version pick, op for op, with this
    tree's kernels: the wts pair and the lock pair gathered through packed
    tables (``packed_gather``), a zero lock filled in when there is none,
    ctts expanded to one pair per op, every input copied contiguous, then
    the pick over per-op rows."""
    import torch

    from repro_torch.kernels.mvcc_version_select import mvcc_version_select

    shp, S = tuple(keys.shape), wh.shape[1]
    vh, vl = packed_gather((wh, wl), keys)
    z = torch.zeros(shp, dtype=torch.int32, device=keys.device)
    gh, gl = packed_gather((lh, ll), keys) if lh is not None else (z, z)

    def flat(a):
        return a.expand(shp).reshape(-1)

    args = (vh.reshape(-1, S), vl.reshape(-1, S), flat(ch[:, None]), flat(cl[:, None]), flat(gh), flat(gl))
    return mvcc_version_select(*(a.contiguous() for a in args))


def one_device_op(fn, kernel):
    """Profile one call of ``fn``: it must issue exactly one device
    operation, a launch of ``kernel`` (no copy, no fill, no cat)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(dev) != 1 or kernel + "_kernel" not in dev[0]:
        raise AssertionError(f"one call must be one {kernel} launch, the device ran {dev}")


def phase_multi_read(gen):
    """multi_read against its plain version on the card, exactly: 1 to 4
    arrays of widths 1 to 16 read in place, keys in [-3, R+3), M = 0, 480,
    2400 and 12000, views that are not 16-byte aligned, and the one-array
    packed-table call.  Then, at each main path's gather_many calls, the
    whole ops-level call on the kernel plane (one launch, checked with the
    profiler) against the torch plane's per-array ``a[keys]`` (the library
    call), the plain version and the parent's packed sequence."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.multi_read import multi_read, multi_read_many
    from repro_torch.kernels.ref import gather_many_ref, multi_read_ref

    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int32).cuda()

    worst = 0

    def check(got, want, label):
        nonlocal worst
        torch.cuda.synchronize()
        if [tuple(g.shape) for g in got] != [tuple(w.shape) for w in want]:
            raise AssertionError(f"multi_read {label}: shapes {[g.shape for g in got]} != {[w.shape for w in want]}")
        err = max((int((g.long() - w.long()).abs().max()) for g, w in zip(got, want) if w.numel()), default=0)
        worst = max(worst, err)
        if err or not all(g.is_contiguous() for g in got):
            raise AssertionError(f"multi_read disagrees with its plain version at {label}: max |err| {err}")

    width_sets = [(1,), (2,), (3,), (4,), (8,), (9,), (16,), (4, 4), (2, 1), (16, 1), (1, 1, 1), (4, 4, 1),
                  (3, 9, 8, 1), (16, 4, 2, 1)]
    for M in (0, 480, 2400, 12000):
        R = R_RECORDS if M in (480, 2400) else 1000
        for ws in width_sets:
            arrs = [rand(R, w) if w > 1 else rand(R) for w in ws]
            keys = torch.randint(-3, R + 3, (M,), generator=gen, dtype=torch.int32).cuda()
            check(multi_read_many(arrs, keys), gather_many_ref(arrs, keys), f"R={R} M={M} widths {ws}")
            if ws in ((4,), (16, 1), (3, 9, 8, 1)) and M:
                views = [unaligned(a) for a in arrs]
                check(multi_read_many(views, keys), gather_many_ref(arrs, keys), f"unaligned R={R} M={M} widths {ws}")
        for A in (1, 2, 3, 8, 9):
            table, keys = rand(R, A), torch.randint(-3, R + 3, (M,), generator=gen, dtype=torch.int32).cuda()
            check((multi_read(table, keys),), (multi_read_ref(table, keys),), f"one table R={R} M={M} A={A}")
        log(f"  multi_read M={M} (R={R}, keys in [-3, R+3)): {len(width_sets)} array sets, 5 one-table widths, "
            f"the unaligned views: max |err| 0")

    by_path = {}
    for path, (N, K, sets) in GATHERS.items():
        M, parts = N * K, []
        keys = torch.randint(0, R_RECORDS, (N, K), generator=gen, dtype=torch.int32).cuda()
        kf = keys.reshape(-1)
        for name, (shapes, n) in sets.items():
            arrs = [torch.randint(0, 1000, (R_RECORDS,) + s, generator=gen, dtype=torch.int32).cuda() for s in shapes]
            fn = lambda: ops.gather_many(arrs, keys, plane=ops.KERNEL)  # noqa: E731
            one_device_op(fn, "multi_read")
            for g, w in zip(fn(), packed_gather(arrs, keys)):
                if not torch.equal(g, w):
                    raise AssertionError(f"multi_read ({path}, {name}): the parent's packed sequence disagrees")
            t = timed(fn, lambda: gather_many_ref(arrs, kf), lambda: ops.gather_many(arrs, keys, plane=ops.TORCH))
            packed = lambda: packed_gather(arrs, keys)  # noqa: E731
            t["packed_ms"], t["packed_host_ms"] = time_graph_ms(packed), time_ms(packed)
            words = sum(math.prod(s) for s in shapes)
            t["bound_ms"], t["bound_by"] = bound_ms(M * 4 + 2 * M * words * 4, 0)  # keys + rows read + rows written
            log(f"multi_read ({path}: {name}, R={R_RECORDS}, M={M}, {n} per tick): ops.gather_many "
                f"{t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued eagerly), the parent's packed "
                f"sequence {t['packed_ms']:.6f} ({t['packed_host_ms']:.6f}), per-array a[keys] "
                f"{t['library_ms']:.6f} ({t['library_host_ms']:.6f}), plain {t['plain_ms']:.6f} "
                f"({t['plain_host_ms']:.6f}), bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
            parts.append((n, t))
        by_path[path] = dict(mix(parts), M=M, calls_per_tick={name: n for name, (_, n) in sets.items()})
    return dict(
        name="multi_read", route="cuda", source="src/repro_torch/kernels/csrc/multi_read.cu",
        replaces="src/repro/kernels/multi_read.py:41", max_abs_err=float(worst), by_path=by_path,
    )


def phase_version_select(gen):
    """mvcc_version_select against its plain versions, exactly: the fused
    read (store rows at keys in [-3, R+3), with and without the lock, S =
    1, 2, 4, 16, M = 0 to 12000, ties, empty slots, int32 extremes,
    unaligned views), picks over row views with one ctts pair per
    transaction, and per-op picks at edge cases.  Then, at the main path's
    picks, the fused read (one launch, checked with the profiler) against
    the plain version and the parent's sequence for the same pick."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.mvcc_version_select import mvcc_version_read, mvcc_version_select
    from repro_torch.kernels.ref import mvcc_version_select_ref, version_read_ref

    worst = 0

    def check(got, want, label):
        nonlocal worst
        torch.cuda.synchronize()
        bad = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None) or (w is not None and (g.dtype != w.dtype or g.shape != w.shape)):
                raise AssertionError(f"mvcc_version_select {label}: outputs differ in kind, dtype or shape")
            if w is not None and w.numel():
                bad += int((g != w).sum())
                worst = max(worst, int((g.long() - w.long()).abs().max()))
        if bad:
            raise AssertionError(f"mvcc_version_select disagrees with its plain version at {label}: {bad} mismatches")

    reads = [(R_RECORDS, 240, 10, 4, kind) for kind in ("engine", "narrow", "ties", "empty", "extremes", "unaligned")]
    reads += [(1000, N, K, S, "narrow") for N, K in ((0, 10), (48, 10), (240, 10), (1200, 10)) for S in (1, 2, 4, 16)]
    reads += [(50, 37, 3, S, kind) for S in (1, 4, 16) for kind in ("ties", "empty", "extremes", "unaligned")]
    for R, N, K, S, kind in reads:
        wh, wl, lh, ll, keys, ch, cl = read_case(R, N, K, S, gen, kind)
        for lock in ((lh, ll), (None, None)):
            got = mvcc_version_read(wh, wl, keys, ch, cl, *lock)
            check(got, version_read_ref(wh, wl, keys, ch, cl, *lock), f"read R={R} N={N} K={K} S={S} {kind}")
            inside = (keys >= 0) & (keys < R)  # a key outside reads empty slots: slot 0
            if kind == "ties" and S > 1 and not bool((got[1][inside] == 1).all()):
                raise AssertionError("mvcc_version_select: the first of tied winning slots must win")
    log(f"  mvcc_version_select: {2 * len(reads)} fused reads (keys in [-3, R+3), with and without the lock) "
        f"equal their plain version")
    for S in (1, 4, 16):  # row views: column slices of one (M, 2S) table, one ctts pair per 10 ops
        table = torch.randint(-1, 3, (2400, 2 * S), generator=gen, dtype=torch.int32).cuda()
        ch, cl = (torch.randint(-1, 3, (240,), generator=gen, dtype=torch.int32).cuda() for _ in range(2))
        lh, ll = (torch.randint(-1, 2, (2400,), generator=gen, dtype=torch.int32).cuda() for _ in range(2))
        got = mvcc_version_select(table[:, :S], table[:, S:], ch, cl, lh, ll)
        want = mvcc_version_select_ref(table[:, :S], table[:, S:], ch.repeat_interleave(10), cl.repeat_interleave(10),
                                       lh, ll)
        check(got, want, f"row views S={S}")
    cases = [(2400, 4, "engine"), (2400, 4, "random")]
    cases += [(2400, S, "random") for S in (1, 2, 3, 8, 16)]
    cases += [(M, 4, "random") for M in (0, 1, 37)]
    cases += [(37, S, kind) for S in (1, 4, 16) for kind in ("empty", "ctts_eq", "ties", "lock_eq", "extremes")]
    for M, S, kind in cases:
        args = version_case(M, S, gen, kind)
        check(mvcc_version_select(*args), mvcc_version_select_ref(*args), f"per-op M={M} S={S} {kind}")
    log(f"  mvcc_version_select: row views at S = 1, 4, 16 and {len(cases)} per-op cases equal their plain version")

    by_path = {}
    for path, ((N, K, S), picks) in PICKS.items():
        M, parts = N * K, []
        wh, wl, lh, ll, keys, ch, cl = read_case(R_RECORDS, N, K, S, gen, "engine")
        keys = torch.randint(0, R_RECORDS, (N, K), generator=gen, dtype=torch.int32).cuda()
        for with_lock, n in picks.items():
            lock = (lh, ll) if with_lock else (None, None)
            fn = lambda: ops.version_read(wh, wl, keys, ch, cl, *lock)  # noqa: E731
            one_device_op(fn, "mvcc_version_select")
            parent = lambda: parent_pick(wh, wl, keys, ch, cl, *lock)  # noqa: E731
            got, old = fn(), parent()
            if not all(torch.equal(a.reshape(-1), b) for a, b in zip(got[:3 if with_lock else 2], old)):
                raise AssertionError(f"mvcc_version_select ({path}): the parent's sequence disagrees")
            t = timed(fn, lambda: version_read_ref(wh, wl, keys, ch, cl, *lock))
            t["parent_seq_ms"], t["parent_seq_host_ms"] = time_graph_ms(parent), time_ms(parent)
            # bytes: keys, the ctts pairs, each op's 2S wts words (and lock pair) read; found, slot (and ok) and the
            # 2S gathered words written.  Operations: about 12 integer operations per slot and 6 for Cond R2
            n_in = M * 4 + N * 8 + M * 2 * S * 4 + (M * 8 if with_lock else 0)
            n_out = M * (1 + 4 + (1 if with_lock else 0)) + M * 2 * S * 4
            t["bound_ms"], t["bound_by"] = bound_ms(n_in + n_out, M * (12 * S + 6))
            log(f"mvcc_version_select ({path}: fused read, R={R_RECORDS}, N={N}, K={K}, S={S}, "
                f"{'with' if with_lock else 'without'} the lock, {n} per tick): {t['ms']:.6f} ms/call on the device "
                f"({t['host_ms']:.6f} issued eagerly), the parent's sequence {t['parent_seq_ms']:.6f} "
                f"({t['parent_seq_host_ms']:.6f}), plain {t['plain_ms']:.6f} ({t['plain_host_ms']:.6f}), "
                f"no library call, bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
            parts.append((n, t))
        by_path[path] = dict(mix(parts), M=M, S=S, picks_per_tick={"with lock": picks[True], "without": picks[False]})
    return dict(
        name="mvcc_version_select", route="cuda", source="src/repro_torch/kernels/csrc/mvcc_version_select.cu",
        replaces="src/repro/kernels/mvcc_version_select.py:47", max_abs_err=float(worst), by_path=by_path,
    )


def attn_inputs(B, H, Sq, Sk, Dh, dtype, gen, *, bshd=False):
    """q (B, H, Sq, Dh), k/v (B, H, Sk, Dh) on the card; with ``bshd`` they
    are (B, S, H, Dh) storage seen through a transpose, as the LM's
    ``attention_op`` hands them over; with ``bshd="unaligned"`` that storage
    is the last Dh of (B, S, H, Dh + 1) rows, so neither the base nor a row
    is 16-byte aligned (the kernel's plain-load path)."""
    import torch

    def one(S):
        if bshd == "unaligned":
            t = torch.randn((B, S, H, Dh + 1), generator=gen).to(dtype).cuda()
            return t[..., 1:].transpose(1, 2)
        t = torch.randn((B, S, H, Dh) if bshd else (B, H, S, Dh), generator=gen).to(dtype).cuda()
        return t.transpose(1, 2) if bshd else t

    return one(Sq), one(Sk), one(Sk)


def attn_work(B, H, Sq, Sk, Dh, causal, elem):
    """(bytes, flops) the attention must move and do: q, k, v read once and o
    written once; two products of 2*Dh flops per unmasked (row, key) pair."""
    pairs = sum(min(r + 1, Sk) for r in range(Sq)) if causal else Sq * Sk
    return elem * B * H * Dh * (2 * Sq + 2 * Sk), 4 * B * H * Dh * pairs


def phase_flash(gen):
    """flash_attention against its plain version on the card, in the
    working dtype (1e-5 in float32, 3e-2 in bfloat16, the reference's
    tolerances: |err| <= tol + tol*|want|), then timed at the serving shape
    with the SDPA call as a yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    tols = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
    cases = [(2, 3, S, S, Dh, causal, dt, False) for S in (1, 63, 64, 65, 128, 320) for Dh in (32, 64, 128)
             for causal in (True, False) for dt in tols]
    cases += [(1, 2, 2048, 2048, Dh, causal, dt, False) for Dh in (32, 64, 128) for causal in (True, False) for dt in tols]
    cases += [(2, 2, 50, 130, 64, False, dt, False) for dt in tols] + [(1, 2, 300, 77, 128, False, dt, False) for dt in tols]
    cases += [(1, 2, 130, 50, 32, True, torch.float32, False), (1, 2, 50, 130, 64, True, torch.float32, False)]
    cases += [(4, 32, 2048, 2048, 64, True, torch.float32, True), (2, 32, 256, 256, 64, True, torch.float32, True)]
    # the serving shape in bfloat16; Dh = 128 with Sq != Sk, causal; views whose rows are not 16-byte aligned
    cases += [(4, 32, 2048, 2048, 64, True, torch.bfloat16, True)]
    cases += [(2, 3, Sq, Sk, 128, True, dt, True) for Sq, Sk in ((200, 333), (333, 200)) for dt in tols]
    cases += [(2, 3, S, S, Dh, causal, dt, "unaligned") for S, Dh, causal in ((130, 64, True), (77, 32, False),
                                                                              (200, 128, True)) for dt in tols]
    cases += [(1, 2, 70, 0, 64, causal, dt, False) for causal in (True, False) for dt in tols]  # Sk = 0: zeros
    worst = {dt: 0.0 for dt in tols}
    for B, H, Sq, Sk, Dh, causal, dt, bshd in cases:
        q, k, v = attn_inputs(B, H, Sq, Sk, Dh, dt, gen, bshd=bshd)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        worst[dt] = max(worst[dt], float(err.max()))
        excess = float((err - tols[dt] * (1 + want.float().abs())).max())
        if excess > 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention disagrees with its plain version at B={B} H={H} Sq={Sq} Sk={Sk} "
                                 f"Dh={Dh} causal={causal} {dt}: max |err| {float(err.max())}")
    log(f"  flash_attention: {len(cases)} cases within tolerance; max |err| float32 {worst[torch.float32]:.3e}, "
        f"bfloat16 {worst[torch.bfloat16]:.3e}")

    B, H, S, Dh = 4, 32, 2048, 64  # the serving prefill's call, as attention_op makes it
    q, k, v = attn_inputs(B, H, S, S, Dh, torch.float32, gen, bshd=True)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    fn = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: flash_attention_ref(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True)  # noqa: E731
    t = {"ms": time_graph_ms(fn, reps=10), "plain_ms": time_graph_ms(plain, reps=3),
         "library_ms": time_graph_ms(sdpa, reps=10), "host_ms": time_ms(fn, reps=10, warm=2),
         "plain_host_ms": time_ms(plain, reps=3, warm=1), "library_host_ms": time_ms(sdpa, reps=10, warm=2)}
    sdpa_err = float((sdpa().float() - plain().float()).abs().max())
    n_bytes, n_flops = attn_work(B, H, S, S, Dh, True, 4)
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, n_flops, FP32_FLOPS_PER_S)
    log(f"flash_attention ({SERVE_PATH}: B={B}, H={H}, S={S}, Dh={Dh}, causal, float32): {t['ms']:.6f} ms/call "
        f"on the device ({t['host_ms']:.6f} issued eagerly), plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), "
        f"SDPA {t['library_ms']:.6f} ms ({t['library_host_ms']:.6f}; max |err| vs plain {sdpa_err:.3e}), "
        f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {n_flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB), "
        f"{n_flops / t['ms'] / 1e9:.2f} TFLOP/s")
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:70", max_abs_err=worst[torch.float32],
        max_abs_err_bf16=worst[torch.bfloat16], by_path={SERVE_PATH: dict(t, B=B, H=H, S=S, Dh=Dh)},
    )


def phase_profile(protocol, workload, n_ticks=20):
    """Where one main-path tick's time goes: ``n_ticks`` ticks of one
    config (hybrid 63, kernel plane) timed bare, then traced with
    torch.profiler for the device's busy time and kernel launches.  On
    YCSB, the workload's sequential key de-duplication is timed and traced
    alone as well, at the tick's shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import init_state
    from repro_torch.core.registry import get_protocol, protocol_family
    from repro_torch.core.store import init_store
    from repro_torch.core.sweep import GridSpec, engine_config, resolve_knobs

    gs = GridSpec(protocol=protocol, workload=workload, kernel_plane="kernel", device="cuda")
    ec, cm, wl = engine_config(gs, resolve_knobs(workload, {"hybrid": 63}))
    tick = get_protocol(protocol).tick
    st = init_state(ec, wl)
    store = init_store(protocol_family(protocol), ec.n_records, wl.rw, wl.init_value,
                       n_versions=ec.mvcc_slots, device="cuda")
    t = 0
    for _ in range(40):  # past warm-up allocations
        st, store = tick(ec, cm, wl, st, store, t)
        t += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        st, store = tick(ec, cm, wl, st, store, t)
        t += 1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_ticks

    def device_events(fn, n):
        """The device events of ``n`` calls, and the host's top-level
        operations per call (torch operations and runtime calls with no
        parent)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        host = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.cpu_parent is None)
        return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA], host / n

    def one_tick():
        nonlocal st, store, t
        st, store = tick(ec, cm, wl, st, store, t)
        t += 1

    dev, host_ops = device_events(one_tick, n_ticks)
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n_ticks
    by_family = {}  # kernel name up to its template/argument list -> [launches, us] per tick
    for e in dev:
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        fam = by_family.setdefault(name.split("<")[0].split("(")[0].strip(), [0.0, 0.0])
        fam[0] += 1 / n_ticks
        fam[1] += e.time_range.elapsed_us() / n_ticks
    top = sorted(by_family.items(), key=lambda kv: -kv[1][1])[:8]
    names = ("lock_arbiter", "multi_read", "mvcc_version_select")
    cats = [e for e in dev if "CatArrayBatchedCopy" in e.name]
    prof_line = {
        "path": f"{protocol}/{workload}",
        "tick_wall_ms": wall_ms, "device_busy_ms_per_tick": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if dev else None,
        "device_ops_per_tick": len(dev) / n_ticks, "host_top_level_ops_per_tick": host_ops,
        "top_device_launches_and_us_per_tick": dict(top),
        "cat_launches_and_us_per_tick": [len(cats) / n_ticks, sum(e.time_range.elapsed_us() for e in cats) / n_ticks],
        "kernel_launches_per_tick": {n: sum(1 for e in dev if n + "_kernel" in e.name) / n_ticks for n in names},
        "kernel_device_us": {
            n: sum(e.time_range.elapsed_us() for e in dev if n + "_kernel" in e.name)
            / max(1, sum(1 for e in dev if n + "_kernel" in e.name))
            for n in names
        },
    }
    if workload == "ycsb":
        from repro_torch.workloads.util import dedup_keys

        keys, slot = st["keys"].clone(), torch.arange(ec.n_slots, dtype=torch.int32, device="cuda")
        for _ in range(5):
            dedup_keys(keys, slot, ec.n_records)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            dedup_keys(keys, slot, ec.n_records)
        torch.cuda.synchronize()
        d_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
        d_dev, d_host = device_events(lambda: dedup_keys(keys, slot, ec.n_records), n_ticks)
        prof_line["dedup_wall_ms"] = d_ms
        prof_line["dedup_share_of_tick_wall"] = d_ms / wall_ms
        prof_line["dedup_device_ops"] = len(d_dev) / n_ticks
        prof_line["dedup_host_top_level_ops"] = d_host
        prof_line["dedup_device_busy_ms"] = sum(e.time_range.elapsed_us() for e in d_dev) / 1e3 / n_ticks
    log("profile: " + json.dumps(prof_line))


def ulps(a, b):
    """Largest float32 ulp distance between two same-sign arrays."""
    import numpy as np

    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def margins(logits):
    """Top-1 minus top-2 logit per (step, request): logits (G, B, V)."""
    top2 = logits.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu()


def decided_steps(margin_row):
    """Steps 0.. up to and including the first whose margin is below 10x the
    tolerance: those tokens must agree; later ones may follow another token."""
    for s, m in enumerate(margin_row):
        if m < 10 * LOGIT_TOL:
            return s + 1
    return len(margin_row)


def check_init(params, golden):
    """The card's init_lm against the reference's weights: samples within
    2 ulp, sums of |w| within 1e-6 relative."""
    for name, ref in golden["leaves"].items():
        parts = name.split("/")
        t = params
        if ref["layer"] is not None:
            t = t.layers[ref["layer"]]
            parts = parts[1:]
        for part in parts:
            t = getattr(t, part)
        sample = t[:2, :8] if ref["corner"] == "head" else t[-2:, -8:]
        d = ulps(sample.cpu().numpy(), ref["sample"])
        total = float(t.double().abs().sum())
        rel = abs(total - ref["abs_sum"]) / ref["abs_sum"]
        log(f"  init {name}: sample within {d} ulp, sum |w| {total:.6f} vs {ref['abs_sum']:.6f} (rel {rel:.2e})")
        if d > 2 or rel > 1e-6:
            raise AssertionError(f"init_lm on the card differs from the reference at {name}")


def check_golden(res, golden):
    """A kernel-plane serve at the golden file's size against the JAX
    reference's full-width outputs."""
    import torch

    if res.prompts.cpu().tolist() != golden["prompts"]:
        raise AssertionError("golden: prompts differ from the reference's randint(PRNGKey(1))")
    worst = 0.0
    for b in range(golden["batch"]):
        ref_m = [st["top_logits"][b][0] - st["top_logits"][b][1] for st in golden["steps"]]
        n = decided_steps(ref_m)
        for s in range(n):
            st = golden["steps"][s]
            lg = res.logits[s, b].double().cpu()
            ids = torch.tensor(st["top_ids"][b])
            got = [lg[ids], lg.max(), torch.logsumexp(lg, 0)]
            want = [torch.tensor(st["top_logits"][b], dtype=torch.float64), torch.tensor(st["max"][b]),
                    torch.tensor(st["lse"][b])]
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err)
            if err > LOGIT_TOL:
                raise AssertionError(f"golden: request {b} step {s}: logits off by {err} > {LOGIT_TOL}")
            if ref_m[s] > 10 * LOGIT_TOL and int(lg.argmax()) != st["top_ids"][b][0]:
                raise AssertionError(f"golden: request {b} step {s}: top-1 {int(lg.argmax())} != {st['top_ids'][b][0]}")
            if int(res.tokens[b, s]) != golden["tokens"][b][s]:
                raise AssertionError(f"golden: request {b} step {s}: token {int(res.tokens[b, s])} != "
                                     f"{golden['tokens'][b][s]}")
        log(f"  golden request {b}: {n} of {golden['gen_len']} steps decided (margin > {10 * LOGIT_TOL}); "
            f"tokens equal, logits within {LOGIT_TOL}")
    return worst


def device_busy(fn):
    """Wall ms of one synchronised call, the device's busy ms in it
    (torch.profiler: the sum of the device operations' durations), their
    count, and the largest kernel families: name -> [launches, ms]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    fams = {}
    for e in dev:
        fam = fams.setdefault(e.name.split("(")[0].strip()[:80], [0, 0.0])
        fam[0] += 1
        fam[1] += e.time_range.elapsed_us() / 1e3
    top = dict(sorted(fams.items(), key=lambda kv: -kv[1][1])[:8])
    return out, wall, busy, len(dev), top


def phase_serve(counted):
    """The LM serving path at full width on the card: init_lm from seed 0,
    the golden-file run, a profiled prefill and decode step, then the main
    path: serve() at SERVE on the kernel plane, launches counted from 0, and
    the same requests on the torch plane.  Returns the kernel plane's
    launches by kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import init_lm

    cfg, _ = get_config("stablelm-1.6b")
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_stablelm.json")) as f:
        golden = json.load(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve: init_lm({cfg.name}, seed 0) on the card: {n_params:,} parameters in "
        f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # the config's analytic count takes one d_model vector per norm; a layernorm also has a bias,
    # and the final norm is not counted
    if n_params != cfg.param_count() + 2 * cfg.d_model * (cfg.n_layers + 1):
        raise AssertionError(f"init_lm: {n_params} parameters, config {cfg.param_count()} + norms")
    check_init(params, golden)

    g = serve(cfg, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
              page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=params)
    err = check_golden(g, golden)
    log(f"serve golden ({golden['batch']} x {golden['prompt_len']}, {golden['gen_len']} steps, kernel plane): "
        f"logits within {err:.3e} of the JAX reference (tolerance {LOGIT_TOL}), tokens {g.tokens.tolist()}")

    # where the time goes: one prefill and one decode step at the main path's shape, profiled
    with torch.inference_mode():
        prompts = prng.randint(prng.prng_key(1, "cuda"), (SERVE["batch"], SERVE["prompt_len"]), 0, cfg.vocab_size)
        pad = SERVE["prompt_len"] + SERVE["gen_len"]
        lm_prefill(params, cfg, {"tokens": prompts[:, :64]}, pad_to=96, plane="kernel")  # warm-up
        (logits, cache), p_wall, p_busy, p_ops, p_top = device_busy(
            lambda: lm_prefill(params, cfg, {"tokens": prompts}, pad_to=pad, plane="kernel"))
        tok = logits.argmax(-1)
        lm_decode_step(params, cfg, cache, {"token": tok})  # warm-up: writes slot S, which the next call rewrites
        _, d_wall, d_busy, d_ops, d_top = device_busy(lambda: lm_decode_step(params, cfg, cache, {"token": tok}))
        del cache, logits
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log("serve profile: " + json.dumps(prof))

    # the main path: counts from 0, then read
    for fn in counted:
        fn.launches = 0
    k = serve(cfg, **SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    log(f"main path {SERVE_PATH} (kernel plane, B={SERVE['batch']}, prompt {SERVE['prompt_len']}, "
        f"{SERVE['gen_len']} tokens each, float32): prefill {k.prefill_ms:.3f} ms, decode {k.decode_ms_per_step:.3f} "
        f"ms/step, {k.tokens_per_s:.1f} tok/s, page table {k.pages_used}/{k.pages_total} used, "
        f"{k.pages_used_after_release} after release, launches {got}")
    expect = {fn.__name__: 0 for fn in counted}
    expect["flash_attention"] = cfg.n_layers
    if got != expect:
        raise AssertionError(f"{SERVE_PATH}: kernel launches {got} != {expect} (one flash_attention per prefill layer)")
    if flash_attention.launches != cfg.n_layers:
        raise AssertionError("flash_attention: launch count")

    t = serve(cfg, **SERVE, seed=0, device="cuda", plane="torch", params=params)
    log(f"main path {SERVE_PATH} (torch plane): prefill {t.prefill_ms:.3f} ms, decode {t.decode_ms_per_step:.3f} "
        f"ms/step, {t.tokens_per_s:.1f} tok/s")
    gap = float((k.logits[0] - t.logits[0]).abs().max())
    if gap > LOGIT_TOL:
        raise AssertionError(f"{SERVE_PATH}: prefill logits of the planes differ by {gap} > {LOGIT_TOL}")
    m = margins(t.logits)
    for b in range(SERVE["batch"]):
        n = decided_steps(m[:, b].tolist())
        if k.tokens[b, :n].tolist() != t.tokens[b, :n].tolist():
            raise AssertionError(f"{SERVE_PATH}: request {b}: greedy tokens differ within the first {n} steps")
        log(f"  request {b}: tokens equal over the {n} decided steps of {SERVE['gen_len']} "
            f"({int((k.tokens[b] == t.tokens[b]).sum())} equal in all)")
    log(f"{SERVE_PATH}: prefill logits of the planes within {gap:.3e} (tolerance {LOGIT_TOL}); "
        f"logits std {float(k.logits[0].std()):.3f}")
    return got


def main_path_spec(protocol, workload, plane, codes=CODES):
    from repro_torch.api import ExperimentSpec

    return ExperimentSpec(
        protocol=protocol, workload=workload, configs=[{"hybrid": c} for c in codes], kernel_plane=plane
    )


def show_rows(label, res):
    for r in res.rows:
        ticks = r["ticks"] + res.plan.grid_spec.warmup
        log(f"  {label} hybrid={r['hybrid']} commits={r['commits']} aborts={r['aborts']} "
            f"throughput_mtps={r['throughput_mtps']} avg_latency_us={r['avg_latency_us']} "
            f"wall_s={r['wall_s']:.3f} sim_ticks_per_s={ticks / r['wall_s']:.1f}")
        for k in ("throughput_mtps", "avg_latency_us", "abort_rate", "avg_round_trips"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{label} {r['hybrid']}: {k}={r[k]} is not finite")
        if len(r["stage_us_per_commit"]) != 8 or not all(map(math.isfinite, r["stage_us_per_commit"])):
            raise AssertionError(f"{label} {r['hybrid']}: bad stage_us_per_commit")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.mvcc_version_select import mvcc_version_select

    counted = (lock_arbiter, multi_read, mvcc_version_select, flash_attention)
    # float32 products stay float32: a TF32 product would blow the serving phase's tolerance
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build_logs = _build.build()
    log(f"build: {len(build_logs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    kernels = phase_kernels()
    for protocol, workload, _, _ in PATHS:
        phase_profile(protocol, workload)

    launches = {k["name"]: {} for k in kernels}
    for protocol, workload, golden_file, torch_codes in PATHS:
        path = f"{protocol}/{workload}"
        # phase 4: the main path on the kernel plane; launches counted from 0
        for fn in counted:
            fn.launches = 0
        pl = api.plan(main_path_spec(protocol, workload, "kernel"))
        log(pl.summary())
        res = api.execute(pl)
        got = {fn.__name__: fn.launches for fn in counted}
        n_ticks = len(CODES) * (pl.grid_spec.ticks + pl.grid_spec.warmup)
        log(f"main path {path} (kernel plane): {res.wall_s:.3f} s for {n_ticks} ticks, launches {got}")
        show_rows(f"{path} kernel", res)
        expect = {name: per * n_ticks for name, per in PER_TICK[protocol].items()}
        if got != expect:
            raise AssertionError(f"{path}: kernel launches {got} != {expect}")
        for name, n in got.items():
            launches[name][path] = n

        # phase 5: the torch plane gives the same counters
        res_t = api.run(main_path_spec(protocol, workload, "torch", torch_codes))
        log(f"main path {path} (torch plane, hybrid {list(torch_codes)}): {res_t.wall_s:.3f} s")
        show_rows(f"{path} torch", res_t)
        by_code = {r["hybrid"]: r for r in res.rows}
        for b in res_t.rows:
            a = by_code[b["hybrid"]]
            for k in ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips"):
                if a[k] != b[k]:
                    raise AssertionError(f"{path}: planes disagree on {a['hybrid']} {k}: {a[k]} vs {b[k]}")
        log(f"{path}: planes agree bitwise on the counters")

        # phase 6: the JAX reference's golden counters
        with open(os.path.join(ROOT, "src", "repro_torch", "data", golden_file)) as f:
            golden = json.load(f)
        if golden["spec"] != {"protocol": protocol, "workload": workload,
                              "configs": [{"hybrid": c} for c in CODES]}:
            raise AssertionError(f"{golden_file} holds another spec: {golden['spec']}")
        rows = [{"hybrid": r["hybrid"], "commits": r["commits"], "aborts": r["aborts"]} for r in res.rows]
        if rows != golden["rows"]:
            raise AssertionError(f"{path}: counters {rows} != JAX golden {golden['rows']}")
        log(f"{path} golden: counters equal the JAX reference's")

    # phase 7: the LM serving path (stablelm-1.6b at full width)
    for name, n in phase_serve(counted).items():
        launches[name][SERVE_PATH] = n

    for k in kernels:  # launches summed over the main paths' runs; times weighted by them
        k["launches"] = sum(launches[k["name"]].values())
        k["launches_by_path"] = launches[k["name"]]
        mean = mix([(launches[k["name"]][p], r) for p, r in k["by_path"].items()])
        k.update({key: mean[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                             "host_ms", "plain_host_ms", "library_host_ms")})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
