#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card and
``nvcc``.  In order, one line (or block) per phase:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the hand-written CUDA kernels built from ``src/repro_torch/kernels/csrc``;
3. each kernel held against its plain PyTorch version on the card, exactly,
   at every main path's shapes and at edge cases, then, at each main path's
   shapes, its device time per call (calls captured in a CUDA graph,
   replayed between CUDA events), its time per call as the host issues them
   eagerly, its bound, the plain version's times and a library call's times;
   then one tick of each main path (NOWAIT/SmallBank and MVCC/YCSB, hybrid
   63, kernel plane) timed bare and traced with torch.profiler: wall time,
   device busy time, device operations and top-level host operations per
   tick (and, for YCSB, the share of its sequential key de-duplication);
4. the main paths: ``repro_torch.api.run`` at the full ExperimentSpec
   defaults (4 nodes x 60 co-routines, 65536 records per node, 400 + 80
   ticks) for hybrid codes {0, 63, 21, 42} on the ``"kernel"`` plane, with
   the kernels' launch counts, for NOWAIT/SmallBank and then MVCC/YCSB
   (16-word records, 10 ops per txn, 4 version slots);
5. the same specs on the ``"torch"`` plane (MVCC/YCSB for hybrid 63 only),
   whose counters must be equal;
6. phase 4's counters against the JAX reference's golden files.

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
# kernel launches per tick on each path's kernel plane
PER_TICK = {
    "nowait": {"lock_arbiter": 1, "multi_read": 2, "mvcc_version_select": 0},
    "mvcc": {"lock_arbiter": 1, "multi_read": 11, "mvcc_version_select": 3},
}
# H100 SXM peaks: the HBM3 rate (NVIDIA data sheet), and the INT32 issue rate
# that bounds integer compares and selects: 132 SMs x 64 INT32 lanes per SM x
# 1.98 GHz boost clock = 16.7e12 ops/s (the data sheet's 67 TFLOP/s float32
# counts an FMA as two flops on 128 FP32 lanes per SM; a Hopper SM has 64
# INT32 lanes)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


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


def bound_ms(n_bytes, n_ops):
    """Least time for the work: the larger of bytes over the memory rate
    and integer operations over the INT32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def arbiter_case(G, M, n_keys, gen, *, ties=False, pad=False):
    import torch

    keys = torch.randint(0, max(n_keys, 1), (G, M), generator=gen, dtype=torch.int32)
    hi = torch.randint(-3, 4, (G, M), generator=gen, dtype=torch.int32)  # narrow: lo decides
    lo = torch.stack([torch.randperm(M, generator=gen) for _ in range(G)]).to(torch.int32) if M else \
        torch.zeros((G, 0), dtype=torch.int32)
    if ties:
        lo = lo // 2  # pairs share (hi, lo): several winners per key
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
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.ref import lock_arbiter_ref, multi_read_ref

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
    ]
    for c in cases:
        args = arbiter_case(c["G"], c["M"], c["n_keys"], gen, ties=c.get("ties", False), pad=c.get("pad", False))
        got, want = lock_arbiter(*args), lock_arbiter_ref(*args)
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
        t["bound_ms"], t["bound_by"] = bound_ms(M * 13 + M, 4 * M * M)  # 3 int32 + 1 bool in, 1 bool out; 4 ops a pair
        log(f"lock_arbiter ({path}: G=1, M={M}): {t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued "
            f"eagerly), plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), "
            f"bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
        by_path[path] = dict(t, M=M)
    rows.append(dict(
        name="lock_arbiter", route="cuda", source="src/repro_torch/kernels/csrc/lock_arbiter.cu",
        replaces="src/repro/kernels/lock_arbiter.py:41", max_abs_err=float(worst), by_path=by_path,
    ))

    # multi_read: R = 4*65536; each main path's packed widths A with their launches per tick
    # (NOWAIT: lock pair, data|ver; MVCC: wts pair x5, lock or rts pair x4, lock|rts_hi, wts|ver)
    R = 262144
    widths = {"nowait/smallbank": (480, {2: 1, 3: 1}), "mvcc/ycsb": (2400, {8: 5, 2: 4, 3: 1, 9: 1})}
    worst = 0
    for M in (480, 2400):
        for A in (1, 2, 3, 8, 9):
            for R_ in (R, 1000):
                table = torch.randint(-2**31, 2**31 - 1, (R_, A), generator=gen, dtype=torch.int32).cuda()
                keys = torch.randint(-3, R_ + 3, (M,), generator=gen, dtype=torch.int32).cuda()
                got, want = multi_read(table, keys), multi_read_ref(table, keys)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                worst = max(worst, err)
                log(f"  multi_read R={R_} M={M} A={A} (keys in [-3, R+3)): max |err| {err}")
                if err:
                    raise AssertionError(f"multi_read disagrees with its plain version at R={R_} M={M} A={A}")
    by_path = {}
    for path, (M, per_tick) in widths.items():
        parts = []
        for A, n in per_tick.items():
            table = torch.randint(0, 1000, (R, A), generator=gen, dtype=torch.int32).cuda()
            keys = torch.randint(0, R, (M,), generator=gen, dtype=torch.int32).cuda()
            t = timed(lambda: multi_read(table, keys), lambda: multi_read_ref(table, keys), lambda: table[keys])
            t["bound_ms"], t["bound_by"] = bound_ms(M * 4 + 2 * M * A * 4, 0)  # keys + rows read + rows written
            log(f"multi_read ({path}: R={R}, M={M}, A={A}, {n} per tick): {t['ms']:.6f} ms/call on the device "
                f"({t['host_ms']:.6f} issued eagerly), plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), "
                f"table[keys] {t['library_ms']:.6f} ms ({t['library_host_ms']:.6f}), "
                f"bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
            parts.append((n, t))
        by_path[path] = dict(mix(parts), M=M, widths_per_tick=per_tick)
    rows.append(dict(
        name="multi_read", route="cuda", source="src/repro_torch/kernels/csrc/multi_read.cu",
        replaces="src/repro/kernels/multi_read.py:41", max_abs_err=float(worst), by_path=by_path,
    ))
    rows.append(phase_version_select(gen))
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


def phase_version_select(gen):
    """mvcc_version_select against its plain version, exactly, then timed at
    the main path's shape: M = N*K = 240*10 ops, S = 4 slots."""
    import torch

    from repro_torch.kernels.mvcc_version_select import mvcc_version_select
    from repro_torch.kernels.ref import mvcc_version_select_ref

    cases = [(2400, 4, "engine"), (2400, 4, "random")]
    cases += [(2400, S, "random") for S in (1, 2, 3, 8, 16)]
    cases += [(M, 4, "random") for M in (0, 1, 37)]
    cases += [(37, S, kind) for S in (1, 4, 16) for kind in ("empty", "ctts_eq", "ties", "lock_eq", "extremes")]
    worst = 0
    for M, S, kind in cases:
        args = version_case(M, S, gen, kind)
        got, want = mvcc_version_select(*args), mvcc_version_select_ref(*args)
        torch.cuda.synchronize()
        bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        worst = max(worst, max((int((g.long() - w.long()).abs().max()) for g, w in zip(got, want) if M), default=0))
        log(f"  mvcc_version_select M={M} S={S} {kind}: {bad} mismatches, {int(want[0].sum())} found")
        if bad:
            raise AssertionError(f"mvcc_version_select disagrees with its plain version at M={M} S={S} {kind}")
        if kind == "ties" and S > 1 and not bool((got[1] == 1).all()):
            raise AssertionError("mvcc_version_select: the first of tied winning slots must win")
    M, S = 2400, 4
    args = version_case(M, S, gen, "engine")
    t = timed(lambda: mvcc_version_select(*args), lambda: mvcc_version_select_ref(*args))
    # bytes: each row's 2S + 4 int32 words in, 2 bools and an int32 out; operations: about 12 integer
    # operations per slot (two lexicographic compares, the empty-slot test, the best-so-far selects)
    # and 6 for Cond R2
    t["bound_ms"], t["bound_by"] = bound_ms(M * (2 * S + 4) * 4 + M * 6, M * (12 * S + 6))
    log(f"mvcc_version_select (mvcc/ycsb: M={M}, S={S}): {t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} "
        f"issued eagerly), plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), no library call, "
        f"bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
    return dict(
        name="mvcc_version_select", route="cuda", source="src/repro_torch/kernels/csrc/mvcc_version_select.cu",
        replaces="src/repro/kernels/mvcc_version_select.py:47", max_abs_err=float(worst),
        by_path={"mvcc/ycsb": dict(t, M=M, S=S)},
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
        fam = by_family.setdefault(e.name.split("<")[0].split("(")[0].strip(), [0.0, 0.0])
        fam[0] += 1 / n_ticks
        fam[1] += e.time_range.elapsed_us() / n_ticks
    top = sorted(by_family.items(), key=lambda kv: -kv[1][1])[:8]
    names = ("lock_arbiter", "multi_read", "mvcc_version_select")
    prof_line = {
        "path": f"{protocol}/{workload}",
        "tick_wall_ms": wall_ms, "device_busy_ms_per_tick": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if dev else None,
        "device_ops_per_tick": len(dev) / n_ticks, "host_top_level_ops_per_tick": host_ops,
        "top_device_launches_and_us_per_tick": dict(top),
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
    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.mvcc_version_select import mvcc_version_select

    counted = (lock_arbiter, multi_read, mvcc_version_select)
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
            if "registers" in line or "error" in line.lower():
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
