#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card and
``nvcc``.  In order, one line (or block) per phase:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the hand-written CUDA kernels built from ``src/repro_torch/kernels/csrc``;
3. each kernel held against its plain PyTorch version on the card, exactly,
   at the engine's shapes and at edge cases, with its device time per call
   (calls captured in a CUDA graph, replayed between CUDA events), its time
   per call as the host issues them eagerly, its bound, the plain version's
   times and a library call's times;
   then one main-path tick timed bare and traced with torch.profiler: wall
   time, device busy time, device operations per tick;
4. the main path: ``repro_torch.api.run`` of NOWAIT/SmallBank at the full
   ExperimentSpec defaults (4 nodes x 60 co-routines, 65536 records per
   node, 400 + 80 ticks) for hybrid codes {0, 63, 21, 42} on the
   ``"kernel"`` plane, with the kernels' launch counts;
5. the same spec on the ``"torch"`` plane, whose counters must be equal;
6. phase 4's counters against the JAX reference's golden file.

It prints a JSON line of kernel measurements, then, last, one JSON line
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
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the CUDA cores' float32
# rate, taken as the scalar-instruction rate for integer compares and selects
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


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
    and operations over the scalar rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S
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


def phase_kernels():
    """Each kernel against its plain version on the card; returns the
    kernels' measurement rows (without ``launches``)."""
    import torch

    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.ref import lock_arbiter_ref, multi_read_ref

    gen = torch.Generator().manual_seed(0)
    rows = []

    # lock_arbiter: main path is G=1, M=N*K=240*2=480 over 262144 records
    worst = 0
    cases = [
        dict(G=1, M=480, n_keys=262144), dict(G=1, M=480, n_keys=64), dict(G=1, M=480, n_keys=64, ties=True),
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
    args = arbiter_case(1, 480, 262144, gen)
    G, M = args[0].shape
    t = {"ms": time_graph_ms(lambda: lock_arbiter(*args)), "plain_ms": time_graph_ms(lambda: lock_arbiter_ref(*args)),
         "host_ms": time_ms(lambda: lock_arbiter(*args)), "plain_host_ms": time_ms(lambda: lock_arbiter_ref(*args))}
    bms, by = bound_ms(G * M * 13 + G * M, 4 * G * M * M)  # 3 int32 + 1 bool in, 1 bool out; 4 ops a pair
    log(f"lock_arbiter (G=1, M=480): {t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued eagerly), "
        f"plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), bound {bms:.9f} ms ({by})")
    rows.append(dict(
        name="lock_arbiter", route="cuda", source="src/repro_torch/kernels/csrc/lock_arbiter.cu",
        replaces="src/repro/kernels/lock_arbiter.py:41", max_abs_err=float(worst), ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=bms, bound_by=by, library_ms=None,
        host_ms=t["host_ms"], plain_host_ms=t["plain_host_ms"], library_host_ms=None,
    ))

    # multi_read: main path is R=4*65536, M=480, A=2 (lock words) and A=3 (data|ver)
    R, M = 262144, 480
    worst = 0
    for A in (1, 2, 3):
        for R_ in (R, 1000):
            table = torch.randint(-2**31, 2**31 - 1, (R_, A), generator=gen, dtype=torch.int32).cuda()
            keys = torch.randint(-3, R_ + 3, (M,), generator=gen, dtype=torch.int32).cuda()
            got, want = multi_read(table, keys), multi_read_ref(table, keys)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            log(f"  multi_read R={R_} M={M} A={A} (keys in [-3, R+3)): max |err| {err}")
            if err:
                raise AssertionError(f"multi_read disagrees with its plain version at R={R_} A={A}")
    avg = dict.fromkeys(("ms", "plain_ms", "library_ms", "host_ms", "plain_host_ms", "library_host_ms", "bound_ms"), 0.0)
    for A in (2, 3):  # the engine launches one of each per tick: average them
        table = torch.randint(0, 1000, (R, A), generator=gen, dtype=torch.int32).cuda()
        keys = torch.randint(0, R, (M,), generator=gen, dtype=torch.int32).cuda()
        t = {"ms": time_graph_ms(lambda: multi_read(table, keys)),
             "plain_ms": time_graph_ms(lambda: multi_read_ref(table, keys)),
             "library_ms": time_graph_ms(lambda: table[keys]),
             "host_ms": time_ms(lambda: multi_read(table, keys)),
             "plain_host_ms": time_ms(lambda: multi_read_ref(table, keys)),
             "library_host_ms": time_ms(lambda: table[keys])}
        t["bound_ms"], by = bound_ms(M * 4 + 2 * M * A * 4, 0)  # keys + the rows read + the rows written
        log(f"multi_read (R={R}, M={M}, A={A}): {t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued "
            f"eagerly), plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), table[keys] {t['library_ms']:.6f} ms "
            f"({t['library_host_ms']:.6f}), bound {t['bound_ms']:.9f} ms ({by})")
        for k in avg:
            avg[k] += t[k] / 2
    rows.append(dict(
        name="multi_read", route="cuda", source="src/repro_torch/kernels/csrc/multi_read.cu",
        replaces="src/repro/kernels/multi_read.py:41", max_abs_err=float(worst), bound_by="bytes", **avg,
    ))
    return rows


def phase_profile(n_ticks=20):
    """Where one main-path tick's time goes: ``n_ticks`` ticks of one
    config (hybrid 63, kernel plane) timed bare, then traced with
    torch.profiler for the device's busy time and kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import init_state
    from repro_torch.core.registry import get_protocol
    from repro_torch.core.store import init_store
    from repro_torch.core.sweep import GridSpec, engine_config, resolve_knobs

    gs = GridSpec(protocol="nowait", workload="smallbank", kernel_plane="kernel", device="cuda")
    ec, cm, wl = engine_config(gs, resolve_knobs("smallbank", {"hybrid": 63}))
    tick = get_protocol("nowait").tick
    st = init_state(ec, wl)
    store = init_store("twopl", ec.n_records, wl.rw, wl.init_value, device="cuda")
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            st, store = tick(ec, cm, wl, st, store, t)
            t += 1
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n_ticks
    by_family = {}  # kernel name up to its template/argument list -> [launches, us] per tick
    for e in dev:
        fam = by_family.setdefault(e.name.split("<")[0].split("(")[0].strip(), [0.0, 0.0])
        fam[0] += 1 / n_ticks
        fam[1] += e.time_range.elapsed_us() / n_ticks
    top = sorted(by_family.items(), key=lambda kv: -kv[1][1])[:8]
    prof_line = {
        "tick_wall_ms": wall_ms, "device_busy_ms_per_tick": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if dev else None,
        "device_ops_per_tick": len(dev) / n_ticks,
        "top_device_launches_and_us_per_tick": dict(top),
        "kernel_device_us": {
            n: sum(e.time_range.elapsed_us() for e in dev if n + "_kernel" in e.name)
            / max(1, sum(1 for e in dev if n + "_kernel" in e.name))
            for n in ("lock_arbiter", "multi_read")
        },
    }
    log("profile: " + json.dumps(prof_line))


def main_path_spec(plane):
    from repro_torch.api import ExperimentSpec

    return ExperimentSpec(
        protocol="nowait", workload="smallbank", configs=[{"hybrid": c} for c in CODES], kernel_plane=plane
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
    phase_profile()

    # phase 4: the main path on the kernel plane; launches counted from 0
    lock_arbiter.launches = 0
    multi_read.launches = 0
    pl = api.plan(main_path_spec("kernel"))
    log(pl.summary())
    res = api.execute(pl)
    launches = {"lock_arbiter": lock_arbiter.launches, "multi_read": multi_read.launches}
    n_ticks = len(CODES) * (pl.grid_spec.ticks + pl.grid_spec.warmup)
    log(f"main path (kernel plane): {res.wall_s:.3f} s for {n_ticks} ticks, launches {launches}")
    show_rows("kernel", res)
    expect = {"lock_arbiter": n_ticks, "multi_read": 2 * n_ticks}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")

    # phase 5: the torch plane gives the same counters
    res_t = api.run(main_path_spec("torch"))
    log(f"main path (torch plane): {res_t.wall_s:.3f} s")
    show_rows("torch", res_t)
    for a, b in zip(res.rows, res_t.rows):
        for k in ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips"):
            if a[k] != b[k]:
                raise AssertionError(f"planes disagree on {a['hybrid']} {k}: {a[k]} vs {b[k]}")
    log("planes agree bitwise on the counters")

    # phase 6: the JAX reference's golden counters
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_nowait_smallbank.json")) as f:
        golden = json.load(f)["rows"]
    got = [{"hybrid": r["hybrid"], "commits": r["commits"], "aborts": r["aborts"]} for r in res.rows]
    if got != golden:
        raise AssertionError(f"counters {got} != JAX golden {golden}")
    log("golden: counters equal the JAX reference's")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
