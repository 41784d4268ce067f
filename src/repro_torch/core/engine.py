"""Bulk-synchronous vectorized transaction engine (port of
``repro.core.engine``, dense layout).

One engine *tick* is one network round.  Every node runs C co-routine
slots; each slot drives one transaction through its protocol's stage
machine.  RPC requests queue on the destination handler CPU (local
co-routines in their execution phase starve it, Fig. 9); one-sided verbs
queue on the RNIC.

All state lives in dicts of tensors on ``EngineConfig.device``; a run is a
Python loop over ticks.  The code is functional like the reference: every
step builds new tensors and leaves its inputs untouched, so a later read
in the same tick sees exactly what the reference's would.  The store
scatters (:func:`write_rows`) write into a fresh copy with one spare row
that takes the reference's out-of-range "drop" index.  The only in-place
updates are to tensors the same function has just allocated
(``_scatter_drop``'s copy, ``service_ops``' ranks, ``account_round``'s
copy of ``stage_us``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel as cmod
from repro_torch.core import prng
from repro_torch.core.arbiter import hash_prio
from repro_torch.core.costmodel import N_STAGES, RPC, CostModel
from repro_torch.core.store import init_store
from repro_torch.core.timestamps import TS, ts_eq, ts_is_zero
from repro_torch.kernels import ops as kops

_I32_MIN = -(2**31)


@dataclass(frozen=True)
class EngineConfig:
    """Engine configuration (the reference's fields, dense layout).

    ``hybrid`` holds one primitive per canonical stage (Python ints: the
    port runs each config on its own, so protocol code may branch on it).
    ``active_coroutines`` / ``active_records_per_node`` are the bucket
    padding extents: only the first ``active_*`` slots per node run and
    only the first ``active_records_per_node`` rows per node are
    addressable, while every identity-derived value uses LOGICAL ids, so a
    padded run equals the unpadded one bitwise.  ``kernel_plane`` picks the
    hot-path backend (:mod:`repro_torch.kernels.ops`); ``device`` is where
    every tensor of the run lives.
    """

    protocol: str
    n_nodes: int = 4
    coroutines: int = 10
    records_per_node: int = 16384
    active_coroutines: Optional[int] = None
    active_records_per_node: Optional[int] = None
    rw: int = 2
    max_ops: int = 4
    hybrid: Tuple[int, ...] = (RPC,) * N_STAGES
    doorbell: bool = True
    merge_stages: bool = False
    exec_ticks: int = 1
    history_cap: int = 0
    mvcc_slots: int = 4
    seed: int = 0
    kernel_plane: str = kops.TORCH
    device: str = "cuda"

    @property
    def n_slots(self) -> int:
        return self.n_nodes * self.coroutines

    @property
    def n_records(self) -> int:
        return self.n_nodes * self.records_per_node


class Workload(NamedTuple):
    name: str
    rw: int
    max_ops: int
    init_value: int
    # gen(keys (N, 2), slot_node (N,), slot_id (N,)) -> (keys, is_w, valid), each (N, K)
    gen: Callable
    # execute(keys, is_w, valid, rvals (N, K, RW)) -> wvals (N, K, RW)
    execute: Callable
    exec_ticks: int = 1


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_state(ec: EngineConfig, wl: Workload) -> Dict[str, torch.Tensor]:
    N, K, RW = ec.n_slots, ec.max_ops, wl.rw
    dev = ec.device

    def z(*s):
        return torch.zeros(s, dtype=torch.int32, device=dev)

    def zb(*s):
        return torch.zeros(s, dtype=torch.bool, device=dev)

    def zf(*s):
        return torch.zeros(s, dtype=torch.float32, device=dev)

    st = {
        "keys": z(N, K),
        "is_w": zb(N, K),
        "valid": zb(N, K),
        "rvals": z(N, K, RW),
        "wvals": z(N, K, RW),
        "stage": torch.full((N,), -1, dtype=torch.int32, device=dev),  # -1 => fresh slot
        "substep": z(N),
        "ts_hi": z(N),
        "ts_lo": z(N),
        "clock": z(N),
        "locked": zb(N, K),
        "served": zb(N, K),
        "seq_seen": z(N, K),
        "ver_seen": z(N, K),
        "wts_seen_hi": z(N, K),
        "wts_seen_lo": z(N, K),
        "commit_hi": z(N),
        "commit_lo": z(N),
        "exec_left": z(N),
        "lat_us": zf(N),
        "rounds": z(N),
        "txn_no": z(N),
        "n_commit": z(N),
        "n_abort": z(N),
        "lat_sum": zf(N),
        "rt_sum": zf(N),
        "stage_us": zf(N_STAGES),
        "wait_us": zf(1),
        "tick": z(1),
    }
    if ec.history_cap:
        H = ec.history_cap
        st["h_idx"] = z(1)
        st["h_keys"] = z(H, K)
        st["h_ver_r"] = z(H, K)
        st["h_ver_w"] = z(H, K)
        st["h_isw"] = zb(H, K)
        st["h_valid"] = zb(H, K)
        st["h_ts_hi"] = z(H)
        st["h_ts_lo"] = z(H)
    return st


# The id tensors below depend on the (frozen, hashable) config alone; the
# reference's compiler folds them to constants, the port builds them once.
@functools.lru_cache(maxsize=32)
def _ids(ec: EngineConfig):
    sid = torch.arange(ec.n_slots, dtype=torch.int32, device=ec.device)
    node = sid // ec.coroutines
    if ec.active_coroutines is None:
        lsid, alive = sid, None
    else:
        c = sid % ec.coroutines
        lsid, alive = node * int(ec.active_coroutines) + c, c < int(ec.active_coroutines)
    return sid, node, lsid, alive


@functools.lru_cache(maxsize=32)
def _op_index(ec: EngineConfig, k: int):
    lsid = _ids(ec)[2]
    return lsid[:, None] * k + torch.arange(k, dtype=torch.int32, device=ec.device)[None, :]


@functools.lru_cache(maxsize=32)
def _slot_keys(ec: EngineConfig):
    """``fold_in(PRNGKey(seed), lsid)``: each slot's RNG stream key."""
    return prng.fold_in(prng.prng_key(ec.seed, ec.device), _ids(ec)[2])


def slot_ids(ec: EngineConfig):
    sid, node, _, _ = _ids(ec)
    return sid, node  # (slot, node)


def logical_ids(ec: EngineConfig):
    """(logical slot id, node, alive mask) under bucket padding.

    The logical id is the slot's identity in the UNPADDED system
    (node * active_coroutines + coroutine).  ``alive`` is None when the
    coroutine axis is unpadded.
    """
    _, node, lsid, alive = _ids(ec)
    return lsid, node, alive


def alive_mask(ec: EngineConfig):
    """(n_slots,) bool of live slots, or None when nothing is padded."""
    return _ids(ec)[3]


def op_index(ec: EngineConfig, k: int):
    """(n_slots, k) logical flat op index ``lsid * k + op``."""
    return _op_index(ec, k)


def physical_keys(ec: EngineConfig, keys):
    """Map workload-generated LOGICAL keys onto the padded store layout:
    node k // aR gets physical row ``node * records_per_node + k % aR``."""
    if ec.active_records_per_node is None:
        return keys
    a_r = int(ec.active_records_per_node)
    return (keys // a_r) * ec.records_per_node + keys % a_r


def regen_txns(ec: EngineConfig, wl: Workload, st: Dict, mask, *, new_ts=True) -> Dict:
    """Generate fresh transactions for slots in `mask` (LOGICAL ids only)."""
    lsid, node, alive = logical_ids(ec)
    if alive is not None:
        mask = mask & alive
    txn_keys = prng.fold_in(_slot_keys(ec), st["txn_no"])
    keys, is_w, valid = wl.gen(txn_keys, node, lsid)
    keys = physical_keys(ec, keys)
    st = dict(st)
    m2 = mask[:, None]
    st["keys"] = torch.where(m2, keys, st["keys"])
    st["is_w"] = torch.where(m2, is_w, st["is_w"])
    st["valid"] = torch.where(m2, valid, st["valid"])
    st["txn_no"] = torch.where(mask, st["txn_no"] + 1, st["txn_no"])
    st["locked"] = st["locked"] & ~m2
    st["served"] = st["served"] & ~m2
    st["substep"] = torch.where(mask, 0, st["substep"])
    st["rounds"] = torch.where(mask, 0, st["rounds"])
    st["lat_us"] = torch.where(mask, 0.0, st["lat_us"])
    if new_ts:
        clock = st["clock"] + mask.to(torch.int32)
        # lo encodes the unique LOGICAL slot id (padding-invariant)
        st["ts_hi"] = torch.where(mask, clock, st["ts_hi"])
        st["ts_lo"] = torch.where(mask, lsid + 1, st["ts_lo"])
        st["clock"] = clock
    return st


def per_op(x, k: int):
    """(N,) -> (N*k,): each slot's value repeated for its k ops (``jnp.repeat``)."""
    return x[:, None].expand(-1, k).reshape(-1)


def txn_ts(st) -> TS:
    return TS(st["ts_hi"], st["ts_lo"])


# ---------------------------------------------------------------------------
# Per-tick service-capacity model
# ---------------------------------------------------------------------------


def service_ops(ec: EngineConfig, cm: CostModel, st: Dict, op_mask, primitive_is_rpc: bool, salt: int):
    """Which requested ops get served this tick, given per-node capacities.

    op_mask (N,K) bool: ops wanting a round this tick.  Returns
    (served (N,K), dest_load (N,K) float32: same-plane load at each op's
    destination).  Requests rank within (destination, plane) by a hashed
    arrival priority; the sort is stable, as the reference's.
    """
    N, K = op_mask.shape
    dev = op_mask.device
    keys_f = st["keys"].reshape(-1)
    active = op_mask.reshape(-1)
    dest = torch.clamp(keys_f // ec.records_per_node, 0, ec.n_nodes - 1)
    plane = int(bool(primitive_is_rpc))

    # execution-phase co-routines starve their node's RPC handler (Fig. 9)
    _, node, _ = logical_ids(ec)
    exec_load = torch.zeros((ec.n_nodes,), dtype=torch.int32, device=dev).index_add(
        0, node, (st["exec_left"] > 0).to(torch.int32)
    )
    rpc_cap = torch.clamp(cm.handler_cap - exec_load * max(1, ec.exec_ticks), min=1)
    nic_cap = int(np.float32(cm.nic_eff_cap()))

    prio = hash_prio(op_index(ec, K).reshape(-1) + per_op(st["ts_lo"], K), salt)
    group = dest * 2 + plane
    sort_key = torch.where(active, group * (2**20) + (prio & (2**20 - 1)), 2**30)
    order = torch.argsort(sort_key, stable=True)
    # rank within group via the running start of each group's sorted run
    g_sorted = group[order]
    first = torch.ones_like(g_sorted, dtype=torch.bool)
    first[1:] = g_sorted[1:] != g_sorted[:-1]
    idx_in_sorted = torch.arange(N * K, dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(first, idx_in_sorted, 0), dim=0).values
    rank = torch.empty_like(idx_in_sorted)
    rank[order] = idx_in_sorted - seg_start

    cap = rpc_cap[dest] if plane else nic_cap
    served = active & (rank < cap)

    # same-plane per-destination load (for queue-delay accounting)
    slot = dest.long() * 2 + plane
    load = torch.zeros((ec.n_nodes * 2,), dtype=torch.int32, device=dev).index_add(
        0, slot, active.to(torch.int32)
    )
    op_load = load[slot].to(torch.float32)
    return served.reshape(N, K), op_load.reshape(N, K)


def base_time(ec: EngineConfig, cm: CostModel, st: Dict, canon_stage) -> Dict:
    """Per-tick base time: every active txn spends tick_us in its stage.

    canon_stage (N,) int32: canonical cost-stage id of each active txn
    (negative => inactive).
    """
    st = dict(st)
    active = canon_stage >= 0
    tick = torch.where(active, cm.tick_us, 0.0)
    st["lat_us"] = st["lat_us"] + tick
    st["stage_us"] = _scatter_drop(
        st["stage_us"], torch.where(active, canon_stage, N_STAGES), tick, accumulate=True
    )
    return st


def account_round(
    ec: EngineConfig,
    cm: CostModel,
    st: Dict,
    stage_id: int,
    op_mask,
    op_load,
    primitive: int,
    bytes_per_op,
    n_verbs: int = 1,
) -> Dict:
    """Attribute one round's *extras* (beyond the tick base) per txn:
    (plane RTT - tick) + MMIO + wire bytes + destination queueing.  Also
    counts the network round for the round-trip metric (Fig. 5)."""
    per_op = cmod.round_latency_us(
        cm, primitive == RPC, op_load, bytes_per_op, n_verbs=n_verbs, doorbell=ec.doorbell
    ) - cm.tick_us
    per_op = torch.where(op_mask, per_op, float("-inf"))
    per_txn = per_op.amax(dim=1)  # outstanding requests overlap within a round
    txn_mask = op_mask.any(dim=1)
    per_txn = torch.where(txn_mask, per_txn, 0.0)
    st = dict(st)
    st["lat_us"] = st["lat_us"] + per_txn
    st["rounds"] = st["rounds"] + txn_mask.to(torch.int32)
    stage_us = st["stage_us"].clone()
    stage_us[stage_id] += per_txn.sum()
    st["stage_us"] = stage_us
    return st


# ---------------------------------------------------------------------------
# Store access helpers (the two communication planes differ only in cost and
# round structure; raw memory semantics are identical).
# ---------------------------------------------------------------------------


def _scatter_drop(arr, idx, vals, *, accumulate: bool = False):
    """``arr.at[idx].set/add(vals, mode="drop")``: a new tensor with rows
    ``idx`` written, where an index >= ``len(arr)`` drops its write.

    The copy carries one spare row that takes every dropped write; the
    result is a view of its first ``len(arr)`` rows.  Adds to a repeated
    index accumulate.
    """
    n = arr.shape[0]
    ext = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    if not isinstance(vals, torch.Tensor):
        vals = torch.full((), vals, dtype=arr.dtype, device=arr.device)
    ext.index_put_((torch.clamp(idx, max=n).long(),), vals, accumulate=accumulate)
    return ext[:n]


def gather_rows(arr, keys):
    """arr (R, ...) at keys (N,K) -> (N,K,...)."""
    return arr[keys.reshape(-1)].reshape(keys.shape + arr.shape[1:])


def read_rows(ec: EngineConfig, arr, keys):
    return gather_rows(arr, keys)


def read_rows_many(ec: EngineConfig, arrs: Sequence, keys) -> Tuple:
    """Gather several store arrays at the same keys: independent gathers
    (torch plane) or ONE multi-read launch that reads every array in place
    (kernel plane)."""
    if ec.kernel_plane == kops.KERNEL:
        return kops.gather_many(arrs, keys, plane=ec.kernel_plane)
    return tuple(gather_rows(a, keys) for a in arrs)


def read_rows2(ec: EngineConfig, arr, keys, sel):
    """(row, slot) gather from a (R, S, ...) store array (MVCC versions)."""
    flat = arr[keys.reshape(-1), sel.reshape(-1)]
    return flat.reshape(keys.shape + arr.shape[2:])


def write_rows(ec: EngineConfig, arr, idx, vals, *, op: str = "set"):
    """Row scatter.  ``idx`` (M,) rows, with the drop sentinel
    (>= n_records) for masked-off requests."""
    return _scatter_drop(arr, idx, vals, accumulate=op == "add")


def write_rows2(ec: EngineConfig, arr, idx, sel, vals, *, op: str = "set"):
    """(row, slot) scatter into a (R, S, ...) store array."""
    R, S = arr.shape[0], arr.shape[1]
    flat = arr.reshape((R * S,) + tuple(arr.shape[2:]))
    fidx = torch.where(idx < R, idx * S + sel, R * S)
    return _scatter_drop(flat, fidx, vals, accumulate=op == "add").reshape(arr.shape)


def arb_winner(ec: EngineConfig, keys, prio_hi, prio_lo, active):
    """Per-key CAS arbitration (the RNIC's serialization of one round):
    scatter-min (torch plane) or the arbitration kernel (kernel plane),
    the same lexicographic-min winners bitwise."""
    return kops.cas_arbitrate(keys, prio_hi, prio_lo, active, ec.n_records, plane=ec.kernel_plane)


def scatter_ts_max(ec: EngineConfig, hi_arr, lo_arr, idx, ch, cl, active):
    """Lexicographic scatter-max of (ch, cl) timestamps into a store TS pair
    (MVCC rts bump, SUNDIAL lease renewal)."""
    r = ec.n_records
    li = torch.clamp(idx, max=r).long()

    def seg_max(vals):
        ext = torch.full((r + 1,), _I32_MIN, dtype=torch.int32, device=vals.device)
        return ext.scatter_reduce(0, li, vals, "amax")[:r]

    cand_hi = seg_max(torch.where(active, ch, _I32_MIN))
    at_max = active & (ch == cand_hi[torch.clamp(idx, 0, r - 1).long()])
    cand_lo = seg_max(torch.where(at_max, cl, _I32_MIN))
    upd = (hi_arr < cand_hi) | ((hi_arr == cand_hi) & (lo_arr < cand_lo))
    return torch.where(upd, cand_hi, hi_arr), torch.where(upd, cand_lo, lo_arr)


def try_lock(ec: EngineConfig, store, st, op_mask, prio_hi, prio_lo):
    """Arbitrated CAS on lock words for ops in op_mask.

    Returns (won (N,K), store').  A CAS wins iff the lock is free (or held
    by this txn) and it is the per-key arbitration winner this round.
    """
    N, K = op_mask.shape
    keys_f = st["keys"].reshape(-1)
    active = op_mask.reshape(-1)
    win = arb_winner(ec, keys_f, prio_hi.reshape(-1), prio_lo.reshape(-1), active)
    lock_hi, lock_lo = read_rows_many(ec, (store["lock_hi"], store["lock_lo"]), st["keys"])
    lock = TS(lock_hi, lock_lo)
    mine = ts_eq(lock, TS(st["ts_hi"][:, None], st["ts_lo"][:, None]))
    free = ts_is_zero(lock) | mine
    won = win.reshape(N, K) & free & op_mask
    wf = won.reshape(-1)
    ts = txn_ts(st)
    new_hi = per_op(ts.hi, K)
    new_lo = per_op(ts.lo, K)
    store = dict(store)
    idx_w = torch.where(wf, keys_f, ec.n_records)
    store["lock_hi"] = write_rows(ec, store["lock_hi"], idx_w, torch.where(wf, new_hi, 0))
    store["lock_lo"] = write_rows(ec, store["lock_lo"], idx_w, torch.where(wf, new_lo, 0))
    return won, store


def release_locks(ec: EngineConfig, store, st, rel_mask):
    """Zero lock words this txn holds for ops in rel_mask."""
    keys_f = st["keys"].reshape(-1)
    m = (rel_mask & st["locked"]).reshape(-1)
    store = dict(store)
    idx = torch.where(m, keys_f, ec.n_records)
    store["lock_hi"] = write_rows(ec, store["lock_hi"], idx, 0)
    store["lock_lo"] = write_rows(ec, store["lock_lo"], idx, 0)
    return store


def finish_commit(ec: EngineConfig, cm: CostModel, st: Dict, mask) -> Dict:
    st = dict(st)
    st["n_commit"] = st["n_commit"] + mask.to(torch.int32)
    st["lat_sum"] = st["lat_sum"] + torch.where(mask, st["lat_us"], 0.0)
    st["rt_sum"] = st["rt_sum"] + torch.where(mask, st["rounds"].to(torch.float32), 0.0)
    if ec.history_cap:
        H = ec.history_cap
        offs = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
        row = torch.where(mask, st["h_idx"][0] + offs, H)  # drop when full
        row = torch.where(row < H, row, H)
        st["h_keys"] = _scatter_drop(st["h_keys"], row, st["keys"])
        st["h_ver_r"] = _scatter_drop(st["h_ver_r"], row, st["ver_seen"])
        ver_w = st["ver_seen"] + st["is_w"].to(torch.int32)
        st["h_ver_w"] = _scatter_drop(st["h_ver_w"], row, ver_w)
        st["h_isw"] = _scatter_drop(st["h_isw"], row, st["is_w"])
        st["h_valid"] = _scatter_drop(st["h_valid"], row, st["valid"])
        st["h_ts_hi"] = _scatter_drop(st["h_ts_hi"], row, st["ts_hi"])
        st["h_ts_lo"] = _scatter_drop(st["h_ts_lo"], row, st["ts_lo"])
        st["h_idx"] = st["h_idx"] + mask.sum(dtype=torch.int32)
    return st


def finish_abort(st: Dict, mask) -> Dict:
    st = dict(st)
    st["n_abort"] = st["n_abort"] + mask.to(torch.int32)
    return st


# ---------------------------------------------------------------------------
# Run loop + metrics
# ---------------------------------------------------------------------------


def run(
    protocol_tick,
    ec: EngineConfig,
    cm: CostModel,
    wl: Workload,
    n_ticks: int,
    warmup: int = 0,
    *,
    ticks_active: Optional[int] = None,
):
    """Run the engine; returns (final_state, final_store, metrics dict).

    ``ticks_active`` (None = ``n_ticks``) runs only the first
    ``ticks_active`` measured ticks: the reference freezes its whole carry
    on the ticks past ``warmup + ticks_active``, which is the same as
    stopping the loop there.
    """
    from repro_torch.core.registry import protocol_family

    store = init_store(
        protocol_family(ec.protocol), ec.n_records, wl.rw, wl.init_value,
        n_versions=ec.mvcc_slots, device=ec.device,
    )
    st = init_state(ec, wl)

    def tick(st, store, t):
        st, store = protocol_tick(ec, cm, wl, st, store, t)
        st = dict(st)
        st["tick"] = st["tick"] + 1
        return st, store

    for t in range(warmup):
        st, store = tick(st, store, t)
    if warmup:
        # reset counters after warmup
        for k in ("n_commit", "n_abort", "lat_sum", "rt_sum", "stage_us"):
            st[k] = torch.zeros_like(st[k])
    n_live = n_ticks if ticks_active is None else max(0, min(int(ticks_active), n_ticks))
    for t in range(warmup, warmup + n_live):
        st, store = tick(st, store, t)
    n_eff = n_ticks if ticks_active is None else ticks_active
    return st, store, summarize(ec, cm, st, n_eff)


def summarize(ec: EngineConfig, cm: CostModel, st: Dict, n_ticks: int) -> Dict[str, Any]:
    """Run metrics as tensors on the run's device (float32 ratios computed
    as the reference computes them)."""
    commits = st["n_commit"].sum(dtype=torch.int32)
    aborts = st["n_abort"].sum(dtype=torch.int32)
    sim_us = n_ticks * cm.tick_us
    per_commit = torch.clamp(commits, min=1)
    return {
        "commits": commits,
        "aborts": aborts,
        "throughput_mtps": commits / sim_us,  # million txns/sec (txns per us)
        "avg_latency_us": st["lat_sum"].sum() / per_commit,
        "abort_rate": aborts / torch.clamp(commits + aborts, min=1),
        "avg_round_trips": st["rt_sum"].sum() / per_commit,
        "stage_us_per_commit": st["stage_us"] / per_commit,
    }
