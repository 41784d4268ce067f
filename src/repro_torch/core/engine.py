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
(``scatter_drop``'s copy, ``service_ops``' ranks, ``account_round``'s
copy of ``stage_us``).

**The config axis.**  One run carries ``EngineConfig.n_configs`` = G
configs of one shape bucket at once, where the reference vmaps them.  Every
state tensor is (G·N, ...), the contiguous view of (G, N, ...) with N =
``n_slots`` rows per config; every store array is (G·R, ...) with R =
``n_records``.  ``st["keys"]`` holds STORE ROWS: config g's key k is row
g·R + k, so every gather, scatter and kernel reads the flat store with no
offset at its boundary, and the drop sentinel ``store_rows`` = G·R lies
past every config.  Per-config quantities (``stage_us``, ``h_idx``, the
history rows) are flat (G·X, ...) as well, so a run of one config has
exactly the reference's shapes.  A knob (``hybrid`` per stage, ``seed``,
``exec_ticks``, the active extents) is one Python value when every config
of the run shares it, so a run whose configs agree computes no per-config
select, or a tuple of G values, expanded per row by :func:`per_row`.
The rest of the code is the same for every G, one config included.

**The node mesh.**  ``EngineConfig.shard`` is None for the dense run, or
a :class:`~repro_torch.core.planes.NodeShard` (see :func:`run_sharded`).
The state then stays on the coordinator (``device`` = the shard's first
device) while every store array is a ``planes.Shards`` tuple of per-shard
(G·R_l, ...) tensors, and every store access below routes through the
planes transport: an owner-local step per shard and one exchange.  The
steps that read no store word (the capacity ranking, the CAS contest)
run once on the coordinator, as in the dense run.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import costmodel as cmod
from repro_torch.core import planes, prng
from repro_torch.core.arbiter import hash_prio
from repro_torch.core.costmodel import N_STAGES, RPC, CostModel
from repro_torch.core.planes import NodeShard, Shards, scatter_drop
from repro_torch.core.store import init_store
from repro_torch.core.timestamps import TS, ts_eq, ts_is_zero
from repro_torch.kernels import ops as kops

# a per-config knob: one value for every config, or a tuple of one per config
Knob = Union[int, float, Tuple]


@dataclass(frozen=True)
class EngineConfig:
    """Engine configuration (the reference's fields, dense layout).

    ``n_configs`` configs of one shape run at once (module docstring).
    ``hybrid`` holds one primitive per canonical stage, each a Python int
    (every config) or a tuple of one per config; ``seed``, ``exec_ticks``
    and the active extents likewise.  ``active_coroutines`` /
    ``active_records_per_node`` are the bucket padding extents: only the
    first ``active_*`` slots per node run and only the first
    ``active_records_per_node`` rows per node are addressable, while every
    identity-derived value uses LOGICAL ids, so a padded run equals the
    unpadded one bitwise.  ``kernel_plane`` picks the hot-path backend
    (:mod:`repro_torch.kernels.ops`); ``device`` is where every tensor of
    the run lives, or, with ``shard`` set (the node mesh), where the
    replicated state lives: the shard's first device.
    """

    protocol: str
    n_nodes: int = 4
    coroutines: int = 10
    records_per_node: int = 16384
    active_coroutines: Optional[Knob] = None
    active_records_per_node: Optional[Knob] = None
    rw: int = 2
    max_ops: int = 4
    hybrid: Tuple[Knob, ...] = (RPC,) * N_STAGES
    doorbell: bool = True
    merge_stages: bool = False
    exec_ticks: Knob = 1
    history_cap: int = 0
    mvcc_slots: int = 4
    seed: Knob = 0
    kernel_plane: str = kops.TORCH
    device: str = "cuda"
    n_configs: int = 1
    shard: Optional[NodeShard] = None

    def __post_init__(self):
        for name in ("active_coroutines", "active_records_per_node", "exec_ticks", "seed"):
            _check_knob(self, name, getattr(self, name))
        for stage, v in enumerate(self.hybrid):
            _check_knob(self, f"hybrid[{stage}]", v)

    @property
    def n_slots(self) -> int:
        """Co-routine slots per config (rows of state per config)."""
        return self.n_nodes * self.coroutines

    @property
    def n_records(self) -> int:
        """Store rows per config."""
        return self.n_nodes * self.records_per_node

    @property
    def store_rows(self) -> int:
        """Rows of every store array (all configs), and the drop sentinel."""
        return self.n_configs * self.n_records

    @property
    def records_local(self) -> int:
        """Store rows of one config that one node shard owns (= n_records
        when dense)."""
        return self.n_records // (self.shard.n_shards if self.shard else 1)


def _check_knob(ec: EngineConfig, name: str, v) -> None:
    if isinstance(v, tuple) and len(v) != ec.n_configs:
        raise ValueError(f"EngineConfig.{name}: {len(v)} values for n_configs={ec.n_configs}")


def uniform(v) -> Knob:
    """A knob's values, one per config, as the engine takes them: the one
    value when all are equal, else the tuple."""
    v = tuple(v)
    return v[0] if all(x == v[0] for x in v) else v


class Workload(NamedTuple):
    name: str
    rw: int
    max_ops: int
    init_value: int
    # gen(keys (N, 2), slot_node (N,), slot_id (N,)[, per_row]) -> (keys, is_w, valid), each (N, K);
    # a run of several configs passes per_row(value, dtype), which maps a knob given per config to its
    # (N,) values
    gen: Callable
    # execute(keys, is_w, valid, rvals (N, K, RW)) -> wvals (N, K, RW)
    execute: Callable
    exec_ticks: Knob = 1


# ---------------------------------------------------------------------------
# Per-config knobs, per row
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _expanded(ec: EngineConfig, v: tuple, dtype: torch.dtype, per: int):
    return torch.tensor(v, dtype=dtype, device=ec.device).repeat_interleave(per)


def per_row(ec: EngineConfig, v, dtype=torch.int32):
    """A knob as the state rows see it: ``v`` itself when it is one value
    for every config, else a (G·N,) tensor of each row's config's value."""
    return _expanded(ec, v, dtype, ec.n_slots) if isinstance(v, tuple) else v


def per_node(ec: EngineConfig, v, dtype=torch.int32):
    """A knob per simulated node of the batch (G·n_nodes,), or ``v`` itself."""
    return _expanded(ec, v, dtype, ec.n_nodes) if isinstance(v, tuple) else v


def per_config(ec: EngineConfig, v, dtype=torch.int32):
    """A knob per config (G,), or ``v`` itself."""
    return _expanded(ec, v, dtype, 1) if isinstance(v, tuple) else v


@functools.lru_cache(maxsize=256)
def stage_primitive(ec: EngineConfig, stage: int):
    """The stage's primitive (RPC / ONE_SIDED): an int, or (G·N,) int32."""
    return per_row(ec, ec.hybrid[stage])


@functools.lru_cache(maxsize=256)
def stage_is_rpc(ec: EngineConfig, stage: int):
    """Whether the stage runs over RPC: a Python bool, or (G·N,) bool."""
    v = ec.hybrid[stage]
    if isinstance(v, tuple):
        return per_row(ec, tuple(x == RPC for x in v), torch.bool)
    return v == RPC


@functools.lru_cache(maxsize=64)
def nic_unit(ec: EngineConfig, cm: CostModel, per: int):
    """The one-sided queueing unit (``cm.nic_unit()``, float32) repeated
    ``per`` times for each config, when ``cm.qp_pressure`` differs by
    config; else None (the one value applies)."""
    if not isinstance(cm.qp_pressure, tuple):
        return None
    return torch.from_numpy(np.asarray(cm.nic_unit(), np.float32)).to(ec.device).repeat_interleave(per)


@functools.lru_cache(maxsize=64)
def _nic_cap(ec: EngineConfig, cm: CostModel):
    """One-sided verbs a node's RNIC serves per tick (the reference's
    float32 capacity truncated to int32): an int, or (G·n_nodes,) int32
    when ``cm.qp_pressure`` differs by config."""
    nic = np.asarray(cm.nic_eff_cap(), np.float32).astype(np.int32)
    if nic.ndim == 0:
        return int(nic)
    return torch.from_numpy(nic).to(ec.device).repeat_interleave(ec.n_nodes)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_state(ec: EngineConfig, wl: Workload) -> Dict[str, torch.Tensor]:
    G, N, K, RW = ec.n_configs, ec.n_configs * ec.n_slots, ec.max_ops, wl.rw
    dev = ec.device

    def z(*s):
        return torch.zeros(s, dtype=torch.int32, device=dev)

    def zb(*s):
        return torch.zeros(s, dtype=torch.bool, device=dev)

    def zf(*s):
        return torch.zeros(s, dtype=torch.float32, device=dev)

    ids = _ids(ec)
    st = {
        # a fresh slot's keys: key 0 of its own config (the reference's zeros)
        "keys": ids.row0[:, None].expand(N, K).contiguous(),
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
        "stage_us": zf(G * N_STAGES),
        "wait_us": zf(G),
        "tick": z(1),
    }
    if ec.history_cap:
        H = G * ec.history_cap
        st["h_idx"] = z(G)
        st["h_keys"] = z(H, K)
        st["h_ver_r"] = z(H, K)
        st["h_ver_w"] = z(H, K)
        st["h_isw"] = zb(H, K)
        st["h_valid"] = zb(H, K)
        st["h_ts_hi"] = z(H)
        st["h_ts_lo"] = z(H)
    return st


class Ids(NamedTuple):
    """Per-row identity tensors of a run (all (G·N,) int32 or bool)."""

    sid: torch.Tensor  # slot id within its config
    node: torch.Tensor  # node within its config
    lsid: torch.Tensor  # LOGICAL slot id (padding-invariant)
    alive: Optional[torch.Tensor]  # live slot (None: the coroutine axis is unpadded)
    cfg: torch.Tensor  # config index
    row0: torch.Tensor  # first store row of the row's config
    node0: torch.Tensor  # first batch node of the row's config


# The id tensors below depend on the (frozen, hashable) config alone; the
# reference's compiler folds them to constants, the port builds them once.
@functools.lru_cache(maxsize=64)
def _ids(ec: EngineConfig) -> Ids:
    dev, G, N = ec.device, ec.n_configs, ec.n_slots
    sid = torch.arange(N, dtype=torch.int32, device=dev).repeat(G)
    node = sid // ec.coroutines
    cfg = torch.arange(G, dtype=torch.int32, device=dev).repeat_interleave(N)
    act = ec.active_coroutines
    if act is None:
        lsid, alive = sid, None
    else:
        c = sid % ec.coroutines
        act = per_row(ec, act)
        lsid, alive = node * act + c, c < act
    return Ids(sid, node, lsid, alive, cfg, cfg * ec.n_records, cfg * ec.n_nodes)


@functools.lru_cache(maxsize=64)
def _op_index(ec: EngineConfig, k: int):
    lsid = _ids(ec).lsid
    return lsid[:, None] * k + torch.arange(k, dtype=torch.int32, device=ec.device)[None, :]


@functools.lru_cache(maxsize=64)
def slot_keys(ec: EngineConfig):
    """``fold_in(PRNGKey(seed), lsid)``: each slot's RNG stream key (G·N, 2)."""
    lsid = _ids(ec).lsid
    if not isinstance(ec.seed, tuple):
        return prng.fold_in(prng.prng_key(ec.seed, ec.device), lsid)
    key0 = torch.stack([prng.prng_key(s) for s in ec.seed]).to(ec.device)
    return prng.fold_in(key0.repeat_interleave(ec.n_slots, dim=0), lsid)


def slot_ids(ec: EngineConfig):
    ids = _ids(ec)
    return ids.sid, ids.node  # (slot, node)


def logical_ids(ec: EngineConfig):
    """(logical slot id, node, alive mask) under bucket padding.

    The logical id is the slot's identity in the UNPADDED system
    (node * active_coroutines + coroutine).  ``alive`` is None when the
    coroutine axis is unpadded.
    """
    ids = _ids(ec)
    return ids.lsid, ids.node, ids.alive


def alive_mask(ec: EngineConfig):
    """(G·N,) bool of live slots, or None when nothing is padded."""
    return _ids(ec).alive


def op_index(ec: EngineConfig, k: int):
    """(G·N, k) logical flat op index ``lsid * k + op``."""
    return _op_index(ec, k)


def physical_keys(ec: EngineConfig, keys):
    """Map workload-generated LOGICAL keys onto the padded store layout:
    node k // aR gets physical row ``node * records_per_node + k % aR``
    (within the key's config)."""
    if ec.active_records_per_node is None:
        return keys
    a_r = per_row(ec, ec.active_records_per_node)
    if isinstance(a_r, torch.Tensor):
        a_r = a_r[:, None]
    return (keys // a_r) * ec.records_per_node + keys % a_r


def local_keys(ec: EngineConfig, keys):
    """Store rows (G·N, K) -> each config's own key (the reference's keys)."""
    row0 = _ids(ec).row0
    return keys - row0[:, None]


def draw_txns(ec: EngineConfig, wl: Workload, keys):
    """Every slot's transaction from its PRNG key (G·N, 2): (store rows,
    is_w, valid), each (G·N, K).  The workload draws LOGICAL keys over its
    config's records; they are mapped onto the padded layout and offset to
    the config's rows.  A run of one config has no per-config knob, so its
    workload is called as the reference's, ``gen(keys, node, slot)``."""
    _, node, lsid, _, _, row0, _ = _ids(ec)
    if ec.n_configs == 1:
        rows, is_w, valid = wl.gen(keys, node, lsid)
    else:
        rows, is_w, valid = wl.gen(keys, node, lsid, functools.partial(per_row, ec))
    return physical_keys(ec, rows) + row0[:, None], is_w, valid


def regen_txns(ec: EngineConfig, wl: Workload, st: Dict, mask, *, new_ts=True) -> Dict:
    """Generate fresh transactions for slots in `mask` (LOGICAL ids only)."""
    lsid, _, alive = logical_ids(ec)
    if alive is not None:
        mask = mask & alive
    keys, is_w, valid = draw_txns(ec, wl, prng.fold_in(slot_keys(ec), st["txn_no"]))
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


def service_ops(ec: EngineConfig, cm: CostModel, st: Dict, op_mask, primitive_is_rpc, salt: int):
    """Which requested ops get served this tick, given per-node capacities.

    op_mask (G·N, K) bool: ops wanting a round this tick;
    ``primitive_is_rpc`` a Python bool or (G·N,) bool.  Returns (served
    (G·N, K), dest_load (G·N, K) float32: same-plane load at each op's
    destination).  Requests rank within (config, destination, plane) by a
    hashed arrival priority; the sort is stable, as the reference's, and
    runs along each config's row, so the int32 sort key never holds the
    config.

    Node-sharded, the ranking runs on the coordinator as in the dense run:
    it reads the replicated request set (keys, ``ts_lo``, ``exec_left``)
    and no store word, so the destination's own ranking would give the
    same flags.
    """
    N, K = op_mask.shape
    G = ec.n_configs
    dev = op_mask.device
    ids = _ids(ec)
    active = op_mask.reshape(-1)
    dest = torch.clamp(local_keys(ec, st["keys"]).reshape(-1) // ec.records_per_node, 0, ec.n_nodes - 1)
    bdest = dest + per_op(ids.node0, K)  # node of the batch
    if isinstance(primitive_is_rpc, torch.Tensor):
        plane = per_op(primitive_is_rpc.to(torch.int32), K)
    else:
        plane = int(bool(primitive_is_rpc))

    # execution-phase co-routines starve their node's RPC handler (Fig. 9)
    node = ids.node + ids.node0
    exec_load = torch.zeros((G * ec.n_nodes,), dtype=torch.int32, device=dev).index_add(
        0, node, (st["exec_left"] > 0).to(torch.int32)
    )
    et = per_node(ec, ec.exec_ticks)
    et = torch.clamp(et, min=1) if isinstance(et, torch.Tensor) else max(1, et)
    rpc_cap = torch.clamp(cm.handler_cap - exec_load * et, min=1)
    nic_cap = _nic_cap(ec, cm)
    if isinstance(nic_cap, torch.Tensor):
        nic_cap = nic_cap[bdest]

    prio = hash_prio(op_index(ec, K).reshape(-1) + per_op(st["ts_lo"], K), salt)
    group = dest * 2 + plane
    key = group * (2**20) + (prio & (2**20 - 1))
    if isinstance(plane, int):
        cap = rpc_cap[bdest] if plane else nic_cap
    else:
        cap = torch.where(plane > 0, rpc_cap[bdest], nic_cap)
    served = active & (_group_rank(torch.where(active, key, 2**30).view(G, -1), group.view(G, -1)) < cap)

    # same-plane per-destination load (for queue-delay accounting)
    slot = bdest.long() * 2 + plane
    load = torch.zeros((G * ec.n_nodes * 2,), dtype=torch.int32, device=dev).index_add(
        0, slot, active.to(torch.int32)
    )
    op_load = load[slot].to(torch.float32)
    return served.reshape(N, K), op_load.reshape(N, K)


def _group_rank(sort_key, group):
    """Each request's rank within its group: (G, M) int32 sort keys and
    groups -> (G·M,) ranks along each config's row (the sort is stable;
    a group's rank counts from the running start of its sorted run)."""
    order = torch.argsort(sort_key, dim=1, stable=True)
    g_sorted = group.gather(1, order)
    first = torch.ones_like(g_sorted, dtype=torch.bool)
    first[:, 1:] = g_sorted[:, 1:] != g_sorted[:, :-1]
    idx_in_sorted = torch.arange(g_sorted.shape[1], dtype=torch.int32, device=sort_key.device).expand_as(g_sorted)
    seg_start = torch.cummax(torch.where(first, idx_in_sorted, 0), dim=1).values
    return torch.empty_like(sort_key).scatter_(1, order, idx_in_sorted - seg_start).view(-1)


def base_time(ec: EngineConfig, cm: CostModel, st: Dict, canon_stage) -> Dict:
    """Per-tick base time: every active txn spends tick_us in its stage.

    canon_stage (G·N,) int32: canonical cost-stage id of each active txn
    (negative => inactive).
    """
    st = dict(st)
    active = canon_stage >= 0
    tick = torch.where(active, cm.tick_us, 0.0)
    st["lat_us"] = st["lat_us"] + tick
    G = ec.n_configs
    canon_stage = canon_stage + _ids(ec).cfg * N_STAGES
    st["stage_us"] = scatter_drop(
        st["stage_us"], torch.where(active, canon_stage, G * N_STAGES), tick, accumulate=True
    )
    return st


def _nic_per_op(ec: EngineConfig, cm: CostModel):
    unit = nic_unit(ec, cm, ec.n_slots)
    return None if unit is None else unit[:, None]


def account_round(
    ec: EngineConfig,
    cm: CostModel,
    st: Dict,
    stage_id: int,
    op_mask,
    op_load,
    primitive,
    bytes_per_op,
    n_verbs: int = 1,
) -> Dict:
    """Attribute one round's *extras* (beyond the tick base) per txn:
    (plane RTT - tick) + MMIO + wire bytes + destination queueing.  Also
    counts the network round for the round-trip metric (Fig. 5).
    ``primitive`` is an int or a (G·N,) int32 tensor of primitives."""
    is_rpc = primitive == RPC
    if isinstance(is_rpc, torch.Tensor):
        is_rpc = is_rpc[:, None]
    per_op = cmod.round_latency_us(
        cm, is_rpc, op_load, bytes_per_op, n_verbs=n_verbs, doorbell=ec.doorbell, nic_unit=_nic_per_op(ec, cm)
    ) - cm.tick_us
    per_op = torch.where(op_mask, per_op, float("-inf"))
    per_txn = per_op.amax(dim=1)  # outstanding requests overlap within a round
    txn_mask = op_mask.any(dim=1)
    per_txn = torch.where(txn_mask, per_txn, 0.0)
    st = dict(st)
    st["lat_us"] = st["lat_us"] + per_txn
    st["rounds"] = st["rounds"] + txn_mask.to(torch.int32)
    stage_us = st["stage_us"].clone()
    G = ec.n_configs
    stage_us.view(G, N_STAGES)[:, stage_id] += per_txn.view(G, -1).sum(dim=1)
    st["stage_us"] = stage_us
    return st


# ---------------------------------------------------------------------------
# Store access helpers (the two communication planes differ only in cost and
# round structure; raw memory semantics are identical).  Every helper routes
# through the planes transport when the run is node-sharded.
# ---------------------------------------------------------------------------


def init_run_store(ec: EngineConfig, family: str, rw: int, init_value: int) -> Dict:
    """The run's fresh store: (G·R, ...) arrays on ``ec.device``, or, node-
    sharded, each array a ``Shards`` of (G·R_l, ...) arrays, one on each
    shard's device (a shard's rows are the same words at any offset)."""
    if ec.shard is None:
        return init_store(family, ec.store_rows, rw, init_value, n_versions=ec.mvcc_slots, device=ec.device)
    parts = [init_store(family, planes.local_rows(ec), rw, init_value, n_versions=ec.mvcc_slots, device=dev)
             for dev in ec.shard.devices]
    return {k: Shards(p[k] for p in parts) for k in parts[0]}


def global_store(ec: EngineConfig, store: Dict) -> Dict:
    """A node-sharded store laid back as the dense (G·R, ...) arrays on the
    coordinator: each config's rows in owner order."""
    if ec.shard is None:
        return store
    G = ec.n_configs
    out = {}
    for k, parts in store.items():
        tail = tuple(parts[0].shape[1:])
        rows = [p.to(ec.device).view((G, ec.records_local) + tail) for p in parts]
        out[k] = torch.cat(rows, dim=1).view((G * ec.n_records,) + tail)
    return out


def gather_rows(arr, keys):
    """arr (R, ...) at keys (N,K) -> (N,K,...)."""
    return arr[keys.reshape(-1)].reshape(keys.shape + arr.shape[1:])


def read_rows(ec: EngineConfig, arr, keys):
    """Row gather: one-sided READ round when node-sharded."""
    if ec.shard is not None:
        return planes.node_read(ec, arr, keys)
    return gather_rows(arr, keys)


def read_rows_many(ec: EngineConfig, arrs: Sequence, keys) -> Tuple:
    """Gather several store arrays at the same keys: independent gathers
    (torch plane) or ONE multi-read launch that reads every array in place
    (kernel plane).  Node-sharded: ONE doorbell-batched exchange, its
    owner-local reads on the same plane."""
    if ec.shard is not None:
        return planes.node_read_batch(ec, arrs, keys)
    if ec.kernel_plane == kops.KERNEL:
        return kops.gather_many(arrs, keys, plane=ec.kernel_plane)
    return tuple(gather_rows(a, keys) for a in arrs)


def read_rows2(ec: EngineConfig, arr, keys, sel):
    """(row, slot) gather from a (R, S, ...) store array (MVCC versions)."""
    if ec.shard is not None:
        return planes.node_read2(ec, arr, keys, sel)
    flat = arr[keys.reshape(-1), sel.reshape(-1)]
    return flat.reshape(keys.shape + arr.shape[2:])


def write_rows(ec: EngineConfig, arr, idx, vals, *, op: str = "set"):
    """Row scatter.  ``idx`` (M,) rows, with the drop sentinel
    (>= store_rows) for masked-off requests."""
    if ec.shard is not None:
        return planes.node_write(ec, arr, idx, vals, op=op)
    return scatter_drop(arr, idx, vals, accumulate=op == "add")


def write_rows2(ec: EngineConfig, arr, idx, sel, vals, *, op: str = "set"):
    """(row, slot) scatter into a (R, S, ...) store array."""
    if ec.shard is not None:
        return planes.node_write2(ec, arr, idx, sel, vals, op=op)
    R, S = arr.shape[0], arr.shape[1]
    flat = arr.reshape((R * S,) + tuple(arr.shape[2:]))
    fidx = torch.where(idx < R, idx * S + sel, R * S)
    return scatter_drop(flat, fidx, vals, accumulate=op == "add").reshape(arr.shape)


def arb_winner(ec: EngineConfig, keys, prio_hi, prio_lo, active):
    """Per-key CAS arbitration (the RNIC's serialization of one round):
    scatter-min (torch plane) or the arbitration kernel, one group per
    config (kernel plane), the same lexicographic-min winners bitwise.
    Node-sharded, the contest runs once on the coordinator over the global
    rows: its inputs are the replicated requests, no store word, so each
    owner's contest over its own rows would give the same flags."""
    return kops.cas_arbitrate(
        keys, prio_hi, prio_lo, active, ec.store_rows, plane=ec.kernel_plane, groups=ec.n_configs
    )


def scatter_ts_max(ec: EngineConfig, hi_arr, lo_arr, idx, ch, cl, active):
    """Lexicographic scatter-max of (ch, cl) timestamps into a store TS pair
    (MVCC rts bump, SUNDIAL lease renewal); owner-local when sharded."""
    if ec.shard is not None:
        return planes.node_scatter_ts_max(ec, hi_arr, lo_arr, idx, ch, cl, active)
    return planes.ts_max_into(hi_arr, lo_arr, idx, ch, cl, active)


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
    idx_w = torch.where(wf, keys_f, ec.store_rows)
    store["lock_hi"] = write_rows(ec, store["lock_hi"], idx_w, torch.where(wf, new_hi, 0))
    store["lock_lo"] = write_rows(ec, store["lock_lo"], idx_w, torch.where(wf, new_lo, 0))
    return won, store


def release_locks(ec: EngineConfig, store, st, rel_mask):
    """Zero lock words this txn holds for ops in rel_mask."""
    keys_f = st["keys"].reshape(-1)
    m = (rel_mask & st["locked"]).reshape(-1)
    store = dict(store)
    idx = torch.where(m, keys_f, ec.store_rows)
    store["lock_hi"] = write_rows(ec, store["lock_hi"], idx, 0)
    store["lock_lo"] = write_rows(ec, store["lock_lo"], idx, 0)
    return store


def finish_commit(ec: EngineConfig, cm: CostModel, st: Dict, mask) -> Dict:
    st = dict(st)
    st["n_commit"] = st["n_commit"] + mask.to(torch.int32)
    st["lat_sum"] = st["lat_sum"] + torch.where(mask, st["lat_us"], 0.0)
    st["rt_sum"] = st["rt_sum"] + torch.where(mask, st["rounds"].to(torch.float32), 0.0)
    if ec.history_cap:
        # one history of H rows per config: config g's rows g*H .. g*H + H - 1
        G, H = ec.n_configs, ec.history_cap
        m = mask.view(G, -1).to(torch.int32)
        offs = (torch.cumsum(m, dim=1, dtype=torch.int32) - 1).view(-1)
        cfg = _ids(ec).cfg
        row = torch.where(mask, st["h_idx"][cfg] + offs, H)
        row = torch.where(row < H, row + cfg * H, G * H)  # drop when full
        st["h_keys"] = scatter_drop(st["h_keys"], row, local_keys(ec, st["keys"]))
        st["h_ver_r"] = scatter_drop(st["h_ver_r"], row, st["ver_seen"])
        ver_w = st["ver_seen"] + st["is_w"].to(torch.int32)
        st["h_ver_w"] = scatter_drop(st["h_ver_w"], row, ver_w)
        st["h_isw"] = scatter_drop(st["h_isw"], row, st["is_w"])
        st["h_valid"] = scatter_drop(st["h_valid"], row, st["valid"])
        st["h_ts_hi"] = scatter_drop(st["h_ts_hi"], row, st["ts_hi"])
        st["h_ts_lo"] = scatter_drop(st["h_ts_lo"], row, st["ts_lo"])
        st["h_idx"] = st["h_idx"] + m.sum(dim=1, dtype=torch.int32)
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
    ticks_active: Optional[Knob] = None,
):
    """Run the engine; returns (final_state, final_store, metrics dict).

    ``ticks_active`` (None = ``n_ticks``; an int, or a tuple of one per
    config) runs only the first ``ticks_active`` measured ticks of each
    config: on the ticks past ``warmup + ticks_active[g]`` config g's
    whole carry, store included, stays as it was, as the reference's
    freezes, and the loop ends once no config is live.
    """
    from repro_torch.core.registry import protocol_family

    store = init_run_store(ec, protocol_family(ec.protocol), wl.rw, wl.init_value)
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
    live = ticks_active if isinstance(ticks_active, tuple) else (n_ticks if ticks_active is None else ticks_active,)
    live = tuple(max(0, min(int(n), n_ticks)) for n in live)
    for t in range(max(live)):
        new_st, new_store = tick(st, store, warmup + t)
        if min(live) <= t:  # some config's ticks are over: its carry stays
            keep = per_config(ec, tuple(n > t for n in live), torch.bool)
            new_st, new_store = _freeze(ec, keep, new_st, st), _freeze(ec, keep, new_store, store)
        st, store = new_st, new_store
    n_eff = n_ticks if ticks_active is None else ticks_active
    return st, store, summarize(ec, cm, st, n_eff)


def run_sharded(
    protocol_tick,
    ec: EngineConfig,
    cm: CostModel,
    wl: Workload,
    n_ticks: int,
    warmup: int = 0,
    *,
    devices: Optional[Sequence] = None,
):
    """:func:`run` with the simulated cluster on a node mesh: the store
    sharded over ``devices`` (whole simulated nodes per shard), the
    per-slot state replicated on the first device, every store access an
    owner-local step per shard plus one exchange (:mod:`planes`).  Counters
    and the store equal the dense run's bitwise.

    ``devices`` defaults to every visible device of ``ec.device``'s type
    (:func:`planes.visible_devices`); a device may repeat.  Their count must
    divide ``ec.n_nodes``.  Returns (state, GLOBAL store, metrics), as
    :func:`run`.
    """
    ec_sh = node_mesh_config(ec, devices)
    st, store, m = run(protocol_tick, ec_sh, cm, wl, n_ticks, warmup=warmup)
    return st, global_store(ec_sh, store), m


def node_mesh_config(ec: EngineConfig, devices: Optional[Sequence]) -> EngineConfig:
    """Validate the node mesh and return the sharded config (its state on
    the mesh's first device).  Shared by :func:`run_sharded` and CALVIN's
    epoch runner."""
    if ec.shard is not None:
        raise ValueError("node mesh: config already node-sharded")
    devices = tuple(str(d) for d in devices) if devices is not None else planes.visible_devices(ec.device)
    n_shards = len(devices)
    if ec.n_nodes % n_shards:
        raise ValueError(
            f"node mesh: {n_shards} device(s) must divide n_nodes={ec.n_nodes} "
            "(shards own whole simulated nodes)"
        )
    return dataclasses.replace(ec, device=devices[0], shard=NodeShard(n_shards, devices))


# state tensors that the configs of a batch share; every other state or
# store tensor's leading axis is (G·X), config g's rows g·X .. g·X + X - 1
SHARED = frozenset({"tick"})


def _rows_per_config(ec: EngineConfig, k: str, v) -> int:
    """X of tensor ``k``'s leading (G·X) axis."""
    if v.shape[0] % ec.n_configs:
        raise ValueError(f"{k}: leading size {v.shape[0]} is no multiple of the {ec.n_configs} configs")
    return v.shape[0] // ec.n_configs


def _freeze(ec: EngineConfig, keep, new: Dict, old: Dict) -> Dict:
    """``new`` where ``keep`` (G,) holds, ``old`` elsewhere: every tensor
    takes its config's choice (each shard of a sharded array its slice of
    the config), a tensor in SHARED takes ``new``."""
    G = ec.n_configs

    def pick(k, v, o):
        shape = (G, _rows_per_config(ec, k, v)) + tuple(v.shape[1:])
        m = keep.to(v.device).view((G,) + (1,) * v.dim())
        return torch.where(m, v.reshape(shape), o.reshape(shape)).reshape(v.shape)

    out = {}
    for k, v in new.items():
        if k in SHARED:
            out[k] = v
        elif isinstance(v, Shards):
            out[k] = Shards(pick(k, a, b) for a, b in zip(v, old[k]))
        else:
            out[k] = pick(k, v, old[k])
    return out


def config_slice(ec: EngineConfig, tensors: Dict, g: int) -> Dict:
    """Config g's part of a batched run's state or store dict, laid out as
    a run of that config alone: its rows of every tensor (a tensor in
    SHARED whole), with ``keys`` the config's own keys (``st["keys"]``
    holds store rows; the history holds own keys already).  The validator
    (:mod:`repro_torch.core.validate`) checks each config of a batch
    through it."""
    out = {}
    for k, v in tensors.items():
        if k in SHARED:
            out[k] = v
            continue
        n = _rows_per_config(ec, k, v)
        out[k] = v[g * n:(g + 1) * n]
    if "keys" in out and "stage" in out:
        out["keys"] = out["keys"] - g * ec.n_records
    return out


def summarize(ec: EngineConfig, cm: CostModel, st: Dict, n_ticks: Knob) -> Dict[str, Any]:
    """Run metrics as tensors on the run's device, each with a leading
    config axis (G, ...) (float32 ratios computed as the reference computes
    them).  ``n_ticks`` is an int, or a tuple of one per config."""
    G = ec.n_configs
    commits = st["n_commit"].view(G, -1).sum(dim=1, dtype=torch.int32)
    aborts = st["n_abort"].view(G, -1).sum(dim=1, dtype=torch.int32)
    if isinstance(n_ticks, tuple):
        throughput = commits / (torch.tensor(n_ticks, dtype=torch.float32, device=commits.device) * cm.tick_us)
    else:
        # the reference divides by a constant under jit, which XLA turns into a product with the
        # constant's float32 reciprocal (up to an ulp from the quotient; ROADMAP.md C.16)
        throughput = commits.float() * float(np.float32(1.0) / np.float32(n_ticks * cm.tick_us))
    per_commit = torch.clamp(commits, min=1)
    return {
        "commits": commits,
        "aborts": aborts,
        "throughput_mtps": throughput,  # million txns/sec (txns per us)
        "avg_latency_us": st["lat_sum"].view(G, -1).sum(dim=1) / per_commit,
        "abort_rate": aborts / torch.clamp(commits + aborts, min=1),
        "avg_round_trips": st["rt_sum"].view(G, -1).sum(dim=1) / per_commit,
        "stage_us_per_commit": st["stage_us"].view(G, N_STAGES) / per_commit[:, None],
    }
