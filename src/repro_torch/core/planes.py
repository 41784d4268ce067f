"""Communication planes: RCC's two primitive families over a node-sharded
store (port of ``repro.core.planes``).

The reference runs the simulated cluster SPMD under ``shard_map``; the
port keeps ONE Python controller and writes the mesh out.  A
:class:`NodeShard` names a torch device per shard (a device may repeat:
four shards on one card, or on the CPU in the tests, are the port's
counterpart of the reference's forced host device count).  Two layers
live here:

  * the **engine transport** (the ``node_*`` primitives): what
    ``engine.run_sharded`` runs on.  Every store array is a
    :class:`Shards` tuple, shard s's rows on ``devices[s]``; the
    per-slot coordinator state is held once, on ``devices[0]``.  A round
    is one owner-local step per shard, on that shard's own tensor (the
    gather, the scatter, the timestamp scatter-max: the RNIC's job), then
    the replies are added on the coordinator.  That sum is the reference's
    ``psum``: every addend but the owner's is zero, so it is exact.
    :func:`node_read_batch` is the doorbell-batched multi-op round (paper
    §4.2): several metadata words for one key set in one exchange.  The
    CAS contest and the capacity ranking read the replicated requests and
    no store word, so the engine runs them once on the coordinator
    (``engine.arb_winner``, ``engine.service_ops``): the reference's
    per-owner ``node_cas_winner`` has no counterpart here.
  * the **request-routed planes** (:func:`make_planes`): requests packed
    into per-destination buffers and exchanged all-to-all (the transpose
    of the shards' buffer lists): the standalone proof that one engine
    round maps onto one fabric exchange.

One-sided plane (``os_read`` / ``os_cas``): the owner performs raw gathers
and an arbitrated CAS with no protocol logic.  Two-sided plane
(``rpc_call``): the owner runs a handler on the delivered requests (the
remote CPU's job).

**Rows under a shard.**  A batched run's store is flat (G·R, ...) and
``st["keys"]`` hold global store rows g·R + key (``engine`` module
docstring).  Shard s owns keys [s·R_l, (s+1)·R_l) of EVERY config, so its
array is (G·R_l, ...): global row g·R + key lives there at local row
g·R_l + (key - s·R_l).  The drop sentinel of a shard is G·R_l; the global
one (G·R) maps past every shard's rows.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.arbiter import scatter_min_winner
from repro_torch.kernels import ops as kops

_I32_MIN = -(2**31)


# ---------------------------------------------------------------------------
# Engine transport: node-sharded store primitives
# ---------------------------------------------------------------------------


class NodeShard(NamedTuple):
    """The node mesh of a run (``EngineConfig.shard``): ``n_shards``
    shards, shard s on ``devices[s]``; ``devices[0]`` is the coordinator,
    where the replicated state lives.  Simulated nodes map onto shards in
    contiguous blocks (n_nodes % n_shards == 0), so a shard owns whole
    nodes' record ranges."""

    n_shards: int
    devices: Tuple[str, ...]


class Shards(tuple):
    """One node-sharded store array: shard s's (G·R_l, ...) rows on the
    shard's device.  Protocol code hands it to the engine helpers as it
    hands a dense tensor."""

    __slots__ = ()


def visible_devices(device) -> Tuple[str, ...]:
    """Every device a run on ``device``'s type can see: each CUDA device
    (the counterpart of ``jax.devices()``), or the one CPU.  Refuses when
    CUDA is asked for and absent: the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (str(dev),)
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available; pass device='cpu' to run on the CPU")
    return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))


def scatter_drop(arr, idx, vals, *, accumulate: bool = False):
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


def local_rows(ec) -> int:
    """Rows of each shard's store arrays, G·R_l: its drop sentinel."""
    return ec.n_configs * ec.records_local


def owner_local(ec, rows):
    """Global store rows -> (owner shard, local row on the owner).  A row
    at or past the global drop sentinel gets a local row at or past
    :func:`local_rows`, outside every shard's array."""
    R, r_l = ec.n_records, ec.records_local
    g, k = rows // R, rows % R
    return k // r_l, g * r_l + k % r_l


def local_ix_drop(ec, s: int, owner, local):
    """Shard ``s``'s view of :func:`owner_local`'s rows: its own rows'
    local index, every other row at the shard's drop sentinel (the
    write-side form; a gather reads zeros there)."""
    return torch.where(owner == s, local, local_rows(ec))


def to_device(x, dev):
    """``x`` on ``dev`` (a Python value stays as it is)."""
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def psum(ec, parts):
    """The reply exchange: per-shard addends moved to the coordinator and
    summed (OR for bool).  Exact: only the owner's addend is non-zero."""
    dev0 = ec.shard.devices[0]
    out = None
    for p in parts:
        p = p.to(dev0)
        out = p if out is None else (out | p if p.dtype == torch.bool else out + p)
    return out


def _masked_gather(arrs, li):
    """``a[li]`` for each array, zero rows where ``li`` lies outside the
    array (the reference's clip + where)."""
    n = arrs[0].shape[0]
    mine = li < n
    idx = torch.clamp(li, max=n - 1).long()
    return tuple(torch.where(mine.reshape((-1,) + (1,) * (a.dim() - 1)), a[idx], 0) for a in arrs)


def _node_gather(ec, arrs: Sequence[Shards], keys, kernel: bool) -> Tuple:
    kf = keys.reshape(-1)
    owner, local = owner_local(ec, kf)
    per_shard = []
    for s, dev in enumerate(ec.shard.devices):
        li = local_ix_drop(ec, s, owner, local).to(dev)
        mine = [a[s] for a in arrs]
        # the kernel reads zero rows for the keys outside the shard's rows
        per_shard.append(kops.gather_many(mine, li, plane=kops.KERNEL) if kernel else _masked_gather(mine, li))
    return tuple(
        psum(ec, [p[i] for p in per_shard]).reshape(tuple(keys.shape) + tuple(a[0].shape[1:]))
        for i, a in enumerate(arrs)
    )


def node_read(ec, arr: Shards, keys):
    """One-sided READ round: gather global rows ``keys`` (...,) of a
    node-sharded array.  Each owner gathers its rows, zeros elsewhere; the
    replies combine in one exchange."""
    return _node_gather(ec, (arr,), keys, kernel=False)[0]


def node_read_batch(ec, arrs: Sequence[Shards], keys) -> Tuple:
    """Doorbell-batched multi-op READ: several arrays, same keys, ONE
    exchange.  On the kernel plane each owner's gather is one
    ``multi_read`` launch on its own arrays, in place, with local keys
    outside its rows reading zeros."""
    return _node_gather(ec, arrs, keys, kernel=ec.kernel_plane == kops.KERNEL)


def node_read2(ec, arr: Shards, keys, sel):
    """READ of (row, slot) pairs from a (G·R_l, S, ...) sharded array
    (MVCC version-slot fetch).  One exchange."""
    kf, sf = keys.reshape(-1), sel.reshape(-1)
    owner, local = owner_local(ec, kf)
    parts = []
    for s, dev in enumerate(ec.shard.devices):
        a = arr[s]
        li = local_ix_drop(ec, s, owner, local).to(dev)
        mine = li < a.shape[0]
        vals = a[torch.clamp(li, max=a.shape[0] - 1).long(), sf.to(dev).long()]
        parts.append(torch.where(mine.reshape((-1,) + (1,) * (a.dim() - 2)), vals, 0))
    return psum(ec, parts).reshape(tuple(keys.shape) + tuple(arr[0].shape[2:]))


def node_write(ec, arr: Shards, idx, vals, *, op: str = "set") -> Shards:
    """One-sided WRITE round: scatter into global rows ``idx`` (M,) (the
    global drop sentinel for masked-off requests).  The request set is
    replicated, so each owner applies its rows' writes and no reply is
    needed.  ``op`` in {"set", "add"}."""
    owner, local = owner_local(ec, idx)
    return Shards(
        scatter_drop(a, local_ix_drop(ec, s, owner, local).to(a.device), to_device(vals, a.device), accumulate=op == "add")
        for s, a in enumerate(arr)
    )


def node_write2(ec, arr: Shards, idx, sel, vals, *, op: str = "set") -> Shards:
    """WRITE of (row, slot) pairs into a (G·R_l, S, ...) sharded array."""
    owner, local = owner_local(ec, idx)
    out = []
    for s, a in enumerate(arr):
        dev, (R, S) = a.device, a.shape[:2]
        li = local_ix_drop(ec, s, owner, local).to(dev)
        fidx = torch.where(li < R, li * S + sel.to(dev), R * S)
        flat = a.reshape((R * S,) + tuple(a.shape[2:]))
        out.append(scatter_drop(flat, fidx, to_device(vals, dev), accumulate=op == "add").reshape(a.shape))
    return Shards(out)


def node_scatter_ts_max(ec, hi_arr: Shards, lo_arr: Shards, idx, ch, cl, active):
    """Owner-local lexicographic scatter-max of (ch, cl) into a sharded
    timestamp pair: each shard reduces the candidates for its own rows."""
    owner, local = owner_local(ec, idx)
    out_hi, out_lo = [], []
    for s, (hi, lo) in enumerate(zip(hi_arr, lo_arr)):
        dev, r = hi.device, hi.shape[0]
        li = local_ix_drop(ec, s, owner, local).to(dev)
        act = active.to(dev) & (li < r)
        h, l_ = ts_max_into(hi, lo, li, ch.to(dev), cl.to(dev), act)
        out_hi.append(h)
        out_lo.append(l_)
    return Shards(out_hi), Shards(out_lo)


def ts_max_into(hi_arr, lo_arr, idx, ch, cl, active):
    """Lexicographic scatter-max of (ch, cl) at rows ``idx`` (rows >=
    ``len(hi_arr)`` dropped) into the pair (hi_arr, lo_arr)."""
    r = hi_arr.shape[0]
    li = torch.clamp(idx, max=r).long()

    def seg_max(vals):
        ext = torch.full((r + 1,), _I32_MIN, dtype=torch.int32, device=vals.device)
        return ext.scatter_reduce(0, li, vals, "amax")[:r]

    cand_hi = seg_max(torch.where(active, ch, _I32_MIN))
    at_max = active & (ch == cand_hi[torch.clamp(idx, 0, r - 1).long()])
    cand_lo = seg_max(torch.where(at_max, cl, _I32_MIN))
    upd = (hi_arr < cand_hi) | ((hi_arr == cand_hi) & (lo_arr < cand_lo))
    return torch.where(upd, cand_hi, hi_arr), torch.where(upd, cand_lo, lo_arr)


# ---------------------------------------------------------------------------
# Request-routed planes
# ---------------------------------------------------------------------------


def _route(requests, dest, n_nodes: int, cap: int):
    """Pack per-node request buffers (n_nodes, cap, W) by destination.

    requests (M, W) int32, dest (M,); a request past ``cap`` in its
    destination's buffer is dropped (scattered to a spare row), never
    aliased into slot cap-1.  Returns (buf, valid (n_nodes, cap), slot)."""
    onehot = torch.nn.functional.one_hot(dest.long(), n_nodes).to(torch.int32)  # (M, n)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # rank within destination
    slot = (pos * onehot).sum(dim=-1, dtype=torch.int32)
    keep = slot < cap
    dest_k = torch.where(keep, dest, n_nodes).long()
    slot_k = torch.where(keep, slot, 0).long()
    dev = requests.device
    buf = torch.zeros((n_nodes + 1, cap, requests.shape[1]), dtype=requests.dtype, device=dev)
    buf[dest_k, slot_k] = requests
    valid = torch.zeros((n_nodes + 1, cap), dtype=torch.bool, device=dev)
    valid[dest_k, slot_k] = True
    return buf[:n_nodes], valid[:n_nodes], slot


def _all_to_all(shard: NodeShard, bufs):
    """The exchange: shard i's buffer for shard j arrives at j as its
    i-th row (``jax.lax.all_to_all(..., tiled=True)`` over the node axis)."""
    return [torch.stack([b[j].to(dev) for b in bufs]) for j, dev in enumerate(shard.devices)]


def _split(shard: NodeShard, x):
    """A global array split into per-shard row blocks on their devices
    (``shard_map``'s ``in_specs=P(axis)``)."""
    return [c.to(dev) for c, dev in zip(torch.chunk(x, shard.n_shards), shard.devices)]


def _join(shard: NodeShard, parts):
    """Per-shard row blocks laid back in shard order on the coordinator."""
    return torch.cat([p.to(shard.devices[0]) for p in parts])


def make_planes(shard: NodeShard, records_per_node: int, rw: int, cap: int = 0):
    """Returns (os_read, os_cas, rpc_call) over a store with one simulated
    node per shard.  Each takes global arrays, splits them by shard, runs
    each shard's step on its device and returns global arrays.

    ``cap`` bounds the per-destination request buffer (0 = lossless, the
    per-shard request count).  With a finite cap, requests beyond it are
    DROPPED by the routing fabric: their replies come back zero / not-won,
    never another request's payload.
    """
    n_nodes = shard.n_shards

    def requests(keys_l, *cols):
        m = keys_l.shape[0]
        c = cap or m
        dest = keys_l // records_per_node
        ar = torch.arange(m, dtype=torch.int32, device=keys_l.device)
        req = torch.stack([keys_l % records_per_node, *cols, ar], dim=1)
        buf, valid, slot = _route(req, dest, n_nodes, c)
        return buf, valid, slot, dest, c

    def unroute(back, dest, slot, c):
        # the reply for local request i sits at (dest[i], its slot); a dropped request gets zeros
        keep = slot < c
        out = back[dest.long(), torch.clamp(slot, max=c - 1).long()]
        return torch.where(keep.reshape((-1,) + (1,) * (out.dim() - 1)), out, 0)

    def os_read(store_data, keys):
        """One-sided READ: ``keys`` (n_nodes·m,) global keys, m per node
        shard; ``store_data`` (R, rw).  The owner does no protocol logic,
        just the DMA gather."""
        data, ks = _split(shard, store_data), _split(shard, keys)
        routed = [requests(k) for k in ks]
        inbox = _all_to_all(shard, [r[0] for r in routed])
        vals = [d[torch.clamp(ib[..., 0], 0, d.shape[0] - 1).long()] for d, ib in zip(data, inbox)]
        back = _all_to_all(shard, vals)
        return _join(shard, [unroute(b, r[3], r[2], r[4]) for b, r in zip(back, routed)])

    def os_cas(lock_words, keys, new_vals):
        """One-sided CAS (expect-free): arbitrated at the owner's memory
        controller; returns (lock_words', won).  ``lock_words`` (R,)."""
        locks, ks, nv = _split(shard, lock_words), _split(shard, keys), _split(shard, new_vals)
        routed = [requests(k, v) for k, v in zip(ks, nv)]
        inbox = _all_to_all(shard, [r[0] for r in routed])
        vin = _all_to_all(shard, [r[1] for r in routed])
        new_locks, oks = [], []
        for lock_l, ib, v in zip(locks, inbox, vin):
            flat, v = ib.reshape(-1, 3), v.reshape(-1)
            addr, newv = flat[:, 0], flat[:, 1]
            ar = torch.arange(addr.shape[0], dtype=torch.int32, device=addr.device)
            win = scatter_min_winner(addr, torch.zeros_like(addr), ar, v, lock_l.shape[0])
            free = lock_l[torch.clamp(addr, 0, lock_l.shape[0] - 1).long()] == 0
            ok = win & free & v
            new_locks.append(scatter_drop(lock_l, torch.where(ok, addr, lock_l.shape[0]), torch.where(ok, newv, 0)))
            oks.append(ok.to(torch.int32).reshape(n_nodes, -1))
        back = _all_to_all(shard, oks)
        won = [unroute(b, r[3], r[2], r[4]) > 0 for b, r in zip(back, routed)]
        return _join(shard, new_locks), _join(shard, won)

    def rpc_call(store_data, keys, handler: Callable):
        """Two-sided RPC: requests routed to owners; the OWNER's CPU runs
        ``handler(data_local, addrs, valid) -> (data_local', replies)``."""
        data, ks = _split(shard, store_data), _split(shard, keys)
        routed = [requests(k) for k in ks]
        inbox = _all_to_all(shard, [r[0] for r in routed])
        vin = _all_to_all(shard, [r[1] for r in routed])
        new_data, replies = [], []
        for d, ib, v in zip(data, inbox, vin):
            d, rep = handler(d, ib[..., 0].reshape(-1), v.reshape(-1))
            new_data.append(d)
            replies.append(rep.reshape(n_nodes, ib.shape[1], -1))
        back = _all_to_all(shard, replies)
        return _join(shard, new_data), _join(shard, [unroute(b, r[3], r[2], r[4]) for b, r in zip(back, routed)])

    return os_read, os_cas, rpc_call
