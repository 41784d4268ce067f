"""CALVIN (paper §4.6; port of ``repro.core.protocols.calvin``):
deterministic, epoch-based, shared-nothing.

Per epoch: (1) sequencing layer — every node broadcasts its local batch of
transactions to all other nodes (RPC batch, or one-sided: two doorbell-
batched WRITEs into pre-agreed per-(epoch, sender) ring buffers — value
then valid-flag); (2) RS/WS forwarding — passive participants send RS
records to active participants, actives exchange WS records; (3) local
deterministic execution in the agreed global order (lock-free: conflicting
transactions execute in dependency waves).  No aborts by construction.

Epoch synchronization is why co-routines do not help CALVIN (paper Fig. 7):
the epoch barrier serializes sequencer rounds regardless of overlap.

The runner takes the engine's config axis: G configs run their epochs
together, each epoch's waves to the largest wave count in the batch.  The
wave count is read on the host once per epoch, node-sharded too
(:func:`run_epochs_sharded`: the store split by owner, each wave's reads
and writes routed through the planes transport).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import costmodel as cmod
from repro_torch.core import engine as eng
from repro_torch.core import prng
from repro_torch.core import registry
from repro_torch.core.costmodel import ONE_SIDED, CostModel
from repro_torch.core.engine import EngineConfig, Knob, Workload

tick = None  # CALVIN uses the epoch runner below, not the slot engine
STAGES_USED = ("sequence", "forward", "execute")

_F32 = np.float32


def _epoch_txns(ec: EngineConfig, wl: Workload, epoch: int):
    """This epoch's global batch in deterministic order: (store rows,
    is_w, valid (G·N, K), node (G·N,)).

    The key is ``fold_in(fold_in(PRNGKey(seed), lsid), epoch)`` (slot
    first, then epoch, unlike the engine's ``regen_txns``).  Identity
    flows through LOGICAL slot ids and keys are remapped onto the padded
    layout, so padded runs equal unpadded ones; dead (padded) slots get
    valid=False.
    """
    _, node, alive = eng.logical_ids(ec)
    keys, is_w, valid = eng.draw_txns(ec, wl, prng.fold_in(eng.slot_keys(ec), epoch))
    if alive is not None:
        valid = valid & alive[:, None]
    return keys, is_w, valid, node


def _waves(ec: EngineConfig, keys, is_w, valid):
    """Dependency wave per txn (G·N,): readers wait for earlier writers;
    writers wait for all earlier accesses (deterministic lock schedule).

    Each config sorts its own ops, on the reference's int32 key
    ``key*(M+1)+order`` with the sentinel 2**30 (never widened: the order
    must follow the reference's wherever that product passes the sentinel
    or wraps), stably, as ``jnp.argsort``: a txn that touches one key twice
    ties with itself.
    """
    G = ec.n_configs
    N, K = keys.shape[0] // G, keys.shape[1]
    M = N * K
    kf = eng.local_keys(ec, keys).reshape(G, M)
    order = torch.arange(N, dtype=torch.int32, device=keys.device).repeat_interleave(K)
    wf = (is_w & valid).reshape(G, M)
    af = valid.reshape(G, M)
    sort_key = torch.where(af, kf * (M + 1) + order, 2**30)
    perm = torch.argsort(sort_key, dim=1, stable=True)
    k_s = kf.gather(1, perm)
    w_s = wf.gather(1, perm).to(torch.int32)
    a_s = af.gather(1, perm).to(torch.int32)
    first = torch.ones_like(k_s, dtype=torch.bool)
    first[:, 1:] = k_s[:, 1:] != k_s[:, :-1]
    # exclusive prefix counts within key segments
    cw = torch.cumsum(w_s, dim=1, dtype=torch.int32) - w_s
    ca = torch.cumsum(a_s, dim=1, dtype=torch.int32) - a_s
    seg_cw0 = torch.cummax(torch.where(first, cw, 0), dim=1).values
    seg_ca0 = torch.cummax(torch.where(first, ca, 0), dim=1).values
    wave_s = torch.where(w_s > 0, ca - seg_ca0, cw - seg_cw0)
    wave_f = torch.zeros_like(wave_s).scatter_(1, perm, wave_s)
    wave_f = torch.where(af, wave_f, 0)
    return wave_f.reshape(G * N, K).amax(dim=1)  # txn wave


def _sequence_us(ec: EngineConfig, cm: CostModel, wl: Workload, is_rpc, act_c):
    """Sequencing broadcast latency per config: each node ships its C txn
    descriptors to n-1 peers (message shapes from the wire-cost table).

    The reference multiplies a Python ``act_c`` in float64 before the
    float32 round, and a padded (traced) one in float32; so does this."""
    per = cmod.CALVIN_WIRE["sequence"].bytes_for(wl.rw, n_ops=wl.max_ops)
    dev = ec.device
    if isinstance(act_c, tuple):
        desc = torch.tensor(act_c, dtype=torch.float32, device=dev) * _F32(per)
        msg = desc * _F32(ec.n_nodes - 1)
    else:
        msg = act_c * per * (ec.n_nodes - 1)
    load = torch.full((), float(ec.n_nodes - 1), dtype=torch.float32, device=dev)
    # n_verbs=2 models the one-sided value+valid-flag WRITE pair; the RPC
    # branch never reads n_verbs
    return cmod.round_latency_us(cm, is_rpc, load, msg, n_verbs=2, doorbell=ec.doorbell, nic_unit=eng.nic_unit(ec, cm, 1))


def run_epochs(
    ec: EngineConfig,
    cm: CostModel,
    wl: Workload,
    n_epochs: int,
    *,
    epochs_active: Optional[Knob] = None,
):
    """Returns (final store, metrics matching engine.summarize's schema plus
    ``avg_waves``), every metric with a leading config axis (G, ...).

    ``epochs_active`` (None = unpadded; an int or a tuple of one per
    config) is the tick-bucketing mask: epochs past it execute zero waves,
    leave the store alone, and contribute zero to every stat, so a padded
    run is bitwise-equal to a run of exactly ``epochs_active`` epochs.
    With ``ec.shard`` set the store is node-sharded (returned as such) and
    the wave executor's gathers and scatters route through the planes
    transport: one exchange per wave's read.
    """
    G, K = ec.n_configs, wl.max_ops
    dev = ec.device
    store = eng.init_run_store(ec, "nowait", wl.rw, wl.init_value)
    hy0 = ec.hybrid[0]
    if isinstance(hy0, tuple):  # the batch's configs differ
        one_sided = torch.tensor([h == ONE_SIDED for h in hy0], device=dev)
        is_rpc = ~one_sided
    else:
        one_sided = hy0 == ONE_SIDED
        is_rpc = not one_sided
    # live co-routines per node / batch size under bucket padding
    act_c = ec.coroutines if ec.active_coroutines is None else ec.active_coroutines
    n_live = torch.full((G,), ec.n_nodes, dtype=torch.int32, device=dev) * eng.per_config(ec, act_c)
    bcast = _sequence_us(ec, cm, wl, is_rpc, act_c)
    fwd_per = cmod.CALVIN_WIRE["forward"].bytes_for(wl.rw)
    n_nodes = max(ec.n_nodes, 1)
    exec_ticks = eng.per_config(ec, wl.exec_ticks)
    if isinstance(one_sided, torch.Tensor):
        rounds = torch.where(one_sided, 4.0, 2.0)
    else:
        rounds = torch.full((G,), 4.0 if one_sided else 2.0, device=dev)
    ep_act = None if epochs_active is None else eng.per_config(ec, epochs_active)
    N = ec.n_slots

    stats = {"commits": [], "epoch_us": [], "rounds": [], "waves": []}
    for epoch in range(n_epochs):
        if ep_act is None:
            live = None
        elif isinstance(ep_act, torch.Tensor):
            live = ep_act > epoch
        else:
            live = torch.full((G,), epoch < ep_act, device=dev)
        keys, is_w, valid, node = _epoch_txns(ec, wl, epoch)
        wave = _waves(ec, keys, is_w, valid)
        n_waves = wave.view(G, N).amax(dim=1) + 1
        if live is not None:
            n_waves = torch.where(live, n_waves, 0)

        # ---- execute waves sequentially (deterministic order) ----------
        # one loop for the batch, to its largest wave count; a wave index
        # past a config's own count activates none of its txns, and a dead
        # (padded) epoch's txns are masked out by ``live``
        writes = is_w & valid
        if live is not None:
            writes = writes & live.repeat_interleave(N)[:, None]
        for w in range(int(n_waves.max())):
            rvals = eng.read_rows(ec, store["data"], keys)
            wv = wl.execute(keys, is_w, valid, rvals)
            active = (wave == w)[:, None] & writes
            af = active.reshape(-1)
            idx = torch.where(af, keys.reshape(-1), ec.store_rows)
            store = dict(store)
            store["data"] = eng.write_rows(ec, store["data"], idx, wv.reshape(-1, wl.rw))
            store["ver"] = eng.write_rows(ec, store["ver"], idx, 1, op="add")

        # ---- epoch cost model -------------------------------------------
        # RS/WS forwarding: ops whose owner differs from an active participant
        owner = eng.local_keys(ec, keys) // ec.records_per_node
        remote = valid & (owner != node[:, None])
        fwd_ops = remote.view(G, -1).sum(dim=1, dtype=torch.int32)
        fwd_bytes = fwd_ops * fwd_per
        fwd = cmod.round_latency_us(
            cm, is_rpc, fwd_ops / n_nodes, fwd_bytes / n_nodes, n_verbs=2, doorbell=ec.doorbell,
            nic_unit=eng.nic_unit(ec, cm, 1),
        )
        exec_us = n_waves.to(torch.float32) * exec_ticks * cm.tick_us
        barrier = cm.tick_us  # epoch sync barrier across sequencers
        epoch_us = bcast + fwd + exec_us + barrier
        if live is None:
            stats["commits"].append(n_live)
            stats["epoch_us"].append(epoch_us)
            stats["rounds"].append(rounds)
        else:
            stats["commits"].append(torch.where(live, n_live, 0))
            stats["epoch_us"].append(torch.where(live, epoch_us, 0.0))
            stats["rounds"].append(torch.where(live, rounds, 0.0))
        stats["waves"].append(n_waves.to(torch.int32))

    s = {k: torch.stack(v).sum(dim=0, dtype=torch.int32 if k in ("commits", "waves") else torch.float32)
         for k, v in stats.items()}
    n_eff = n_epochs if ep_act is None else ep_act
    commits = s["commits"]
    metrics = {
        "commits": commits,
        "aborts": torch.zeros((G,), dtype=torch.int32, device=dev),
        "throughput_mtps": commits / s["epoch_us"],
        # txns commit at epoch end; dead (padded) epochs contribute zero
        "avg_latency_us": s["epoch_us"] / n_eff,
        "abort_rate": torch.zeros((G,), dtype=torch.float32, device=dev),
        "avg_round_trips": s["rounds"] / n_eff,
        "avg_waves": s["waves"] / n_eff,
        "stage_us_per_commit": torch.zeros((G, cmod.N_STAGES), dtype=torch.float32, device=dev),
    }
    return store, metrics


def run_epochs_sharded(
    ec: EngineConfig,
    cm: CostModel,
    wl: Workload,
    n_epochs: int,
    *,
    devices=None,
    epochs_active: Optional[Knob] = None,
):
    """:func:`run_epochs` on a node mesh (``engine.node_mesh_config``):
    the partitioned store sharded by owner, sequencing and forwarding cost
    replicated bookkeeping, each dependency wave's record exchange one
    plane round.  Returns (GLOBAL store, metrics), bitwise the dense
    :func:`run_epochs`'."""
    ec_sh = eng.node_mesh_config(ec, devices)
    store, m = run_epochs(ec_sh, cm, wl, n_epochs, epochs_active=epochs_active)
    return eng.global_store(ec_sh, store), m


# ---------------------------------------------------------------------------
# Registry entry: CALVIN is epoch-driven, so it owns its run hooks instead of
# a slot-engine tick.  ``ticks`` from the front door map onto epochs at the
# historical ratio (one epoch per 8 ticks, floor 8) so grid specs stay
# comparable across protocols.
# ---------------------------------------------------------------------------


def epochs_for_ticks(ticks: int) -> int:
    return max(int(ticks) // 8, 8)


def _grid_run(entry, ec, cm, wl, *, ticks, warmup, ticks_active):
    if ticks_active is None:
        ep_act = None
    else:
        ep_act = tuple(max(int(t) // 8, 8) for t in ticks_active) if isinstance(ticks_active, tuple) \
            else max(int(ticks_active) // 8, 8)
    _, m = run_epochs(ec, cm, wl, epochs_for_ticks(ticks), epochs_active=ep_act)
    return m


def _node_run(entry, ec, cm, wl, *, ticks, warmup, devices):
    _, m = run_epochs_sharded(ec, cm, wl, epochs_for_ticks(ticks), devices=devices)
    return m


registry.register_protocol(
    "calvin",
    tick=None,
    stages=STAGES_USED,
    hooks=registry.RunHooks(grid_run=_grid_run, node_run=_node_run),
    capabilities=registry.Caps(
        # the reference's wave executor iterates a per-config traced wave
        # count that cannot batch around its node collectives: single-config
        # node meshes only, as there
        node_shardable=True,
        batch_node_shardable=False,
        deterministic=True,
        tick_driven=False,
    ),
)
