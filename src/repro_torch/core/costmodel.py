"""Latency/throughput cost model for the two communication planes (port of
``repro.core.costmodel``).

One engine tick is one network round.  Counts (rounds, bytes, handler ops,
aborts) are measured by the simulation; only the per-unit costs below are
modelled.  Every latency is float32, computed in the reference's order of
operations: host-side constants are ``np.float32`` scalars, so a sum of two
constants rounds to float32 exactly where the reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np
import torch

RPC = 0
ONE_SIDED = 1

# canonical stage ids; the first six are network stages (the unit of the
# paper's hybrid coding), exec/wait are local latency buckets
ST_FETCH, ST_LOCK, ST_VALIDATE, ST_LOG, ST_COMMIT, ST_RELEASE, ST_EXEC, ST_WAIT = range(8)
STAGE_NAMES = ("fetch", "lock", "validate", "log", "commit", "release", "exec", "wait")
N_HYBRID_STAGES = 6
N_STAGES = 8

_F32 = np.float32


@dataclass(frozen=True)
class CostModel:
    tick_us: float = 2.0  # one bulk-synchronous network round
    rpc_rtt_us: float = 2.2
    os_rtt_us: float = 1.8
    handler_us: float = 0.20  # remote CPU service time per RPC request
    handler_cap: int = 64  # RPC requests a node can service per tick
    nic_cap: int = 512  # one-sided verbs a node's RNIC serves per tick
    mmio_us: float = 0.15  # per-verb MMIO cost saved by doorbell batching
    byte_us: float = 0.00008  # ~12.5 GB/s per link
    n_backups: int = 3  # 3-way replication (paper §6.1)
    # grows with emulated cluster size (Fig. 10); a tuple holds one value per
    # config of a batched run
    qp_pressure: Union[float, Tuple[float, ...]] = 0.0

    def nic_eff_cap(self):
        """NIC verb capacity degraded by QP-state cache pressure (float32,
        as the reference computes it from its float32 sweep knob): a
        ``np.float32``, or a float32 array of one per config."""
        qp = np.asarray(self.qp_pressure, np.float32)
        return _F32(self.nic_cap) / (_F32(1.0) + qp)

    def nic_unit(self):
        """One-sided queueing time per queued verb, float32: ``1 / nic_eff_cap
        * tick_us`` (a ``np.float32``, or an array of one per config)."""
        return _F32(1.0) / np.maximum(self.nic_eff_cap(), _F32(1e-6)) * _F32(self.tick_us)

    @staticmethod
    def tcp() -> "CostModel":
        """Reference TCP/kernel-stack plane: ~10x RTT, syscall instead of
        MMIO, costlier handler service through the kernel network stack."""
        return CostModel(
            tick_us=18.0,
            rpc_rtt_us=25.0,
            os_rtt_us=25.0,
            handler_us=1.5,
            handler_cap=12,
            nic_cap=12,
            mmio_us=2.0,
            byte_us=0.0008,
        )


@dataclass(frozen=True)
class WireCost:
    """Wire bytes + verb count for one protocol stage's network round:
    ``bytes = base + words * 4 * rw + per_op * n_ops``, times the
    replication fan-out for replicated stages."""

    base: float = 0.0
    words: float = 0.0
    per_op: float = 0.0
    n_verbs: int = 1
    replicated: bool = False

    def bytes_for(self, rw: int, n_backups: int = 1, n_ops: int = 1) -> float:
        b = self.base + self.words * 4.0 * rw + self.per_op * n_ops
        return b * (n_backups if self.replicated else 1)


_LOG_WIRE = WireCost(base=8.0, words=1.0, replicated=True)
_RELEASE_WIRE = WireCost(base=8.0)
_COMMIT_WIRE = WireCost(base=12.0, words=1.0, n_verbs=2)

WIRE_COSTS: Dict[str, Dict[int, WireCost]] = {
    "twopl": {
        ST_LOCK: WireCost(base=16.0, words=1.0, n_verbs=2),  # CAS + READ doorbell
        ST_LOG: _LOG_WIRE,
        ST_COMMIT: _COMMIT_WIRE,
        ST_RELEASE: _RELEASE_WIRE,
    },
    "occ": {
        ST_FETCH: WireCost(base=12.0, words=1.0),
        ST_LOCK: WireCost(base=16.0, n_verbs=2),
        ST_VALIDATE: WireCost(base=12.0),
        ST_LOG: _LOG_WIRE,
        ST_COMMIT: _COMMIT_WIRE,
        ST_RELEASE: _RELEASE_WIRE,
    },
    "sundial": {
        ST_FETCH: WireCost(base=48.0, words=2.0, n_verbs=2),
        ST_LOCK: WireCost(base=24.0, words=1.0, n_verbs=2),
        ST_VALIDATE: WireCost(base=24.0),
        ST_LOG: _LOG_WIRE,
        ST_COMMIT: WireCost(base=16.0, words=1.0, n_verbs=2),
        ST_RELEASE: _RELEASE_WIRE,
    },
    "mvcc": {
        ST_FETCH: WireCost(base=48.0, words=8.0, n_verbs=2),
        ST_LOCK: WireCost(base=24.0, words=1.0, n_verbs=2),
        ST_VALIDATE: WireCost(base=16.0),
        ST_LOG: _LOG_WIRE,
        ST_COMMIT: WireCost(base=16.0, words=1.0, n_verbs=2),
        ST_RELEASE: _RELEASE_WIRE,
    },
}

# CALVIN's epoch plane (sequencing broadcast + RS/WS forwarding) is not a
# slot-engine stage machine, but its message shapes live in the same table.
CALVIN_WIRE: Dict[str, WireCost] = {
    "sequence": WireCost(base=16.0, per_op=5.0, n_verbs=2),  # txn descriptor batch
    "forward": WireCost(base=8.0, words=1.0, n_verbs=2),  # RS/WS record ship
}

_PROTO_FAMILY = {"nowait": "twopl", "waitdie": "twopl"}


def wire_cost(protocol: str, stage: int) -> WireCost:
    """Wire-cost entry for a protocol's canonical stage (family-aliased)."""
    from repro_torch.core import registry

    fam = registry.protocol_family(protocol)
    return WIRE_COSTS[_PROTO_FAMILY.get(fam, fam)][stage]


def queue_delay_us(cm: CostModel, primitive_is_rpc, dest_load: torch.Tensor, nic_unit=None):
    """Queueing delay at the destination given this tick's same-plane load
    (float32 tensor).  RPC requests queue on the handler CPU, one-sided
    verbs on the RNIC.  ``primitive_is_rpc`` is a Python bool or a bool
    tensor broadcastable to ``dest_load`` (then both branches are computed
    and selected, as the reference's ``jnp.where``); ``nic_unit`` overrides
    ``cm.nic_unit()`` with a tensor of one value per row (a batch whose
    configs differ in ``qp_pressure``)."""
    if isinstance(primitive_is_rpc, torch.Tensor):
        return torch.where(
            primitive_is_rpc,
            queue_delay_us(cm, True, dest_load, nic_unit),
            queue_delay_us(cm, False, dest_load, nic_unit),
        )
    excess = torch.clamp(dest_load - 1, min=0.0)
    if primitive_is_rpc:
        return excess * _F32(cm.handler_us) / 2.0 + _F32(cm.handler_us)
    return excess * (cm.nic_unit() if nic_unit is None else nic_unit) / 2.0


def round_latency_us(
    cm: CostModel, primitive_is_rpc, dest_load, msg_bytes, n_verbs: int = 1, doorbell: bool = True,
    nic_unit=None,
):
    """Latency of one network round for a request batch of n_verbs verbs.

    ``msg_bytes`` is a Python float or a float32 tensor broadcastable to
    ``dest_load``; the sum runs left to right in float32 as the reference's.
    Tensors stand first in each product and sum (float32 ``*`` and ``+``
    commute exactly): a numpy scalar on the left would take the tensor
    into numpy.  ``primitive_is_rpc`` and ``nic_unit`` are as in
    :func:`queue_delay_us`.
    """
    if isinstance(primitive_is_rpc, torch.Tensor):
        return torch.where(
            primitive_is_rpc,
            round_latency_us(cm, True, dest_load, msg_bytes, n_verbs, doorbell, nic_unit),
            round_latency_us(cm, False, dest_load, msg_bytes, n_verbs, doorbell, nic_unit),
        )
    base = _F32(cm.rpc_rtt_us if primitive_is_rpc else cm.os_rtt_us)
    mmio = _F32(cm.mmio_us if primitive_is_rpc else cm.mmio_us * (1 if doorbell else n_verbs))
    if isinstance(msg_bytes, torch.Tensor):
        head = msg_bytes * _F32(cm.byte_us) + (base + mmio)
    else:
        head = (base + mmio) + _F32(msg_bytes * cm.byte_us)
    return queue_delay_us(cm, primitive_is_rpc, dest_load, nic_unit) + head
