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
from typing import Dict

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
    qp_pressure: float = 0.0  # grows with emulated cluster size (Fig. 10)

    def nic_eff_cap(self) -> np.float32:
        """NIC verb capacity degraded by QP-state cache pressure (float32,
        as the reference computes it from its float32 sweep knob)."""
        return _F32(self.nic_cap) / (_F32(1.0) + _F32(self.qp_pressure))

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

_PROTO_FAMILY = {"nowait": "twopl", "waitdie": "twopl"}


def wire_cost(protocol: str, stage: int) -> WireCost:
    """Wire-cost entry for a protocol's canonical stage (family-aliased)."""
    from repro_torch.core import registry

    fam = registry.protocol_family(protocol)
    return WIRE_COSTS[_PROTO_FAMILY.get(fam, fam)][stage]


def queue_delay_us(cm: CostModel, primitive_is_rpc: bool, dest_load: torch.Tensor):
    """Queueing delay at the destination given this tick's same-plane load
    (float32 tensor).  RPC requests queue on the handler CPU, one-sided
    verbs on the RNIC."""
    excess = torch.clamp(dest_load - 1, min=0.0)
    if primitive_is_rpc:
        return excess * _F32(cm.handler_us) / 2.0 + _F32(cm.handler_us)
    nic_unit = _F32(1.0) / max(cm.nic_eff_cap(), _F32(1e-6)) * _F32(cm.tick_us)
    return excess * nic_unit / 2.0


def round_latency_us(
    cm: CostModel, primitive_is_rpc: bool, dest_load, msg_bytes, n_verbs: int = 1, doorbell: bool = True
):
    """Latency of one network round for a request batch of n_verbs verbs.

    ``msg_bytes`` is a Python float or a float32 tensor broadcastable to
    ``dest_load``; the sum runs left to right in float32 as the reference's.
    Tensors stand first in each product and sum (float32 ``*`` and ``+``
    commute exactly): a numpy scalar on the left would take the tensor
    into numpy.
    """
    base = _F32(cm.rpc_rtt_us if primitive_is_rpc else cm.os_rtt_us)
    mmio = _F32(cm.mmio_us if primitive_is_rpc else cm.mmio_us * (1 if doorbell else n_verbs))
    if isinstance(msg_bytes, torch.Tensor):
        head = msg_bytes * _F32(cm.byte_us) + (base + mmio)
    else:
        head = (base + mmio) + _F32(msg_bytes * cm.byte_us)
    return queue_delay_us(cm, primitive_is_rpc, dest_load) + head
