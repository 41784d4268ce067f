"""Deterministic arbitration of concurrent atomic ops (port of
``repro.core.arbiter``).

Several coordinators CAS the same lock word in one round; the remote RNIC
serializes them.  The winner is the per-key lexicographic minimum of
(prio_hi, prio_lo), found with a two-pass scatter-min.
"""
from __future__ import annotations

import torch

_BIG = 2**31 - 1
_U32 = 0xFFFFFFFF


def scatter_min_winner(keys, prio_hi, prio_lo, active, n_records: int):
    """Among active requests, find the per-key minimum (prio_hi, prio_lo).

    keys (M,) int32 in [0, n_records); returns (M,) bool: is this request
    a winner for its key.  Exact ties give several winners (callers keep
    (prio_hi, prio_lo) unique among active requests).
    """
    keys = keys.long()
    kh = torch.where(active, prio_hi, _BIG)
    best_hi = torch.full((n_records,), _BIG, dtype=torch.int32, device=keys.device)
    best_hi = best_hi.scatter_reduce(0, keys, kh, "amin")
    hi_ok = active & (prio_hi == best_hi[keys])
    kl = torch.where(hi_ok, prio_lo, _BIG)
    best_lo = torch.full((n_records,), _BIG, dtype=torch.int32, device=keys.device)
    best_lo = best_lo.scatter_reduce(0, keys, kl, "amin")
    return hi_ok & (prio_lo == best_lo[keys])


def hash_prio(ts_lo, salt: int):
    """Deterministic pseudo-random priority (models arrival order).

    The reference multiplies, xors and shifts in uint32; torch has no full
    uint32 arithmetic, so this works in int64 and masks to 32 bits (an
    int64 product that wraps keeps its low 32 bits exact).
    """
    x = ((ts_lo.to(torch.int64) & _U32) * 2654435761) & _U32
    x = x ^ (int(salt) & _U32)
    x = x ^ (x >> 16)
    return (x & 0x7FFFFFFF).to(torch.int32)
