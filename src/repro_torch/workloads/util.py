"""Workload-factory arithmetic (port of ``repro.workloads.util``).

The port runs concrete Python counts only (bucket padding with traced
record counts is not ported), so these are the reference's concrete paths,
with the same float32 truncation in :func:`scaled_count`.
"""
from __future__ import annotations

import numpy as np
import torch


def imin(a: int, b: int) -> int:
    return min(int(a), int(b))


def imax(a: int, b: int) -> int:
    return max(int(a), int(b))


def scaled_count(n: int, frac: float, floor: int) -> int:
    """``max(int(n * frac), floor)`` with the product taken in float32 and
    truncated toward zero, as the reference takes it."""
    return max(int(np.float32(int(n)) * np.float32(frac)), floor)


def dedup_keys(keys, slot, n_records: int, rounds: int = 4):
    """The ycsb/tpcc within-txn de-duplication, vectorised over slots.

    keys (N, K) int32, slot (N,) int32.  The reference nudges each key that
    collides with an earlier one of its txn, over ``rounds`` passes of
    ``i = 1 .. K-1``; every step reads the keys the previous step wrote, so
    the ``rounds * (K - 1)`` steps stay sequential, as written there.
    """
    ks = keys.clone()
    nudge = slot * 13 + 1
    for r in range(rounds):
        for i in range(1, ks.shape[1]):
            clash = (ks[:, :i] == ks[:, i : i + 1]).any(dim=1)
            ks[:, i] = torch.where(clash, (ks[:, i] + (i * 131 + r * 37) + nudge) % n_records, ks[:, i])
    return ks
