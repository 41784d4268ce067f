"""Workload-factory arithmetic (port of ``repro.workloads.util``).

A count or knob is a Python value, or, in a batched run whose configs
differ in it (record padding, ``hot_prob``), a tuple of one per config;
the arithmetic runs per config in Python with the reference's truncation,
and :func:`column` hands the draws each row's value.
"""
from __future__ import annotations

import numpy as np
import torch


def map_configs(fn, *args):
    """``fn`` of Python values, or a tuple of ``fn`` per config where an
    argument is a tuple of one value per config."""
    n = next((len(a) for a in args if isinstance(a, tuple)), None)
    if n is None:
        return fn(*args)
    return tuple(fn(*(a[i] if isinstance(a, tuple) else a for a in args)) for i in range(n))


def imin(a, b):
    return map_configs(lambda x, y: min(int(x), int(y)), a, b)


def imax(a, b):
    return map_configs(lambda x, y: max(int(x), int(y)), a, b)


def scaled_count(n, frac: float, floor: int):
    """``max(int(n * frac), floor)`` with the product taken in float32 and
    truncated toward zero, as the reference takes it (concrete and traced
    alike)."""
    return map_configs(lambda x: max(int(np.float32(int(x)) * np.float32(frac)), floor), n)


def column(per_row, v, dtype=torch.int32):
    """A knob as the draws of a batch use it: ``v`` itself when it is one
    value for every config, else each row's value as an (N, 1) tensor
    (``per_row`` is the engine's expansion of a per-config tuple)."""
    if not isinstance(v, tuple):
        return v
    if per_row is None:
        raise ValueError("a workload knob given per config needs the engine's per_row expansion")
    return per_row(v, dtype)[:, None]


def dedup_keys(keys, slot, n_records, rounds: int = 4):
    """The ycsb/tpcc within-txn de-duplication, vectorised over slots.

    keys (N, K) int32, slot (N,) int32, n_records an int or each row's
    count ((N,) or (N, 1) int32).
    The reference nudges each key that collides with an earlier one of its
    txn, over ``rounds`` passes of ``i = 1 .. K-1``; every step reads the
    keys the previous step wrote, so the ``rounds * (K - 1)`` steps stay
    sequential, as written there.
    """
    ks = keys.clone()
    if isinstance(n_records, torch.Tensor):
        n_records = n_records.reshape(-1)
    nudge = slot * 13 + 1
    for r in range(rounds):
        for i in range(1, ks.shape[1]):
            clash = (ks[:, :i] == ks[:, i : i + 1]).any(dim=1)
            ks[:, i] = torch.where(clash, (ks[:, i] + (i * 131 + r * 37) + nudge) % n_records, ks[:, i])
    return ks
