"""YCSB (paper §6.1; port of ``repro.workloads.ycsb``): one table, 64-byte
records (16 words), 10 ops per txn, 80 % reads / 20 % writes, a 0.1 % hot
area and a configurable hot-access probability (the contention knob).

``gen`` and ``execute`` are vectorised over slots (the reference vmaps its
per-slot functions); the draws are bit-exact copies of the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.engine import Workload
from repro_torch.workloads.util import column, dedup_keys, map_configs, scaled_count

RW = 16  # 64-byte records
K = 10


def make_ycsb(
    n_records,
    hot_prob=0.10,
    hot_frac: float = 0.001,
    write_frac: float = 0.20,
    exec_ticks=3,  # ~5us execution phase at tick=2us
) -> Workload:
    """``n_records``, ``hot_prob`` and ``exec_ticks`` are Python values, or
    tuples of one per config of a batched run."""
    # floor the hot set so tiny test stores don't degenerate to one record
    n_hot = scaled_count(n_records, hot_frac, 16)
    # the reference's knobs are float32: compare the float32 draws with them
    hot_p = map_configs(lambda p: float(np.float32(p)), hot_prob)
    write_p = float(np.float32(write_frac))

    def gen(keys, node, slot, per_row=None):
        """keys (N, 2) PRNG keys -> (keys (N, K) int32, is_w, valid (N, K) bool).

        The reference draws ``split(key, 4)``, then ``uniform(k1)``,
        ``randint(k2)``, ``randint(k3)`` and ``uniform(k4)``, each of shape
        (K,); their six independent threefry passes run here as one (in
        the legacy mode each row's K words from K/2 blocks, as the
        reference's).
        """
        sub = prng.split(keys, 4)  # k1..k4
        halves = prng.split(sub[:, 1:3], 2)  # randint's (higher, lower) keys of k2, k3
        bits = prng.random_bits(torch.cat([sub[:, 0:1], halves.flatten(1, 2), sub[:, 3:4]], dim=1), (K,))
        # bits rows: k1, k2 hi/lo, k3 hi/lo, k4
        n_rec, n_h = column(per_row, n_records), column(per_row, n_hot)
        hot = prng.uniform_from_bits(bits[:, 0]) < column(per_row, hot_p, torch.float32)
        cold = prng.randint_from_bits(bits[:, 1], bits[:, 2], n_h, n_rec)
        hot_keys = prng.randint_from_bits(bits[:, 3], bits[:, 4], 0, n_h)
        ks = dedup_keys(torch.where(hot, hot_keys, cold), slot, n_rec)
        is_w = prng.uniform_from_bits(bits[:, 5]) < write_p
        valid = torch.ones_like(is_w)
        return ks, is_w, valid

    def execute(keys, is_w, valid, rvals):
        return rvals + 1  # field increment

    return Workload(
        name="ycsb", rw=RW, max_ops=K, init_value=0, gen=gen, execute=execute, exec_ticks=exec_ticks
    )
