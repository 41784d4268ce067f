"""TPC-C new-order (paper §6.1; port of ``repro.workloads.tpcc``): long
transactions with up to 15 distributed writes (stock updates), a
CPU-intensive execution phase and 100 % write ops.

The model keeps new-order's distributed-contention core: 5-15 stock
records (read-modify-write), ~10 % remote-warehouse items and
warehouse-local hot rows.  ``gen`` and ``execute`` are vectorised over
slots; the draws are bit-exact copies of the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.engine import Workload
from repro_torch.workloads.util import column, dedup_keys, imax, map_configs

RW = 4
K = 15
# the draw shapes of gen's batched pass: randint(k1, ()) twice, randint(k3 and k4, (K,)) twice each, uniform(k2, (K,))
_SHAPES = ((),) * 2 + ((K,),) * 5


def make_tpcc_neworder(
    n_records,
    n_warehouses: int = 16,
    remote_prob: float = 0.10,
    exec_ticks=5,
) -> Workload:
    """``n_records`` and ``exec_ticks`` are ints, or tuples of one per
    config of a batched run."""
    per_wh = imax(map_configs(lambda n: int(n) // n_warehouses, n_records), 1)
    remote_p = float(np.float32(remote_prob))

    def gen(keys, node, slot, per_row=None):
        """keys (N, 2) PRNG keys -> (keys (N, K) int32, is_w, valid (N, K) bool).

        The reference draws ``split(key, 5)``, then ``randint(k1, ())``,
        ``uniform(k2)``, ``randint(k3)`` and ``randint(k4)`` of shape (K,);
        their seven threefry passes run here as one, each row at its own
        shape's counts (``prng.row_bits``: in the partitionable mode the
        shape-() draw is the count-0 element of a shape-(K,) one, in the
        legacy mode it is not, and K = 15 pads the legacy blocks).
        """
        sub = prng.split(keys, 5)  # k1..k5 (k5 unused, as in the reference)
        halves = prng.split(sub[:, [0, 2, 3]], 2)  # randint's (higher, lower) keys of k1, k3, k4
        bits = prng.row_bits(torch.cat([halves.flatten(1, 2), sub[:, 1:2]], dim=1), _SHAPES)
        # bits rows: k1 hi/lo, k3 hi/lo, k4 hi/lo, k2
        n_items = prng.randint_from_bits(bits[:, 0, 0], bits[:, 1, 0], 5, K + 1)
        wh = (slot * 7 + node) % n_warehouses  # home warehouse
        remote = prng.uniform_from_bits(bits[:, 6]) < remote_p
        wh_i = torch.where(remote, prng.randint_from_bits(bits[:, 2], bits[:, 3], 0, n_warehouses), wh[:, None])
        pw = column(per_row, per_wh)
        item = prng.randint_from_bits(bits[:, 4], bits[:, 5], 0, pw)
        ks = dedup_keys((wh_i * pw + item).to(torch.int32), slot, column(per_row, n_records))
        valid = torch.arange(K, device=keys.device)[None, :] < n_items[:, None]
        return ks, valid.clone(), valid  # new-order: every stock access is read-modify-write

    def execute(keys, is_w, valid, rvals):
        """Stock decrement with wraparound (the s_quantity rule), ytd + 1."""
        q = rvals[:, :, 0]
        w = rvals.clone()
        w[:, :, 0] = torch.where(q > 10, q - 5, q - 5 + 91)
        w[:, :, 1] += 1
        return w

    return Workload(
        name="tpcc", rw=RW, max_ops=K, init_value=50, gen=gen, execute=execute, exec_ticks=exec_ticks
    )
