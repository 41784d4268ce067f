"""SmallBank (paper §6.1; port of ``repro.workloads.smallbank``): a banking
app with fewer than 3 reads/writes per txn and trivial arithmetic, so it
is network-bound.  Accounts hold (checking, savings) balances.

``gen`` and ``execute`` are vectorised over slots (the reference vmaps its
per-slot functions); the draws are bit-exact copies of the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.engine import Workload
from repro_torch.workloads.util import column, imin

RW = 2  # record: (checking, savings)
K = 2  # max ops per txn
HOT_FRAC = 0.25  # fraction of accesses hitting the hot 100 accounts
# the draw shapes of gen's batched pass: randint(k1, ()) twice, randint(k3 and k4, (2,)) twice each, uniform(k2, (2,))
_SHAPES = ((),) * 2 + ((K,),) * 5


def make_smallbank(n_records, hot_accounts: int = 100, exec_ticks=1) -> Workload:
    """``n_records`` and ``exec_ticks`` are ints, or tuples of one per
    config of a batched run."""
    n_hot = imin(hot_accounts, n_records)

    def gen(keys, node, slot, per_row=None):
        """keys (N, 2) PRNG keys -> (keys (N, K) int32, is_w, valid (N, K) bool).

        The reference draws ``split(key, 5)``, ``randint`` three times and
        ``uniform`` once; here the independent threefry passes of those
        draws run batched (four passes in all).  The last pass draws the
        shape-() ``randint`` of k1 beside the (2,) draws, each row at its
        own shape's counts (``prng.row_bits``: in the partitionable mode a
        shape-() draw is the count-0 element of a shape-(2,) one, in the
        legacy mode it is not).
        """
        sub = prng.split(keys, 5)  # k1..k5
        # randint's (higher, lower) keys of k1, k3, k4
        halves = prng.split(torch.stack((sub[:, 0], sub[:, 2], sub[:, 3]), dim=1), 2)
        bits = prng.row_bits(torch.cat([halves.flatten(1, 2), sub[:, 1:2]], dim=1), _SHAPES)
        # bits rows: k1 hi/lo, k3 hi/lo, k4 hi/lo, k2
        n_rec = column(per_row, n_records)
        ttype = prng.randint_from_bits(bits[:, 0, 0], bits[:, 1, 0], 0, 6)
        acct = prng.randint_from_bits(bits[:, 2], bits[:, 3], 0, n_rec)
        acct_hot = prng.randint_from_bits(bits[:, 4], bits[:, 5], 0, column(per_row, n_hot))
        hot = prng.uniform_from_bits(bits[:, 6]) < HOT_FRAC
        a = torch.where(hot, acct_hot, acct)
        pos = torch.arange(2, dtype=torch.int32, device=keys.device)
        same = (a[:, 1] == a[:, 0])[:, None]
        a = torch.where(same, (a + pos) % n_rec, a)  # distinct accounts
        # balance() is read-only single-account; amalgamate / send-payment touch 2
        two_accounts = (ttype == 0) | (ttype == 3)
        read_only = ttype == 1
        valid = torch.stack([torch.ones_like(two_accounts), two_accounts], dim=1)
        is_w = torch.stack([~read_only, two_accounts & ~read_only], dim=1)
        return a, is_w, valid

    def execute(keys, is_w, valid, rvals):
        """rvals (N, K, RW) -> wvals: move 1 from checking[0] to checking[1]
        on a transfer, deposit +1 to checking on a single-account write."""
        w = rvals.clone()
        w[:, 0, 0] += torch.where(valid[:, 1], -1, 1).to(rvals.dtype)
        w[:, 1, 0] += 1
        return w

    return Workload(
        name="smallbank",
        rw=RW,
        max_ops=K,
        init_value=1000,
        gen=gen,
        execute=execute,
        exec_ticks=exec_ticks,
    )
