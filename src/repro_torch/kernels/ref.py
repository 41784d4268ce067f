"""Plain PyTorch versions of the hand-written kernels.

The CPU tests hold them against the JAX kernels, the ``"kernel"`` plane
runs them on CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.
"""
from __future__ import annotations

import torch


def lock_arbiter_ref(keys, prio_hi, prio_lo, active):
    """(G, M) -> won (G, M): per-group per-key lexicographic
    (prio_hi, prio_lo) minimum wins (``scatter_min_winner`` semantics, no
    index tiebreak: exact ties give several winners)."""
    same = keys[:, :, None] == keys[:, None, :]
    hi_j, hi_i = prio_hi[:, None, :], prio_hi[:, :, None]
    lo_j, lo_i = prio_lo[:, None, :], prio_lo[:, :, None]
    beats = same & active[:, None, :] & ((hi_j < hi_i) | ((hi_j == hi_i) & (lo_j < lo_i)))
    return active & ~beats.any(dim=-1)


def multi_read_ref(table, keys):
    """table (R, A), keys (M,) -> (M, A); keys outside [0, R) gather zeros."""
    R = table.shape[0]
    inside = (keys >= 0) & (keys < R)
    out = table[torch.clamp(keys, 0, max(R - 1, 0)).long()]
    return torch.where(inside[:, None], out, 0)
