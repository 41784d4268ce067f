"""Plain PyTorch versions of the hand-written kernels.

The CPU tests hold them against the JAX kernels, the ``"kernel"`` plane
runs them on CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.
"""
from __future__ import annotations

import math

import torch

_I32_MIN = -(2**31)


def flash_attention_ref(q, k, v, *, causal=True):
    """q (B, H, Sq, Dh), k/v (B, H, Sk, Dh) -> (B, H, Sq, Dh): O(S^2)
    attention with float32 scores, -1e30 at masked entries (causal is
    top-left aligned: key c is seen by query r iff c <= r), and the softmax
    cast to v's dtype before the PV product."""
    Dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(Dh)
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        mask = torch.arange(Sk, device=q.device)[None, :] <= torch.arange(Sq, device=q.device)[:, None]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


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


def gather_many_ref(arrs, keys):
    """Several (R, ...) arrays sharing R at keys (M,) -> a tuple of (M, ...):
    one masked gather per array, zero rows for keys outside [0, R)."""
    R = arrs[0].shape[0]
    inside = (keys >= 0) & (keys < R)
    idx = torch.where(inside, keys, 0).long()
    outs = []
    for a in arrs:
        if R == 0:
            outs.append(a.new_zeros((keys.shape[0],) + tuple(a.shape[1:])))
            continue
        mask = inside.reshape((-1,) + (1,) * (a.dim() - 1))
        outs.append(torch.where(mask, a[idx], 0))
    return tuple(outs)


def version_read_ref(wts_hi, wts_lo, keys, ctts_hi, ctts_lo, lock_hi=None, lock_lo=None):
    """The fused version read: the store's wts_* (R, S) (and lock_* (R,))
    at keys (N, K), zero words for keys outside [0, R), then the version
    pick with one ctts pair (N,) per row of keys.  Returns (found, slot,
    r2_ok or None) shaped (N, K) and the gathered wts rows (N, K, S) x 2."""
    N, K = keys.shape
    arrs = (wts_hi, wts_lo) if lock_hi is None else (wts_hi, wts_lo, lock_hi, lock_lo)
    got = gather_many_ref(arrs, keys.reshape(-1))
    wh, wl = got[0], got[1]
    lh, ll = (got[2], got[3]) if lock_hi is not None else (torch.zeros_like(wh[:, 0]),) * 2
    ch, cl = ctts_hi.repeat_interleave(K), ctts_lo.repeat_interleave(K)
    found, slot, ok = mvcc_version_select_ref(wh, wl, ch, cl, lh, ll)
    S = wts_hi.shape[1]
    return (found.reshape(N, K), slot.reshape(N, K), None if lock_hi is None else ok.reshape(N, K),
            wh.reshape(N, K, S), wl.reshape(N, K, S))


def mvcc_version_select_ref(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi, lock_lo):
    """wts_* (M, S), the rest (M,) int32 -> (found (M,) bool, slot (M,)
    int32, r2_ok (M,) bool).

    Cond R1: the slot with the lexicographically largest signed
    (wts_hi, wts_lo) strictly below (ctts_hi, ctts_lo), empty (0, 0) slots
    skipped; ``slot`` is the first index among tied winners, 0 when nothing
    is found.  Cond R2: the lock is free (0, 0) or ctts < lock.
    """
    ch, cl = ctts_hi[:, None], ctts_lo[:, None]
    lt = (wts_hi < ch) | ((wts_hi == ch) & (wts_lo < cl))
    cand = lt & ((wts_hi != 0) | (wts_lo != 0))
    bh = torch.where(cand, wts_hi, _I32_MIN).amax(dim=1, keepdim=True)
    at_h = cand & (wts_hi == bh)
    bl = torch.where(at_h, wts_lo, _I32_MIN).amax(dim=1, keepdim=True)
    slot = first_true(at_h & (wts_lo == bl))
    free = (lock_hi == 0) & (lock_lo == 0)
    after = (ctts_hi < lock_hi) | ((ctts_hi == lock_hi) & (ctts_lo < lock_lo))
    return cand.any(dim=1), slot, free | after


def first_true(mask):
    """Index of the first True along the last axis, 0 where there is none
    (``jnp.argmax`` of a bool mask), int32."""
    S = mask.shape[-1]
    idx = torch.arange(S, dtype=torch.int32, device=mask.device)
    first = torch.where(mask, idx, S).amin(dim=-1)
    return torch.where(first == S, 0, first).to(torch.int32)
