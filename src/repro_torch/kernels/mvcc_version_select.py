"""MVCC version selection: the hand-written CUDA kernel's wrappers.

RCC's per-op MVCC read check (paper §4.4): over the S static version slots
of each op, Cond R1 picks the slot with the largest wts strictly below the
reader's ctts (empty (0, 0) slots skipped, first index among ties) and
Cond R2 checks that the record's lock is free or ordered after ctts.  The
kernel is ``csrc/mvcc_version_select.cu``.  :func:`mvcc_version_read` is
the engine's fused read: one launch gathers each op's wts row (and lock
pair) from the store in place and picks.  :func:`mvcc_version_select`
picks over op rows the caller already holds.  On CPU tensors the wrappers
run the plain versions, ``ref.version_read_ref`` and
``ref.mvcc_version_select_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mvcc_version_select_ref, version_read_ref


def _check_words(what, named, device):
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, wts_hi on {device}")


def _check_shape(what, name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {tuple(shape)}")


def _check_lock(what, lock_hi, lock_lo):
    if (lock_hi is None) != (lock_lo is None):
        raise ValueError(f"{what}: give both lock words or neither")
    return () if lock_hi is None else (("lock_hi", lock_hi), ("lock_lo", lock_lo))


def _launch(wts_hi, wts_lo, stride, keys, R, ctts_hi, ctts_lo, K, lock_hi, lock_lo, shape, S, rows):
    """One launch of the kernel over the ops of ``shape``; returns (found,
    slot, ok or None, rows_hi, rows_lo) shaped ``shape`` (the rows ``shape
    + (S,)``, None unless ``rows``), each allocated in its final shape."""
    dev = wts_hi.device
    M = math.prod(shape)
    found = torch.empty(shape, dtype=torch.bool, device=dev)
    slot = torch.empty(shape, dtype=torch.int32, device=dev)
    ok = None if lock_hi is None else torch.empty(shape, dtype=torch.bool, device=dev)
    rows_hi = rows_lo = None
    if rows:
        rows_hi, rows_lo = (torch.empty(shape + (S,), dtype=torch.int32, device=dev) for _ in range(2))
    if M == 0:
        return found, slot, ok, rows_hi, rows_lo

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.kernel_fn("mvcc_version_select")
    with torch.cuda.device(dev):
        err = fn(
            wts_hi.data_ptr(), wts_lo.data_ptr(), stride, ptr(keys), R, ctts_hi.data_ptr(), ctts_lo.data_ptr(), K,
            ptr(lock_hi), ptr(lock_lo), found.data_ptr(), slot.data_ptr(), ptr(ok), ptr(rows_hi), ptr(rows_lo),
            M, S, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"mvcc_version_select: kernel launch failed with CUDA error {err}")
    mvcc_version_select.launches += 1
    return found, slot, ok, rows_hi, rows_lo


def _cuda(dev, what):
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")


def mvcc_version_select(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi=None, lock_lo=None):
    """Version pick over op rows: wts_* (M, S) int32, contiguous along S
    (views with another row stride, the same for both, are read in place),
    ctts_* (M,) per op or (N,) per transaction of M / N consecutive ops,
    lock_* (M,) contiguous or None -> (found (M,) bool, slot (M,) int32,
    r2_ok (M,) bool, or None without a lock).  Launches
    ``csrc/mvcc_version_select.cu`` on CUDA tensors (or raises); runs the
    plain version on CPU tensors."""
    what = "mvcc_version_select"
    if wts_hi.dim() != 2 or wts_hi.shape[1] < 1:
        raise ValueError(f"{what}: wts_hi must be (M, S) with S >= 1, got {tuple(wts_hi.shape)}")
    M, S = wts_hi.shape
    lock = _check_lock(what, lock_hi, lock_lo)
    _check_words(what, (("wts_hi", wts_hi), ("wts_lo", wts_lo), ("ctts_hi", ctts_hi), ("ctts_lo", ctts_lo)) + lock,
                 wts_hi.device)
    for name, t in (("wts_hi", wts_hi), ("wts_lo", wts_lo)):
        if M and S > 1 and t.stride(1) != 1:
            raise ValueError(f"{what}: {name} must be contiguous along S")
    _check_shape(what, "wts_lo", wts_lo, (M, S))
    if M > 1 and wts_hi.stride(0) != wts_lo.stride(0):
        raise ValueError(f"{what}: wts_hi and wts_lo must share one row stride")
    N = ctts_hi.shape[0] if ctts_hi.dim() == 1 else -1
    if N < 0 or (N == 0) != (M == 0) or (N and M % N):
        raise ValueError(f"{what}: ctts_hi shape {tuple(ctts_hi.shape)} is not (N,) with N dividing M = {M}")
    _check_shape(what, "ctts_lo", ctts_lo, (N,))
    for name, t in lock:
        _check_shape(what, name, t, (M,))
    for name, t in (("ctts_hi", ctts_hi), ("ctts_lo", ctts_lo)) + lock:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    K = M // N if N else 1
    dev = wts_hi.device
    if dev.type == "cpu":
        ch, cl = ctts_hi.repeat_interleave(K), ctts_lo.repeat_interleave(K)
        lh, ll = (lock_hi, lock_lo) if lock else (torch.zeros_like(ch),) * 2
        found, slot, ok = mvcc_version_select_ref(wts_hi, wts_lo, ch, cl, lh, ll)
        return found, slot, ok if lock else None
    _cuda(dev, what)
    stride = wts_hi.stride(0) if M > 1 else S
    return _launch(wts_hi, wts_lo, stride, None, M, ctts_hi, ctts_lo, K, lock_hi, lock_lo, (M,), S, False)[:3]


def mvcc_version_read(wts_hi, wts_lo, keys, ctts_hi, ctts_lo, lock_hi=None, lock_lo=None):
    """The fused version read: the store's wts_* (R, S) and, with a lock,
    lock_* (R,) int32 arrays, all contiguous, read at keys (N, K) int32
    (zero words for keys outside [0, R): no version, lock free), picked
    against one ctts pair (N,) per row of keys.  Returns (found (N, K)
    bool, slot (N, K) int32, r2_ok (N, K) bool or None, rows_hi, rows_lo
    (N, K, S) int32: the gathered wts rows).  One launch of
    ``csrc/mvcc_version_select.cu`` on CUDA tensors (or raises); the plain
    version on CPU tensors."""
    what = "mvcc_version_read"
    if wts_hi.dim() != 2 or wts_hi.shape[1] < 1:
        raise ValueError(f"{what}: wts_hi must be (R, S) with S >= 1, got {tuple(wts_hi.shape)}")
    if keys.dim() != 2:
        raise ValueError(f"{what}: keys must be (N, K), got {tuple(keys.shape)}")
    (R, S), (N, K) = wts_hi.shape, keys.shape
    lock = _check_lock(what, lock_hi, lock_lo)
    named = (("wts_hi", wts_hi), ("wts_lo", wts_lo), ("keys", keys), ("ctts_hi", ctts_hi), ("ctts_lo", ctts_lo))
    _check_words(what, named + lock, wts_hi.device)
    _check_shape(what, "wts_lo", wts_lo, (R, S))
    _check_shape(what, "ctts_hi", ctts_hi, (N,))
    _check_shape(what, "ctts_lo", ctts_lo, (N,))
    for name, t in lock:
        _check_shape(what, name, t, (R,))
    for name, t in named + lock:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    dev = wts_hi.device
    if dev.type == "cpu":
        return version_read_ref(wts_hi, wts_lo, keys, ctts_hi, ctts_lo, lock_hi, lock_lo)
    _cuda(dev, what)
    return _launch(wts_hi, wts_lo, S, keys, R, ctts_hi, ctts_lo, max(K, 1), lock_hi, lock_lo, (N, K), S, True)


mvcc_version_select.launches = 0  # CUDA launches of csrc/mvcc_version_select.cu by either wrapper
