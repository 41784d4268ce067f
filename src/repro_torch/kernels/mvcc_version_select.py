"""MVCC version selection: the hand-written CUDA kernel's wrapper.

RCC's per-op MVCC read check (paper §4.4): over the S static version slots
of each op, Cond R1 picks the slot with the largest wts strictly below the
reader's ctts (empty (0, 0) slots skipped, first index among ties) and
Cond R2 checks that the record's lock is free or ordered after ctts.  The
kernel is ``csrc/mvcc_version_select.cu``; on CPU tensors the wrapper runs
the plain version, ``ref.mvcc_version_select_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mvcc_version_select_ref


def _check(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi, lock_lo):
    if wts_hi.dim() != 2 or wts_hi.shape[1] < 1:
        raise ValueError(f"mvcc_version_select: wts_hi must be (M, S) with S >= 1, got {tuple(wts_hi.shape)}")
    M = wts_hi.shape[0]
    for name, t, shape in (
        ("wts_hi", wts_hi, wts_hi.shape),
        ("wts_lo", wts_lo, wts_hi.shape),
        ("ctts_hi", ctts_hi, (M,)),
        ("ctts_lo", ctts_lo, (M,)),
        ("lock_hi", lock_hi, (M,)),
        ("lock_lo", lock_lo, (M,)),
    ):
        if t.dtype != torch.int32:
            raise TypeError(f"mvcc_version_select: {name} must be int32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"mvcc_version_select: {name} shape {tuple(t.shape)} != {tuple(shape)}")
        if t.device != wts_hi.device:
            raise ValueError(f"mvcc_version_select: {name} on {t.device}, wts_hi on {wts_hi.device}")
        if not t.is_contiguous():
            raise ValueError(f"mvcc_version_select: {name} must be contiguous")


def mvcc_version_select(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi, lock_lo):
    """wts_* (M, S), the rest (M,) int32 -> (found (M,) bool, slot (M,)
    int32, r2_ok (M,) bool).  Launches ``csrc/mvcc_version_select.cu`` on
    CUDA tensors (or raises); runs the plain version on CPU tensors."""
    _check(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi, lock_lo)
    dev = wts_hi.device
    if dev.type == "cpu":
        return mvcc_version_select_ref(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi, lock_lo)
    if dev.type != "cuda":
        raise ValueError(f"mvcc_version_select: unsupported device {dev}")
    M, S = wts_hi.shape
    found = torch.empty((M,), dtype=torch.bool, device=dev)
    slot = torch.empty((M,), dtype=torch.int32, device=dev)
    ok = torch.empty((M,), dtype=torch.bool, device=dev)
    if M == 0:
        return found, slot, ok
    fn = _build.kernel_fn("mvcc_version_select")
    with torch.cuda.device(dev):
        err = fn(
            wts_hi.data_ptr(), wts_lo.data_ptr(), ctts_hi.data_ptr(), ctts_lo.data_ptr(),
            lock_hi.data_ptr(), lock_lo.data_ptr(), found.data_ptr(), slot.data_ptr(), ok.data_ptr(),
            M, S, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"mvcc_version_select: kernel launch failed with CUDA error {err}")
    mvcc_version_select.launches += 1
    return found, slot, ok


mvcc_version_select.launches = 0  # CUDA launches; reset by whoever reads it
