"""Lock-CAS arbitration: the hand-written CUDA kernel's wrapper.

Models the owning node's RNIC serializing concurrent CAS verbs: within
each group, request i wins iff it is active and no active request on the
same key has a lexicographically smaller signed (prio_hi, prio_lo).  This
is ``repro.core.arbiter.scatter_min_winner``'s semantics (no index
tiebreak), so the kernel plane is bitwise-interchangeable with the torch
plane.  The kernel is ``csrc/lock_arbiter.cu``, a per-key hash table of
packed priorities (:func:`pack_prio`); on CPU tensors the wrapper runs the
plain version, ``ref.lock_arbiter_ref``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lock_arbiter_ref


@functools.lru_cache(maxsize=64)
def _scratch_words(M: int) -> int:
    """64-bit words of global scratch per group the kernel needs for M
    requests: 0 when its table fits in shared memory (one launch), else an
    insert and a decide launch.  The kernel's own rule, asked of it."""
    return _build.helper_fn("rt_lock_arbiter_scratch_words")(M)


def pack_prio(hi, lo):
    """The kernel's 64-bit priority word, as numpy uint64:
    ``((hi ^ 0x80000000) << 32) | (lo ^ 0x80000000)`` on the int32 words'
    bits.  Its unsigned order is the signed lexicographic order of (hi, lo),
    and equal words are exact ties."""
    hi = np.asarray(hi, np.int32).view(np.uint32).astype(np.uint64)
    lo = np.asarray(lo, np.int32).view(np.uint32).astype(np.uint64)
    bias = np.uint64(0x80000000)
    return ((hi ^ bias) << np.uint64(32)) | (lo ^ bias)


def _check(keys, prio_hi, prio_lo, active):
    if keys.dim() != 2:
        raise ValueError(f"lock_arbiter: keys must be (G, M), got {tuple(keys.shape)}")
    for name, t, dt in (
        ("keys", keys, torch.int32),
        ("prio_hi", prio_hi, torch.int32),
        ("prio_lo", prio_lo, torch.int32),
        ("active", active, torch.bool),
    ):
        if t.dtype != dt:
            raise TypeError(f"lock_arbiter: {name} must be {dt}, got {t.dtype}")
        if t.shape != keys.shape:
            raise ValueError(f"lock_arbiter: {name} shape {tuple(t.shape)} != keys {tuple(keys.shape)}")
        if t.device != keys.device:
            raise ValueError(f"lock_arbiter: {name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"lock_arbiter: {name} must be contiguous")


def lock_arbiter(keys, prio_hi, prio_lo, active):
    """keys/prio_hi/prio_lo (G, M) int32, active (G, M) bool -> won (G, M)
    bool.  Launches ``csrc/lock_arbiter.cu`` on CUDA tensors (or raises):
    one launch with the table in shared memory, or, at an M too large for
    that, two over a global-memory table; runs the plain version on CPU
    tensors."""
    _check(keys, prio_hi, prio_lo, active)
    if keys.device.type == "cpu":
        return lock_arbiter_ref(keys, prio_hi, prio_lo, active)
    if keys.device.type != "cuda":
        raise ValueError(f"lock_arbiter: unsupported device {keys.device}")
    G, M = keys.shape
    won = torch.empty((G, M), dtype=torch.bool, device=keys.device)
    if G == 0 or M == 0:
        return won
    words = _scratch_words(M)
    if words and G > 65535:
        raise ValueError(f"lock_arbiter: G={G} exceeds the grid's y limit (65535) on the global-table path (M={M})")
    scratch = torch.empty((G, words), dtype=torch.int64, device=keys.device) if words else None
    fn = _build.kernel_fn("lock_arbiter")
    with torch.cuda.device(keys.device):
        err = fn(
            keys.data_ptr(), prio_hi.data_ptr(), prio_lo.data_ptr(), active.data_ptr(), won.data_ptr(),
            None if scratch is None else scratch.data_ptr(), G, M, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lock_arbiter: kernel launch failed with CUDA error {err}")
    lock_arbiter.launches += 2 if words else 1
    return won


lock_arbiter.launches = 0  # CUDA launches; reset by whoever reads it
