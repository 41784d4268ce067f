"""Lock-CAS arbitration: the hand-written CUDA kernel's wrapper.

Models the owning node's RNIC serializing concurrent CAS verbs: within
each group, request i wins iff it is active and no active request on the
same key has a lexicographically smaller signed (prio_hi, prio_lo).  This
is ``repro.core.arbiter.scatter_min_winner``'s semantics (no index
tiebreak), so the kernel plane is bitwise-interchangeable with the torch
plane.  The kernel is ``csrc/lock_arbiter.cu``; on CPU tensors the wrapper
runs the plain version, ``ref.lock_arbiter_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lock_arbiter_ref


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
    bool.  Launches ``csrc/lock_arbiter.cu`` on CUDA tensors (or raises);
    runs the plain version on CPU tensors."""
    _check(keys, prio_hi, prio_lo, active)
    if keys.device.type == "cpu":
        return lock_arbiter_ref(keys, prio_hi, prio_lo, active)
    if keys.device.type != "cuda":
        raise ValueError(f"lock_arbiter: unsupported device {keys.device}")
    G, M = keys.shape
    if G > 65535:
        raise ValueError(f"lock_arbiter: G={G} exceeds the grid's y limit (65535)")
    won = torch.empty((G, M), dtype=torch.bool, device=keys.device)
    if G == 0 or M == 0:
        return won
    fn = _build.kernel_fn("lock_arbiter")
    with torch.cuda.device(keys.device):
        err = fn(
            keys.data_ptr(), prio_hi.data_ptr(), prio_lo.data_ptr(), active.data_ptr(),
            won.data_ptr(), G, M, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lock_arbiter: kernel launch failed with CUDA error {err}")
    lock_arbiter.launches += 1
    return won


lock_arbiter.launches = 0  # CUDA launches; reset by whoever reads it
