"""Doorbell-batched multi-read: the hand-written CUDA kernel's wrapper.

One RDMA doorbell posts several dependent READs for the same key set
(paper §4.2); the engine's analogue packs several store arrays along a
feature axis and gathers them at one batch of row ids.  The kernel is
``csrc/multi_read.cu``, an exact int32 gather; on CPU tensors the wrapper
runs the plain version, ``ref.multi_read_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import multi_read_ref


def _check(table, keys):
    if table.dim() != 2 or keys.dim() != 1:
        raise ValueError(
            f"multi_read: table must be (R, A) and keys (M,), got {tuple(table.shape)} / {tuple(keys.shape)}"
        )
    if table.dtype != torch.int32 or keys.dtype != torch.int32:
        raise TypeError(f"multi_read: table and keys must be int32, got {table.dtype} / {keys.dtype}")
    if table.device != keys.device:
        raise ValueError(f"multi_read: table on {table.device}, keys on {keys.device}")
    if not (table.is_contiguous() and keys.is_contiguous()):
        raise ValueError("multi_read: table and keys must be contiguous")


def multi_read(table, keys):
    """table (R, A) int32, keys (M,) int32 -> (M, A) int32 == table[keys],
    with zero rows for keys outside [0, R).  Launches
    ``csrc/multi_read.cu`` on CUDA tensors (or raises); runs the plain
    version on CPU tensors."""
    _check(table, keys)
    if keys.device.type == "cpu":
        return multi_read_ref(table, keys)
    if keys.device.type != "cuda":
        raise ValueError(f"multi_read: unsupported device {keys.device}")
    (R, A), M = table.shape, keys.shape[0]
    out = torch.empty((M, A), dtype=torch.int32, device=keys.device)
    if M == 0 or A == 0:
        return out
    fn = _build.kernel_fn("multi_read")
    with torch.cuda.device(keys.device):
        err = fn(table.data_ptr(), keys.data_ptr(), out.data_ptr(), R, A, M,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"multi_read: kernel launch failed with CUDA error {err}")
    multi_read.launches += 1
    return out


multi_read.launches = 0  # CUDA launches; reset by whoever reads it
