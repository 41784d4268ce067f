"""Doorbell-batched multi-read: the hand-written CUDA kernel's wrappers.

One RDMA doorbell posts several dependent READs for the same key set
(paper §4.2); the engine's analogue gathers several store arrays at one
batch of row ids.  The kernel is ``csrc/multi_read.cu``: one launch reads
up to :data:`MAX_ARRAYS` arrays where they lie (their base pointers ride
in the launch's parameters), an exact int32 gather with zero rows for keys
outside [0, R).  On CPU tensors the wrappers run the plain versions,
``ref.gather_many_ref`` and ``ref.multi_read_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gather_many_ref, multi_read_ref

MAX_ARRAYS = 8  # the kernel's kMaxArrays


def _check(arrs, keys):
    if not 1 <= len(arrs) <= MAX_ARRAYS:
        raise ValueError(f"multi_read: takes 1 to {MAX_ARRAYS} arrays, got {len(arrs)}")
    R = arrs[0].shape[0] if arrs[0].dim() else None
    for i, t in enumerate((keys, *arrs)):
        name = "keys" if i == 0 else f"array {i - 1}"
        if t.dtype != torch.int32:
            raise TypeError(f"multi_read: {name} must be int32, got {t.dtype}")
        if t.device != keys.device:
            raise ValueError(f"multi_read: {name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"multi_read: {name} must be contiguous")
        if i and (t.dim() < 1 or t.shape[0] != R):
            raise ValueError(f"multi_read: every array must be (R, ...) with R = {R}, {name} is {tuple(t.shape)}")


def multi_read_many(arrs, keys):
    """Several (R, ...) int32 arrays sharing R, keys (...) int32 -> a tuple
    of ``keys.shape + arr.shape[1:]`` int32 arrays, ``arr[keys]`` each, with
    zero rows for keys outside [0, R).  On CUDA tensors one launch of
    ``csrc/multi_read.cu`` reads every array in place (or raises), each into
    its own contiguous output; on CPU tensors the plain version runs."""
    arrs = tuple(arrs)
    _check(arrs, keys)
    if keys.device.type == "cpu":
        outs = gather_many_ref(arrs, keys.reshape(-1))
        return tuple(o.reshape(tuple(keys.shape) + tuple(a.shape[1:])) for o, a in zip(outs, arrs))
    if keys.device.type != "cuda":
        raise ValueError(f"multi_read: unsupported device {keys.device}")
    M, R = keys.numel(), arrs[0].shape[0]
    # one allocation per output: the caching allocator's blocks start on 512-byte boundaries (the
    # kernel's 16-byte path), and an output made in its final shape needs no view
    outs = tuple(torch.empty(tuple(keys.shape) + tuple(a.shape[1:]), dtype=torch.int32, device=keys.device)
                 for a in arrs)
    widths = [math.prod(a.shape[1:]) for a in arrs]
    if M == 0 or not any(widths):
        return outs
    n = len(arrs)
    fn = _build.kernel_fn("multi_read")
    with torch.cuda.device(keys.device):
        err = fn(
            (ctypes.c_void_p * n)(*(a.data_ptr() for a in arrs)),
            (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
            (ctypes.c_int * n)(*widths), n, keys.data_ptr(), R, M,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"multi_read: kernel launch failed with CUDA error {err}")
    multi_read.launches += 1
    return outs


def multi_read(table, keys):
    """table (R, A) int32, keys (M,) int32 -> (M, A) int32 == table[keys],
    with zero rows for keys outside [0, R): the one-array case of
    :func:`multi_read_many` (the TPU kernel's packed-table gather)."""
    if table.dim() != 2 or keys.dim() != 1:
        raise ValueError(
            f"multi_read: table must be (R, A) and keys (M,), got {tuple(table.shape)} / {tuple(keys.shape)}"
        )
    if keys.device.type == "cpu":
        _check((table,), keys)
        return multi_read_ref(table, keys)
    return multi_read_many((table,), keys)[0]


multi_read.launches = 0  # CUDA launches of csrc/multi_read.cu by either wrapper; reset by whoever reads it
