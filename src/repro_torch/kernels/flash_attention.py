"""Flash attention: the hand-written CUDA kernel's wrapper.

The LM's prefill attention: q (B, H, Sq, Dh), k/v (B, H, Sk, Dh), heads
already GQA-expanded, float32 scores and online-softmax statistics, ``p``
cast to v's dtype before the PV product, causal masking top-left aligned
(``col <= row``).  The kernel is ``csrc/flash_attention.cu``; on CPU tensors
the wrapper runs the plain version, ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 112, 128)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, H, S, Dh), got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; q, k and v must share one of {DTYPES}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous along Dh (stride {t.stride(-1)})")
    B, H, _, Dh = q.shape
    if k.shape != v.shape or tuple(k.shape[:2]) != (B, H) or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {Dh} not in {HEAD_DIMS}")


def flash_attention(q, k, v, *, causal: bool = True):
    """q (B, H, Sq, Dh), k/v (B, H, Sk, Dh) -> (B, H, Sq, Dh) in q's dtype.

    Launches ``csrc/flash_attention.cu`` on CUDA tensors (or raises); runs
    the plain version on CPU tensors.  Inputs may be strided views as long
    as Dh is contiguous (views whose base or strides are not 16-byte
    aligned take the kernel's plain-load path instead of its cp.async
    copies); the output has q's memory layout (``empty_like``),
    so (B, S, H, Dh) projections transposed in give a (B, S, H, Dh) result
    back with a free transpose.
    """
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal).to(q.dtype)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    out = torch.empty_like(q)
    if out.stride(-1) != 1:  # empty_like keeps q's strides only where they are dense
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if B * H * Sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.kernel_fn("flash_attention")
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq, Sk, Dh, strides,
            1.0 / math.sqrt(Dh), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # CUDA launches; reset by whoever reads it
