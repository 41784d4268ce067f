"""Mamba-1 selective SSM block (falcon-mamba-7b), port of ``repro.layers.ssm``.

Train and prefill run a parallel associative scan over time
(``layers.scan``, lax's algorithm); decode carries the SSM state h
(B, d_inner, N) float32 and the conv window's last K - 1 inputs
(B, K - 1, d_inner).  The recurrence ``h_t = dA_t * h_{t-1} + dBx_t`` runs on
(B, S, d_inner, N) float32 tensors, 4.3 GB each at falcon-mamba's B = 4 x
2048 tokens, so ``_ssm_core`` runs it over chunks of d_inner channels: the
channels are independent, so a chunked run is bitwise the whole one.  Under
autograd each chunk is checkpointed, so a chunk's tree of products exists
only while that chunk runs or is differentiated (ROADMAP.md C.23).
Plain PyTorch on both kernel planes: the reference runs this layer through
XLA, with no Pallas kernel.  ``Record`` splits a call's device time by
step in a profiler trace.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.layers.common import ParamSet
from repro_torch.layers.scan import associative_scan
from repro_torch.sharding import P, Param, dense_init, name_key, ones_init, zeros_init

# elements of one (B, S, chunk, N) float32 tensor of the scan: 1 GiB; the scan holds about 7 of them at once, and a
# chunk's backward about 10 (its tree of products and their gradients)
SCAN_CHUNK_ELEMS = 1 << 28


class SSM(ParamSet):
    """``in_proj`` (D, 2 di), ``conv_w`` (K, di), ``conv_b`` (di,), ``x_proj``
    (di, R + 2N), ``dt_proj`` (R, di), ``dt_bias`` (di,), ``A_log`` (di, N),
    ``Dp`` (di,) float32, ``out_proj`` (di, D)."""

    NAMES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "Dp", "out_proj")


class Record:
    """While open (``with Record():``), every SSM call marks its steps as
    profiler ranges ``ssm:<step>`` (``in_proj``, ``conv``, ``x_proj/dt``,
    ``scan``, ``out_proj``), which split its device time in a trace."""

    current = None  # the open record, if any (one per class: ``rglru.Record`` is another)

    def __enter__(self):
        if type(self).current is not None:
            raise RuntimeError("a Record is already open")
        type(self).current = self
        return self

    def __exit__(self, *exc):
        type(self).current = None


def _step(name):
    """A profiler range around one step of the SSM while a Record is open."""
    return record_function(f"ssm:{name}") if Record.current is not None else contextlib.nullcontext()


def init_ssm(key, cfg: ArchConfig, dtype=torch.float32) -> SSM:
    """The reference's draws.  ``A_log`` is XLA's CPU ``log`` of 1..N for
    every channel; ``dt_bias`` is the inverse softplus of dt =
    exp(u (log 0.1 - log 0.001) + log 0.001), u uniform, evaluated op by
    op in float32 as the reference's eager ``init_ssm`` does, with XLA's
    CPU ``exp`` and ``log`` (``prng``)."""
    D, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv
    dev = key.device
    if dev.type == "meta":  # a spec walk: no draw
        a_init, dt_bias = torch.empty((di, N), device=dev), torch.empty((di,), device=dev)
    else:
        a_init = prng.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)).expand(di, N).contiguous()
        lo, hi = prng.log(torch.tensor([0.001, 0.1], dtype=torch.float32, device=dev))  # jnp.log of the float32 values
        u = prng.uniform(name_key(key, "dt_bias"), (di,))
        dt = prng.exp(u * (hi - lo) + lo)
        dt_bias = prng.log(prng.exp(dt) - 1.0 + float(np.float32(1e-9)))  # inverse-softplus of dt in [1e-3, 1e-1]
    return SSM({
        "in_proj": dense_init(key, "in_proj", (D, 2 * di), P(("embed", "fsdp"), "d_inner"), dtype),
        "conv_w": dense_init(key, "conv_w", (K, di), P(None, "d_inner"), dtype, scale=0.5),
        "conv_b": zeros_init("conv_b", (di,), P("d_inner"), dtype, dev),
        "x_proj": dense_init(key, "x_proj", (di, R + 2 * N), P("d_inner", None), dtype),
        "dt_proj": dense_init(key, "dt_proj", (R, di), P(None, "d_inner"), dtype),
        "dt_bias": Param(dt_bias, P("d_inner")),
        "A_log": Param(a_init, P("d_inner", None)),
        "Dp": ones_init("Dp", (di,), P("d_inner"), torch.float32, dev),
        "out_proj": dense_init(key, "out_proj", (di, D), P("d_inner", ("embed", "fsdp")), dtype),
    })


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,di), w (K,di) -> (B,S,di): the sum
    over the K taps in the reference's order, then the bias."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i : i + S] * w[i]
    return out + b


def _dt(params: SSM, dt_r):
    """(B,S,R) -> float32 step sizes softplus(dt_r @ dt_proj + dt_bias)."""
    return softplus((dt_r @ params.dt_proj.to(dt_r.dtype)).float() + params.dt_bias)


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


def _scan_chunk(dt, x, B_ssm, C_ssm, A):
    """The recurrence over one chunk of c channels: dt, x (B,S,c), B/C
    (B,S,N) float32, A (c,N) -> (the readout y (B,S,c), the last state
    (B,c,N))."""
    dA = torch.exp(dt[..., None] * A)  # (B,S,c,N)
    dBx = (dt * x)[..., None] * B_ssm[:, :, None, :]
    _, h = associative_scan(_combine, (dA, dBx), dim=1)
    del dA, dBx
    # the readout ``bsdn,bsn->bsd`` as a product and a sum over n: a batched matmul's order of summation
    # depends on the chunk's width, and a chunked run must be bitwise the whole one
    return (h * C_ssm[:, :, None, :]).sum(-1), h[:, -1].clone()


def _ssm_core(params: SSM, x_c, dt_r, B_ssm, C_ssm, chunk: Optional[int] = None):
    """Selective scan. x_c (B,S,di), dt_r (B,S,R), B/C (B,S,N) -> (y (B,S,di),
    h_last (B,di,N) float32), over ``chunk`` channels at a time (by default
    as many as keep one (B,S,chunk,N) tensor within ``SCAN_CHUNK_ELEMS``).
    Under autograd each chunk is checkpointed: its tree of products is made
    again in the backward, one chunk at a time, and not kept from the
    forward."""
    Bn, S, di = x_c.shape
    N = B_ssm.shape[-1]
    grad = torch.is_grad_enabled()
    if chunk is None:
        chunk = max(1, SCAN_CHUNK_ELEMS // (Bn * S * N))
    with _step("x_proj/dt"):
        dt = _dt(params, dt_r)  # (B,S,di) fp32
        A = -torch.exp(params.A_log.float())  # (di,N)
    xf, Bf, Cf = x_c.float(), B_ssm.float(), C_ssm.float()
    y = torch.empty((Bn, S, di), dtype=torch.float32, device=x_c.device)
    h_last = torch.empty((Bn, di, N), dtype=torch.float32, device=x_c.device)
    with _step("scan"):
        for c0 in range(0, di, chunk):
            c1 = min(di, c0 + chunk)
            args = (dt[..., c0:c1], xf[..., c0:c1], Bf, Cf, A[c0:c1])
            yc, hc = checkpoint(_scan_chunk, *args, use_reentrant=False) if grad else _scan_chunk(*args)
            y[..., c0:c1] = yc
            h_last[:, c0:c1] = hc
            del yc, hc
        y = y + params.Dp * xf
    return y.to(x_c.dtype), h_last


def apply_ssm(params: SSM, cfg: ArchConfig, x: torch.Tensor, return_state: bool = False):
    """Full-sequence forward. x (B,S,D) -> (B,S,D) [, {"h": (B,di,N) float32,
    "conv": (B,K-1,di)}].  The state needs S >= K - 1: the reference keeps a
    shorter conv tail for a shorter prompt, which its decode step cannot
    take (ROADMAP.md C.10)."""
    R, N, K = cfg.ssm_dt_rank, cfg.ssm_state, cfg.ssm_conv
    S = x.shape[1]
    if return_state and S < K - 1:
        raise ValueError(f"apply_ssm: a prompt of {S} tokens is shorter than the conv window's K - 1 = {K - 1}: "
                         "the decode state needs at least K - 1 tokens")
    dt = x.dtype
    with _step("in_proj"):
        xz = x @ params.in_proj.to(dt)
        x_in, z = xz.chunk(2, dim=-1)
    with _step("conv"):
        x_c = F.silu(causal_conv(x_in, params.conv_w.to(dt), params.conv_b.to(dt)))
    with _step("x_proj/dt"):
        xdb = x_c @ params.x_proj.to(dt)
        dt_r, B_ssm, C_ssm = xdb.split([R, N, N], dim=-1)
    y, h_last = _ssm_core(params, x_c, dt_r, B_ssm, C_ssm)
    with _step("out_proj"):
        out = (y * F.silu(z)) @ params.out_proj.to(dt)
    if return_state:
        return out, {"h": h_last, "conv": x_in[:, S - (K - 1):]}
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": torch.zeros((batch, di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
    }


def apply_ssm_step(params: SSM, cfg: ArchConfig, x, cache: Dict[str, torch.Tensor]):
    """Single decode step. x (B,1,D), cache {h (B,di,N), conv (B,K-1,di)} ->
    (y (B,1,D), cache).  Unlike the reference, which returns a new cache,
    the step writes h and the shifted conv window into the given tensors
    and returns the same dict."""
    R, N = cfg.ssm_dt_rank, cfg.ssm_state
    dt_ = x.dtype
    with _step("in_proj"):
        xz = x @ params.in_proj.to(dt_)
        x_in, z = xz.chunk(2, dim=-1)  # (B,1,di)
    with _step("conv"):
        window = torch.cat([cache["conv"], x_in], dim=1)  # (B,K,di)
        w = params.conv_w.to(dt_)
        x_c = F.silu((window * w[None]).sum(1, keepdim=True) + params.conv_b.to(dt_))
        cache["conv"].copy_(window[:, 1:])
    with _step("x_proj/dt"):
        xdb = x_c @ params.x_proj.to(dt_)
        dt_r, B_ssm, C_ssm = xdb.split([R, N, N], dim=-1)
        dtv = _dt(params, dt_r)[:, 0]  # (B,di)
    with _step("scan"):
        A = -torch.exp(params.A_log.float())
        dA = torch.exp(dtv[..., None] * A)  # (B,di,N)
        xc0 = x_c[:, 0].float()
        dBx = (dtv * xc0)[..., None] * B_ssm[:, 0].float()[:, None, :]
        h = cache["h"].mul_(dA).add_(dBx)
        y = (h * C_ssm[:, 0].float()[:, None, :]).sum(-1)
        y = (y + params.Dp * xc0).to(dt_)[:, None]
    with _step("out_proj"):
        out = (y * F.silu(z)) @ params.out_proj.to(dt_)
    return out, cache
