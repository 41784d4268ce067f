"""RG-LRU recurrent block (recurrentgemma / Griffin), port of
``repro.layers.rglru``.

Two branches from x, (linear -> causal conv -> RG-LRU) gated by (linear ->
GeLU), merged multiplicatively, then the output projection.  The gates are
per channel; the recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) *
(i_t * x_t)`` runs as the reference's associative scan over time
(``layers.scan``) on (B, S, rnn_width) float32 tensors, 84 MB each at
recurrentgemma's B = 4 x 2048 tokens.  Decode carries h (B, rnn_width)
float32 and the conv window's last K - 1 inputs (B, K - 1, rnn_width).
Plain PyTorch on both kernel planes: the reference runs this layer through
XLA, with no Pallas kernel.  ``Record`` splits a call's device time by step
in a profiler trace.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.layers import ssm
from repro_torch.layers.common import ParamSet
from repro_torch.layers.scan import associative_scan
from repro_torch.sharding import P, Param, dense_init, name_key, zeros_init

_C = 8.0  # Griffin's fixed recurrence sharpness constant


class RGLRU(ParamSet):
    """``w_in``, ``w_gate`` (D, W), ``conv_w`` (K, W), ``conv_b`` (W,), the
    diagonal gates ``wa``, ``ba``, ``wx``, ``bx`` (W,) float32, ``lam`` (W,)
    float32 and ``w_out`` (W, D), W = ``cfg.rnn_width``."""

    NAMES = ("w_in", "w_gate", "conv_w", "conv_b", "wa", "ba", "wx", "bx", "lam", "w_out")


class Record(ssm.Record):
    """While open (``with Record():``), every RG-LRU call marks its steps as
    profiler ranges ``rglru:<step>`` (``in/gate proj``, ``conv``,
    ``gates``, ``scan``, ``out_proj``), which split its device time in a
    trace."""

    current = None


def _step(name):
    """A profiler range around one step of the RG-LRU while a Record is open."""
    return record_function(f"rglru:{name}") if Record.current is not None else contextlib.nullcontext()


def init_rglru(key, cfg: ArchConfig, dtype=torch.float32) -> RGLRU:
    """The reference's draws.  ``lam`` = log(p / (1 - p)), p = u ** (1/8),
    u uniform on [0.9, 0.999), so that a = sigmoid(lam) ** 8 lies in about
    [0.9, 0.999]: evaluated op by op in float32 as the reference's eager
    ``init_rglru`` does, with XLA's CPU ``pow`` and ``log`` (``prng``)."""
    D, W, K = cfg.d_model, cfg.rnn_width, cfg.ssm_conv
    dev = key.device
    if dev.type == "meta":  # a spec walk: no draw
        lam = torch.empty((W,), device=dev)
    else:
        p = prng.powf(prng.uniform(name_key(key, "lam"), (W,), 0.9, 0.999), 1.0 / _C)
        lam = prng.log(p / (1.0 - p))
    return RGLRU({
        "w_in": dense_init(key, "w_in", (D, W), P("embed", "rnn"), dtype),
        "w_gate": dense_init(key, "w_gate", (D, W), P("embed", "rnn"), dtype),
        "conv_w": dense_init(key, "conv_w", (K, W), P(None, "rnn"), dtype, scale=0.5),
        "conv_b": zeros_init("conv_b", (W,), P("rnn"), dtype, dev),
        "wa": zeros_init("wa", (W,), P("rnn"), torch.float32, dev),
        "ba": zeros_init("ba", (W,), P("rnn"), torch.float32, dev),
        "wx": zeros_init("wx", (W,), P("rnn"), torch.float32, dev),
        "bx": zeros_init("bx", (W,), P("rnn"), torch.float32, dev),
        "lam": Param(lam, P("rnn")),
        "w_out": dense_init(key, "w_out", (W, D), P("rnn", "embed"), dtype),
    })


def _gates(params: RGLRU, xc32):
    """xc32 (..., W) float32 -> (a, the gated input b) of the recurrence."""
    r = torch.sigmoid(xc32 * params.wa + params.ba)
    i = torch.sigmoid(xc32 * params.wx + params.bx)
    a = torch.exp(-_C * ssm.softplus(params.lam) * r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xc32)
    return a, b


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


def _branches(params: RGLRU, x):
    """x (B,S,D) -> (the recurrence's input, the GeLU gate), each (B,S,W)."""
    dt = x.dtype
    with _step("in/gate proj"):
        xi = x @ params.w_in.to(dt)
        gate = F.gelu(x @ params.w_gate.to(dt), approximate="tanh")
    return xi, gate


def _out(params: RGLRU, h, gate):
    with _step("out_proj"):
        return (h.to(gate.dtype) * gate) @ params.w_out.to(gate.dtype)


def apply_rglru(params: RGLRU, cfg: ArchConfig, x: torch.Tensor, return_state: bool = False):
    """Full-sequence forward. x (B,S,D) -> (B,S,D) [, {"h": (B,W) float32,
    "conv": (B,K-1,W)}].  The state needs S >= K - 1: the reference keeps a
    shorter conv tail for a shorter prompt, which its decode step cannot
    take (ROADMAP.md C.10)."""
    K, S = cfg.ssm_conv, x.shape[1]
    if return_state and S < K - 1:
        raise ValueError(f"apply_rglru: a prompt of {S} tokens is shorter than the conv window's K - 1 = {K - 1}: "
                         "the decode state needs at least K - 1 tokens")
    xi, gate = _branches(params, x)
    with _step("conv"):
        xc = ssm.causal_conv(xi, params.conv_w.to(x.dtype), params.conv_b.to(x.dtype))
    with _step("gates"):
        a, b = _gates(params, xc.float())
    with _step("scan"):
        _, h = associative_scan(_combine, (a, b), dim=1)
    out = _out(params, h, gate)
    if return_state:
        return out, {"h": h[:, -1], "conv": xi[:, S - (K - 1):]}
    return out


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    W, K = cfg.rnn_width, cfg.ssm_conv
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, W), dtype=dtype, device=device),
    }


def apply_rglru_step(params: RGLRU, cfg: ArchConfig, x, cache: Dict[str, torch.Tensor]):
    """Single decode step. x (B,1,D), cache {h (B,W), conv (B,K-1,W)} ->
    (y (B,1,D), cache).  Unlike the reference, which returns a new cache,
    the step writes h and the shifted conv window into the given tensors
    and returns the same dict."""
    dt = x.dtype
    xi, gate = _branches(params, x)
    with _step("conv"):
        window = torch.cat([cache["conv"], xi], dim=1)  # (B,K,W)
        xc = (window * params.conv_w.to(dt)[None]).sum(1) + params.conv_b.to(dt)  # (B,W)
        cache["conv"].copy_(window[:, 1:])
    with _step("gates"):
        a, b = _gates(params, xc.float())
    with _step("scan"):
        h = cache["h"].mul_(a).add_(b)
    return _out(params, h[:, None], gate), cache
