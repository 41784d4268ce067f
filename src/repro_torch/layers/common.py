"""Norms, activations and rotary embeddings (incl. partial rotary), port of
``repro.layers.common``.

A norm's parameters live in a :class:`Norm` module whose parameter names
are the reference's keys (``scale``, ``bias``).  ``apply_mrope`` waits
for qwen2-vl (ROADMAP.md A.12.7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.sharding import ones_init, zeros_init

NORMS = ("rmsnorm", "layernorm", "layernorm_nobias")
EPS = 1e-5


class ParamSet(nn.Module):
    """A layer's parameters, named as the reference's parameter dict: every
    name in ``NAMES`` is a parameter, or None where absent.  Parameters are
    built frozen, for serving; ``requires_grad_()`` turns them on."""

    NAMES: tuple = ()

    def __init__(self, tensors):
        super().__init__()
        unknown = set(tensors) - set(self.NAMES)
        if unknown:
            raise ValueError(f"{type(self).__name__}: unknown parameters {sorted(unknown)}")
        for name in self.NAMES:
            t = tensors.get(name)
            setattr(self, name, None if t is None else nn.Parameter(t, requires_grad=False))


class Norm(nn.Module):
    """``scale`` (d,) and, for "layernorm", ``bias`` (d,)."""

    def __init__(self, kind: str, tensors):
        super().__init__()
        if kind not in NORMS:
            raise ValueError(kind)
        if ("bias" in tensors) != (kind == "layernorm"):
            raise ValueError(f"{kind} norm: parameters {sorted(tensors)}")
        self.kind = kind
        self.scale = nn.Parameter(tensors["scale"], requires_grad=False)
        self.bias = nn.Parameter(tensors["bias"], requires_grad=False) if "bias" in tensors else None


def init_norm(kind: str, d: int, dtype=torch.float32, device=None) -> Norm:
    p = {"scale": ones_init("scale", (d,), dtype, device)}
    if kind == "layernorm":
        p["bias"] = zeros_init("bias", (d,), dtype, device)
    return Norm(kind, p)


def apply_norm(kind: str, params: Norm, x: torch.Tensor) -> torch.Tensor:
    """Statistics in float32, the result in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS)
        return (x * params.scale.float()).to(dt)
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + EPS)
    x = x * params.scale.float()
    if params.bias is not None:
        x = x + params.bias.float()
    return x.to(dt)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "sq_relu":  # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def rope_freqs(head_dim: int, rope_pct: float, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated slice of the head dim (float32)."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_pct: float, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) int: rotate the first
    ``rope_pct`` of each head (halves rotated against each other), keep the
    rest."""
    Dh = x.shape[-1]
    inv = rope_freqs(Dh, rope_pct, theta, device=x.device)  # (rot/2,)
    rot = inv.shape[0] * 2
    ang = positions[..., None].float() * inv  # (..., S, rot/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]  # (..., S, 1, rot/2)
    x1, x2, xp = x[..., : rot // 2], x[..., rot // 2 : rot], x[..., rot:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def sinusoid_freqs(d: int, device=None) -> torch.Tensor:
    """(d/2,) float32 ``1 / 10000 ** (2i / d)`` as the reference computes it
    under ``jit``, where XLA rewrites ``1 / pow(b, e)`` into ``pow(b, -e)``
    (eagerly, its ``1 /`` moves a third of the bands by an ulp): glibc's
    ``powf`` (``prng.powf``), XLA's CPU ``pow``.  ``torch.pow`` misses a
    band, and one ulp of a band's frequency moves its angle at position 1499
    by about 1e-4."""
    return prng.powf(10_000.0, -(torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) ``[sin(p f), cos(p f)]`` of float32 positions (...), with
    XLA's CPU ``sin`` and ``cos`` (glibc's, ``prng.sinf``/``cosf``)."""
    ang = positions[..., None] * sinusoid_freqs(d, positions.device)
    return torch.cat([prng.sinf(ang), prng.cosf(ang)], dim=-1)


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n_pos, d), float32: the
    reference's table under ``jit``, bit for bit."""
    return sinusoid_at(torch.arange(n_pos, dtype=torch.float32, device=device), d)
