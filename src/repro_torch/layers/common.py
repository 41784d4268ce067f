"""Norms, activations and rotary embeddings (incl. partial rotary and
M-RoPE), port of ``repro.layers.common``.

A norm's parameters live in a :class:`Norm` module whose parameter names
are the reference's keys (``scale``, ``bias``).  A module built from
initialisers' :class:`~repro_torch.sharding.Param` s keeps each leaf's
logical spec in ``specs`` (``models/lm.param_specs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.sharding import P, Param, ones_init, zeros_init

NORMS = ("rmsnorm", "layernorm", "layernorm_nobias")
EPS = 1e-5


class ParamSet(nn.Module):
    """A layer's parameters, named as the reference's parameter dict: every
    name in ``NAMES`` is a parameter, or None where absent.  Parameters are
    built frozen, for serving; ``requires_grad_()`` turns them on.  Given
    :class:`Param` s (an initialiser's), ``specs`` maps each name to its
    logical spec."""

    NAMES: tuple = ()

    def __init__(self, tensors):
        super().__init__()
        unknown = set(tensors) - set(self.NAMES)
        if unknown:
            raise ValueError(f"{type(self).__name__}: unknown parameters {sorted(unknown)}")
        self.specs = {}
        for name in self.NAMES:
            setattr(self, name, frozen_parameter(self.specs, name, tensors.get(name)))


def frozen_parameter(specs, name, t):
    """A frozen ``nn.Parameter`` of ``t`` (a tensor, a :class:`Param` whose
    spec goes to ``specs[name]``, or None)."""
    if isinstance(t, Param):
        specs[name] = t.spec
        t = t.value
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Norm(nn.Module):
    """``scale`` (d,) and, for "layernorm", ``bias`` (d,)."""

    def __init__(self, kind: str, tensors):
        super().__init__()
        if kind not in NORMS:
            raise ValueError(kind)
        if ("bias" in tensors) != (kind == "layernorm"):
            raise ValueError(f"{kind} norm: parameters {sorted(tensors)}")
        self.kind = kind
        self.specs = {}
        self.scale = frozen_parameter(self.specs, "scale", tensors["scale"])
        self.bias = frozen_parameter(self.specs, "bias", tensors.get("bias"))


def init_norm(kind: str, d: int, dtype=torch.float32, device=None) -> Norm:
    p = {"scale": ones_init("scale", (d,), P("embed"), dtype, device)}
    if kind == "layernorm":
        p["bias"] = zeros_init("bias", (d,), P("embed"), dtype, device)
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


_ROPE_TABLES = {}


def rope_freqs(head_dim: int, rope_pct: float, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated slice of the head dim (float32,
    (rot/2,)): the reference's ``1 / theta ** (2i / rot)`` as its launchers
    run it, under ``jit``, which is ``jit_freqs(rot, theta)`` bit for bit
    (ROADMAP.md C.20, the ordinary rotary's case of C.14).  The eager
    table and torch's ``pow`` miss up to 24 of 64 bands by an ulp (qwen2.5's
    theta 1e6), which moved ``apply_rope`` up to 4.7e-4 from the jitted
    reference at positions up to 2079.  Made once per (rot, theta, device), outside
    inference mode, so that a training step may take it after a serve."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    key = (rot, float(theta), torch.device(device if device is not None else "cpu"))
    table = _ROPE_TABLES.get(key)
    if table is None:
        with torch.inference_mode(False):
            table = _ROPE_TABLES[key] = jit_freqs(rot, theta, key[2])
    return table


def rotate_halves(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., Dh) with its halves rotated against each other by the angles
    whose ``cos`` and ``sin`` (..., Dh/2) broadcast against them; in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_pct: float, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) int: rotate the first
    ``rope_pct`` of each head (halves rotated against each other), keep the
    rest."""
    Dh = x.shape[-1]
    inv = rope_freqs(Dh, rope_pct, theta, device=x.device)  # (rot/2,)
    rot = inv.shape[0] * 2
    ang = positions[..., None].float() * inv  # (..., S, rot/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]  # (..., S, 1, rot/2)
    return torch.cat([rotate_halves(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


def jit_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    """(d/2,) float32 ``1 / theta ** (2i / d)`` as the reference computes it
    under ``jit``, where XLA rewrites ``1 / pow(b, e)`` into ``pow(b, -e)``
    (ROADMAP.md C.14, C.20; eagerly, its ``1 /`` moves a third of the bands by an
    ulp, 25 of 64 at qwen2-vl's theta 1e6 and Dh 128): glibc's ``powf``
    (``prng.powf``), XLA's CPU ``pow``.  ``torch.pow`` misses bands too, and
    one ulp of a band's frequency moves its angle at position p by p ulps
    of the band: about 1e-4 rad at p = 2048 for a band near 1."""
    return prng.powf(theta, -(torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))


def mrope_rotation(positions: torch.Tensor, sections, theta: float, head_dim: int):
    """M-RoPE's (cos, sin), each (..., S, 1, Dh/2) float32, of positions
    (..., 3, S) int, the (temporal, height, width) ids of each token: the
    Dh/2 frequency bands (``jit_freqs``) split into ``sections`` (t, h, w)
    consecutive runs, each band rotated by its section's id times its
    frequency, as the reference's ``apply_mrope`` computes them (its
    ``take_along_axis`` on a band -> section table is a concatenation of
    the three ids here).  The angles' ``cos`` and ``sin`` are torch's:
    glibc's (``prng.cosf``/``sinf``), which XLA's CPU calls, took the port
    no closer to the reference (qwen2-vl at full width, 2 layers, the
    golden request: 1.41e-5 with torch's, 1.38e-5 with glibc's, over the
    golden file's top-8 logits, max and lse; 2.6e-6 with either at the
    reduced config), since the rotation's own rounding and the products
    decide the gap, and cost some hundred device operations a call."""
    if sum(sections) * 2 != head_dim:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not split head_dim {head_dim} / 2 bands")
    p = positions.float()
    band_pos = torch.cat([p[..., i, :, None].expand(*p.shape[:-2], p.shape[-1], n)
                          for i, n in enumerate(sections)], dim=-1)  # (..., S, Dh/2)
    ang = band_pos * jit_freqs(head_dim, theta, positions.device)
    return ang.cos()[..., None, :], ang.sin()[..., None, :]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections, theta: float) -> torch.Tensor:
    """Qwen2-VL's multimodal rotary: x (..., S, H, Dh) with positions
    (..., 3, S) int, the whole head rotated (no ``rope_pct``), halves
    against each other (``mrope_rotation``)."""
    return rotate_halves(x, *mrope_rotation(positions, sections, theta, x.shape[-1]))


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) ``[sin(p f), cos(p f)]`` of float32 positions (...) at the
    reference's frequencies under ``jit`` (``jit_freqs`` of 10000), with
    XLA's CPU ``sin`` and ``cos`` (glibc's, ``prng.sinf``/``cosf``)."""
    ang = positions[..., None] * jit_freqs(d, 10_000.0, positions.device)
    return torch.cat([prng.sinf(ang), prng.cosf(ang)], dim=-1)


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n_pos, d), float32: the
    reference's table under ``jit``, bit for bit."""
    return sinusoid_at(torch.arange(n_pos, dtype=torch.float32, device=device), d)
