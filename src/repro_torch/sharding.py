"""Per-name parameter keys and initialisers (port of the part of
``repro.sharding`` that builds parameters).

The reference derives every parameter's key from its name
(``fold_in(key, crc32(name))``) and draws it with
``jax.random.truncated_normal``; the port does the same through its own
threefry (``core.prng``), so a seed gives the reference's weights.  The
logical-axis rules and the ``Param`` spec plumbing wait for multi-GPU
layouts (ROADMAP.md A.12): here an initialiser returns a plain tensor.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.core import prng


def name_key(key: torch.Tensor, name: str) -> torch.Tensor:
    return prng.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def dense_init(key, name, shape, dtype=torch.float32, scale=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (1/sqrt(fan_in) unless
    given), drawn in float32 on the key's device and cast to ``dtype``."""
    if scale is None:
        scale = 1.0 / np.sqrt(max(shape[0], 1))
    v = prng.truncated_normal(name_key(key, name), -2.0, 2.0, shape)
    return (v * float(np.float32(scale))).to(dtype)  # the reference multiplies in float32


def zeros_init(name, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(name, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)
