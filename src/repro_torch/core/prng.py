"""Bit-exact copy of ``jax.random``'s threefry2x32 generator, as the engine
and the workloads use it.

The JAX engine draws every transaction from
``fold_in(fold_in(PRNGKey(seed), lsid), txn_no)`` and the workloads then
call ``split``, ``randint`` and ``uniform``.  A simulated commit history
only matches the reference if every one of those bits does, so this module
follows jax 0.9.0's sources in its default ``jax_threefry_partitionable``
mode (``jax/_src/prng.py``: ``threefry2x32`` lowering, ``threefry_seed``,
``iota_2x32_shape``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_uniform``, ``_randint``).  The legacy mode (flag ``False``) is not
implemented.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; every
function is vectorised over the leading batch dimensions.  torch has no
full uint32 arithmetic, so words live in int64 and every sum, product and
shift is masked back to 32 bits (an int64 product that wraps keeps its low
32 bits exact).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _rotl(v, r: int):
    return ((v << r) & _M) | (v >> (32 - r))


def threefry2x32(k1, k2, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds), elementwise over the
    broadcast of its four int64 uint32-valued arguments."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & _M
    x1 = (x1 + k2) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def _hash_counts(keys, counts):
    """threefry2x32 of each key in ``keys`` (..., 2) at the uint64 counts
    ``counts`` (whose high words are zero), broadcast over ``counts``'
    trailing dims; returns both output words, shaped ``(...,) + counts.shape``."""
    extra = (1,) * counts.dim()
    k1 = keys[..., 0].reshape(keys.shape[:-1] + extra)
    k2 = keys[..., 1].reshape(keys.shape[:-1] + extra)
    return threefry2x32(k1, k2, 0, counts)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: words (0, seed mod 2**32)."""
    seed = int(seed)
    if not _INT32_MIN <= seed <= _INT32_MAX:
        raise ValueError(f"prng_key: seed {seed} is outside int32 (the engine's seed knob type)")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def fold_in(keys, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2), data int (...) -> (..., 2).

    The reference hashes the count pair ``threefry_seed(data) = (0, data)``,
    which is the foldlike ``split`` at count ``data``.
    """
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def split(keys, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2)."""
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = _hash_counts(keys, counts)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: keys (..., 2) -> (...,) + shape, uint32
    values in int64 (``bits1 ^ bits2`` of the partitionable scheme)."""
    shape = tuple(shape)
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device).reshape(shape)
    y0, y1 = _hash_counts(keys, counts)
    return y0 ^ y1


def uniform_from_bits(bits, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``uniform``'s float32 map of 32 random bits onto [minval, maxval)."""
    one_mant = (bits >> 9) | 0x3F800000  # exponent of 1.0, 23 random mantissa bits
    floats = one_mant.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses ``floats * (maxval - minval) + minval`` into one multiply-add
    # (one rounding).  The float64 product of two float32 values is exact, and
    # so is its sum with minval unless the two differ in scale by more than
    # 2**29; rounding that sum to float32 once then gives XLA's value.  The
    # engine's [0, 1) draws scale by 1 and add 0, which is exact either way.
    scaled = (floats.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp(scaled, min=float(lo))


def uniform(keys, shape: Sequence[int] = (), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: keys (..., 2) -> (...,) + shape."""
    return uniform_from_bits(random_bits(keys, shape), minval, maxval)


def randint_from_bits(higher, lower, minval: int, maxval: int) -> torch.Tensor:
    """``randint``'s fold of two 32-bit draws into [minval, maxval), int32.

    The reference's ``rem(higher, span) * multiplier + rem(lower, span)``
    wraps mod 2**32, and so does the squared multiplier.
    """
    minval, maxval = int(minval), int(maxval)
    if not (_INT32_MIN <= minval <= _INT32_MAX and _INT32_MIN <= maxval <= _INT32_MAX):
        raise ValueError(f"randint: bounds [{minval}, {maxval}) must lie in int32")
    span = 1 if maxval <= minval else (maxval - minval) & _M
    multiplier = ((2**16 % span) ** 2 & _M) % span
    offset = ((higher % span) * multiplier + lower % span) & _M
    offset = offset % span
    out = (offset + minval + 2**31) & _M  # int32 add that wraps, as the reference's
    return (out - 2**31).to(torch.int32)


def randint(keys, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32: keys (..., 2) -> (...,) + shape,
    from two 32-bit draws per value under ``split(key)``."""
    sub = split(keys, 2)
    return randint_from_bits(random_bits(sub[..., 0, :], shape), random_bits(sub[..., 1, :], shape), minval, maxval)
