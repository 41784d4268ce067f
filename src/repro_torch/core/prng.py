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
``_uniform``, ``_randint``, ``_truncated_normal``; XLA's float32
``erf_inv``, ``log`` and ``exp``).  The legacy mode (flag ``False``) is not
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


def randint_from_bits(higher, lower, minval, maxval) -> torch.Tensor:
    """``randint``'s fold of two 32-bit draws into [minval, maxval), int32.

    The reference's ``rem(higher, span) * multiplier + rem(lower, span)``
    wraps mod 2**32, and so does the squared multiplier.  The bounds are
    ints, or integer tensors broadcastable to the draws (a batch whose
    configs draw over different ranges, as the reference's traced bounds).
    """
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        lo = torch.as_tensor(minval, device=higher.device).to(torch.int64)
        hi = torch.as_tensor(maxval, device=higher.device).to(torch.int64)
        span = torch.where(hi <= lo, 1, (hi - lo) & _M)
        multiplier = ((2**16 % span) ** 2 & _M) % span
    else:
        lo, hi = int(minval), int(maxval)
        if not (_INT32_MIN <= lo <= _INT32_MAX and _INT32_MIN <= hi <= _INT32_MAX):
            raise ValueError(f"randint: bounds [{lo}, {hi}) must lie in int32")
        span = 1 if hi <= lo else (hi - lo) & _M
        multiplier = ((2**16 % span) ** 2 & _M) % span
    offset = ((higher % span) * multiplier + lower % span) & _M
    offset = offset % span
    out = (offset + lo + 2**31) & _M  # int32 add that wraps, as the reference's
    return (out - 2**31).to(torch.int32)


def randint(keys, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32: keys (..., 2) -> (...,) + shape,
    from two 32-bit draws per value under ``split(key)``."""
    sub = split(keys, 2)
    return randint_from_bits(random_bits(sub[..., 0, :], shape), random_bits(sub[..., 1, :], shape), minval, maxval)


# XLA's CPU float32 math, step for step, for ``erf_inv``: every ``c + a*b`` that
# XLA's CPU backend contracts into one fused multiply-add is ``_fma`` here
# (the float64 product of two float32 values is exact; the float64 sum rounds
# where a true FMA would not only in rare double-rounding cases)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# Giles' single-precision erf_inv ("Approximating the erfinv function"): the
# coefficients of its two branches (w < 5 and w >= 5), highest order first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _f32(c) -> float:
    return float(np.float32(c))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once; tensors or Python floats."""
    a, b, c = (t.double() if torch.is_tensor(t) else _f32(t) for t in (a, b, c))
    return (a * b + c).float()


def log(z: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` for positive normal ``z``: Cephes' logf."""
    bits = z.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    y = _fma(_fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[2])
    y1 = _fma(_fma(x, _LOG_P[3], _LOG_P[4]), x, _LOG_P[5])
    y2 = _fma(_fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    y = _fma(_fma(_fma(y, x3, y1), x3, y2), x3, e * _f32(_LOG_Q1))
    x = _fma(-0.5, x2, x) + y
    return _fma(e, _LOG_Q2, x)


# XLA's CPU float32 exp (Cephes' expf): log2(e), ln 2 in two parts, the
# polynomial's coefficients, highest order first
_EXP_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``exp``, bitwise (checked on dense grids over
    [-87, 88]; ``torch.exp`` differs from it by an ulp on more than 1 % of
    [0, log 100352]):
    ``n = floor(x log2 e + 1/2)``, ``r = x - n ln 2`` in two fused steps,
    Cephes' polynomial in r, times 2**n.  Valid for x in [-87, 88], where
    2**n is a normal float32."""
    n = torch.floor(_fma(x, _EXP_LOG2E, 0.5))
    r = _fma(n, -_EXP_C1, x)
    r = _fma(n, -_EXP_C2, r)
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.maximum(y * two_n, x)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``: a Cephes rational for |x| < sqrt(2) - 1,
    ``log(1 + x)`` above."""
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num, den = _fma(num, x, cn), _fma(den, x, cd)
    x2 = x * x
    small = _fma(-0.5, x2, (x * x2) * (num / den)) + x
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` in float32 as XLA's CPU backend computes it: Giles'
    polynomial in ``w = -log1p(-x*x)``.

    ``torch.erfinv`` is another approximation (up to 64 ulp from XLA's), and
    ``torch.log1p`` differs from XLA's on 9 % of float32 inputs, so both
    are written out here in XLA's order of operations.
    """
    w = -_xla_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i]), _f32(_ERFINV_GE5[i]))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def _erf32(x) -> np.float32:
    """float32 ``erf`` of one float32 value, on the CPU (equals XLA's at the
    truncation points that ``dense_init`` uses)."""
    return np.float32(torch.erf(torch.tensor(x, dtype=torch.float32)).item())


def truncated_normal(key, lower: float, upper: float, shape: Sequence[int], *, chunk: int = 1 << 24) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)`` for
    one key (2,): the uniform on ``[erf(lower/sqrt2), erf(upper/sqrt2))``
    from the key's 32-bit draws, ``sqrt2 * erf_inv(u)``, then the clip to
    the open interval (``nextafter`` of each bound).  Bitwise JAX's on almost every
    element (``erf_inv``'s float64 multiply-adds round twice in rare cases).  The draws run ``chunk`` elements at a time, so a
    (100352, 2048) table needs no more than a few chunk-sized temporaries.
    """
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError(f"truncated_normal: {n} elements need 64-bit counts, which are not implemented")
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = _erf32(lo / sqrt2), _erf32(hi / sqrt2)
    clip_lo = float(np.nextafter(lo, np.float32(np.inf)))
    clip_hi = float(np.nextafter(hi, np.float32(-np.inf)))
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start in range(0, n, chunk):
        counts = torch.arange(start, min(n, start + chunk), dtype=torch.int64, device=key.device)
        y0, y1 = _hash_counts(key, counts)
        u = uniform_from_bits(y0 ^ y1, a, b)
        out[start : start + counts.numel()] = torch.clamp(erf_inv(u) * float(sqrt2), clip_lo, clip_hi)
    return out.reshape(shape)
