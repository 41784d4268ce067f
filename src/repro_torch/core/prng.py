"""Bit-exact copy of ``jax.random``'s threefry2x32 generator, as the engine
and the workloads use it.

The JAX engine draws every transaction from
``fold_in(fold_in(PRNGKey(seed), lsid), txn_no)`` and the workloads then
call ``split``, ``randint`` and ``uniform``.  A simulated commit history
only matches the reference if every one of those bits does, so this module
follows jax 0.9.0's sources (``jax/_src/prng.py``: ``threefry2x32``
lowering, ``threefry_seed``, ``iota_2x32_shape``, ``_threefry_fold_in``;
``jax/_src/random.py``: ``_uniform``, ``_randint``, ``_truncated_normal``,
``_normal_real``; XLA's float32 ``erf_inv``, ``log``, ``exp``, ``pow``,
``sin`` and ``cos``) in both modes of its ``jax_threefry_partitionable``
flag:

* partitionable (``True``, jax's default): ``_threefry_split_foldlike`` and
  ``_threefry_random_bits_partitionable`` hash the 64-bit count of element
  i as the pair ``(i >> 32, i & 0xffffffff)`` (``iota_2x32_shape``) and
  take ``y0 ^ y1`` (``split`` takes both words);
* legacy (``False``, inside ``with threefry_partitionable(False):``):
  ``_threefry_split_original`` and ``_threefry_random_bits_original``
  hash ``iota(n)`` through ``threefry_2x32``, which pads an odd n with one
  0, pairs the first half of the counts with the second and returns
  ``concat(y0, y1)[:n]``: element i < h = ceil(n/2) is ``y0`` at
  ``(i, i + h)``, element i >= h is ``y1`` at ``(i - h, i)``.  So a
  shape-() draw is not the first element of a shape-(2,) draw there.
  ``iota`` is uint32, so a draw of n >= 2**32 - 1 elements runs in blocks:
  ``nb, rem = divmod(n, 2**32 - 1)``, block b < nb is the draw of 2**32 - 1
  elements under ``split(key, nb + 1)[b]`` and the last ``rem`` elements
  are the draw of ``rem`` under ``split(key, nb + 1)[nb]``.

``prng_key`` and ``fold_in`` are the same in both modes.  The
transaction stage-graph counters in ``tests/data/stage_graph_golden.json``
were taken in the legacy mode.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; every
function is vectorised over the leading batch dimensions.  torch has no
full uint32 arithmetic, so words live in int64 and every sum, product and
shift is masked back to 32 bits (an int64 product that wraps keeps its low
32 bits exact).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
# jax's ``jax_threefry_partitionable`` flag, per thread and context as jax's
# own context manager sets it
_PARTITIONABLE = contextvars.ContextVar("threefry_partitionable", default=True)


def partitionable() -> bool:
    """The active mode: True (jax's default) or False (legacy)."""
    return _PARTITIONABLE.get()


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """``with threefry_partitionable(False):`` draws in jax's legacy mode
    inside the block, as ``with jax.threefry_partitionable(False):`` does;
    the mode before it comes back on exit."""
    token = _PARTITIONABLE.set(bool(flag))
    try:
        yield
    finally:
        _PARTITIONABLE.reset(token)


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


# jax's legacy draw hashes ``iota(n)`` in uint32: from this many elements on it runs in blocks of this size
_LEGACY_BLOCK = 2**32 - 1


def _hash_counts(keys, counts, top: int):
    """threefry2x32 of each key in ``keys`` (..., 2) at the 64-bit counts
    ``counts`` (int64, each below ``top``) as the pair (high word, low
    word), broadcast over ``counts``' trailing dims; returns both output
    words, shaped ``(...,) + counts.shape``.  While ``top`` <= 2**32 every
    high word is 0 and the counts are the low words as they are."""
    extra = (1,) * counts.dim()
    k1 = keys[..., 0].reshape(keys.shape[:-1] + extra)
    k2 = keys[..., 1].reshape(keys.shape[:-1] + extra)
    if top <= 2**32:
        return threefry2x32(k1, k2, 0, counts)
    return threefry2x32(k1, k2, counts >> 32, counts & _M)


def _legacy_blocks(n: int, device, start: int = 0, stop: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``threefry_2x32``'s count pairs for ``iota(n)`` (blocks ``start`` to
    ``stop``, default all ceil(n/2)): the first ceil(n/2) counts against the
    rest, the last of an odd n paired with a padded 0."""
    h = (n + 1) // 2
    x0 = torch.arange(start, h if stop is None else stop, dtype=torch.int64, device=device)
    x1 = x0 + h
    return x0, torch.where(x1 < n, x1, 0)


def _legacy_block(keys, n: int) -> torch.Tensor:
    """``threefry_2x32(key, iota(n))`` for keys (..., 2) -> (..., n): both
    words of ceil(n/2) blocks, ``concat(y0, y1)[:n]``."""
    x0, x1 = _legacy_blocks(n, keys.device)
    extra = (1,) * x0.dim()
    y0, y1 = threefry2x32(keys[..., 0].reshape(keys.shape[:-1] + extra),
                          keys[..., 1].reshape(keys.shape[:-1] + extra), x0, x1)
    return torch.cat([y0, y1], dim=-1)[..., :n]


def _legacy_split(keys, num: int) -> torch.Tensor:
    """``_threefry_split_original``: keys (..., 2) -> (..., num, 2), one
    ``threefry_2x32`` of ``iota(2 num)``."""
    return _legacy_block(keys, 2 * num).reshape(keys.shape[:-1] + (num, 2))


def _legacy_bits(keys, n: int) -> torch.Tensor:
    """``_threefry_random_bits_original`` of n 32-bit draws for keys (..., 2)
    -> (..., n): one block below 2**32 - 1 elements, else blocks of 2**32 - 1
    under ``split(key, nb + 1)`` and the remainder under its last key."""
    if n < _LEGACY_BLOCK:
        return _legacy_block(keys, n)
    nb, rem = divmod(n, _LEGACY_BLOCK)
    sub = _legacy_split(keys, nb + 1)
    parts = [_legacy_block(sub[..., b, :], _LEGACY_BLOCK) for b in range(nb)]
    return torch.cat(parts + [_legacy_block(sub[..., nb, :], rem)], dim=-1)


def _legacy_spans(key, n: int, start: int, stop: int):
    """The legacy blocks of one key's draw of n elements that elements
    [start, stop) fall in: (first flat element of the block, its size m,
    its key (2,))."""
    if n < _LEGACY_BLOCK:
        yield 0, n, key
        return
    nb, rem = divmod(n, _LEGACY_BLOCK)
    first, last = start // _LEGACY_BLOCK, min((stop - 1) // _LEGACY_BLOCK, nb)
    sub = _legacy_split(key, nb + 1)
    for b in range(first, last + 1):
        yield b * _LEGACY_BLOCK, (_LEGACY_BLOCK if b < nb else rem), sub[b]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: words (0, seed mod
    2**32), in either mode."""
    seed = int(seed)
    if not _INT32_MIN <= seed <= _INT32_MAX:
        raise ValueError(f"prng_key: seed {seed} is outside int32 (the engine's seed knob type)")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def fold_in(keys, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2), data int (...) -> (..., 2).

    The reference hashes the count pair ``threefry_seed(data) = (0, data)``
    through ``threefry_2x32`` in either mode, which is the foldlike
    ``split`` at count ``data``: the engine's slot keys and CALVIN's epoch
    keys are the same in both modes.
    """
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def split(keys, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2); in the legacy
    mode ``threefry_2x32(key, iota(2 num))`` in rows of two words."""
    if not partitionable():
        return _legacy_split(keys, num)
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = _hash_counts(keys, counts, num)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: keys (..., 2) -> (...,) + shape, uint32
    values in int64 (``bits1 ^ bits2`` of the partitionable mode,
    ``threefry_2x32(key, iota(n))`` of the legacy one)."""
    shape = tuple(shape)
    if not partitionable():
        return _legacy_bits(keys, math.prod(shape)).reshape(keys.shape[:-1] + shape)
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    y0, y1 = _hash_counts(keys, counts, n)
    return y0 ^ y1


@functools.lru_cache(maxsize=None)
def _legacy_rows(shapes: Tuple[Tuple[int, ...], ...], device: str):
    """``draw_counts``' legacy counts and picks, built once per pass layout and device."""
    half = (_LEGACY_BLOCK + 1) // 2  # the count pairs of one whole block
    sizes = [math.prod(sh) for sh in shapes]
    n = torch.tensor(sizes, dtype=torch.int64)[:, None]
    nb = n // _LEGACY_BLOCK
    # the pairs of block b < nb at columns [b half, (b + 1) half), the last block's after them
    width = max(max(s // _LEGACY_BLOCK * half + (s % _LEGACY_BLOCK + 1) // 2 for s in sizes), 1)
    col = torch.arange(width, dtype=torch.int64)[None, :]
    b = torch.minimum(col // half, nb)
    m = torch.where(b < nb, _LEGACY_BLOCK, n % _LEGACY_BLOCK)  # the block's size
    c0 = col - b * half
    c1 = c0 + (m + 1) // 2
    c1 = torch.where(c1 < m, c1, 0)
    i = torch.arange(max(sizes), dtype=torch.int64)[None, :]
    bi = i // _LEGACY_BLOCK
    r = i - bi * _LEGACY_BLOCK
    h = (torch.where(bi < nb, _LEGACY_BLOCK, n % _LEGACY_BLOCK) + 1) // 2
    pick = torch.where(r < h, bi * half + r, width + bi * half + r - h)
    pick = torch.where(i < n, pick, 0)
    return c0.to(device), c1.to(device), pick.to(device)


def draw_counts(shapes: Sequence[Sequence[int]], device=None) -> Tuple[object, torch.Tensor, Optional[torch.Tensor]]:
    """The counts one threefry pass hashes when row j of its keys draws
    ``shapes[j]``, in the active mode: ``(c0, c1, pick)``, each row's
    count pairs ``(c0, c1)`` (broadcast to (R, B)) and how its output words
    make the draws (L = the largest size).

    Partitionable: c0 = i >> 32 (0 while L <= 2**32) and c1 = i & 0xffffffff
    for i in arange(L), the same for every row, pick None: element i is
    ``y0 ^ y1`` at count i, so a smaller draw is the head of a larger one.
    Legacy: row j hashes its ceil(n_j/2) blocks at ``(b, b + h_j)``, a count
    past n_j - 1 padded to 0, and element i is ``concat(y0, y1)[pick[j,
    i]]``: y0 of block i below h_j, y1 of block i - h_j above (pick (R, L);
    elements past n_j pick 0).  A row of n_j >= 2**32 - 1 elements lays out
    its legacy blocks one after another, 2**31 columns each: the columns of
    block b hash under ``split(key, n_j // (2**32 - 1) + 1)[b]`` (``row_bits``
    gives them those keys).
    """
    shapes = tuple(tuple(int(d) for d in sh) for sh in shapes)
    if partitionable():
        top = max(math.prod(sh) for sh in shapes)
        i = torch.arange(top, dtype=torch.int64, device=device)
        return (0, i, None) if top <= 2**32 else (i >> 32, i & _M, None)
    return _legacy_rows(shapes, str(torch.device(device or "cpu")))


def _block_keys(keys, shapes, width: int) -> torch.Tensor:
    """Legacy: the key of each count column of ``draw_counts`` for keys
    (..., R, 2): (..., R, width, 2), row j's own key unless its draw runs in
    blocks, then the split key of each column's block."""
    half = (_LEGACY_BLOCK + 1) // 2
    col = torch.arange(width, device=keys.device) // half
    rows = []
    for j, sh in enumerate(shapes):
        nb = math.prod(sh) // _LEGACY_BLOCK
        k = keys[..., j, :]
        if nb == 0:
            rows.append(k[..., None, :].expand(k.shape[:-1] + (width, 2)))
        else:
            rows.append(_legacy_split(k, nb + 1)[..., col.clamp(max=nb), :])
    return torch.stack(rows, dim=-3)


def row_bits(keys, shapes: Sequence[Sequence[int]]) -> torch.Tensor:
    """One threefry pass for a batch of draws: keys (..., R, 2), row j
    drawing ``random_bits(keys[..., j, :], shapes[j])`` -> (..., R, L), L
    the largest size; row j's first prod(shapes[j]) elements are its draw,
    flattened, and the rest are not defined.  In the partitionable mode
    this is ``random_bits(keys, (L,))``, op for op."""
    c0, c1, pick = draw_counts(shapes, keys.device)
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    if pick is not None and max(math.prod(sh) for sh in shapes) >= _LEGACY_BLOCK:
        k = _block_keys(keys, shapes, c1.shape[-1])
        k1, k2 = k[..., 0], k[..., 1]
    y0, y1 = threefry2x32(k1, k2, c0, c1)
    if pick is None:
        return y0 ^ y1
    words = torch.cat([y0, y1], dim=-1)
    return words.gather(-1, pick.expand(words.shape[:-1] + pick.shape[-1:]))


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


# XLA's CPU float32 ``pow`` calls the C library's ``powf``; glibc's (2.28 on,
# from Arm's optimized-routines) is log2 from a 16-entry table of (1/c, log2 c)
# and a degree-5 polynomial, then exp2 from a 32-entry table of 2**(i/32)
# (its bits less i << 47) and a cubic, all in float64, rounded to float32 once
_POWF_LOG2_TAB = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"), ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010bp+0", "-0x1.7418b0a1fb77bp-2"), ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"), ("0x1.25e227b0b8eap+0", "-0x1.97c1d1b3b7afp-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"), ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"), ("0x1p+0", "0x0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"), ("0x1.ca4b31f026aap-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"), ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"), ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POWF_LOG2_POLY = tuple(float.fromhex(c) for c in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
    "0x1.71547652ab82bp+0"))
_EXP2F_TAB = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F, 0x3FEF9301D0125B51, 0x3FEF72B83C7D517B,
    0x3FEF54873168B9AA, 0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1, 0x3FEF06FE0A31B715, 0x3FEEF1A7373AA9CB,
    0x3FEEDEA64C123422, 0x3FEECE086061892D, 0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429,
    0x3FEEA47EB03A5585, 0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74, 0x3FEEA11473EB0187, 0x3FEEA589994CCE13,
    0x3FEEACE5422AA0DB, 0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D, 0x3FEEE89F995AD3AD,
    0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C, 0x3FEF3720DCEF9069, 0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F,
    0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
_EXP2F_POLY = tuple(float.fromhex(c) for c in ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")  # 0x1.8p52 / 32: adding it rounds to a multiple of 1/32
_EXP2F_SHIFT_BITS = int(np.float64(_EXP2F_SHIFT).view(np.int64))


def powf(x, y) -> torch.Tensor:
    """XLA's CPU float32 ``x ** y`` for positive normal float32 ``x`` and a
    float32 exponent ``y`` whose ``y * log2(x)`` stays within (-126, 126):
    glibc's ``powf``, step for step.  Either argument may be a Python float
    (rounded to float32) and the other a float32 tensor; they broadcast.  A
    float64 ``pow`` rounded to float32 differs from it (its error reaches
    0.82 ulp) on 3 of recurrentgemma's 2560 RG-LRU ``lam`` draws."""
    dev = (x if torch.is_tensor(x) else y).device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yd = y.double() if torch.is_tensor(y) else float(np.float32(y))
    ix = x.contiguous().view(torch.int32).to(torch.int64)
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    e = torch.where(top >= 2**31, top - 2**32, top) >> 23  # (int32_t) top >> 23: x = z 2**e, z in [0.7, 1.4)
    tab = torch.tensor(_POWF_LOG2_TAB, dtype=torch.float64, device=dev)
    invc, logc = tab[i, 0], tab[i, 1]
    z = ((ix - top) & _M).to(torch.int32).view(torch.float32).double()
    A = _POWF_LOG2_POLY
    r = z * invc - 1.0
    y0 = logc + e.double()
    r2 = r * r
    p = A[0] * r + A[1]
    q = A[2] * r + A[3]
    r4 = r2 * r2
    q = q * r2 + (A[4] * r + y0)
    xd = (p * r4 + q) * yd
    # exp2(xd) = 2**(k/32) * 2**r, r in [-1/64, 1/64]
    kd = xd + _EXP2F_SHIFT
    r = xd - (kd - _EXP2F_SHIFT)
    k = kd.view(torch.int64) - _EXP2F_SHIFT_BITS  # round(32 xd), in the low bits of kd
    s = (torch.tensor(_EXP2F_TAB, dtype=torch.int64, device=dev)[k & 31] + k * 2**47).view(torch.float64)
    C = _EXP2F_POLY
    return (((C[0] * r + C[1]) * (r * r) + (C[2] * r + 1.0)) * s).float()


# XLA's CPU float32 ``sin`` and ``cos`` call the C library's ``sinf`` and
# ``cosf``; glibc's (2.28 on, from Arm's optimized-routines) work in float64:
# the signs of the quadrants, 2/pi * 2**24, pi/2, then the cosine's
# coefficients c0..c4 and the sine's s1..s3, with a second set whose cosine is
# negated (the quadrants n with n & 2); and 4/pi to 192 bits for large
# arguments, 8 new bits an entry
_SINCOSF_TAB = tuple(tuple(float.fromhex(c) for c in row) for row in (
    ("0x1p+0", "-0x1p+0", "-0x1p+0", "0x1p+0", "0x1.45f306dc9c883p+23", "0x1.921fb54442d18p+0", "0x1p+0",
     "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16",
     "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"),
    ("0x1p+0", "-0x1p+0", "-0x1p+0", "0x1p+0", "0x1.45f306dc9c883p+23", "0x1.921fb54442d18p+0", "-0x1p+0",
     "0x1.ffffffd0c621cp-2", "-0x1.55553e1068f19p-5", "0x1.6c087e89a359dp-10", "-0x1.99343027bf8c3p-16",
     "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13")))
_INV_PIO4 = (0xA2, 0xA2F9, 0xA2F983, 0xA2F9836E, 0xF9836E4E, 0x836E4E44, 0x6E4E4415, 0x4E441529, 0x441529FC,
             0x1529FC27, 0x29FC2757, 0xFC2757D1, 0x2757D1F5, 0x57D1F534, 0xD1F534DD, 0xF534DDC0, 0x34DDC0DB,
             0xDDC0DB62, 0xC0DB6295, 0xDB629599, 0x6295993C, 0x95993C43, 0x993C4390, 0x3C439041)
_PI63 = float.fromhex("0x1.921fb54442d18p-62")  # 2 pi / 2**64


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """glibc's ``sinf`` (``cos=False``) or ``cosf`` of finite float32 ``y``,
    step for step in float64 (its fused multiply-adds, if any, round once
    where these round twice: that moves the float32 result only if the
    float64 one lies within an ulp of float64 of a float32 rounding point)."""
    dev = y.device
    y = y.float().contiguous()
    xi = y.view(torch.int32).to(torch.int64) & _M
    top12 = (xi >> 20) & 0x7FF
    x = y.double()
    tab = torch.tensor(_SINCOSF_TAB, dtype=torch.float64, device=dev)
    # |y| < 120: n = round(y 2/pi) through a 24-bit shift, r = y - n pi/2
    nf = (((x * tab[0, 4]).to(torch.int32).to(torch.int64) + 0x800000) >> 24)
    r_fast = x - nf.double() * tab[0, 5]
    # larger: y's 24-bit mantissa times 4/pi's bits from y's exponent on, a 2.62 fixed-point remainder
    arr = torch.tensor(_INV_PIO4, dtype=torch.int64, device=dev)
    j = (xi >> 26) & 15
    m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)
    res0 = (m * arr[j]) & _M
    res1 = m * arr[j + 4]
    res2 = m * arr[j + 8]
    res0 = ((res2 >> 32) & _M) | (res0 << 32)
    res0 = res0 + res1
    nl = ((res0 + (1 << 61)) >> 62) & 3
    r_large = (res0 - (nl << 62)).double() * _PI63
    sign = xi >> 31
    small, fast = top12 < 0x3F4, top12 < 0x42F  # |y| < 0.75 and |y| < 120, as glibc's abstop12 tests them
    # the quadrant picks the polynomial; with y's sign added (large |y|) it picks the sign and the set
    quad = torch.where(small, 0, torch.where(fast, nf, nl))
    n = torch.where(fast, quad, nl + sign)
    r = torch.where(small, x, torch.where(fast, r_fast, r_large))
    p = tab[(n & 2) >> 1]
    s = torch.where(small, 1.0, p[..., 0:4].gather(-1, (n & 3)[..., None])[..., 0])
    if cos:
        quad = quad ^ 1
    r = r * s
    r2 = r * r
    # the sine polynomial on even quadrants, the cosine on odd ones
    r3 = r * r2
    sin_p = (r + r3 * p[..., 11]) + (r3 * r2) * (p[..., 12] + r2 * p[..., 13])
    r4 = r2 * r2
    cos_p = (p[..., 6] + r2 * p[..., 7]) + r4 * p[..., 8] + (r4 * r2) * (p[..., 9] + r2 * p[..., 10])
    out = torch.where((quad & 1) == 1, cos_p, sin_p).float()
    tiny = top12 < 0x398  # |y| < 2**-12: sinf returns y, cosf 1
    return torch.where(tiny, torch.ones_like(y) if cos else y, out)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``sin`` (glibc's ``sinf``): ``torch.sin`` differs
    from it by an ulp on some angles (0.5 % of ``tests/test_torch_whisper.py``'s grid)."""
    return _sincosf(y, cos=False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``cos`` (glibc's ``cosf``)."""
    return _sincosf(y, cos=True)


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
    # the square root correctly rounded, as XLA's: torch's float32 sqrt on the CPU is not everywhere
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

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


def _truncated_normal_fn(lower: float, upper: float):
    """``truncated_normal``'s float32 map of 32 random bits onto (lower, upper)."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = _erf32(lo / sqrt2), _erf32(hi / sqrt2)
    clip_lo = float(np.nextafter(lo, np.float32(np.inf)))
    clip_hi = float(np.nextafter(hi, np.float32(-np.inf)))
    return lambda bits: torch.clamp(erf_inv(uniform_from_bits(bits, a, b)) * float(sqrt2), clip_lo, clip_hi)


def truncated_normal(key, lower: float, upper: float, shape: Sequence[int], *,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)`` for
    one key (2,): the uniform on ``[erf(lower/sqrt2), erf(upper/sqrt2))``
    from the key's 32-bit draws, ``sqrt2 * erf_inv(u)``, then the clip to
    the open interval (``nextafter`` of each bound).  Bitwise JAX's on
    almost every element (``erf_inv``'s float64 multiply-adds round twice in
    rare cases).  The draws run ``chunk`` elements at a time
    (``_chunked_draw``), so a (100352, 2048) table needs no more than a few
    chunk-sized temporaries.
    """
    shape = tuple(int(d) for d in shape)
    return _chunked_draw(key, shape, _truncated_normal_fn(lower, upper), chunk=chunk).reshape(shape)


def _chunked_draw(key, shape, fn, start: int = 0, stop: Optional[int] = None, *, chunk: Optional[int] = None,
                  dtype=torch.float32) -> torch.Tensor:
    """``fn(bits)`` of elements [start, stop) (default all) of one key's (2,)
    32-bit draw over ``shape``, flat, without making the rest: ``chunk``
    elements at a time (default 2**24 on a card, 2**18 elsewhere: a CPU
    keeps a smaller chunk's temporaries in its caches).  Partitionable:
    element i hashes the count pair (i >> 32, i & 0xffffffff).  Legacy: in
    each block of the draw (one below 2**32 - 1 elements), chunks of
    ``chunk // 2`` count pairs, each giving its y0 words to the first half of
    the block and its y1 words to the second; a pair that no element of the
    window needs is not hashed.  ``fn`` must act elementwise."""
    n = math.prod(int(d) for d in shape)
    stop = n if stop is None else stop
    if not 0 <= start <= stop <= n:
        raise ValueError(f"window [{start}, {stop}) of a draw of {n} elements")
    out = torch.empty(stop - start, dtype=dtype, device=key.device)
    chunk = chunk or (1 << 24 if key.device.type == "cuda" else 1 << 18)
    if partitionable():
        if n > 2**64:
            raise ValueError(f"a draw of {n} elements: jax's counts are 64-bit")
        for s in range(start, stop, chunk):
            counts = torch.arange(s, min(stop, s + chunk), dtype=torch.int64, device=key.device)
            y0, y1 = _hash_counts(key, counts, s + counts.numel())
            out[s - start : s - start + counts.numel()] = fn(y0 ^ y1)
        return out
    step = max(chunk // 2, 1)
    for base, m, k in _legacy_spans(key, n, start, stop):
        lo, hi = max(start - base, 0), min(stop - base, m)  # the window's elements in this block
        h = (m + 1) // 2
        a0, a1 = lo, min(hi, h)  # y0 of these pairs: elements [a0, a1)
        b0, b1 = max(lo, h) - h, max(hi - h, 0)  # y1 of these pairs: elements h + [b0, b1)
        spans = [(a0, a1), (b0, b1)]
        if a0 < a1 and b0 < b1 and max(a0, b0) <= min(a1, b1):
            spans = [(min(a0, b0), max(a1, b1))]  # overlapping: hash each pair once
        for p0, p1 in spans:
            for p in range(p0, p1, step):
                q = min(p1, p + step)
                x0, x1 = _legacy_blocks(m, key.device, p, q)
                y0, y1 = threefry2x32(k[..., 0], k[..., 1], x0, x1)
                i0, i1 = max(p, a0), min(q, a1)
                if i0 < i1:
                    out[base + i0 - start : base + i1 - start] = fn(y0[i0 - p : i1 - p])
                j0, j1 = max(p, b0), min(q, b1)
                if j0 < j1:
                    out[base + h + j0 - start : base + h + j1 - start] = fn(y1[j0 - p : j1 - p])
    return out


def _normal_fn():
    """``normal``'s float32 map of 32 random bits."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    sqrt2 = float(np.float32(np.sqrt(2)))
    return lambda bits: erf_inv(uniform_from_bits(bits, lo, 1.0)) * sqrt2


def normal(key, shape: Sequence[int], *, chunk: Optional[int] = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` for one key (2,), bit for
    bit: the uniform on ``[nextafter(-1, 0), 1)`` from the key's 32-bit
    draws, then ``sqrt2 * erf_inv(u)`` (XLA fuses neither step into
    another).  The draws run ``chunk`` elements at a time."""
    shape = tuple(int(d) for d in shape)
    return _chunked_draw(key, shape, _normal_fn(), chunk=chunk).reshape(shape)
