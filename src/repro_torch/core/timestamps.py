"""Two-word (hi, lo) transaction timestamps (port of ``repro.core.timestamps``).

``hi`` holds the int32 logical local clock and ``lo`` the unique LOGICAL
slot id + 1; comparisons are lexicographic on signed int32 words.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

class TS(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def ts_lt(a: TS, b: TS):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def ts_le(a: TS, b: TS):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def ts_eq(a: TS, b: TS):
    return (a.hi == b.hi) & (a.lo == b.lo)


def ts_is_zero(a: TS):
    return (a.hi == 0) & (a.lo == 0)


def ts_max(a: TS, b: TS):
    a_ge = ~ts_lt(a, b)
    return TS(torch.where(a_ge, a.hi, b.hi), torch.where(a_ge, a.lo, b.lo))


def ts_min(a: TS, b: TS):
    a_le = ts_le(a, b)
    return TS(torch.where(a_le, a.hi, b.hi), torch.where(a_le, a.lo, b.lo))


def ts_where(cond, a: TS, b: TS):
    return TS(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))
