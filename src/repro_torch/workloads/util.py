"""Workload-factory arithmetic (port of ``repro.workloads.util``).

The port runs concrete Python counts only (bucket padding with traced
record counts is not ported), so these are the reference's concrete paths,
with the same float32 truncation in :func:`scaled_count`.
"""
from __future__ import annotations

import numpy as np


def imin(a: int, b: int) -> int:
    return min(int(a), int(b))


def imax(a: int, b: int) -> int:
    return max(int(a), int(b))


def scaled_count(n: int, frac: float, floor: int) -> int:
    """``max(int(n * frac), floor)`` with the product taken in float32 and
    truncated toward zero, as the reference takes it."""
    return max(int(np.float32(int(n)) * np.float32(frac)), floor)
