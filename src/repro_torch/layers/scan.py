"""Parallel prefix scan with an associative combine (port of
``jax.lax.associative_scan``), for the recurrent layers (``layers/ssm``;
the RG-LRU of ``layers/rglru`` uses the same combine).

The algorithm is lax's own, so the tree of products, and with it the
rounding, is the reference's: combine adjacent pairs, scan the half-length
result by recursion (its elements are the odd outputs), combine the odd
outputs with the even inputs (for an odd length the last odd output has
a partner too), then interleave.  A length-n scan is ceil(log2 n) levels
of whole-tensor operations, never a loop over n.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Elems = Tuple[torch.Tensor, ...]


def _sl(t: torch.Tensor, dim: int, start, stop=None, step=1) -> torch.Tensor:
    """``t[start:stop:step]`` along ``dim`` (a view)."""
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _scan(combine: Callable[[Elems, Elems], Elems], elems: Elems, dim: int) -> Elems:
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    # combine adjacent pairs (lax's ``slice_in_dim(e, 0, -1, stride=2)`` and ``(e, 1, None, stride=2)``)
    odd = _scan(combine, tuple(combine(tuple(_sl(e, dim, 0, -1, 2) for e in elems),
                                       tuple(_sl(e, dim, 1, None, 2) for e in elems))), dim)
    evens_in = tuple(_sl(e, dim, 2, None, 2) for e in elems)
    left = odd if n % 2 else tuple(_sl(o, dim, 0, -1) for o in odd)
    even = combine(left, evens_in)
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = e.new_empty(e.shape)
        _sl(r, dim, 0, 1).copy_(_sl(e, dim, 0, 1))  # the first output is the first input
        _sl(r, dim, 2, None, 2).copy_(ev)
        _sl(r, dim, 1, None, 2).copy_(od)
        out.append(r)
    return tuple(out)


def associative_scan(combine: Callable[[Elems, Elems], Elems], elems: Sequence[torch.Tensor], dim: int = 0) -> Elems:
    """The inclusive scan of ``elems`` (tensors sharing the size of ``dim``)
    under ``combine``, which takes two tuples of such tensors (earlier,
    later) and returns one: output k is ``combine`` folded over inputs
    0..k, in lax's tree order."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    n = elems[0].shape[dim]
    if any(e.shape[dim] != n for e in elems):
        raise ValueError(f"associative_scan: sizes along dim {dim} differ: {[tuple(e.shape) for e in elems]}")
    return _scan(combine, elems, dim)
