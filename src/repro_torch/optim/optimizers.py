"""Optimizers (port of ``repro.optim.optimizers``): AdamW and memory-lean
bf16 momentum, with the reference's API.

Parameters, gradients and every state tree are flat dicts of tensors keyed
by the LM's parameter names (``layers.3.attn.wq``, ``dict(model.
named_parameters())``); a state is ``{"m": {name: t}, "v": {name: t}}``,
the reference's tree with its layers unstacked (``convert`` stacks them).
``update`` writes the parameters and the state **in place** and returns
them, and clips the gradients it is given in place, so a step holds no
second copy of the model or of its gradients: a caller that reads the
gradients after ``update`` copies them first.  Scalars (the schedule, the
bias corrections) are float32, as the reference computes them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class OptimizerSpec(NamedTuple):
    init: Callable  # params -> opt_state
    update: Callable  # (grads, opt_state, params, step) -> (params, opt_state, grad_norm)


def wsd_schedule(peak_lr: float, warmup: int = 100, decay_start: int = 10_000, total: int = 20_000):
    """Warmup-stable-decay schedule: ``lr(step)`` -> float32."""
    f = np.float32

    def lr(step) -> np.float32:
        s = f(int(step))
        warm = f(peak_lr) * min((s + f(1)) / f(max(warmup, 1)), f(1))
        frac = min(max((s - f(decay_start)) / f(max(total - decay_start, 1)), f(0)), f(1))
        decay = f(peak_lr) * (f(1) - f(0.9) * frac)
        return warm if s < decay_start else decay

    return lr


def leaf_order(names) -> List[List[str]]:
    """The parameter names grouped by the reference's leaves, in the
    reference's leaf order: a name's leaf is its path without the layer
    index (``layers.3.attn.wq`` -> ``layers/attn/wq``), and JAX flattens a
    dict tree in sorted key order; a group lists its layers in order."""
    groups: Dict[tuple, List[str]] = {}
    for n in names:
        parts = n.split(".")
        leaf = tuple(p for p in parts if not p.isdigit())
        idx = tuple(int(p) for p in parts if p.isdigit())
        groups.setdefault(leaf, []).append((idx, n))
    return [[n for _, n in sorted(groups[k])] for k in sorted(groups)]


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in the
    reference's order (a stacked leaf's layers in turn)."""
    total = None
    for group in leaf_order(grads):
        for n in group:
            sq = grads[n].float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping); new tensors, in each gradient's dtype."""
    return clip_by_global_norm_({n: g.clone() for n, g in grads.items()}, max_norm)


@torch.no_grad()
def clip_by_global_norm_(grads: Tree, max_norm: float):
    """Each gradient scaled by ``min(max_norm / global_norm, 1)``, written
    into the given gradients: the float32 product by the 0-dim scale,
    rounded to the gradient's dtype.
    Returns (the clipped gradients, the norm before clipping); a gradient
    that cannot be written in place (an expanded one, whose elements
    share memory, or one that another entry of ``grads`` also holds) is
    replaced by a copy."""
    gn = global_norm(grads)
    scale = torch.clamp(float(np.float32(max_norm)) / torch.clamp(gn, min=1e-9), max=1.0)
    out, seen = {}, set()
    for n, g in grads.items():  # every copy taken before any gradient is written
        if any(st == 0 and k > 1 for st, k in zip(g.stride(), g.shape)) or g.data_ptr() in seen:
            g = g.clone()
        seen.add(g.data_ptr())
        out[n] = g
    for g in out.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float().mul_(scale))
    return out, gn


def _zeros(params: Tree, dtype) -> Tree:
    return {n: torch.zeros_like(p, dtype=dtype) for n, p in params.items()}


def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: float = 1.0) -> OptimizerSpec:
    f = np.float32

    def init(params: Tree):
        return {"m": _zeros(params, torch.float32), "v": _zeros(params, torch.float32)}

    @torch.no_grad()
    def update(grads: Tree, state, params: Tree, step):
        grads, gnorm = clip_by_global_norm_(grads, max_grad_norm)
        t = f(int(step)) + f(1)
        bc1 = float(f(1) - f(b1) ** t)
        bc2 = float(f(1) - f(b2) ** t)
        lr_t = float(lr(step))
        c1, c2 = float(f(1 - b1)), float(f(1 - b2))
        for n, p in params.items():
            # the same products and sums, in the same order, as the out-of-place
            #   m = b1 m + c1 g;  v = b2 v + c2 g^2;  p = p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)
            # with two leaf-sized temporaries
            g = grads[n].float()
            m, v = state["m"][n], state["v"][n]
            tmp = c1 * g
            m.mul_(float(f(b1))).add_(tmp)
            torch.square(g, out=tmp)
            v.mul_(float(f(b2))).add_(tmp.mul_(c2))
            del g
            u = m / bc1
            torch.div(v, bc2, out=tmp)
            u.div_(tmp.sqrt_().add_(float(f(eps))))
            pf = p.float()
            torch.mul(pf, float(f(weight_decay)), out=tmp)
            u.add_(tmp).mul_(lr_t)
            del tmp
            if p.dtype == torch.float32:
                p.sub_(u)
            else:
                p.copy_(pf.sub_(u))
        return params, state, gnorm

    return OptimizerSpec(init, update)


def momentum_bf16(lr: Callable, beta: float = 0.9, weight_decay: float = 0.0,
                  max_grad_norm: float = 1.0) -> OptimizerSpec:
    """Memory-lean SGD-momentum with bf16 state, for configs where AdamW's
    8 float32 bytes per parameter do not fit."""
    f = np.float32

    def init(params: Tree):
        return {"m": _zeros(params, torch.bfloat16)}

    @torch.no_grad()
    def update(grads: Tree, state, params: Tree, step):
        grads, gnorm = clip_by_global_norm_(grads, max_grad_norm)
        lr_t = float(lr(step))
        for n, p in params.items():
            # m = bf16(beta m + g);  p = p - lr (m + wd p), in float32
            m = state["m"][n]
            u = m.float().mul_(float(f(beta))).add_(grads[n])
            m.copy_(u)
            u.copy_(m)
            pf = p.float()
            u.add_(pf * float(f(weight_decay))).mul_(lr_t)
            if p.dtype == torch.float32:
                p.sub_(u)
            else:
                p.copy_(pf.sub_(u))
        return params, state, gnorm

    return OptimizerSpec(init, update)


def make_optimizer(name: str, peak_lr: float = 3e-4, **kw) -> OptimizerSpec:
    sched = wsd_schedule(peak_lr)
    if name == "adamw":
        return adamw(sched, **kw)
    if name == "momentum_bf16":
        return momentum_bf16(sched, **kw)
    raise ValueError(name)


def opt_state_specs(opt_name: str, param_specs):
    """Optimizer-state logical specs mirror the param specs."""
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs}
    return {"m": param_specs}
