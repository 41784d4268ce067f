"""Gradient compression for cross-pod reduction (port of
``repro.optim.compression``): int8 quantization with error feedback.

  * ``compressed_psum(parts)``: the quantized sum of the participants'
    tensors (int8 grid, exact int32 reduction, rescale).  The reference
    runs it inside ``shard_map`` over the cross-pod axis; the port has no
    ``shard_map`` and takes the participants' tensors as a list, one per
    participant, on devices that may repeat one device (as
    ``core.planes`` takes per-shard tensors): the scales are max-reduced,
    each part is requantized against the global scale, and the int32 sum
    runs on the first part's device.
  * ``with_error_feedback(opt)``: an optimizer wrapper that quantizes and
    dequantizes each gradient and carries the residual into the next step.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.optim.optimizers import OptimizerSpec, leaf_order


def _scale(parts) -> torch.Tensor:
    """The int8 grid step of tensors that share one: their largest |x| / 127."""
    return torch.clamp(torch.stack([x.float().abs().amax() for x in parts]).amax() / 127.0, min=1e-12)


def _on_grid(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale([g])
    return _on_grid(g, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of ``parts`` on the int8 grid of their largest scale, as
    float32 on the first part's device: what every participant of the
    reference's ``compressed_psum`` receives."""
    dev0 = parts[0].device
    g_scale = torch.stack([_scale([x]).to(dev0) for x in parts]).amax()
    total = None
    for x in parts:
        q = _on_grid(x, g_scale.to(x.device)).to(torch.int32).to(dev0)
        total = q if total is None else total + q
    return total.float() * g_scale


def with_error_feedback(opt: OptimizerSpec, enabled: bool = True) -> OptimizerSpec:
    """Wrap an optimizer with int8 gradient quantization + error feedback:
    the state is ``{"inner": opt's state, "residual": {name: float32}}``.
    Each of the reference's leaves is quantized on one grid, so the layers
    of a stacked leaf share their largest scale."""
    if not enabled:
        return opt

    def init(params):
        return {"inner": opt.init(params),
                "residual": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        cgrads, resid = {}, {}
        for group in leaf_order(grads):  # one grid per reference leaf: a stacked leaf's layers share it
            gqs = [grads[n].float() + state["residual"][n] for n in group]
            scale = _scale(gqs)
            for n, gq in zip(group, gqs):
                deq = dequantize_int8(_on_grid(gq, scale).to(torch.int8), scale)
                cgrads[n], resid[n] = deq.to(grads[n].dtype), gq - deq
        new_params, inner, gnorm = opt.update(cgrads, state["inner"], params, step)
        return new_params, {"inner": inner, "residual": resid}, gnorm

    return OptimizerSpec(init, update)
