"""Feed-forward blocks: SwiGLU (3-matrix) and 2-matrix (sq_relu / gelu),
port of ``repro.layers.mlp``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import ParamSet, activation
from repro_torch.sharding import P, dense_init, zeros_init


class MLP(ParamSet):
    """Parameters ``wg`` (D, F) for the gated kinds, ``wu`` (D, F), ``wd``
    (F, D), and with ``mlp_bias`` ``bu`` (F,) and ``bd`` (D,)."""

    NAMES = ("wg", "wu", "wd", "bu", "bd")


def init_mlp(key, cfg: ArchConfig, dtype=torch.float32) -> MLP:
    D, F = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["wg"] = dense_init(key, "wg", (D, F), P(("embed", "fsdp"), "ff"), dtype)
    p["wu"] = dense_init(key, "wu", (D, F), P(("embed", "fsdp"), "ff"), dtype)
    p["wd"] = dense_init(key, "wd", (F, D), P("ff", ("embed", "fsdp")), dtype)
    if cfg.mlp_bias:
        p["bu"] = zeros_init("bu", (F,), P("ff"), dtype, key.device)
        p["bd"] = zeros_init("bd", (D,), P("embed"), dtype, key.device)
    return MLP(p)


def apply_mlp(params: MLP, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = x @ params.wg.to(dt)
        u = x @ params.wu.to(dt)
        h = activation("silu" if cfg.mlp_act == "swiglu" else "gelu", g) * u
    else:
        u = x @ params.wu.to(dt)
        if params.bu is not None:
            u = u + params.bu.to(dt)
        h = activation(cfg.mlp_act, u)
    out = h @ params.wd.to(dt)
    if params.bd is not None:
        out = out + params.bd.to(dt)
    return out
