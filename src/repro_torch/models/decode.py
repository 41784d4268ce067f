"""Prefill + single-token decode with a KV or SSM-state cache (port of
``repro.models.decode``: attention stacks with a dense MLP or MoE FFN, and
Mamba-1 SSM stacks).

Cache layout, as the reference's: ``{"len": int, "layers": {...}}`` with
``len`` the number of tokens already in the cache (a Python int here, a
traced scalar there) and ``layers`` either ``{"k": (L,B,S,KV,Dh), "v": ...}``
(attention) or ``{"h": (L,B,di,N) float32, "conv": (L,B,K-1,di)}`` (SSM).
Unlike the reference, which is functional, the port writes into the cache's
arrays **in place**: prefill fills a cache allocated once at its padded
size (no per-layer pad and no stack copy), and each decode step writes its
token's k/v, or each layer's new state and conv window, into the arrays it
was given (no copy of the cache per step); the returned cache shares them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.common import apply_norm
from repro_torch.layers.ssm import apply_ssm_step
from repro_torch.models.lm import (
    LM, _attn_in, _block_full, _block_out, _rope, check_ported, default_positions, embed_tokens, logits_fn,
)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.float32, device=None) -> Dict:
    """An empty cache, len 0: zeros (L, batch, s_max, KV, Dh) for k and v,
    or for an SSM stack zeros h (L, batch, di, N) float32 and conv
    (L, batch, K-1, di) (``s_max`` unused)."""
    check_ported(cfg)
    L = cfg.n_layers
    if cfg.is_ssm:
        di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        layers = {"h": torch.zeros((L, batch, di, N), dtype=torch.float32, device=device),
                  "conv": torch.zeros((L, batch, K - 1, di), dtype=dtype, device=device)}
    else:
        shape = (L, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
        layers = {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"len": 0, "layers": layers}


def lm_prefill(params: LM, cfg: ArchConfig, batch, pad_to: Optional[int] = None, *, plane=ops.AUTO):
    """Full forward building the cache. Returns (last-token logits (B,V), cache).

    pad_to: cache headroom — an attention cache holds max(S, pad_to) slots
    so decode can continue past the prompt (an SSM cache has no sequence
    axis).  Each layer is the forward's block, which writes its cache entry
    (the reference's ``_attn_block_prefill``): attention runs through
    ``ops.attention_op`` (the ``flash_attention`` kernel on the ``"kernel"``
    plane: one launch per layer); an SSM stack computes the same on both
    planes.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(tokens)
    x = embed_tokens(params, cfg, tokens)
    cache = init_cache(cfg, B, max(S, pad_to or 0), x.dtype, x.device)
    c = cache["layers"]
    for i, (lp, kind) in enumerate(zip(params.layers, cfg.layer_kinds())):
        x = _block_full(lp, cfg, kind, x, positions, plane=plane, cache_out={name: t[i] for name, t in c.items()})
    cache["len"] = S
    logits = logits_fn(params, cfg, x[:, -1:])
    return logits[:, 0], cache


def _attn_block_step(lp, cfg: ArchConfig, x, kc, vc, pos: int):
    """x (B,1,D); kc/vc (B,S,KV,Dh), written in place at ``pos``. Returns x'."""
    h = _attn_in(lp, cfg, x)
    q, k, v = attn_lib._project_qkv(lp.attn, cfg, h)
    pos_ids = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k = _rope(cfg, q, pos_ids), _rope(cfg, k, pos_ids)
    out, _, _ = attn_lib.decode_attn_cached(q[:, 0], k[:, 0], v[:, 0], kc, vc, pos)
    return _block_out(lp, cfg, x, h, attn_lib._out_proj(lp.attn, out[:, None], x.dtype))


def _block_step(lp, cfg: ArchConfig, kind: str, x, cl: Dict, pos: int):
    """One layer of a decode step on its cache views ``cl`` (the
    reference's ``_block_step``). Returns x'."""
    if kind == "ssm":
        y, _ = apply_ssm_step(lp.ssm, cfg, apply_norm(cfg.norm, lp.norm, x), cl)
        return x + y
    return _attn_block_step(lp, cfg, x, cl["k"], cl["v"], pos)


def lm_decode_step(params: LM, cfg: ArchConfig, cache, batch):
    """One-token decode. batch: {"token": (B,) int}.

    Returns (logits (B,V), new cache); the new cache shares the given
    cache's arrays, which this step has written in place.  An MoE layer
    sees the step's B tokens as one call, as the reference's does, so its
    capacity is that of T = B."""
    pos = int(cache["len"])
    x = embed_tokens(params, cfg, batch["token"][:, None])
    c = cache["layers"]
    for i, (lp, kind) in enumerate(zip(params.layers, cfg.layer_kinds())):
        x = _block_step(lp, cfg, kind, x, {name: t[i] for name, t in c.items()}, pos)
    new_cache = dict(cache)
    new_cache["len"] = pos + 1
    logits = logits_fn(params, cfg, x)
    return logits[:, 0], new_cache
