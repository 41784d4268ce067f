"""Prefill + single-token decode with a KV cache (port of
``repro.models.decode``, attention stacks: dense MLP or MoE FFN).

Cache layout, as the reference's: ``{"len": int, "layers": {"k": (L,B,S,KV,Dh),
"v": ...}}``, with ``len`` the number of tokens already in the cache (a
Python int here, a traced scalar there).  Unlike the reference, which is
functional, the port writes into the cache's arrays **in place**: prefill
fills a cache allocated once at its padded size (no per-layer pad and no
stack copy), and each decode step writes its token's k/v into the arrays
it was given (no copy of the (L,B,S,KV,Dh) arrays per step); the returned
cache shares them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.layers import attention as attn_lib
from repro_torch.models.lm import (
    LM, _attn_in, _block_full, _block_out, _rope, check_ported, default_positions, embed_tokens, logits_fn,
)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.float32, device=None) -> Dict:
    """An empty cache: zeros (L, batch, s_max, KV, Dh) for k and v, len 0."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {
        "len": 0,
        "layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)},
    }


def lm_prefill(params: LM, cfg: ArchConfig, batch, pad_to: Optional[int] = None, *, plane=ops.AUTO):
    """Full forward building the cache. Returns (last-token logits (B,V), cache).

    pad_to: cache headroom — the cache holds max(S, pad_to) slots so decode
    can continue past the prompt.  Each layer is the forward's block, which
    writes its k/v into the cache (the reference's ``_attn_block_prefill``);
    attention runs through ``ops.attention_op`` (the ``flash_attention``
    kernel on the ``"kernel"`` plane: one launch per layer).
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(tokens)
    x = embed_tokens(params, cfg, tokens)
    cache = init_cache(cfg, B, max(S, pad_to or 0), x.dtype, x.device)
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        x = _block_full(lp, cfg, x, positions, plane=plane, kv_out={"k": ks[i], "v": vs[i]})
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


def lm_decode_step(params: LM, cfg: ArchConfig, cache, batch):
    """One-token decode. batch: {"token": (B,) int}.

    Returns (logits (B,V), new cache); the new cache shares the given
    cache's arrays, which this step has written in place (every layer is an
    attention block: the reference's ``_block_step`` dispatch has one kind
    here).  An MoE layer sees the step's B tokens as one call, as the
    reference's does, so its capacity is that of T = B."""
    pos = int(cache["len"])
    x = embed_tokens(params, cfg, batch["token"][:, None])
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        x = _attn_block_step(lp, cfg, x, ks[i], vs[i], pos)
    new_cache = dict(cache)
    new_cache["len"] = pos + 1
    logits = logits_fn(params, cfg, x)
    return logits[:, 0], new_cache
