"""Prefill + single-token decode with a KV, SSM-state, hybrid or
encoder-decoder cache (port of ``repro.models.decode``: attention stacks
with a dense MLP or MoE FFN, Mamba-1 SSM stacks, the hybrid's RG-LRU and
local-attention cycle, and the audio encoder-decoder).

Cache layout, as the reference's: ``{"len": int, "layers": {...}}`` with
``len`` the number of tokens already in the cache (a Python int here, a
traced scalar there) and ``layers`` either ``{"k": (L,B,S,KV,Dh), "v": ...}``
(attention) or ``{"h": (L,B,di,N) float32, "conv": (L,B,K-1,di)}`` (SSM).
A hybrid's is ``{"len", "groups": {f"g{j}_{kind}": ...}, "tail": [...]}``:
group j stacks the n_full layers P l + j of the pattern's kind j (P its
length), tail entry i holds layer P n_full + i on a leading axis of 1.  An
attention layer's entry there is a ring of min(W, s_max) slots for its
window W: decode writes token p at slot p mod W, and prefill leaves the
window's last tokens where decode expects them (``lm.write_kv``); an RG-LRU
layer's is ``{"h": (B, rnn_width) float32, "conv": (B, K-1, rnn_width)}``.
An encoder-decoder's is ``{"len", "self": {"k", "v"}, "cross_k",
"cross_v"}``: its decoder's self k/v (L,B,S,KV,Dh) and each decoder layer's
k and v of the encoder's states (L,B,enc_seq_len,KV,Dh), which prefill
writes and decode only reads.
Unlike the reference, which is functional, the port writes into the cache's
arrays **in place**: prefill fills a cache allocated once at its padded
size (no per-layer pad and no stack copy), and each decode step writes its
token's k/v, or each layer's new state and conv window, into the arrays it
was given (no copy of the cache per step); the returned cache shares them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.common import apply_norm, sinusoid_at
from repro_torch.layers.mlp import apply_mlp
from repro_torch.layers.rglru import apply_rglru_step
from repro_torch.layers.ssm import apply_ssm_step
from repro_torch.models.lm import (
    LM, _attn_in, _block_full, _block_out, _rope, _run_decoder_encdec, attn_window, check_ported, default_positions,
    embed_tokens, encode_audio, logits_fn, rotary,
)
from repro_torch.sharding import P


def _entry(cfg: ArchConfig, kind: str, n: int, batch: int, slots: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Zeros for n stacked layers of ``kind``: k/v (n, batch, slots, KV, Dh),
    or the recurrent state h (float32) and conv tail of an SSM or RG-LRU."""
    K = cfg.ssm_conv
    if kind == "attn":
        shape = (n, batch, slots, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
    h, width = ((cfg.d_inner, cfg.ssm_state), cfg.d_inner) if kind == "ssm" else ((cfg.rnn_width,), cfg.rnn_width)
    return {"h": torch.zeros((n, batch) + h, dtype=torch.float32, device=device),
            "conv": torch.zeros((n, batch, K - 1, width), dtype=dtype, device=device)}


_KV_SPEC = P(None, "batch", "kv_seq", None, None)  # (L, B, S, KV, Dh): S sequence-sharded (flash-decoding)
# each kind of cache entry's logical specs, the reference's ``_{attn,ssm,rglru}_cache_struct``
ENTRY_SPECS = {
    "attn": {"k": _KV_SPEC, "v": _KV_SPEC},
    "ssm": {"h": P(None, "batch", "d_inner", None), "conv": P(None, "batch", None, "d_inner")},
    "rglru": {"h": P(None, "batch", "rnn"), "conv": P(None, "batch", None, "rnn")},
}


def cache_specs(cfg: ArchConfig) -> Dict:
    """The logical specs of ``init_cache``'s tree, leaf for leaf (the
    reference's ``init_cache`` Params): ``len`` replicated, attention k/v
    sequence-sharded over ``kv_seq``, an encoder-decoder's cross k/v over
    the batch only."""
    check_ported(cfg)
    if cfg.encoder_decoder:
        cross = P(None, "batch", None, None, None)
        return {"len": P(), "self": dict(ENTRY_SPECS["attn"]), "cross_k": cross, "cross_v": cross}
    if not cfg.is_hybrid:
        return {"len": P(), "layers": dict(ENTRY_SPECS["ssm" if cfg.is_ssm else "attn"])}
    pat = cfg.block_pattern
    return {"len": P(), "groups": {f"g{j}_{kind}": dict(ENTRY_SPECS[kind]) for j, kind in enumerate(pat)},
            "tail": [dict(ENTRY_SPECS[pat[i]]) for i in range(cfg.n_layers % len(pat))]}


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.float32, device=None) -> Dict:
    """An empty cache, len 0: zeros (L, batch, s_max, KV, Dh) for k and v,
    or for an SSM stack zeros h (L, batch, di, N) float32 and conv
    (L, batch, K-1, di) (``s_max`` unused); for a hybrid the reference's
    groups and tail (the module's docstring), each attention layer a ring
    of min(W, s_max) slots; for an encoder-decoder its decoder's self k/v
    and the cross k/v of ``cfg.enc_seq_len`` frames a layer."""
    check_ported(cfg)
    if cfg.encoder_decoder:
        cross = _entry(cfg, "attn", cfg.n_layers, batch, cfg.enc_seq_len, dtype, device)
        return {"len": 0, "self": _entry(cfg, "attn", cfg.n_layers, batch, s_max, dtype, device),
                "cross_k": cross["k"], "cross_v": cross["v"]}
    if not cfg.is_hybrid:
        kind = "ssm" if cfg.is_ssm else "attn"
        return {"len": 0, "layers": _entry(cfg, kind, cfg.n_layers, batch, s_max, dtype, device)}
    pat = cfg.block_pattern
    n_full, rem = divmod(cfg.n_layers, len(pat))
    slots = min(cfg.local_window or s_max, s_max)
    return {"len": 0,
            "groups": {f"g{j}_{kind}": _entry(cfg, kind, n_full, batch, slots, dtype, device)
                       for j, kind in enumerate(pat)},
            "tail": [_entry(cfg, pat[i], 1, batch, slots, dtype, device) for i in range(rem)]}


def layer_caches(cfg: ArchConfig, cache: Dict) -> List[Dict[str, torch.Tensor]]:
    """Each layer's views into the cache's arrays, in layer order (an
    encoder-decoder's: ``k``, ``v``, ``xk``, ``xv``)."""
    if cfg.encoder_decoder:
        return [{"k": cache["self"]["k"][i], "v": cache["self"]["v"][i], "xk": cache["cross_k"][i],
                 "xv": cache["cross_v"][i]} for i in range(cfg.n_layers)]
    if not cfg.is_hybrid:
        return [{name: t[i] for name, t in cache["layers"].items()} for i in range(cfg.n_layers)]
    pat = cfg.block_pattern
    groups = [cache["groups"][f"g{j}_{kind}"] for j, kind in enumerate(pat)]
    n_full = cfg.n_layers // len(pat)
    out = [{name: t[l] for name, t in groups[j].items()} for l in range(n_full) for j in range(len(pat))]
    return out + [{name: t[0] for name, t in entry.items()} for entry in cache["tail"]]


def lm_prefill(params: LM, cfg: ArchConfig, batch, pad_to: Optional[int] = None, *, plane=ops.AUTO, shd=None):
    """Full forward building the cache. Returns (last-token logits (B,V), cache).

    pad_to: cache headroom — an attention cache holds max(S, pad_to) slots
    so decode can continue past the prompt (an SSM cache has no sequence
    axis; a hybrid's window ring holds W slots, as the reference's prefill
    pads it to its window).  Each layer is the forward's block, which
    writes its cache entry (the reference's ``_attn_block_prefill``):
    attention runs through ``ops.attention_op`` (the ``flash_attention``
    kernel on the ``"kernel"`` plane: one launch per layer); an SSM stack,
    and a hybrid, whose local attention no kernel takes, compute the same
    on both planes.  An encoder-decoder encodes ``batch["frames"]`` (one
    launch per encoder layer), then runs its decoder's layers, which write
    their self and cross entries: its decoder's self-attention goes through
    ``attention_op`` too, where the reference's prefill takes its XLA route.
    ``batch["positions"]`` as ``lm_hidden`` takes them: (B, S), or (B, 3, S)
    under M-RoPE, ``default_positions`` without them.  ``shd``: an
    ``AxisRules`` whose mesh runs the MoE expert-parallel (``lm._ffn``).
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    if cfg.encoder_decoder:
        enc = encode_audio(params, cfg, batch["frames"], plane=plane, shd=shd)
        cache = init_cache(cfg, B, max(S, pad_to or 0), x.dtype, x.device)
        x = _run_decoder_encdec(params, cfg, x, enc, plane=plane, caches=layer_caches(cfg, cache), shd=shd)
        cache["len"] = S
        return logits_fn(params, cfg, x[:, -1:])[:, 0], cache
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, tokens)
    rot = rotary(cfg, positions)
    cache = init_cache(cfg, B, max(S, pad_to or 0, attn_window(cfg)), x.dtype, x.device)
    for lp, kind, cl in zip(params.layers, cfg.layer_kinds(), layer_caches(cfg, cache)):
        x = _block_full(lp, cfg, kind, x, rot, plane=plane, cache_out=cl, shd=shd)
    cache["len"] = S
    logits = logits_fn(params, cfg, x[:, -1:])
    return logits[:, 0], cache


def _attn_block_step(lp, cfg: ArchConfig, x, kc, vc, pos: int, rot, shd=None):
    """x (B,1,D); kc/vc (B,S,KV,Dh), written in place at ``pos`` (at
    ``pos mod S`` in a hybrid's window ring); q and k rotated at ``rot``
    (``step_rotary``). Returns x'."""
    h = _attn_in(lp, cfg, x)
    q, k, v = attn_lib._project_qkv(lp.attn, cfg, h)
    q, k = _rope(cfg, q, rot), _rope(cfg, k, rot)
    out, _, _ = attn_lib.decode_attn_cached(q[:, 0], k[:, 0], v[:, 0], kc, vc, pos, ring=cfg.is_hybrid, shd=shd)
    return _block_out(lp, cfg, x, h, attn_lib._out_proj(lp.attn, out[:, None], x.dtype), shd)


def _block_step(lp, cfg: ArchConfig, kind: str, x, cl: Dict, pos: int, rot, shd=None):
    """One layer of a decode step on its cache views ``cl`` (the
    reference's ``_block_step``). Returns x'."""
    if kind == "ssm":
        y, _ = apply_ssm_step(lp.ssm, cfg, apply_norm(cfg.norm, lp.norm, x), cl)
        return x + y
    if kind == "rglru":
        y, _ = apply_rglru_step(lp.rglru, cfg, apply_norm(cfg.norm, lp.norm1, x), cl)
        x = x + y
        return x + apply_mlp(lp.mlp, cfg, apply_norm(cfg.norm, lp.norm2, x))
    return _attn_block_step(lp, cfg, x, cl["k"], cl["v"], pos, rot, shd)


def _dec_block_step(lp, cfg: ArchConfig, x, cl: Dict, pos: int, shd=None):
    """One decoder layer of an encoder-decoder's decode step: self-attention
    without rotary on its cache (written at ``pos``), cross-attention over
    every cached frame (no write), the MLP. Returns x'."""
    B = x.shape[0]
    q, k, v = attn_lib._project_qkv(lp.attn, cfg, apply_norm(cfg.norm, lp.norm1, x))
    out, _, _ = attn_lib.decode_attn_cached(q[:, 0], k[:, 0], v[:, 0], cl["k"], cl["v"], pos, shd=shd)
    x = x + attn_lib._out_proj(lp.attn, out[:, None], x.dtype)
    hx = apply_norm(cfg.norm, lp.norm_x, x)
    qx = hx @ lp.xattn.wq.to(x.dtype)
    if lp.xattn.bq is not None:
        qx = qx + lp.xattn.bq.to(x.dtype)
    xk = cl["xk"]
    out, _, _ = attn_lib.decode_attn_cached(qx.reshape(B, cfg.n_heads, cfg.head_dim), None, None, xk, cl["xv"],
                                            xk.shape[1], shd=shd)
    x = x + attn_lib._out_proj(lp.xattn, out[:, None], x.dtype)
    return x + apply_mlp(lp.mlp, cfg, apply_norm(cfg.norm, lp.norm2, x))


def step_rotary(cfg: ArchConfig, pos: int, batch):
    """The rotary of a decode step's token (``rotary``): at ``pos`` (B, 1),
    or under M-RoPE at ``batch["positions"]`` (B, 3), which is not the
    cache slot ``pos``: after an image, Qwen2-VL's text positions run behind
    the cache length (the reference's ``positions3``); without them, ``pos``
    for each of the three ids."""
    B, dev = batch["token"].shape[0], batch["token"].device
    positions = batch.get("positions") if cfg.mrope_sections is not None else None
    if positions is not None:
        ids = positions.to(device=dev, dtype=torch.int32)[:, :, None]
    else:
        ids = torch.full((B, 3, 1) if cfg.mrope_sections is not None else (B, 1), pos, dtype=torch.int32, device=dev)
    return rotary(cfg, ids)


def lm_decode_step(params: LM, cfg: ArchConfig, cache, batch, shd=None):
    """One-token decode. batch: {"token": (B,) int [, "positions": (B, 3)
    int under M-RoPE]}: the token's k and v go to cache slot ``len``, and
    its rotary is ``step_rotary``'s.

    Returns (logits (B,V), new cache); the new cache shares the given
    cache's arrays, which this step has written in place.  An MoE layer
    sees the step's B tokens as one call, as the reference's does, so its
    capacity is that of T = B.  ``shd``: an ``AxisRules`` whose mesh runs
    the MoE expert-parallel and, where ``kv_seq`` resolves to a mesh axis,
    the attention over a sequence-sharded cache
    (``attention.decode_attn_cached``)."""
    pos = int(cache["len"])
    x = embed_tokens(params, cfg, batch["token"][:, None])
    if cfg.encoder_decoder:
        x = x + _encdec_pos(pos, cfg.d_model, x)
        for lp, cl in zip(params.dec_layers, layer_caches(cfg, cache)):
            x = _dec_block_step(lp, cfg, x, cl, pos, shd)
    else:
        rot = step_rotary(cfg, pos, batch)
        for lp, kind, cl in zip(params.layers, cfg.layer_kinds(), layer_caches(cfg, cache)):
            x = _block_step(lp, cfg, kind, x, cl, pos, rot, shd)
    new_cache = dict(cache)
    new_cache["len"] = pos + 1
    logits = logits_fn(params, cfg, x)
    return logits[:, 0], new_cache


def _encdec_pos(pos: int, d: int, x):
    """The decoder's sinusoid at position ``pos`` (1, 1, d) in x's dtype,
    the table's row ``pos`` bit for bit."""
    return sinusoid_at(torch.tensor(float(pos), device=x.device), d).to(x.dtype)[None, None]
