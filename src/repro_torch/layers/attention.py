"""GQA attention: projections, the O(S^2) reference and cached decode
attention, port of ``repro.layers.attention``.

Prefill attention runs through ``kernels.ops.attention_op`` (the
``flash_attention`` kernel on the ``"kernel"`` plane, ``naive_attention``
on the ``"torch"`` plane); the reference's scan-flash ``flash_attention_xla``
computes the same function, and the kernel's plain version stands in for it.
Decode attention is plain PyTorch, as in the reference, which has no decode
kernel.  The sequence-sharded decode branch, ``local_attention_xla`` and the
cross-attention paths wait (ROADMAP.md A.12).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import ParamSet
from repro_torch.sharding import dense_init, zeros_init


class Attention(ParamSet):
    """``wq`` (D, H*Dh), ``wk``/``wv`` (D, KV*Dh), ``wo`` (H*Dh, D), with
    ``qkv_bias`` ``bq``/``bk``/``bv`` and with ``mlp_bias`` ``bo`` (D,)."""

    NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")


def init_attn(key, cfg: ArchConfig, dtype=torch.float32) -> Attention:
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(key, "wq", (D, H * Dh), dtype),
        "wk": dense_init(key, "wk", (D, KV * Dh), dtype),
        "wv": dense_init(key, "wv", (D, KV * Dh), dtype),
        "wo": dense_init(key, "wo", (H * Dh, D), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init("bq", (H * Dh,), dtype, key.device)
        p["bk"] = zeros_init("bk", (KV * Dh,), dtype, key.device)
        p["bv"] = zeros_init("bv", (KV * Dh,), dtype, key.device)
    if cfg.mlp_bias:
        p["bo"] = zeros_init("bo", (D,), dtype, key.device)
    return Attention(p)


def _project_qkv(params: Attention, cfg: ArchConfig, x):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params.wq.to(x.dtype)
    k = x @ params.wk.to(x.dtype)
    v = x @ params.wv.to(x.dtype)
    if params.bq is not None:
        q = q + params.bq.to(x.dtype)
        k = k + params.bk.to(x.dtype)
        v = v + params.bv.to(x.dtype)
    return q.reshape(B, S, H, Dh), k.reshape(B, S, KV, Dh), v.reshape(B, S, KV, Dh)


def _out_proj(params: Attention, x_attn, dtype):
    """(B,S,H,Dh) -> (B,S,D)."""
    B, S, H, Dh = x_attn.shape
    out = x_attn.reshape(B, S, H * Dh) @ params.wo.to(dtype)
    if params.bo is not None:
        out = out + params.bo.to(dtype)
    return out


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,KV,Dh) -> (B,S,KV*n_rep,Dh)."""
    if n_rep == 1:
        return k
    B, S, KV, Dh = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, Dh).reshape(B, S, KV * n_rep, Dh)


def naive_attention(q, k, v, causal: bool):
    """q (B,Sq,H,Dh), k/v (B,Sk,H,Dh) -> (B,Sq,H,Dh). float32 softmax."""
    Dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(Dh)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = torch.arange(Sk, device=q.device)[None, :] <= torch.arange(Sq, device=q.device)[:, None]
        s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _gqa_partials(q, k_cache, v_cache):
    """GQA partial attention without head expansion, over every cache entry
    given.

    q (B,KV,rep,Dh); k/v_cache (B,C,KV,Dh).
    Returns float32 (num (B,KV,rep,Dh), den (B,KV,rep), m (B,KV,rep)).
    """
    Dh = q.shape[-1]
    s = torch.einsum("bkrd,bckd->bkrc", q, k_cache).float() / math.sqrt(Dh)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    den = p.sum(-1)
    num = torch.einsum("bkrc,bckd->bkrd", p.to(v_cache.dtype), v_cache).float()
    return num, den, m


def decode_attn_cached(q, k_new, v_new, k_cache, v_cache, cache_len: int):
    """One-token attention against an unsharded KV cache.

    q (B,H,Dh) with rope applied; k_new/v_new (B,KV,Dh); k/v_cache
    (B,S,KV,Dh); ``cache_len`` the number of valid entries before this step
    (a Python int).  Writes (k_new, v_new) at ``cache_len`` **in place**,
    saving the reference's copy of the cache, and attends over the valid
    prefix (the entries the reference leaves unmasked).  Returns
    (out (B,H,Dh), k_cache, v_cache).
    """
    B, S, KV, Dh = k_cache.shape
    H = q.shape[1]
    slot = min(max(cache_len, 0), S - 1)
    k_cache[:, slot] = k_new
    v_cache[:, slot] = v_new
    n_valid = min(cache_len + 1, S)
    num, den, _ = _gqa_partials(q.reshape(B, KV, H // KV, Dh), k_cache[:, :n_valid], v_cache[:, :n_valid])
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype), k_cache, v_cache
