"""GQA attention: projections, the O(S^2) reference, the scan-flash
online softmax, chunked local (sliding-window) attention and cached decode
attention over a prefix or a window's ring, port of
``repro.layers.attention``.

Serving's prefill attention runs through ``kernels.ops.attention_op`` (the
``flash_attention`` kernel on the ``"kernel"`` plane, ``naive_attention``
on the ``"torch"`` plane).  Training takes the reference's XLA route,
``naive_attention`` up to 512 tokens and ``flash_attention_xla`` above,
which autograd differentiates (the kernel has no backward).  Decode
attention is plain PyTorch, as in the reference, which has no decode
kernel.  Local attention takes the reference's XLA route on every plane
(``models.lm._attention``): no kernel takes a window.  So does an
encoder-decoder's cross-attention (``flash_attention_xla`` over the
encoder's states in the forward and prefill, ``decode_attn_cached``
without a write over all of them in decode), as in the reference.

Given an ``AxisRules`` whose ``kv_seq`` resolves to a mesh axis, decode
attention runs sequence-sharded (flash-decoding, the reference's
``shard_map`` branch): shard i of n holds cache positions [i S/n,
(i+1) S/n), each shard's partials (``_gqa_partials``) are computed on its
device and combined on the cache's device (``combine_partials``).  The
cache stays one tensor: a shard on the cache's device reads a view of it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import ParamSet
from repro_torch.sharding import P, dense_init, zeros_init


class Attention(ParamSet):
    """``wq`` (D, H*Dh), ``wk``/``wv`` (D, KV*Dh), ``wo`` (H*Dh, D), with
    ``qkv_bias`` ``bq``/``bk``/``bv`` and with ``mlp_bias`` ``bo`` (D,)."""

    NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")


def init_attn(key, cfg: ArchConfig, dtype=torch.float32, cross: bool = False) -> Attention:
    """The reference's draw, which ignores ``cross``: a decoder layer's
    cross-attention drawn from its self-attention's key holds the same
    values (ROADMAP.md C.13), in tensors of its own."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(key, "wq", (D, H * Dh), P("embed", "heads"), dtype),
        "wk": dense_init(key, "wk", (D, KV * Dh), P("embed", "kv_heads"), dtype),
        "wv": dense_init(key, "wv", (D, KV * Dh), P("embed", "kv_heads"), dtype),
        "wo": dense_init(key, "wo", (H * Dh, D), P("heads", "embed"), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init("bq", (H * Dh,), P("heads"), dtype, key.device)
        p["bk"] = zeros_init("bk", (KV * Dh,), P("kv_heads"), dtype, key.device)
        p["bv"] = zeros_init("bv", (KV * Dh,), P("kv_heads"), dtype, key.device)
    if cfg.mlp_bias:
        p["bo"] = zeros_init("bo", (D,), P("embed"), dtype, key.device)
    return Attention(p)


def _project_qkv(params: Attention, cfg: ArchConfig, x, kv_x=None):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S_kv,KV,Dh) of ``kv_x`` (B,S_kv,D),
    x itself unless given (a cross-attention's encoder states)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_x = x if kv_x is None else kv_x
    q = x @ params.wq.to(x.dtype)
    k = kv_x @ params.wk.to(x.dtype)
    v = kv_x @ params.wv.to(x.dtype)
    if params.bq is not None:
        q = q + params.bq.to(x.dtype)
        k = k + params.bk.to(x.dtype)
        v = v + params.bv.to(x.dtype)
    S_kv = kv_x.shape[1]
    return q.reshape(B, S, H, Dh), k.reshape(B, S_kv, KV, Dh), v.reshape(B, S_kv, KV, Dh)


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


def _mask(Sq: int, kpos, causal: bool, window: int, q_offset: int, device):
    """(Sq, len(kpos)) bool: key positions ``kpos`` each query may attend."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    mask = torch.ones((Sq, kpos.shape[0]), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos
    if window:
        mask &= kpos[None, :] > qpos - window
    return mask


def naive_attention(q, k, v, causal: bool, window: int = 0, q_offset: int = 0):
    """q (B,Sq,H,Dh), k/v (B,Sk,H,Dh) -> (B,Sq,H,Dh). float32 softmax;
    query i sits at position ``i + q_offset``, and with ``window`` attends
    only the keys less than ``window`` positions back."""
    Dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(Dh)
    if causal or window:
        kpos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(_mask(q.shape[1], kpos, causal, window, q_offset, q.device), s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def flash_attention_xla(q, k, v, *, causal: bool, window: int = 0, chunk: int = 1024, q_offset: int = 0):
    """Memory-bounded attention: online softmax over KV chunks of ``chunk``
    keys, masked with -1e30 (the reference's scan, as a Python loop that
    autograd differentiates; a last chunk that the reference pads is
    shorter here, which changes no unmasked term).

    q (B,Sq,H,Dh), k/v (B,Sk,H,Dh) with H already GQA-expanded.
    """
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    qT = q.transpose(1, 2)  # (B,H,Sq,Dh)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dh), dtype=torch.float32, device=q.device)
    for j in range(0, Sk, chunk):
        k_j, v_j = k[:, j : j + chunk].transpose(1, 2), v[:, j : j + chunk].transpose(1, 2)  # (B,H,C,Dh)
        s = torch.einsum("bhqd,bhcd->bhqc", qT, k_j).float() * scale
        if causal or window:
            kpos = torch.arange(j, j + k_j.shape[2], device=q.device)
            s = torch.where(_mask(Sq, kpos, causal, window, q_offset, q.device), s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bhcd->bhqd", p.to(v_j.dtype), v_j).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,H,Dh)


def local_attention_xla(q, k, v, *, window: int, causal: bool = True):
    """Chunked sliding-window attention. q/k/v (B,S,H,Dh), H pre-expanded.

    Each chunk of W = ``window`` queries attends to [the previous chunk,
    its own chunk], masked to the exact window (keys less than W positions
    back): O(S * 2W) memory and work.  A sequence of S <= W is
    ``naive_attention`` masked to the window.
    """
    B, S, H, Dh = q.shape
    W = window
    if S <= W:
        return naive_attention(q, k, v, causal=causal, window=W)
    n = -(-S // W)
    pad = (0, 0, 0, 0, 0, n * W - S)
    qc, kc, vc = (F.pad(t, pad).reshape(B, n, W, H, Dh) for t in (q, k, v))
    # [the previous chunk (zeros before the first), own chunk]: (B,n,2W,H,Dh)
    k2, v2 = (torch.cat([torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1), c], dim=2) for c in (kc, vc))
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qc, k2).float() / math.sqrt(Dh)
    qpos = torch.arange(W, device=q.device)[:, None] + W  # position within the [previous, own] frame
    kpos = torch.arange(2 * W, device=q.device)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones((W, 2 * W), dtype=torch.bool, device=q.device)
    mask = mask & (kpos > qpos - W)
    first = torch.arange(n, device=q.device)[:, None, None] > 0  # the first chunk has no previous one
    mask_n = mask[None] & (first | (kpos[None] >= W))  # (n, W, 2W)
    s = torch.where(mask_n[None, :, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p.to(v2.dtype), v2)
    return out.reshape(B, n * W, H, Dh)[:, :S]


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


def decode_attn_cached(q, k_new, v_new, k_cache, v_cache, cache_len: int, *, ring: bool = False, shd=None):
    """One-token attention against a KV cache, sequence-sharded when
    ``shd`` (an ``AxisRules``) resolves the cache's ``kv_seq`` axis to a
    mesh axis (``_decode_sharded``), whole otherwise.

    q (B,H,Dh) with rope applied; k_new/v_new (B,KV,Dh), or None for no
    write (a cross-attention over the encoder's cached states); k/v_cache
    (B,S,KV,Dh); ``cache_len`` the number of tokens before this one (a
    Python int).  Writes (k_new, v_new) at slot ``cache_len`` (``cache_len
    mod S`` for a window's ``ring``) **in place**, saving the reference's
    copy of the cache, and attends over the valid entries, the first
    ``min(cache_len + 1, S)`` (those the reference leaves unmasked; the
    first ``min(cache_len, S)`` without a write).
    Returns (out (B,H,Dh), k_cache, v_cache).
    """
    B, S, KV, Dh = k_cache.shape
    H = q.shape[1]
    qg = q.reshape(B, KV, H // KV, Dh)
    entry = shd.resolve(P("kv_seq"), (S,))[0] if shd is not None and shd.mesh is not None else None
    if entry is not None:
        out = _decode_sharded(shd.shard_devices(entry), qg, k_new, v_new, k_cache, v_cache, cache_len, ring)
        return out.reshape(B, H, Dh).to(q.dtype), k_cache, v_cache
    if k_new is not None:
        slot = cache_len % S if ring else min(max(cache_len, 0), S - 1)
        k_cache[:, slot] = k_new
        v_cache[:, slot] = v_new
    n_valid = min(cache_len + (k_new is not None), S)
    num, den, _ = _gqa_partials(qg, k_cache[:, :n_valid], v_cache[:, :n_valid])
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype), k_cache, v_cache


def _decode_sharded(devices, qg, k_new, v_new, k_cache, v_cache, cache_len: int, ring: bool):
    """The reference's sequence-sharded decode over len(devices) shards of
    the cache's S positions, shard i at positions [i S/n, (i+1) S/n) on
    ``devices[i]``: the new token goes into the shard that owns slot
    ``cache_len`` (mod S for a ring; past the cache, none), then each shard
    with valid entries computes its partials, (num, den, m) (B,KV,rep,...),
    over them.  A shard with none is skipped: the reference's partials of a
    fully masked shard carry the weight exp(-1e30 - m) = 0, so it adds
    exact zeros.  The partials are combined on the cache's device in shard
    order.  Returns the combined output (B,KV,rep,Dh) float32."""
    S = k_cache.shape[1]
    s_local = S // len(devices)
    if k_new is not None:
        slot = cache_len % S if ring else cache_len
        if 0 <= slot < S:  # written into the owning shard's view
            k_cache[:, slot] = k_new
            v_cache[:, slot] = v_new
    n_valid = min(cache_len + (k_new is not None), S)
    home = k_cache.device
    parts = []
    for i, dev in enumerate(devices):
        lo = i * s_local
        hi = min(lo + s_local, n_valid)
        if hi <= lo:
            continue
        num, den, m = _gqa_partials(qg.to(dev), k_cache[:, lo:hi].to(dev), v_cache[:, lo:hi].to(dev))
        parts.append((num.to(home), den.to(home), m.to(home)))
    return combine_partials(parts)


def decode_attention_local(q, k_cache, v_cache, cache_len, *, pos_offset=0):
    """Partial attention over a local cache chunk; returns (num, denom, max).

    q (B,H,Dh); k/v_cache (B,C,H,Dh) — H pre-expanded.  Entries at global
    position >= cache_len (the chunk starting at ``pos_offset``) are masked
    with -1e30, as the reference masks them.  Returns float32 partials for
    ``combine_partials``."""
    Dh = q.shape[-1]
    s = torch.einsum("bhd,bchd->bhc", q, k_cache).float() / math.sqrt(Dh)
    pos = torch.arange(k_cache.shape[1], device=q.device) + pos_offset
    s = torch.where((pos < cache_len)[None, None, :], s, -1e30)
    m = s.amax(-1)  # (B,H)
    p = torch.exp(s - m[..., None])
    den = p.sum(-1)
    num = torch.einsum("bhc,bchd->bhd", p.to(v_cache.dtype), v_cache).float()
    return num, den, m


def combine_partials(parts):
    """lse-weighted combine of partial attention, the reference's
    ``combine_partials`` over a mesh axis: ``parts`` is each shard's (num,
    den, m), in shard order, on one device.  The global max g_m, then each
    shard's num and den times exp(m - g_m), summed in shard order, then
    num / den.  One shard's partials give num / den (the reference's
    ``axis_name=None``): its correction is exp(0) = 1."""
    g_m = parts[0][2]
    for _, _, m in parts[1:]:
        g_m = torch.maximum(g_m, m)
    num = den = None
    for n_i, d_i, m_i in parts:
        corr = torch.exp(m_i - g_m)
        num = n_i * corr[..., None] if num is None else num + n_i * corr[..., None]
        den = d_i * corr if den is None else den + d_i * corr
    return num / torch.clamp(den, min=1e-30)[..., None]
