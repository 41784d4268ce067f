"""The LM (port of ``repro.models.lm``: attention stacks with a dense MLP
or an MoE FFN, Mamba-1 SSM stacks, the hybrid's cycle of RG-LRU and
local-attention blocks, and the audio encoder-decoder).

Parameters are ``nn.Module``s whose names follow the reference's parameter
tree, one module per layer where the reference stacks layers on a leading
axis: ``layers.{l}.attn.wq`` is the reference's ``layers/attn/wq[l]`` (a
hybrid's layer P l + j is its ``groups/g{j}_{kind}/…[l]`` for a pattern of
length P, and its tail layers follow the groups; an encoder-decoder's are
``enc_layers.{l}.…`` and ``dec_layers.{l}.…``), so ``convert`` is a name
map.  The functions mirror the reference's
(``lm_apply(params, cfg, batch, shd=...)``: the sharding rules are a
keyword, None for one device) and take a ``plane`` for attention: a kernel
plane (``kernels.ops.attention_op``, for serving) or ``TRAIN``, the
reference's XLA route that autograd differentiates.  Parameters are built
frozen, for serving; training turns them on with ``LM.requires_grad_()``
(``train.steps`` does) and runs ``lm_loss``, whose blocks are checkpointed
as ``cfg.remat`` says.

Position ids are (B, S), or (B, 3, S) under M-RoPE (qwen2-vl: the
temporal, height and width ids of each token); the layers take them as
``rotary`` makes them.  A hybrid pattern of block kinds the port does not
run raises ``NotImplementedError``.

Every leaf that ``init_lm`` builds keeps its logical spec (the reference's
``Param`` specs): ``named_specs`` lists them by parameter name, and
``param_specs`` gives the reference's tree of specs, from an ``init_lm`` on
the ``meta`` device, which draws and allocates nothing.  The forward, the
loss and the blocks of prefill and decode (``models/decode``) take an
``AxisRules`` (``shd``) for the MoE FFN: with a ``model`` mesh axis of n > 1
that divides the experts it runs expert-parallel
(``layers/moe.apply_moe``), under autograd and its checkpoints too; any
other ``shd`` computes what None computes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.attention import Attention
from repro_torch.layers.common import (
    Norm, apply_norm, apply_rope, frozen_parameter, init_norm, mrope_rotation, rotate_halves, sinusoidal_positions,
)
from repro_torch.layers.mlp import MLP, apply_mlp, init_mlp
from repro_torch.layers.moe import MoE, apply_moe, init_moe
from repro_torch.layers.rglru import RGLRU, apply_rglru, init_rglru
from repro_torch.layers.ssm import SSM, apply_ssm, init_ssm
from repro_torch.sharding import P, dense_init, name_key


def resolve_device(device) -> torch.device:
    """``"cuda"`` (the default of every entry point) or ``"cpu"``; refuses
    CUDA on a machine without it instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: pass a 'cuda' or 'cpu' device")
    return dev


HYBRID_KINDS = ("attn", "rglru")  # the block kinds a hybrid's pattern may cycle through


def check_ported(cfg: ArchConfig) -> None:
    """Raise for the families whose blocks are not ported yet."""
    if cfg.is_hybrid and not set(cfg.block_pattern) <= set(HYBRID_KINDS):
        raise NotImplementedError(f"{cfg.name}: a hybrid pattern {cfg.block_pattern} of other kinds than "
                                  f"{HYBRID_KINDS} is not ported")


class Block(nn.Module):
    """One decoder layer: ``norm1``, ``attn``, ``norm2`` and the FFN under
    the reference's name, ``moe`` for an MoE config and ``mlp`` otherwise (a
    parallel block has one ``norm``); an SSM layer is ``norm`` and ``ssm``;
    an RG-LRU layer ``norm1``, ``rglru``, ``norm2`` and ``mlp``; an
    encoder-decoder's decoder layer ``norm1``, ``attn``, ``norm_x``,
    ``xattn`` (its cross-attention), ``norm2`` and ``mlp``."""

    def __init__(self, parts: Dict[str, nn.Module]):
        super().__init__()
        for name, mod in parts.items():
            setattr(self, name, mod)


class LM(nn.Module):
    """``embed`` (V, D), ``final_norm``, ``lm_head`` (D, V) unless tied, and
    ``layers``, one :class:`Block` each.  An encoder-decoder holds them as
    ``dec_layers``, and its encoder as ``enc_layers`` and ``enc_norm`` (the
    reference's tree has no ``layers`` there)."""

    def __init__(self, cfg: ArchConfig, embed, final_norm: Norm, lm_head: Optional[torch.Tensor], layers: List[Block],
                 enc_layers: Optional[List[Block]] = None, enc_norm: Optional[Norm] = None):
        super().__init__()
        self.cfg = cfg
        self.specs = {}  # the logical specs of embed and lm_head, given as Params
        self.embed = frozen_parameter(self.specs, "embed", embed)
        self.final_norm = final_norm
        self.lm_head = frozen_parameter(self.specs, "lm_head", lm_head)
        if cfg.encoder_decoder:
            self.enc_layers = nn.ModuleList(enc_layers)
            self.enc_norm = enc_norm
            self.dec_layers = nn.ModuleList(layers)
        else:
            self.layers = nn.ModuleList(layers)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _ffn_name(cfg: ArchConfig) -> str:
    return "moe" if cfg.is_moe else "mlp"


def _block(cfg: ArchConfig, norms: List[Norm], attn: Attention, ffn: nn.Module) -> Block:
    if cfg.parallel_block:
        return Block({"norm": norms[0], "attn": attn, _ffn_name(cfg): ffn})
    return Block({"norm1": norms[0], "attn": attn, "norm2": norms[1], _ffn_name(cfg): ffn})


def _init_layer(key, cfg: ArchConfig, kind: str, dtype) -> Block:
    if kind == "ssm":
        return Block({"norm": init_norm(cfg.norm, cfg.d_model, dtype, key.device), "ssm": init_ssm(key, cfg, dtype)})
    if kind == "rglru":
        norm = lambda: init_norm(cfg.norm, cfg.d_model, dtype, key.device)  # noqa: E731
        return Block({"norm1": norm(), "rglru": init_rglru(key, cfg, dtype), "norm2": norm(),
                      "mlp": init_mlp(key, cfg, dtype)})
    norms = [init_norm(cfg.norm, cfg.d_model, dtype, key.device) for _ in range(1 if cfg.parallel_block else 2)]
    ffn = init_moe(key, cfg, dtype) if cfg.is_moe else init_mlp(key, cfg, dtype)
    return _block(cfg, norms, attn_lib.init_attn(key, cfg, dtype), ffn)


def _init_dec_layer(key, cfg: ArchConfig, dtype) -> Block:
    """An encoder-decoder's decoder layer.  The reference draws ``xattn``
    from ``attn``'s key and names, so the two hold equal values (ROADMAP.md
    C.13); here they are separate tensors, as the reference's two leaves
    are, which part at the first optimizer step."""
    norm = lambda: init_norm(cfg.norm, cfg.d_model, dtype, key.device)  # noqa: E731
    return Block({"norm1": norm(), "attn": attn_lib.init_attn(key, cfg, dtype), "norm_x": norm(),
                  "xattn": attn_lib.init_attn(key, cfg, dtype, cross=True), "norm2": norm(),
                  "mlp": init_mlp(key, cfg, dtype)})


def layer_keys(key, cfg: ArchConfig) -> torch.Tensor:
    """(L, 2): each layer's init key, as the reference's ``_stack_init``
    vmaps them: layer l's is ``split(name_key(key, "layers"), L)[l]``; a
    hybrid's layer P l + j (P the pattern's length) is
    ``split(name_key(key, f"grp{j}"), n_full)[l]`` and its tail layer i's
    ``name_key(key, f"tail{i}")``; an encoder-decoder's decoder layer l's is
    ``split(name_key(key, "dec"), L)[l]`` (its encoder layer l's,
    ``split(name_key(key, "enc"), L_enc)[l]``, is drawn in ``init_lm``)."""
    if cfg.encoder_decoder:
        return prng.split(name_key(key, "dec"), cfg.n_layers)
    if not cfg.is_hybrid:
        return prng.split(name_key(key, "layers"), cfg.n_layers)
    P = len(cfg.block_pattern)
    n_full, rem = divmod(cfg.n_layers, P)
    groups = torch.stack([prng.split(name_key(key, f"grp{j}"), n_full) for j in range(P)], dim=1)  # (n_full, P, 2)
    tail = [name_key(key, f"tail{i}") for i in range(rem)]
    return torch.cat([groups.reshape(n_full * P, 2)] + [t[None] for t in tail])


def init_lm(key, cfg: ArchConfig, dtype=torch.float32, *, device="cuda") -> LM:
    """The reference's ``init_lm`` from a ``prng.prng_key``: every tensor is
    drawn on ``device`` from the same per-name keys (``layer_keys``), so a
    seed gives the reference's weights (``prng.truncated_normal``).  On
    ``device="meta"`` it draws nothing: the leaves' shapes, dtypes and
    specs (``param_specs``)."""
    check_ported(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    key = key.to(dev)
    V, D = cfg.vocab_size, cfg.d_model
    # embed table: vocab-sharded only (an fsdp axis on D would force gathers in the reference's sharded lookup)
    embed = dense_init(key, "embed", (V, D), P("vocab", None), dtype, scale=0.02)
    final_norm = init_norm(cfg.norm, D, dtype, dev)
    lm_head = None if cfg.tie_embeddings else dense_init(key, "lm_head", (D, V), P(("embed", "fsdp"), "vocab"), dtype)
    keys = layer_keys(key, cfg)
    if cfg.encoder_decoder:
        enc = [_init_layer(k, cfg, "attn", dtype) for k in prng.split(name_key(key, "enc"), cfg.n_enc_layers)]
        return LM(cfg, embed, final_norm, lm_head, [_init_dec_layer(k, cfg, dtype) for k in keys],
                  enc, init_norm(cfg.norm, D, dtype, dev))
    layers = [_init_layer(keys[i], cfg, kind, dtype) for i, kind in enumerate(cfg.layer_kinds())]
    return LM(cfg, embed, final_norm, lm_head, layers)


def named_specs(model: LM) -> Dict[str, P]:
    """The logical spec of every leaf an initialiser built, by the name
    ``model.state_dict()`` gives it (``layers.0.attn.wq``: one layer's, with
    no layer axis)."""
    return {f"{prefix}.{name}" if prefix else name: spec
            for prefix, mod in model.named_modules() for name, spec in getattr(mod, "specs", {}).items()}


def param_specs(cfg: ArchConfig, dtype=torch.float32):
    """(the reference's tree of ``meta`` tensors, its tree of logical specs)
    for ``cfg``, from an ``init_lm`` on the ``meta`` device: no draw and no
    allocation (all 61 layers of kimi-k2 hold 1.03 T parameters).  A leaf
    stacked over layers takes a leading None (the reference's
    ``_stack_init``); a hybrid's tail leaves do not."""
    from repro_torch import convert  # convert builds LMs: imported here, not at the top

    model = init_lm(prng.prng_key(0), cfg, dtype, device="meta")
    specs = named_specs(model)
    state = model.state_dict()
    if set(specs) != set(state):
        raise AssertionError(f"{cfg.name}: leaves without a spec {sorted(set(state) - set(specs))}")
    shapes = convert.stack_named(state, cfg)
    return shapes, convert.stack_named(specs, cfg, stack=lambda ss: P(None, *ss[0]))


def lm_from_state(cfg: ArchConfig, state: Dict[str, torch.Tensor]) -> LM:
    """An :class:`LM` from a flat name -> tensor map with the names of
    ``LM.state_dict()`` (``embed``, ``layers.0.attn.wq``, ...)."""
    check_ported(cfg)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    def norm(prefix):
        return Norm(cfg.norm, sub(prefix))

    def attn_block(p):
        names = ("norm",) if cfg.parallel_block else ("norm1", "norm2")
        ffn = (MoE if cfg.is_moe else MLP)(sub(p + _ffn_name(cfg) + "."))
        return _block(cfg, [norm(p + n + ".") for n in names], Attention(sub(p + "attn.")), ffn)

    if cfg.encoder_decoder:
        enc = [attn_block(f"enc_layers.{i}.") for i in range(cfg.n_enc_layers)]
        dec = [Block({"norm1": norm(p + "norm1."), "attn": Attention(sub(p + "attn.")), "norm_x": norm(p + "norm_x."),
                      "xattn": Attention(sub(p + "xattn.")), "norm2": norm(p + "norm2."), "mlp": MLP(sub(p + "mlp."))})
               for p in (f"dec_layers.{i}." for i in range(cfg.n_layers))]
        return LM(cfg, state["embed"], norm("final_norm."), state.get("lm_head"), dec, enc, norm("enc_norm."))
    layers = []
    for i, kind in enumerate(cfg.layer_kinds()):
        p = f"layers.{i}."
        if kind == "ssm":
            layers.append(Block({"norm": norm(p + "norm."), "ssm": SSM(sub(p + "ssm."))}))
            continue
        if kind == "rglru":
            layers.append(Block({"norm1": norm(p + "norm1."), "rglru": RGLRU(sub(p + "rglru.")),
                                 "norm2": norm(p + "norm2."), "mlp": MLP(sub(p + "mlp."))}))
            continue
        layers.append(attn_block(p))
    return LM(cfg, state["embed"], norm("final_norm."), state.get("lm_head"), layers)


# ---------------------------------------------------------------------------
# Block bodies (full sequence)
# ---------------------------------------------------------------------------


def rotary(cfg: ArchConfig, positions):
    """What the layers' ``_rope`` takes for position ids: the ids (B, S)
    themselves, or under M-RoPE the (cos, sin) of ids (B, 3, S), made once
    for every layer's q and k (``mrope_rotation``; the reference makes the
    same values in each call)."""
    if cfg.mrope_sections is None:
        return positions
    return mrope_rotation(positions, cfg.mrope_sections, cfg.rope_theta, cfg.head_dim)


def _rope(cfg: ArchConfig, x, positions):
    """x (B, S, H, Dh) rotated at ``rotary(cfg, ids)``."""
    if cfg.mrope_sections is not None:
        return rotate_halves(x, *positions)
    return apply_rope(x, positions, cfg.rope_pct, cfg.rope_theta)


def _attn_in(lp: Block, cfg: ArchConfig, x):
    """The attention's input: the block's first norm of x."""
    return apply_norm(cfg.norm, lp.norm if cfg.parallel_block else lp.norm1, x)


def _ffn(lp: Block, cfg: ArchConfig, x, shd=None):
    """The block's FFN: the MoE for an MoE config (expert-parallel on
    ``shd``'s mesh, ``apply_moe``), the MLP otherwise."""
    if cfg.is_moe:
        return apply_moe(lp.moe, cfg, x, shd)
    return apply_mlp(lp.mlp, cfg, x)


def _block_out(lp: Block, cfg: ArchConfig, x, h, attn_out, shd=None):
    """The block's output from its input x, the normed h and the attention's
    output: a parallel block adds the FFN of h, a sequential one the FFN of
    its second norm after the attention's residual."""
    if cfg.parallel_block:
        return x + attn_out + _ffn(lp, cfg, h, shd)
    x = x + attn_out
    return x + _ffn(lp, cfg, apply_norm(cfg.norm, lp.norm2, x), shd)


TRAIN = "train"  # the attention route of training (``_attention``)


def _attention(q, k, v, plane, window: int = 0, causal: bool = True):
    """Self-attention on ``plane``, causal unless told (an encoder's is
    not); ``TRAIN`` takes the reference's route without the Pallas kernel
    (``repro.models.lm._attn_full``): ``naive_attention`` up to 512 tokens,
    ``flash_attention_xla`` above.  Local attention (``window``) takes the
    reference's route on every plane, as its kernel takes no window:
    ``local_attention_xla`` past the window, else ``naive_attention`` or
    ``flash_attention_xla`` masked to it."""
    S = q.shape[1]
    if window and S > window:
        return attn_lib.local_attention_xla(q, k, v, window=window, causal=causal)
    if plane != TRAIN and not window:
        return ops.attention_op(q, k, v, causal=causal, plane=plane)
    if S <= 512:
        return attn_lib.naive_attention(q, k, v, causal=causal, window=window)
    return attn_lib.flash_attention_xla(q, k, v, causal=causal, window=window)


def write_kv(cache_out, k, v):
    """Prefill's cache entry: token p's k and v at slot p mod n of the
    (B, n, KV, Dh) views ``cache_out``, so the first S slots for S <= n,
    and for a window's ring of n < S slots the last n tokens where decode
    expects them (the reference keeps ``k[:, S - n:]`` in slots 0.., which
    its decode then overwrites out of order: ROADMAP.md C.12)."""
    S, n = k.shape[1], cache_out["k"].shape[1]
    r = S % n if S > n else 0
    for name, t in (("k", k), ("v", v)):
        last = t[:, max(S - n, 0):]
        cache_out[name][:, r : r + last.shape[1]] = last[:, : last.shape[1] - r]
        cache_out[name][:, :r] = last[:, last.shape[1] - r :]


def _attn_full(lp: Attention, cfg: ArchConfig, x, positions, *, plane=ops.AUTO, window: int = 0, cache_out=None,
               causal: bool = True, use_rope: bool = True):
    """Self-attention over x (B,S,D), causal unless told, within ``window``
    positions when it is set, rotated at ``positions`` (``rotary(cfg,
    ids)``) unless ``use_rope`` is False.  With
    ``cache_out`` (this layer's (B, n, KV, Dh) cache views, zeroed) k and v
    are written as ``write_kv`` places them: that is prefill's cache entry
    (the reference pads each layer's entry and stacks them; ``_pad_entry``)."""
    q, k, v = attn_lib._project_qkv(lp, cfg, x)
    if use_rope:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    if cache_out is not None:
        write_kv(cache_out, k, v)
    k = attn_lib.repeat_kv(k, cfg.n_rep)
    v = attn_lib.repeat_kv(v, cfg.n_rep)
    return attn_lib._out_proj(lp, _attention(q, k, v, plane, window, causal), x.dtype)


def attn_window(cfg: ArchConfig) -> int:
    """The window of the config's attention layers: a hybrid's local
    window, 0 (the whole causal prefix) otherwise."""
    return cfg.local_window if cfg.is_hybrid else 0


def _block_full(lp: Block, cfg: ArchConfig, kind: str, x, positions, *, plane=ops.AUTO, cache_out=None,
                causal: bool = True, shd=None):
    """One block of ``kind`` (``cfg.layer_kinds()``) over a full sequence,
    causal unless told (an encoder's block is not). x (B,S,D).  With
    ``cache_out``, this layer's cache views, the block also writes its
    prefill cache entry: an attention block its k/v
    (``_attn_full``), an SSM or RG-LRU block its final state h and conv
    tail (the reference's ``_attn_block_prefill``).  The recurrent blocks
    compute the same on every plane and take no positions.  ``shd``: the
    MoE's ``AxisRules`` (``_ffn``)."""
    if kind in ("ssm", "rglru"):
        ssm = kind == "ssm"
        apply, params = (apply_ssm, lp.ssm) if ssm else (apply_rglru, lp.rglru)
        h = apply_norm(cfg.norm, lp.norm if ssm else lp.norm1, x)
        if cache_out is None:
            y = apply(params, cfg, h)
        else:
            y, st = apply(params, cfg, h, return_state=True)
            cache_out["h"].copy_(st["h"])
            cache_out["conv"].copy_(st["conv"])
        x = x + y
        return x if ssm else x + apply_mlp(lp.mlp, cfg, apply_norm(cfg.norm, lp.norm2, x))
    h = _attn_in(lp, cfg, x)
    attn_out = _attn_full(lp.attn, cfg, h, positions, plane=plane, window=attn_window(cfg), cache_out=cache_out,
                          causal=causal)
    return _block_out(lp, cfg, x, h, attn_out, shd)


def _save_weight_products(ctx, op, *args, **kwargs):
    """``save_attn``'s policy, the counterpart of JAX's
    ``checkpoint_dots_with_no_batch_dims``: keep the products with the
    weights (``x @ W`` folds into one ``mm``, the MoE router's too),
    recompute the rest: the attention's and the experts' batched products
    (``bmm``), and the SSM's scan and readout (a product and a sum, as JAX
    recomputes that batched einsum)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f, cfg: ArchConfig):
    """f with ``cfg.remat``'s rematerialisation: ``"none"`` keeps every
    activation, ``"full"`` keeps the block's input and recomputes the rest
    in the backward, ``"save_attn"`` also keeps the weight products."""
    if cfg.remat == "none":
        return f
    if cfg.remat == "save_attn":
        return lambda *a, **kw: checkpoint(
            f, *a, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_save_weight_products), **kw)
    if cfg.remat == "full":
        return lambda *a, **kw: checkpoint(f, *a, use_reentrant=False, **kw)
    raise ValueError(f"remat={cfg.remat!r}: pass 'full', 'save_attn' or 'none'")


def _run_stack(params: LM, cfg: ArchConfig, x, positions, *, plane=ops.AUTO, shd=None):
    """The decoder stack over x (B,S,D), layer by layer; while autograd
    records, each block runs under ``cfg.remat``.  ``shd``: the MoE's
    ``AxisRules`` (``_ffn``)."""
    block = _remat(_block_full, cfg) if torch.is_grad_enabled() else _block_full
    for lp, kind in zip(params.layers, cfg.layer_kinds()):
        x = block(lp, cfg, kind, x, positions, plane=plane, shd=shd)
    return x


# ---------------------------------------------------------------------------
# The encoder-decoder (stub audio frontend: inputs are frame embeddings)
# ---------------------------------------------------------------------------


def encode_audio(params: LM, cfg: ArchConfig, frames, *, plane=ops.AUTO, shd=None):
    """frames (B, T_enc, D) -> the encoder's states: the sinusoid added,
    then ``enc_layers``' non-causal attention blocks (rotary, as the
    reference's: ROADMAP.md C.14; on a kernel plane the ``flash_attention``
    kernel, one launch a layer), then ``enc_norm``.  ``shd`` reaches the
    blocks (``_block_full``)."""
    T = frames.shape[1]
    x = frames + sinusoidal_positions(T, cfg.d_model, frames.device).to(frames.dtype)[None]
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)[None]
    block = _remat(_block_full, cfg) if torch.is_grad_enabled() else _block_full
    for lp in params.enc_layers:
        x = block(lp, cfg, "attn", x, positions, plane=plane, causal=False, shd=shd)
    return apply_norm(cfg.norm, params.enc_norm, x)


def cross_attention(lp: Attention, cfg: ArchConfig, x, enc, cache_out=None):
    """x (B,S,D) attends to all of the encoder's states enc (B,T,D) on the
    reference's route on every plane (``flash_attention_xla``, not causal).
    With ``cache_out`` (this layer's (B, T, KV, Dh) ``xk``/``xv`` views) the
    projected k and v are written there: prefill's cross cache."""
    q, k, v = attn_lib._project_qkv(lp, cfg, x, kv_x=enc)
    if cache_out is not None:
        cache_out["xk"].copy_(k)
        cache_out["xv"].copy_(v)
    k, v = attn_lib.repeat_kv(k, cfg.n_rep), attn_lib.repeat_kv(v, cfg.n_rep)
    return attn_lib._out_proj(lp, attn_lib.flash_attention_xla(q, k, v, causal=False), x.dtype)


def _dec_block_full(lp: Block, cfg: ArchConfig, x, enc, *, plane=ops.AUTO, cache_out=None):
    """One decoder layer over x (B,S,D): causal self-attention without
    rotary (through ``attention_op`` on a kernel plane), cross-attention to
    the encoder's states, the MLP.  With ``cache_out`` (this layer's self
    ``k``/``v`` and cross ``xk``/``xv`` views) it writes its prefill cache
    entry."""
    h = apply_norm(cfg.norm, lp.norm1, x)
    x = x + _attn_full(lp.attn, cfg, h, None, plane=plane, cache_out=cache_out, use_rope=False)
    x = x + cross_attention(lp.xattn, cfg, apply_norm(cfg.norm, lp.norm_x, x), enc, cache_out)
    return x + apply_mlp(lp.mlp, cfg, apply_norm(cfg.norm, lp.norm2, x))


def _run_decoder_encdec(params: LM, cfg: ArchConfig, x, enc, *, plane=ops.AUTO, caches=None, shd=None):
    """The decoder over the token embeddings x (B,S,D): the sinusoid of
    positions 0..S-1 added (the reference's stand-in for whisper's learned
    table), then ``dec_layers``.  With ``caches`` (each layer's cache views,
    ``decode.layer_caches``) each layer writes its prefill entry.  ``shd``
    is taken as the reference takes it: a decoder layer's FFN is the dense
    MLP, on which the rules change no value (``AxisRules.constrain``)."""
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    if caches is not None:
        for lp, cl in zip(params.dec_layers, caches):
            x = _dec_block_full(lp, cfg, x, enc, plane=plane, cache_out=cl)
        return x
    block = _remat(_dec_block_full, cfg) if torch.is_grad_enabled() else _dec_block_full
    for lp in params.dec_layers:
        x = block(lp, cfg, x, enc, plane=plane)
    return x


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(params: LM, cfg: ArchConfig, tokens):
    """Table lookup: tokens (B,S) -> (B,S,D), on every mesh.  The
    reference's vocab-sharded lookup on a mesh (a masked gather per vocab
    shard and a ``psum``) adds the one shard's row that holds a token to
    zeros from the others: the same values as the whole lookup, and the
    same gradient, each token's output gradient added into its looked-up
    row (the masked gathers' transpose scatters into the owning shard's
    rows, the others' are masked to zero)."""
    return F.embedding(tokens, params.embed)


def logits_fn(params: LM, cfg: ArchConfig, x):
    x = apply_norm(cfg.norm, params.final_norm, x)
    w = params.embed.t() if cfg.tie_embeddings else params.lm_head
    return x @ w.to(x.dtype)


def default_positions(cfg: ArchConfig, tokens):
    """The position ids of a batch that brings none: 0..S-1 (B, S), and
    under M-RoPE the text-only layout, 0..S-1 for each of the three ids
    (B, 3, S), as the reference's serve passes them and its decode falls
    back to (its own forward and prefill default to (B, S) there, which
    its ``apply_mrope`` reads as (..., 3, S): ROADMAP.md C.15)."""
    B, S = tokens.shape
    ids = torch.arange(S, dtype=torch.int32, device=tokens.device)
    return ids.expand(B, 3, S) if cfg.mrope_sections is not None else ids.expand(B, S)


def lm_hidden(params: LM, cfg: ArchConfig, batch, *, plane=ops.AUTO, shd=None):
    """Backbone forward -> final hidden states (B,S,D); an encoder-decoder
    encodes ``batch["frames"]`` first.  ``batch["positions"]``: (B, S), or
    (B, 3, S) under M-RoPE; ``default_positions`` without it.  ``shd``: the
    ``AxisRules`` of a mesh (None: one device), which an MoE FFN runs on
    (``_ffn``)."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    if cfg.encoder_decoder:
        enc = encode_audio(params, cfg, batch["frames"], plane=plane, shd=shd)
        return _run_decoder_encdec(params, cfg, x, enc, plane=plane, shd=shd)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, tokens)
    return _run_stack(params, cfg, x, rotary(cfg, positions), plane=plane, shd=shd)


def lm_apply(params: LM, cfg: ArchConfig, batch, *, plane=ops.AUTO, shd=None):
    """Full forward -> logits (B,S,V). batch: tokens (+positions (B, S), or
    (B, 3, S) under M-RoPE, or the frames (B, T_enc, D) of an
    encoder-decoder); ``shd`` as ``lm_hidden`` takes it."""
    return logits_fn(params, cfg, lm_hidden(params, cfg, batch, plane=plane, shd=shd))


def _nll(logits, labels):
    """Per-token negative log-likelihood in float32: (..., V), (...) -> (...)."""
    lf = logits.float()
    m = lf.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    return lse - lf.gather(-1, labels[..., None].long())[..., 0]


def xent_loss(logits, labels, mask=None):
    """Mean cross-entropy over (B, S) tokens in float32, or the mean over
    the tokens where ``mask`` is 1."""
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(params: LM, cfg: ArchConfig, xc, yc):
    """Summed NLL of one sequence chunk: its logits exist only in here."""
    return _nll(logits_fn(params, cfg, xc), yc).sum()


def lm_loss(params: LM, cfg: ArchConfig, batch, loss_chunk: int = 1024, *, shd=None):
    """Causal LM loss with a sequence-chunked head and cross-entropy: each
    chunk of ``loss_chunk`` positions is checkpointed, so its (B, chunk, V)
    logits are recomputed in the backward and the (B, S, V) logits never
    exist (the reference's ``lm_loss``; its padded last chunk is shorter
    here).  ``shd`` as ``lm_hidden`` takes it: the head and the loss run
    whole on every mesh, as the reference's vocab-sharded ones give the
    same values."""
    labels = batch["labels"]
    x = lm_hidden(params, cfg, batch, plane=TRAIN, shd=shd)
    xs, ys = x[:, :-1], labels[:, 1:]
    B, S1, _ = xs.shape
    chunk = min(loss_chunk, S1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(0, S1, chunk):
        xc, yc = xs[:, j : j + chunk], ys[:, j : j + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, params, cfg, xc, yc, use_reentrant=False)
        else:
            total = total + _chunk_nll(params, cfg, xc, yc)
    return total / max(B * S1, 1)
