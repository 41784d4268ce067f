"""Mixture-of-Experts FFN with capacity dropping (port of ``repro.layers.moe``).

Each token's router picks its ``top_k`` experts; every expert takes at most
C = ``_capacity`` of the call's T·k assignments, in the flat (token, slot)
order, and the rest are dropped (their contribution is exactly zero).  The
kept tokens are dispatched into an (E, C, D) buffer, the experts run as
batched products, and each token sums its kept outputs times its gates.
C depends on the T of the call, so a batch split in two routes differently:
prefill runs the whole batch as one call, as the reference does.

``moe_local`` is the reference's ``_moe_local`` for the experts
[e0, e0 + n_local).  ``apply_moe`` runs all experts in one call, or, given
an ``AxisRules`` whose mesh has a ``model`` axis of n > 1 that divides the
experts, expert-parallel as the reference's ``shard_map`` branch does: the
batch split over its ``batch`` mesh axes (each batch shard routes its own
tokens with its own capacity), and for each batch shard, model shard j runs
``moe_local`` over its E/n experts on its device, the shards' outputs
summed in shard order (the reference's ``psum``).  A shard's expert weights
are views of the whole tensors where its device is theirs: the one-card
mesh holds no second copy.  Under autograd the gradients follow the views:
the router's from every (batch shard, model shard) pair that used it, each
shard's expert slices into the one full-size gradient of each weight.  A
``Record`` keeps what each call routed and splits its time by step in a
trace.  Plain PyTorch on both kernel planes: the reference runs this layer
through XLA, with no Pallas kernel.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import ParamSet, activation
from repro_torch.sharding import P, AxisRules, dense_init


class MoE(ParamSet):
    """``wr`` (D, E) router, float32; ``wg``, ``wu`` (E, D, F) and ``wd``
    (E, F, D) expert weights."""

    NAMES = ("wr", "wg", "wu", "wd")


def init_moe(key, cfg: ArchConfig, dtype=torch.float32) -> MoE:
    """The reference's draws: ``dense_init`` takes fan_in = shape[0], which
    for the (E, D, F) expert tensors is E (so their std is about 0.88/sqrt(E))."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return MoE({
        "wr": dense_init(key, "wr", (D, E), P("embed", None), torch.float32),
        "wg": dense_init(key, "wg", (E, D, F), P("expert", "fsdp", None), dtype),
        "wu": dense_init(key, "wu", (E, D, F), P("expert", "fsdp", None), dtype),
        "wd": dense_init(key, "wd", (E, F, D), P("expert", "fsdp", None), dtype),
    })


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens (at least 4),
    whatever the number of local experts (the reference's takes it and
    does not use it)."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, 4)


def _expert_ffn(cfg: ArchConfig, wg, wu, wd, buf):
    """buf (E_l, C, D) -> (E_l, C, D): batched products (``bmm``, which the
    ``save_attn`` remat policy recomputes, as JAX's recomputes batched dots)."""
    dt = buf.dtype
    g = torch.bmm(buf, wg.to(dt))
    if cfg.mlp_act == "swiglu":
        h = activation("silu", g) * torch.bmm(buf, wu.to(dt))
    else:
        h = activation(cfg.mlp_act, g)
    return torch.bmm(h, wd.to(dt))


def _router_logits(wr, x_flat):
    """x_flat (T, D) -> float32 router logits (T, E)."""
    return x_flat.float() @ wr.float()


def _ranked(logits):
    """Router probabilities (T, E) from the logits, sorted descending per
    token, and their expert ids.  The softmax is the reference's
    (``exp(l - max) / sum``); ``jax.lax.top_k`` puts the lower index first
    among equal values, and a stable descending sort does the same
    (``torch.topk`` promises no order for ties)."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    top = torch.sort(e / e.sum(-1, keepdim=True), dim=-1, descending=True, stable=True)
    return top.values, top.indices


def _route(cfg: ArchConfig, wr, x_flat):
    """x_flat (T, D) -> gates (T, k) float32, expert ids (T, k) int64, and
    the router logits (T, E) they come from: the top k probabilities
    renormalised over the k picks (exactly 1.0 at k = 1)."""
    logits = _router_logits(wr, x_flat)
    probs, ids = _ranked(logits)
    gates, idx = probs[:, : cfg.top_k], ids[:, : cfg.top_k]
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx, logits


def _slots(cfg: ArchConfig, idx, T: int, e0: int, n_local: int):
    """The reference's slot assignment for ids (T, k): returns (keep, dest,
    C) over the T·k assignments in flat (token, slot) order.  An assignment
    to a local expert takes the next of its C slots in that order; ``keep``
    is local and within capacity, ``dest`` = expert·C + rank (the overflow
    row n_local·C where not kept)."""
    C = _capacity(cfg, T)
    le = idx.reshape(-1) - e0
    local = (le >= 0) & (le < n_local)
    le_safe = le.clamp(0, n_local - 1)
    # running rank within each local expert: a cumulative one-hot count, non-local assignments in row n_local
    # (experts on rows, so the count runs along the inner dim, one scan per expert: the card's scan along the
    # outer dim is slow)
    col = torch.where(local, le_safe, n_local)
    onehot = torch.nn.functional.one_hot(col, n_local + 1).to(torch.int32).t()
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_a = pos.gather(0, le_safe[None, :])[0]
    keep = local & (pos_a < C)
    dest = torch.where(keep, le_safe * C + pos_a, n_local * C)
    return keep, dest, C


def _dispatch(cfg: ArchConfig, idx, x_flat, e0: int, n_local: int):
    """Tokens into their experts' slots: (buf (n_local, C, D), keep, dest, C).
    The kept destinations are distinct, so each kept token's row is copied
    into its slot (the dropped ones all land in the overflow row, which is
    thrown away) instead of accumulating every assignment into a buffer."""
    T, D = x_flat.shape
    keep, dest, C = _slots(cfg, idx, T, e0, n_local)
    tid = torch.arange(T, device=x_flat.device).repeat_interleave(cfg.top_k)
    buf = torch.zeros((n_local * C + 1, D), dtype=x_flat.dtype, device=x_flat.device).index_copy(0, dest, x_flat[tid])
    return buf[: n_local * C].reshape(n_local, C, D), keep, dest, C


def _combine(out, gates, keep, dest):
    """Each token's kept expert outputs times its gates, summed in slot
    order as the reference's scatter-add into zeros adds them: out
    (n_local, C, D), gates (T, k) -> (T, D)."""
    T, k = gates.shape
    rows = out.reshape(-1, out.shape[-1])
    w = gates.reshape(T * k).to(out.dtype)
    contrib = torch.where(keep[:, None], rows[dest.clamp(max=rows.shape[0] - 1)] * w[:, None], 0).reshape(T, k, -1)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


class Record:
    """What the ``moe_local`` calls made while it is open (``with Record()
    as rec``): each call appends its router logits (T, E), expert ids
    (T, k), keep flags (T·k,) and capacity to ``rec.calls``, tensors the
    call computes anyway, so recording adds no device work; and each call
    runs its four steps inside ``record_function`` ranges ``moe:router``,
    ``moe:dispatch``, ``moe:expert products`` and ``moe:combine``, so that a
    trace splits the layer's time by step.  ``route_stats`` reads a call.
    A block that a checkpoint recomputes in the backward pass (``remat``)
    records nothing the second time: a call is one forward of the layer."""

    current = None  # the open record, if any

    def __enter__(self):
        if Record.current is not None:
            raise RuntimeError("a Record is already open")
        self.calls = []
        Record.current = self
        return self

    def __exit__(self, *exc):
        Record.current = None


def _recording() -> bool:
    """A Record is open and this is not a recomputation: a checkpointed
    block's forward runs again inside the backward pass, where autograd's
    engine has a graph task."""
    return Record.current is not None and torch._C._current_graph_task_id() == -1


def _step(name):
    """A profiler range around one step of the MoE while a Record is open."""
    return record_function("moe:" + name) if _recording() else contextlib.nullcontext()


class Experts(NamedTuple):
    """What ``moe_local`` reads of an MoE: the whole router and the experts
    it runs (an :class:`MoE`, or one shard's views of its expert weights)."""

    wr: torch.Tensor
    wg: torch.Tensor
    wu: torch.Tensor
    wd: torch.Tensor


def _moe_local(params, cfg: ArchConfig, x, e0: int, n_local: int):
    """``moe_local``'s output and what it routed (``Record``'s call)."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    with _step("router"):
        gates, idx, logits = _route(cfg, params.wr, x_flat)
    with _step("dispatch"):
        buf, keep, dest, C = _dispatch(cfg, idx, x_flat, e0, n_local)
    with _step("expert products"):
        out = _expert_ffn(cfg, params.wg, params.wu, params.wd, buf)
    with _step("combine"):
        y = _combine(out, gates, keep, dest).reshape(B, S, D)
    return y, {"logits": logits.detach(), "ids": idx, "keep": keep, "capacity": C}


def moe_local(params, cfg: ArchConfig, x, e0: int, n_local: int):
    """x (B, S, D) -> (B, S, D): the MoE over experts [e0, e0 + n_local)
    (``params`` holds those experts' weights and the whole router): route,
    dispatch, the experts, combine."""
    y, call = _moe_local(params, cfg, x, e0, n_local)
    if _recording():
        Record.current.calls.append(call)
    return y


def apply_moe(params: MoE, cfg: ArchConfig, x, shd: Optional[AxisRules] = None):
    """x (B, S, D) -> (B, S, D): every expert in one call, unless ``shd``
    has a ``model`` mesh axis of n > 1 that divides the experts
    (``_apply_moe_sharded``)."""
    n = shd.axis_sizes.get("model", 1) if shd is not None else 1
    if n == 1 or cfg.n_experts % n != 0:
        return moe_local(params, cfg, x, 0, cfg.n_experts)
    return _apply_moe_sharded(params, cfg, shd, x, n)


def _apply_moe_sharded(params: MoE, cfg: ArchConfig, shd: AxisRules, x, n: int):
    """The reference's expert-parallel branch: the batch split as its
    ``batch`` spec resolves (each batch shard routes its own tokens at the
    capacity of its own T), then for each batch shard the n model shards'
    ``moe_local`` over experts [j E/n, (j+1) E/n) on their devices, summed
    in shard order on x's device.  The reference's ``fsdp`` all-gather is
    the identity here: a shard holds its experts whole, and the gather's
    transpose, a reduce-scatter of the batch shards' gradients, is the sum
    that autograd makes where the batch shards use the same views.  An open
    ``Record`` gets one call, the batch shards' routing concatenated in
    shard order (``batch_shards`` of them, ``split_call``), an assignment
    kept if its expert's shard kept it."""
    n_local = cfg.n_experts // n
    batch_entry = shd.resolve(P("batch"), (x.shape[0],))[0]
    b_local = x.shape[0] // shd.shards(batch_entry)
    names = () if batch_entry is None else (batch_entry,) if isinstance(batch_entry, str) else batch_entry
    outs, calls = [], []
    for b, coords in enumerate(np.ndindex(*(shd.axis_sizes[a] for a in names))):
        x_b = x[b * b_local : (b + 1) * b_local]
        y = keep = None
        for j in range(n):
            dev = shd.mesh.device(**dict(zip(names, coords)), model=j)
            e = slice(j * n_local, (j + 1) * n_local)
            shard = Experts(params.wr.to(dev), params.wg[e].to(dev), params.wu[e].to(dev), params.wd[e].to(dev))
            y_j, call = _moe_local(shard, cfg, x_b.to(dev), j * n_local, n_local)
            y = y_j.to(x.device) if y is None else y + y_j.to(x.device)
            keep = call["keep"].to(x.device) if keep is None else keep | call["keep"].to(x.device)
        outs.append(y)
        calls.append(dict(call, logits=call["logits"].to(x.device), ids=call["ids"].to(x.device), keep=keep))
    if _recording():
        Record.current.calls.append({"logits": torch.cat([c["logits"] for c in calls]),
                                     "ids": torch.cat([c["ids"] for c in calls]),
                                     "keep": torch.cat([c["keep"] for c in calls]), "capacity": calls[0]["capacity"],
                                     "batch_shards": len(calls)})
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def split_call(call: Dict) -> List[Dict]:
    """A recorded call as its batch shards' calls, each routed at the
    call's capacity (a call of one device is one shard)."""
    n = call.get("batch_shards", 1)
    parts = {k: call[k].chunk(n) for k in ("logits", "ids", "keep")}
    return [dict(call, batch_shards=1, **{k: v[i] for k, v in parts.items()}) for i in range(n)]


def route_stats(cfg: ArchConfig, call: Dict) -> Dict:
    """What one recorded ``apply_moe`` call decided, for checking routing
    against the reference: assignments per expert (before capacity),
    dropped assignments, the capacity, and the smallest margin between a
    token's k-th and (k+1)-th router probability (the decision a rounding
    difference could flip; inf with a single expert)."""
    k = cfg.top_k
    probs, _ = _ranked(call["logits"])
    margin = float((probs[:, k - 1] - probs[:, k]).min()) if cfg.n_experts > k else float("inf")
    return {
        "loads": torch.bincount(call["ids"].reshape(-1), minlength=cfg.n_experts).tolist(),
        "dropped": int((~call["keep"]).sum()),
        "capacity": call["capacity"],
        "margin": margin,
    }
