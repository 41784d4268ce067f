"""The kernel plane: backend dispatch for the engine's hot paths (port of
``repro.kernels.ops``).

A *kernel plane* is one of

  * ``"torch"``  — scatter-min arbitration and indexed gathers in plain
    PyTorch (the counterpart of the reference's ``"jnp"`` plane);
  * ``"kernel"`` — the hand-written CUDA kernels (``lock_arbiter``,
    ``multi_read``, ``mvcc_version_select``, ``flash_attention``; the
    counterpart of ``"pallas"``).  On CPU tensors the same dispatch runs
    the kernels' plain versions, the CPU tests' counterpart of
    ``"pallas_interpret"``.

``"auto"`` resolves to ``"kernel"`` on a CUDA device and ``"torch"`` on the
CPU.  Both planes give bitwise-equal integer counters: the kernels
implement exactly the reference semantics (lexicographic-min arbitration
with no index tiebreak, exact int32 gathers, first-index version picks).
The LM's attention agrees across planes within float tolerance: the torch
plane is ``layers.attention.naive_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.core.arbiter import scatter_min_winner
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lock_arbiter import lock_arbiter
from repro_torch.kernels.multi_read import multi_read_many
from repro_torch.kernels.mvcc_version_select import mvcc_version_read, mvcc_version_select
from repro_torch.layers.attention import naive_attention

TORCH = "torch"
KERNEL = "kernel"
KERNEL_PLANES = (TORCH, KERNEL)
AUTO = "auto"


def default_plane(device) -> str:
    """What ``"auto"`` resolves to for tensors on ``device``."""
    return KERNEL if torch.device(device).type == "cuda" else TORCH


def resolve_plane(plane, device) -> str:
    """Validate/resolve a kernel-plane knob (``None``/"auto" -> by device)."""
    if plane is None or plane == AUTO:
        return default_plane(device)
    if plane not in KERNEL_PLANES:
        raise ValueError(f"kernel_plane={plane!r}: pass 'auto' or one of {KERNEL_PLANES}")
    return plane


def describe_plane(plane: str) -> str:
    return {
        TORCH: "plain PyTorch (scatter-min arbitration, indexed gathers, inline version picks, O(S^2) attention)",
        KERNEL: "hand-written CUDA kernels (plain versions on CPU tensors)",
    }[plane]


# ---------------------------------------------------------------------------
# Engine hot-path dispatch
# ---------------------------------------------------------------------------


def cas_arbitrate(keys, prio_hi, prio_lo, active, n_records: int, *, plane: str = TORCH, groups: int = 1):
    """Per-key lexicographic-min CAS arbitration over a flat request batch.

    keys/prio_hi/prio_lo (M,) int32, active (M,) bool -> won (M,) bool,
    bitwise-equal across planes (``scatter_min_winner`` semantics).  The
    batch is ``groups`` equal runs of requests (one per config), each on
    its own keys; the kernel plane arbitrates them as the kernel's (G, M/G)
    groups, one block each."""
    if plane != KERNEL:
        return scatter_min_winner(keys, prio_hi, prio_lo, active, n_records)
    won = lock_arbiter(*(t.contiguous().view(groups, -1) for t in (keys, prio_hi, prio_lo, active)))
    return won.view(-1)


def version_select(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi=None, lock_lo=None):
    """MVCC Cond R1 slot pick (+ Cond R2 with a lock) over op rows the
    caller holds, on the kernel plane (the torch plane picks inline:
    ``mvcc._best_version``).

    wts_* (M, S), contiguous along S (row views are read in place), ctts_*
    (M,) per op or (N,) per transaction, lock_* (M,) or None -> (found,
    slot, r2_ok or None)."""
    return mvcc_version_select(wts_hi, wts_lo, ctts_hi, ctts_lo, lock_hi, lock_lo)


def version_read(wts_hi, wts_lo, keys, ctts_hi, ctts_lo, lock_hi=None, lock_lo=None):
    """The fused MVCC version read on the kernel plane: the store's wts_*
    (R, S) (and lock_* (R,)) at keys (N, K) and the pick against ctts_*
    (N,), in one launch that reads the store in place -> (found, slot,
    r2_ok or None) (N, K) and the gathered wts rows (N, K, S) x 2."""
    return mvcc_version_read(wts_hi, wts_lo, keys, ctts_hi, ctts_lo, lock_hi, lock_lo)


def gather_many(arrs, keys, *, plane: str = TORCH):
    """Doorbell-batched multi-array gather: several (R, ...) store arrays
    at the same keys -> per-array results shaped ``keys.shape +
    arr.shape[1:]`` (engine.read_rows_many's kernel path).  The kernel
    plane is ONE ``multi_read`` launch that reads every array in place; the
    torch plane indexes each array.  A batched run passes its flat (G·R,
    ...) store and keys that are already store rows (``g·R + key``)."""
    if plane == KERNEL:
        return multi_read_many(arrs, keys.contiguous())
    kf = keys.reshape(-1)
    return tuple(a[kf].reshape(tuple(keys.shape) + tuple(a.shape[1:])) for a in arrs)


def attention_op(q, k, v, *, causal=True, plane: str = AUTO):
    """LM attention in the reference's (B, S, H, Dh) layout (H already
    GQA-expanded) -> (B, Sq, H, Dh).

    The ``"kernel"`` plane runs ``flash_attention`` on the transposed views
    (no copies: the kernel takes strides, and its output comes back in the
    (B, S, H, Dh) layout); the ``"torch"`` plane runs ``naive_attention``.
    The kernel has no backward, so the kernel plane refuses inputs that
    autograd would differentiate (on CPU tensors too, where it runs the
    plain version): train through ``models.lm``'s ``TRAIN`` route."""
    plane = resolve_plane(plane, q.device)
    if plane != KERNEL:
        return naive_attention(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("attention_op: the flash_attention kernel has no backward, and these inputs require "
                           "grad; train through models.lm's TRAIN route (naive_attention up to 512 tokens, "
                           "flash_attention_xla above), as lm_loss does")
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)
