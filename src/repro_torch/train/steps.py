"""Step builders (port of ``repro.train.steps``): train (with gradient
accumulation), prefill, decode; and an encoder-decoder's training frames."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models.decode import lm_decode_step, lm_prefill
from repro_torch.models.lm import LM, check_ported, lm_loss
from repro_torch.optim import make_optimizer
from repro_torch.sharding import AxisRules


def build_train_step(cfg: ArchConfig, opt_name: Optional[str] = None, *, shd: Optional[AxisRules] = None):
    """Returns (train_step, optimizer).

    ``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)``: ``params`` is an :class:`LM` (its parameters turned
    trainable here), ``opt_state`` the optimizer's state over
    ``dict(params.named_parameters())``, both updated in place and
    returned; ``batch`` ``{"tokens", "labels"}`` (B, S) (and an
    encoder-decoder's ``frames`` (B, T_enc, D)), or (n_micro,
    B_micro, S) for gradient accumulation: float32 for AdamW, bfloat16
    otherwise, then divided by ``n_micro``.  ``metrics``: ``loss`` and
    ``grad_norm`` (float32 tensors on the model's device) and ``step + 1``.
    ``shd``: the ``AxisRules`` of a mesh that ``lm_loss`` runs on (None:
    one device), for a (B, S) batch and for each microbatch alike; the
    optimizer does not depend on it, as the reference's does not.
    """
    check_ported(cfg)
    name = opt_name or cfg.optimizer
    optimizer = make_optimizer(name)
    acc_dtype = torch.float32 if name == "adamw" else torch.bfloat16

    def value_and_grad(params: LM, named, mb):
        with torch.enable_grad():
            loss = lm_loss(params, cfg, mb, shd=shd)
            grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads))

    def train_step(params: LM, opt_state, step, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        tokens = batch["tokens"]
        if tokens.dim() == 2:
            loss, grads = value_and_grad(params, named, batch)
        else:
            n_micro = tokens.shape[0]
            g_acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for n, p in named.items()}
            l_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_micro):
                l, g = value_and_grad(params, named, {k: v[i] for k, v in batch.items()})
                for n in named:
                    g_acc[n] = g_acc[n] + g[n].to(acc_dtype)
                l_acc = l_acc + l
            grads = {n: g / n_micro for n, g in g_acc.items()}
            loss = l_acc / n_micro
        _, opt_state, gnorm = optimizer.update(grads, opt_state, named, step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "step": int(step) + 1}

    return train_step, optimizer


def build_prefill(cfg: ArchConfig, shd: Optional[AxisRules] = None):
    """``prefill(params, batch, pad_to=None, *, plane)`` -> (last logits,
    cache): ``lm_prefill`` on ``shd``'s mesh (None: one device).  The
    reference's takes no ``pad_to``: its cache holds the prompt only."""
    def prefill(params, batch, pad_to=None, *, plane=ops.AUTO):
        return lm_prefill(params, cfg, batch, pad_to, plane=plane, shd=shd)

    return prefill


def build_decode_step(cfg: ArchConfig, shd: Optional[AxisRules] = None):
    """``decode(params, cache, batch)`` -> (logits, cache): one
    ``lm_decode_step`` on ``shd``'s mesh (None: one device)."""
    def decode(params, cache, batch):
        return lm_decode_step(params, cfg, cache, batch, shd)

    return decode


def frames_batch(cfg: ArchConfig, batch: int, step: int, device=None) -> torch.Tensor:
    """An encoder-decoder's training frames once the pipeline has drawn
    ``step`` batches: ``normal(fold_in(PRNGKey(7), step), (batch,
    enc_seq_len, d_model))``, as the reference's training launcher draws
    them."""
    key = prng.fold_in(prng.prng_key(7, device), step)
    return prng.normal(key, (batch, cfg.enc_seq_len, cfg.d_model))
