"""Deterministic, restartable, shardable synthetic data pipeline (port of
``repro.data.pipeline``).

The pipeline's state is a step counter and a seed, so a restart from a
checkpoint resumes the exact token stream, and any host can rebuild any
host's shard from (step, host_id) alone.  The corpus mixes Zipf-ish
unigram draws with "copy runs" (rows whose second half repeats the first),
enough to drive real training-loop dynamics.

Every draw is the reference's, bit for bit, on the CPU and on the card:
the keys are the port's threefry (``core.prng``), the uniforms XLA's
fused scale-and-shift, and ``exp``/``log`` XLA's CPU float32 functions
(``torch.exp`` differs from XLA's by an ulp on more than 1 % of the
inputs, enough to move tokens in a few full-vocabulary batches).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import prng
from repro_torch.models.lm import resolve_device


class DataState(NamedTuple):
    step: int  # batches drawn so far (the reference's int32 counter)
    seed: int


def _zipf_tokens(key, shape, vocab: int) -> torch.Tensor:
    """Zipf-ish draw via exponentiated uniforms: ``exp(u log V) - 1``
    truncated to int32, u uniform on [1e-6, 1)."""
    u = prng.uniform(key, shape, 1e-6, 1.0)
    log_v = prng.log(torch.tensor(float(vocab), dtype=torch.float32, device=key.device))
    r = prng.exp(u * log_v) - 1.0
    return torch.clamp(r.to(torch.int32), 0, vocab - 1)


def make_pipeline(vocab: int, batch: int, seq: int, *, copy_frac: float = 0.3, seed: int = 0, device="cuda"):
    """Returns (init_state, next_batch) with next_batch(state) -> (state',
    batch): ``{"tokens", "labels"}`` (batch, seq) int32 on ``device``."""
    dev = resolve_device(device)

    def init_state() -> DataState:
        return DataState(0, seed)

    def next_batch(state: DataState) -> Tuple[DataState, Dict[str, torch.Tensor]]:
        key = prng.fold_in(prng.prng_key(state.seed, dev), state.step)
        k1, k2, _ = prng.split(key, 3)
        toks = _zipf_tokens(k1, (batch, seq), vocab)
        # copy runs: second half repeats the first half for a subset of rows
        half = seq // 2
        copied = torch.zeros_like(toks)
        copied[:, :half] = toks[:, :half]
        copied[:, half : 2 * half] = toks[:, :half]
        is_copy = prng.uniform(k2, (batch, 1)) < copy_frac
        toks = torch.where(is_copy, copied, toks)
        return DataState(state.step + 1, state.seed), {"tokens": toks, "labels": toks}

    return init_state, next_batch


def shard_for_host(batch: Dict[str, torch.Tensor], host_id: int, n_hosts: int):
    """Deterministic host shard of a global batch (row-sliced)."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // n_hosts
        out[k] = v[host_id * per : (host_id + 1) * per]
    return out
