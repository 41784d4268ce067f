"""Architecture config registry (``--arch <id>``), port of ``repro.configs``.

Every architecture of the reference, in its order: the dense decoders
nemotron-4-15b, command-r-35b, qwen2.5-32b and stablelm-1.6b, the RG-LRU
+ local-attention hybrid recurrentgemma-2b, the MoE decoders
llama4-scout-17b-a16e and kimi-k2-1t-a32b, the Mamba-1 SSM
falcon-mamba-7b, the audio encoder-decoder whisper-small and the M-RoPE
VLM backbone qwen2-vl-72b.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, cell_supported  # noqa: F401

ARCH_MODULES = {
    "nemotron-4-15b": "nemotron_4_15b",
    "command-r-35b": "command_r_35b",
    "qwen2.5-32b": "qwen2_5_32b",
    "stablelm-1.6b": "stablelm_1_6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-small": "whisper_small",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(ARCH_MODULES)


def get_config(arch_id: str) -> Tuple[ArchConfig, Dict]:
    """Returns (ArchConfig, sharding-rule overrides)."""
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch_id]}")
    return mod.CONFIG, getattr(mod, "SHARDING_OVERRIDES", {})


def reduced_config(arch_id: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (the reference's cuts)."""
    cfg, _ = get_config(arch_id)
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        microbatch=1,
        remat="none",
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), capacity_factor=8.0)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_dt_rank=None)
    if cfg.block_pattern:
        kw.update(local_window=16, rnn_width=0, n_layers=5)
    if cfg.encoder_decoder:
        kw.update(n_enc_layers=2, n_layers=2, enc_seq_len=24)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 6, 6))
    return dataclasses.replace(cfg, **kw)
