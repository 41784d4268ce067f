"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-32B family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    mlp_act="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    microbatch=8,
    seq_parallel_prefill=False,  # measured 4x WORSE collectives under GSPMD auto-partitioning (EXPERIMENTS §Perf it.4 — refuted; needs manual ring attention)
    source="hf:Qwen/Qwen2.5-0.5B (family card)",
)
SHARDING_OVERRIDES = {"fsdp": ("data",)}
