"""nemotron-4-15b — dense GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="sq_relu",
    norm="layernorm_nobias",
    rope_theta=10_000.0,
    rope_pct=0.5,
    microbatch=8,
    seq_parallel_prefill=False,  # measured 4x WORSE collectives under GSPMD auto-partitioning (EXPERIMENTS §Perf it.4 — refuted; needs manual ring attention)
    source="arXiv:2402.16819",
)
SHARDING_OVERRIDES = {"fsdp": ("data",)}
