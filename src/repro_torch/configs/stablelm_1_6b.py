"""stablelm-1.6b — dense MHA (kv=32), partial rotary 25% [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    mlp_act="swiglu",
    norm="layernorm",
    rope_pct=0.25,
    rope_theta=10_000.0,
    microbatch=4,
    seq_parallel_prefill=False,  # measured 4x WORSE collectives under GSPMD auto-partitioning (EXPERIMENTS §Perf it.4 — refuted; needs manual ring attention)
    source="hf:stabilityai/stablelm-2-1_6b",
)
SHARDING_OVERRIDES = {}
