"""recurrentgemma-2b — RG-LRU + local attention, 1 attn : 2 rglru [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_act="geglu",
    norm="rmsnorm",
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    rope_theta=10_000.0,
    microbatch=4,
    subquadratic=True,
    source="arXiv:2402.19427",
)
# heads (10) and kv_heads (1) do not divide the 16-way model axis: the
# shape-aware resolver auto-replicates them; FFN/RG-LRU widths still shard.
SHARDING_OVERRIDES = {}
