"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

A copy of the reference's config (``repro.configs.kimi_k2_1t_a32b``); its
memory note there is about the reference's TPU pods.  The port runs it at
``reduced_config`` only: one float32 layer at full width holds 17 B
parameters (ROADMAP.md A.12.3).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    mlp_act="swiglu",
    norm="rmsnorm",
    n_experts=384,
    top_k=8,
    rope_theta=50_000.0,
    microbatch=4,
    optimizer="momentum_bf16",
    serve_fsdp=True,  # expert weights exceed model-sharded HBM at serve time
    source="arXiv:2501.kimi2 (paper-table)",
)
SHARDING_OVERRIDES = {"fsdp": ("data",)}
