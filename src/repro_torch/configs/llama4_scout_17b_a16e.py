"""llama4-scout-17b-a16e — MoE 16 experts top-1 [hf:meta-llama/Llama-4-Scout-17B-16E].

Early-fusion multimodality is a frontend concern; the assigned cell specifies
the transformer backbone only (text tokens in input_specs).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    mlp_act="swiglu",
    norm="rmsnorm",
    n_experts=16,
    top_k=1,
    rope_theta=500_000.0,
    microbatch=8,
    serve_fsdp=True,  # expert weights exceed model-sharded HBM at serve time
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
SHARDING_OVERRIDES = {"fsdp": ("data",)}
