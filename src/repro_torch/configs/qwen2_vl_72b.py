"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191].

Vision frontend (dynamic resolution ViT) is a STUB per the assignment:
input_specs() provides token ids plus per-token 3D M-RoPE positions
(temporal, height, width); vision tokens map to reserved vocab ids.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mlp_act="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    microbatch=8,
    vision_stub=True,
    seq_parallel_prefill=False,  # measured 4x WORSE collectives under GSPMD auto-partitioning (EXPERIMENTS §Perf it.4 — refuted; needs manual ring attention)
    source="arXiv:2409.12191",
)
SHARDING_OVERRIDES = {"fsdp": ("data",)}
