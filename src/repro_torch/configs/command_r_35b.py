"""command-r-35b — dense GQA, parallel block, no biases [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    mlp_act="swiglu",
    norm="layernorm_nobias",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    microbatch=8,
    seq_parallel_prefill=False,  # measured 4x WORSE collectives under GSPMD auto-partitioning (EXPERIMENTS §Perf it.4 — refuted; needs manual ring attention)
    source="hf:CohereForAI/c4ai-command-r-v01",
)
SHARDING_OVERRIDES = {"fsdp": ("data",)}
