"""whisper-small — encoder-decoder audio backbone [arXiv:2212.04356].

Conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, 1500, d_model).  The model is small
(~240M); it replicates over the model axis except the FFN and shards
batch over data.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm="layernorm",
    encoder_decoder=True,
    n_enc_layers=12,
    enc_seq_len=1500,
    microbatch=4,
    source="arXiv:2212.04356",
)
# 51865 vocab and 12 heads are not 16-divisible -> auto-replicated.
SHARDING_OVERRIDES = {}
