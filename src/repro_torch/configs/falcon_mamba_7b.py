"""falcon-mamba-7b — attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,        # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,           # mamba blocks have no separate FFN
    vocab_size=65024,
    norm="rmsnorm",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    microbatch=8,
    subquadratic=True,
    source="arXiv:2410.05355",
)
SHARDING_OVERRIDES = {"fsdp": ("data",)}
