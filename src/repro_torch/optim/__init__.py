from repro_torch.optim.optimizers import (  # noqa: F401
    OptimizerSpec,
    adamw,
    clip_by_global_norm,
    make_optimizer,
    momentum_bf16,
    opt_state_specs,
    wsd_schedule,
)
