from repro_torch.ft.runner import TrainRunner  # noqa: F401
