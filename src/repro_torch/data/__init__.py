"""Synthetic training data (``pipeline``) and the golden files the port is held to."""
from repro_torch.data.pipeline import DataState, make_pipeline  # noqa: F401
