"""Carry engine state across the JAX reference and the port.

``from_numpy`` turns a ``st`` or ``store`` dict of numpy arrays (for example
``{k: np.asarray(v)}`` of a JAX state) into the port's tensors with the same
dtypes; ``to_numpy`` goes back.  The tests use it to start the port from a
JAX mid-run state and to compare the two key by key.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def from_numpy(d: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.array(v), device=device) for k, v in d.items()}


def to_numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}
