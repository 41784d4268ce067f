"""Carry state across the JAX reference and the port.

``from_numpy`` turns a ``st`` or ``store`` dict of numpy arrays (for example
``{k: np.asarray(v)}`` of a JAX state) into the port's tensors with the same
dtypes; ``to_numpy`` goes back.  The tests use it to start the port from a
JAX mid-run state and to compare the two key by key.

``lm_params_from_numpy`` builds the port's LM from the reference's parameter
tree (nested dicts of arrays, layers stacked on a leading axis), and
``lm_params_to_numpy`` gives that tree back: the two are a name map
(``layers/attn/wq[l]`` is ``layers.{l}.attn.wq``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM, lm_from_state, resolve_device


def from_numpy(d: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.array(v), device=device) for k, v in d.items()}


def to_numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def lm_params_from_numpy(tree: Dict, cfg: ArchConfig, device="cuda") -> LM:
    """The port's LM holding the reference tree's values (copied to ``device``)."""
    dev = resolve_device(device)
    state = {}
    for path, arr in _leaves(tree):
        arr = np.asarray(arr)
        if path[0] == "layers":
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} layers, config has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                state[".".join(("layers", str(i)) + path[1:])] = torch.tensor(arr[i], device=dev)
        else:
            state[".".join(path)] = torch.tensor(arr, device=dev)
    return lm_from_state(cfg, state)


def lm_params_to_numpy(model: LM) -> Dict:
    """The reference's parameter tree (numpy, layers stacked) of an LM."""
    tree: Dict = {}
    per_layer: Dict = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        a = t.detach().cpu().numpy()
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = a
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    for path, by_layer in per_layer.items():
        node = tree.setdefault("layers", {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return tree
