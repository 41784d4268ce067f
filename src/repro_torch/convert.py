"""Carry state across the JAX reference and the port.

``from_numpy`` turns a ``st`` or ``store`` dict of numpy arrays (for example
``{k: np.asarray(v)}`` of a JAX state) into the port's tensors with the same
dtypes; ``to_numpy`` goes back.  The tests use it to start the port from a
JAX mid-run state and to compare the two key by key.

``lm_params_from_numpy`` builds the port's LM from the reference's parameter
tree (nested dicts of arrays, layers stacked on a leading axis), and
``lm_params_to_numpy`` gives that tree back: the two are a name map
(``layers/attn/wq[l]`` is ``layers.{l}.attn.wq``, and an
encoder-decoder's ``enc_layers/…[l]`` and ``dec_layers/…[l]`` are
``enc_layers.{l}.…`` and ``dec_layers.{l}.…``; a hybrid's
``groups/g{j}_{kind}/…[l]`` is ``layers.{P l + j}.…`` for a pattern of
length P over n_full groups, and its ``tail[i]/…``, a list entry with no
layer axis, is ``layers.{P n_full + i}.…``).  ``stack_named`` and
``unstack_tree`` are that map for any flat name -> tensor dict (gradients,
an optimizer's ``m``), ``opt_state_{to,from}_tree`` carry a whole
optimizer state, and ``bundle_{to,from}_tree`` the training runner's
bundle (``params``, ``opt``, ``data``, ``step``): the tree that
``checkpoint`` writes in the reference's layout, so each package restores
the other's checkpoints.  These trees hold torch tensors (bfloat16 has no
numpy dtype without ``ml_dtypes``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataState
from repro_torch.models.lm import LM, lm_from_state, resolve_device


def from_numpy(d: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.array(v), device=device) for k, v in d.items()}


def to_numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def _leaves(tree, prefix=()):
    """(path, leaf) of a tree of dicts and lists (a list entry's key is its index)."""
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(a, dev) -> torch.Tensor:
    """A copy of ``a`` (a tensor or an array) on ``dev``, its own storage."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(dev, copy=True).contiguous()
    return torch.tensor(np.asarray(a), device=dev)


def _name(layer: int, path, stack: str = "layers") -> str:
    return ".".join((stack, str(layer)) + tuple(path))


STACKS = ("layers", "enc_layers", "dec_layers")  # the reference's trees of layers stacked on a leading axis


def unstack_tree(tree: Dict, n_layers: int, device=None) -> Dict[str, torch.Tensor]:
    """A reference tree (layers stacked, or a hybrid's groups and tail) ->
    the port's flat name map.  ``n_layers`` is the decoder's depth (an
    encoder's stack is taken at its own)."""
    out = {}
    P = len(tree.get("groups", {}))
    n_full = (n_layers - len(tree.get("tail", []))) // max(P, 1)
    for path, arr in _leaves(tree):
        if path[0] in STACKS + ("groups",):
            stacked = {"groups": n_full, "enc_layers": arr.shape[0]}.get(path[0], n_layers)
            if arr.shape[0] != stacked:
                raise ValueError(f"{'/'.join(map(str, path))}: {arr.shape[0]} layers, config has {n_layers}")
            for i in range(stacked):
                if path[0] in STACKS:
                    out[_name(i, path[1:], path[0])] = _tensor(arr[i], device)
                else:  # groups/g{j}_{kind}/...
                    out[_name(P * i + int(path[1][1:].split("_")[0]), path[2:])] = _tensor(arr[i], device)
        elif path[0] == "tail":
            out[_name(P * n_full + path[1], path[2:])] = _tensor(arr, device)
        else:
            out[".".join(path)] = _tensor(arr, device)
    return out


def _put(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _stack_tensors(ts):
    return torch.stack([t.detach() for t in ts])


def stack_named(named: Dict, cfg: Optional[ArchConfig] = None, stack=_stack_tensors) -> Dict:
    """The port's flat name map -> the reference's tree (layers stacked; a
    hybrid ``cfg``'s in groups and a tail), detached tensors on the map's
    devices.  ``stack`` makes a stacked leaf of its layers' values (a list;
    ``models/lm.param_specs`` stacks specs); other leaves are taken as they
    are (tensors detached)."""
    tree: Dict = {}
    stacks: Dict[str, Dict[int, Dict]] = {}  # stack -> layer -> {path below it: leaf}
    leaf = lambda t: t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in STACKS:
            stacks.setdefault(parts[0], {}).setdefault(int(parts[1]), {})[tuple(parts[2:])] = leaf(t)
        else:
            _put(tree, parts, leaf(t))
    layers = stacks.pop("layers", None)
    for name, by_layer in stacks.items():
        for path in by_layer[0]:
            _put(tree, (name,) + path, stack([by_layer[i][path] for i in range(len(by_layer))]))
    if not layers:
        return tree
    if cfg is None or not cfg.is_hybrid:
        for path in layers[0]:
            _put(tree, ("layers",) + path, stack([layers[i][path] for i in range(len(layers))]))
        return tree
    pat = cfg.block_pattern
    n_full = cfg.n_layers // len(pat)
    for j, kind in enumerate(pat):
        for path in layers[j]:
            _put(tree, ("groups", f"g{j}_{kind}") + path,
                 stack([layers[len(pat) * l + j][path] for l in range(n_full)]))
    tree["tail"] = [{} for _ in range(cfg.n_layers - len(pat) * n_full)]
    for i, node in enumerate(tree["tail"]):
        for path, t in layers[len(pat) * n_full + i].items():
            _put(node, path, t)
    return tree


def lm_params_from_numpy(tree: Dict, cfg: ArchConfig, device="cuda") -> LM:
    """The port's LM holding the reference tree's values (copied to ``device``)."""
    return lm_from_state(cfg, unstack_tree(tree, cfg.n_layers, resolve_device(device)))


def lm_params_to_numpy(model: LM) -> Dict:
    """The reference's parameter tree (numpy, layers stacked) of an LM."""
    return map_tree(lambda t: t.cpu().numpy(), stack_named(model.state_dict(), model.cfg))


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return {k: map_tree(fn, v) if isinstance(v, (dict, list)) else fn(v) for k, v in tree.items()}


# an optimizer state's keys: those that hold one tensor per parameter, and
# that of a wrapped optimizer's state (``with_error_feedback``)
_PARAM_MAPS = ("m", "v", "residual")
_INNER = "inner"


def _map_opt_state(fn, state: Dict) -> Dict:
    """``fn`` applied to each per-parameter map of an optimizer state (or
    its tree), following the keys the optimizers write."""
    out = {}
    for k, v in state.items():
        if k == _INNER:
            out[k] = _map_opt_state(fn, v)
        elif k in _PARAM_MAPS:
            out[k] = fn(v)
        else:
            raise KeyError(f"optimizer state key {k!r}: expected one of {_PARAM_MAPS + (_INNER,)}")
    return out


def opt_state_to_tree(state: Dict, cfg: Optional[ArchConfig] = None) -> Dict:
    """An optimizer state (``{"m": {name: t}, ...}``, wrappers nested) ->
    the reference's state tree: every name map stacked (``stack_named``)."""
    return _map_opt_state(lambda named: stack_named(named, cfg), state)


def opt_state_from_tree(tree: Dict, cfg: ArchConfig, device="cuda") -> Dict:
    """The reference's optimizer-state tree -> the port's state on
    ``device``: every per-parameter tree unstacked into a name map."""
    dev = resolve_device(device)
    return _map_opt_state(lambda t: unstack_tree(t, cfg.n_layers, dev), tree)


def bundle_to_tree(params: LM, opt_state: Dict, data_state: DataState, step: int) -> Dict:
    """The training runner's checkpoint bundle in the reference's layout,
    on the CPU (stacking there takes no device memory)."""
    i32 = lambda x: torch.tensor(int(x), dtype=torch.int32)  # noqa: E731
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    return {
        "params": stack_named(map_tree(cpu, params.state_dict()), params.cfg),
        "opt": opt_state_to_tree(map_tree(cpu, opt_state), params.cfg),
        "data": {"step": i32(data_state.step), "seed": i32(data_state.seed)},
        "step": i32(step),
    }


def bundle_from_tree(tree: Dict, cfg: ArchConfig, device="cuda"):
    """A bundle tree (the port's or the reference's) -> (step, LM,
    optimizer state, DataState) on ``device``."""
    dev = resolve_device(device)
    params = lm_params_from_numpy(tree["params"], cfg, dev)
    data = DataState(int(tree["data"]["step"]), int(tree["data"]["seed"]))
    return int(tree["step"]), params, opt_state_from_tree(tree["opt"], cfg, dev), data
