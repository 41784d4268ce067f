"""Atomic checkpoints in the reference's layout (port of
``repro.checkpoint.ckpt``), so each package restores the other's.

Layout: <dir>/step_<N:08d>/
  manifest.json      {"step": N, "leaves": {path: {"file", "shape", "dtype"}}},
                     a leaf's path as JAX's ``keystr`` writes it
                     (``['params']['layers']['attn']['wq']``)
  leaf_<i:05d>.npy   one whole array per leaf, numbered in JAX's leaf
                     order (dict keys sorted at every level)

A tree is nested dicts and lists of tensors or arrays (a list entry's path
is its index, ``['tail'][0]``); ``convert.bundle_to_tree`` gives the
training runner's, layers stacked as the reference stacks them.
bfloat16 leaves are stored as their raw bytes (uint8) with the logical
dtype in the manifest, as the reference stores every ``ml_dtypes`` type;
the port reads and writes them through ``Tensor.view``.  A save writes a
temporary directory and renames it, then prunes to the newest ``keep``
steps; a restore takes the newest step whose manifest exists.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

# dtypes that .npy stores as themselves; any other (bfloat16) is stored as raw bytes
_NPY_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint8", "uint16", "uint32",
               "uint64", "bool")
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64, "float32": torch.float32,
                 "float16": torch.float16, "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
                 "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def _items(tree):
    """(key, value) in JAX's order: a dict's keys sorted, a list's in order."""
    return list(enumerate(tree)) if isinstance(tree, list) else [(k, tree[k]) for k in sorted(tree)]


def _flatten(tree, prefix=""):
    """[(keystr path, leaf)] in JAX's leaf order."""
    out = []
    for k, v in _items(tree):
        path = f"{prefix}[{k!r}]"
        out += _flatten(v, path) if isinstance(v, (dict, list)) else [(path, v)]
    return out


def _unflatten(proto, leaves, prefix=""):
    def one(k, v):
        path = f"{prefix}[{k!r}]"
        return _unflatten(v, leaves, path) if isinstance(v, (dict, list)) else leaves[path]

    if isinstance(proto, list):
        return [one(k, v) for k, v in enumerate(proto)]
    return {k: one(k, v) for k, v in proto.items()}


def _lists(node):
    """A structure whose int-keyed dicts become lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def _structure(paths):
    """The nested dicts and lists of a list of keystr paths (leaves None)."""
    tree = {}
    for path in paths:
        keys = [k if k else int(i) for k, i in re.findall(r"\['([^']*)'\]|\[(\d+)\]", path)]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = None
    return _lists(tree)


def _to_npy(leaf):
    """(array to save, logical shape, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name not in _NPY_DTYPES:
            return t.reshape(t.shape or (1,)).view(torch.uint8).numpy(), list(t.shape), name
        return t.numpy(), list(t.shape), name
    arr = np.asarray(leaf)
    return arr, list(arr.shape), str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic checkpoint save; prunes to the newest ``keep`` steps."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr, shape, dtype_name = _to_npy(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest[path] = {"file": fn, "shape": shape, "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, proto=None, *, step: Optional[int] = None, device=None):
    """(step, tree): the checkpoint's leaves as tensors on ``device`` (the
    CPU by default) in the structure of ``proto``, whose leaves are not
    read, or with no ``proto`` every leaf of the manifest (the save-time
    device is irrelevant: leaves are stored whole)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    if proto is None:
        proto = _structure(manifest)
    leaves = {}
    for path, _ in _flatten(proto):
        meta = manifest[path]
        arr = np.load(os.path.join(d, meta["file"]))
        t = torch.from_numpy(arr)
        if str(arr.dtype) != meta["dtype"]:  # raw bytes of a dtype .npy does not hold
            t = t.contiguous().view(_TORCH_DTYPES[meta["dtype"]])
        leaves[path] = t.reshape(meta["shape"]).to(device)
    return step, _unflatten(proto, leaves)
