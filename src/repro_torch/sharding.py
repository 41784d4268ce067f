"""Logical-axis sharding rules, parameter specs, per-name parameter keys
and initialisers (port of ``repro.sharding``).

Model code names every parameter's axes with *logical* names ("batch",
"heads", "ff", "expert", ...).  A per-(arch, mesh) rule table maps logical
names to mesh axes.  Resolution is shape-aware: a logical axis whose
dimension is not divisible by the mapped mesh axes drops them, last first
(replicated): this is how whisper's 12 heads stay replicated on a 16-way
model axis while its 3072-wide FFN still shards.

The port has no compiler and no GSPMD, so a resolved spec is a layout the
port *reports* (the dry run's per-device bytes, ``launch/specs``); work is
split across a mesh only where the reference runs ``shard_map``: the
sequence-sharded decode attention (``layers/attention``) and the
expert-parallel MoE (``layers/moe``).  ``AxisRules.constrain`` is the
identity: in the reference it is only a layout hint to XLA and changes no
value.

The reference derives every parameter's key from its name
(``fold_in(key, crc32(name))``) and draws it with
``jax.random.truncated_normal``; the port does the same through its own
threefry (``core.prng``), so a seed gives the reference's weights.  An
initialiser returns a :class:`Param`, the value and its logical spec; on
the ``meta`` device it draws nothing (``models/lm.param_specs``).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng


class PartitionSpec(tuple):
    """A partition spec: one entry per dimension, each None (replicated), a
    name, or a tuple of names (``jax.sharding.PartitionSpec``'s entries).
    Logical names before ``AxisRules.resolve``, mesh axis names after."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(tuple(self))}"


P = PartitionSpec


class Param(NamedTuple):
    """A parameter leaf as an initialiser returns it: its value and its
    logical spec (the reference's ``Param``)."""

    value: torch.Tensor
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# Default logical -> mesh-axis rules
# ---------------------------------------------------------------------------

# Single-pod production mesh: ("data", "model"); multi-pod adds leading "pod".
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("data",),  # ("pod", "data") resolved automatically on pod meshes
    "seq": None,  # activation sequence axis (context parallelism if set)
    "embed": None,  # d_model dim of activations / params
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "d_inner": ("model",),  # mamba inner channels
    "rnn": ("model",),  # rg-lru width
    "kv_seq": ("model",),  # decode KV-cache sequence sharding (flash-decoding)
    "fsdp": None,  # param dim for ZeRO/FSDP-style sharding (per-arch opt-in)
    "replicated": None,
}


def merge_rules(overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


class NamedSharding(NamedTuple):
    """A leaf's resolved spec and the shape of the shard each device holds
    (``jax.sharding.NamedSharding(mesh, spec).shard_shape(shape)``)."""

    spec: PartitionSpec
    shard_shape: Optional[Tuple[int, ...]]


class AxisRules:
    """Resolves logical PartitionSpecs against a mesh (``launch.mesh.Mesh``).

    mesh=None => everything replicated (single device)."""

    def __init__(self, mesh, rules: Optional[Dict[str, Any]] = None):
        self.mesh = mesh
        self.rules = merge_rules(rules)
        self.axis_sizes = dict(zip(mesh.axis_names, mesh.shape)) if mesh is not None else {}
        self.has_pod = "pod" in self.axis_sizes

    # -- resolution --------------------------------------------------------
    def _mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.rules.get(logical, None)
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        # batch composes with the pod axis on multi-pod meshes
        if logical == "batch" and self.has_pod and "pod" not in axes:
            axes = ("pod",) + axes
        return tuple(a for a in axes if a in self.axis_sizes)

    def resolve(self, spec: Sequence, shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """Logical spec -> mesh spec, dropping non-divisible axes (and a mesh
        axis that an earlier dimension took)."""
        if self.mesh is None:
            return P()
        out, used = [], set()
        for i, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            mesh_axes = [ax for nm in names for ax in self._mesh_axes_for(nm) if ax not in used]
            if shape is not None and mesh_axes:
                total = int(np.prod([self.axis_sizes[a] for a in mesh_axes]))
                while mesh_axes and shape[i] % total != 0:  # greedily drop trailing axes until divisible
                    total //= self.axis_sizes[mesh_axes.pop()]
            used.update(mesh_axes)
            out.append(None if not mesh_axes else mesh_axes[0] if len(mesh_axes) == 1 else tuple(mesh_axes))
        return P(*out)

    def shards(self, entry) -> int:
        """The number of shards a resolved spec entry splits its dimension into."""
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        return int(np.prod([self.axis_sizes[a] for a in names]))

    def shard_devices(self, entry) -> list:
        """The device of each shard a resolved spec entry makes, in shard
        order (row-major over the entry's axes, the mesh's other axes at 0):
        one device for None."""
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        return [self.mesh.device(**dict(zip(names, idx))) for idx in np.ndindex(*(self.axis_sizes[a] for a in names))]

    def sharding(self, spec: Sequence, shape: Optional[Sequence[int]] = None) -> NamedSharding:
        """The resolved spec and, given the global ``shape``, each device's shard shape."""
        assert self.mesh is not None
        resolved = self.resolve(spec, shape)
        if shape is None:
            return NamedSharding(resolved, None)
        entries = tuple(resolved) + (None,) * (len(shape) - len(resolved))
        return NamedSharding(resolved, tuple(int(d) // self.shards(e) for d, e in zip(shape, entries)))

    # -- activation constraints --------------------------------------------
    def constrain(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        """The identity: the reference's ``with_sharding_constraint`` is a
        layout hint to XLA's partitioner and changes no value."""
        return x

    # -- param tree resolution ----------------------------------------------
    def resolve_tree(self, shapes_tree, specs_tree):
        """A tree of tensors (or shapes) x a tree of logical specs -> a tree
        of :class:`NamedSharding` (trees of dicts and lists)."""
        if isinstance(specs_tree, PartitionSpec):
            sh = shapes_tree.shape if hasattr(shapes_tree, "shape") else shapes_tree
            return self.sharding(specs_tree, tuple(sh))
        if isinstance(specs_tree, list):
            return [self.resolve_tree(a, b) for a, b in zip(shapes_tree, specs_tree)]
        return {k: self.resolve_tree(shapes_tree[k], v) for k, v in specs_tree.items()}


# ---------------------------------------------------------------------------
# Deterministic per-name key derivation and initialisers
# ---------------------------------------------------------------------------


def name_key(key: torch.Tensor, name: str) -> torch.Tensor:
    return prng.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def dense_init(key, name, shape, spec, dtype=torch.float32, scale=None) -> Param:
    """Truncated normal on [-2, 2] times ``scale`` (1/sqrt(fan_in) unless
    given), drawn in float32 on the key's device and cast to ``dtype``; on
    the ``meta`` device an empty tensor of the shape and no draw."""
    if key.device.type == "meta":
        return Param(torch.empty(shape, dtype=dtype, device="meta"), P(*spec))
    return Param(_dense_draw(key, name, shape, scale).reshape(shape).to(dtype), P(*spec))


def _dense_draw(key, name, shape, scale=None, start: int = 0, stop=None) -> torch.Tensor:
    """``dense_init``'s float32 values at flat elements [start, stop) of the
    leaf (default all), drawn without the rest: the truncated normal scaled
    in place (the reference multiplies in float32; a second leaf-sized
    buffer would not fit beside kimi-k2's expert leaves on the card)."""
    if scale is None:
        scale = 1.0 / np.sqrt(max(shape[0], 1))
    v = prng._chunked_draw(name_key(key, name), shape, prng._truncated_normal_fn(-2.0, 2.0), start, stop)
    return v.mul_(float(np.float32(scale)))


def zeros_init(name, shape, spec, dtype=torch.float32, device=None) -> Param:
    return Param(torch.zeros(shape, dtype=dtype, device=device), P(*spec))


def ones_init(name, shape, spec, dtype=torch.float32, device=None) -> Param:
    return Param(torch.ones(shape, dtype=dtype, device=device), P(*spec))
