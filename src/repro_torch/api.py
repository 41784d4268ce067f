"""One front door for RCC experiments: ``plan(spec)`` -> ``execute(plan)``
(port of ``repro.api``).

    from repro_torch.api import ExperimentSpec, run

    rows = run(ExperimentSpec(protocol="nowait", workload="smallbank",
                              configs=[{"hybrid": c} for c in range(64)])).rows

Rows keep the reference's row schema.  ``plan`` groups the configs into
power-of-two shape buckets (``sweep.plan_buckets``, as the reference) and
picks one of the reference's four layouts with its rules and errors:

  * ``dense``: each bucket ONE batched run on one device, its configs on a
    leading config axis (the reference's vmapped grid);
  * ``config``: a bucket's config axis split over the devices;
  * ``node``: ONE config, its simulated nodes sharded over the devices
    (``engine.run_sharded``);
  * ``config_node``: both, the devices in rows of ``node_shards``.

``device`` defaults to ``"cuda"``: ``plan`` raises when CUDA is absent and
the caller did not ask for ``device="cpu"``.  ``devices`` is None, "auto"
(every visible device of ``device``'s type: each CUDA device, or the one
CPU) or an explicit sequence, in which a device may repeat: four node
shards on one card, or ``devices=("cpu",) * 4`` on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core import sweep as _sweep
from repro_torch.core.planes import visible_devices
from repro_torch.core.sweep import (  # noqa: F401  (public planner helpers, re-exported)
    KNOB_KEYS,
    STATIC_AXES,
    BucketPlan,
    GridSpec,
    all_hybrid_codes,
    grid_product,
    make_knobs,
    normalize_hybrid,
    plan_buckets,
)
from repro_torch.kernels import ops as _kernel_ops

AUTO = "auto"

# mesh layouts the planner can select (ExperimentSpec.layout overrides)
DENSE = "dense"  # one device, each bucket one batched run
CONFIG = "config"  # config axis split over the devices
NODE = "node"  # ONE config, simulated n_nodes axis sharded over the devices
CONFIG_NODE = "config_node"  # 2-D config × node mesh
LAYOUTS = (DENSE, CONFIG, NODE, CONFIG_NODE)


@dataclass(frozen=True)
class ExperimentSpec:
    """Declarative description of one experiment sweep (the reference's
    fields, plus ``device``).

    ``configs`` is a sequence of per-run dicts mixing knobs (``hybrid``,
    ``seed``, ``exec_ticks``, ``hot_prob``, ``qp_pressure``) with static
    shape axes (:data:`STATIC_AXES`: ``coroutines``, ``records_per_node``,
    ``ticks``); everything else is grid-level.  ``kernel_plane`` is
    ``"auto"`` (``"kernel"`` on CUDA, ``"torch"`` on the CPU), ``"torch"``
    or ``"kernel"``.  ``devices`` (None, "auto" or a sequence, all of one
    type), ``node_shards`` and ``layout`` pick the layout as the
    reference's do; ``device`` is where a run with ``devices=None`` goes,
    and whose devices "auto" means.
    """

    protocol: str
    workload: str
    configs: Tuple[Dict, ...] = ({},)
    n_nodes: int = 4
    coroutines: int = 60
    records_per_node: int = 65536
    ticks: int = 400
    warmup: int = 80
    history_cap: int = 0
    mvcc_slots: int = 4
    doorbell: bool = True
    tcp: bool = False
    merge_stages: bool = False
    kernel_plane: str = "auto"
    devices: Union[None, str, Tuple[Any, ...]] = None
    node_shards: Optional[int] = None
    layout: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "configs", tuple(dict(c) for c in self.configs))
        if isinstance(self.devices, (list, tuple)):
            object.__setattr__(self, "devices", tuple(self.devices))


@dataclass(frozen=True)
class PlannedBucket:
    """One shape bucket of the plan: a padded GridSpec (= one batched run,
    or one per config shard), the per-config active extents that make the
    padding inert, and the bucket's stacked knobs."""

    index: int
    grid_spec: GridSpec
    bucket: BucketPlan
    knobs: _sweep.RunKnobs

    def describe(self) -> str:
        b, g = self.bucket, self.grid_spec
        axes = []
        for name, padded, active in (
            ("coroutines", g.coroutines, b.coroutines_active),
            ("records_per_node", g.records_per_node, b.records_active),
            ("ticks", g.ticks, b.ticks_active),
        ):
            if active is None:
                axes.append(f"{name}={padded}")
            else:
                axes.append(f"{name}={padded} (active {min(active)}..{max(active)})")
        return f"bucket {self.index}: {len(b.indices)} config(s), " + ", ".join(axes) + " -> 1 batched run"


@dataclass(frozen=True)
class ExecutionPlan:
    """What :func:`execute` will run: the layout, its devices, the buckets,
    the resolved device and kernel plane."""

    spec: ExperimentSpec
    buckets: Tuple[PlannedBucket, ...]
    kernel_plane: str = _kernel_ops.TORCH
    device: str = "cuda"
    layout: str = DENSE
    devices: Optional[Tuple[str, ...]] = None  # None = ``device`` alone
    node_shards: Optional[int] = None

    @property
    def n_configs(self) -> int:
        return len(self.spec.configs)

    @property
    def n_devices(self) -> int:
        return len(self.devices) if self.devices is not None else 1

    def device_name(self) -> str:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            return f"{dev} ({torch.cuda.get_device_name(dev)})"
        return str(dev)

    def mesh_shape(self) -> str:
        if self.layout == DENSE:
            return "1 device (dense, each bucket one batched run)"
        if self.layout == CONFIG:
            return f"1-D grid mesh, {self.n_devices} device(s) on the config axis"
        if self.layout == NODE:
            return f"1-D node mesh, {self.n_devices} device(s) on the n_nodes axis"
        n_cfg = self.n_devices // (self.node_shards or 1)
        return (f"2-D config × node mesh, {self.n_devices} device(s) as "
                f"{n_cfg} config-shard(s) × {self.node_shards} node-shard(s)")

    def summary(self) -> str:
        """Human-readable plan: layout, buckets, shapes, devices and kernel plane."""
        s, g = self.spec, self.buckets[0].grid_spec
        devices = "" if self.devices is None else f" ({', '.join(self.devices)})"
        return "\n".join([
            f"ExperimentSpec: protocol={s.protocol} workload={s.workload} configs={self.n_configs}",
            f"layout: {self.layout} — {self.mesh_shape()}{devices}",
            f"shapes: n_nodes={g.n_nodes}, warmup={g.warmup}",
            *(pb.describe() for pb in self.buckets),
            f"device: {self.device_name()}",
            f"kernel plane: {self.kernel_plane} — {_kernel_ops.describe_plane(self.kernel_plane)}",
        ])


@dataclass(frozen=True)
class Results:
    """Executed plan: one metrics dict per config, in ``spec.configs`` order."""

    rows: List[Dict] = field(default_factory=list)
    plan: Optional[ExecutionPlan] = None
    wall_s: float = 0.0

    @property
    def row(self) -> Dict:
        if len(self.rows) != 1:
            raise ValueError(f"Results.row: plan produced {len(self.rows)} rows, not 1")
        return self.rows[0]


def _resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ExperimentSpec.device={name!r} but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ExperimentSpec.device={name!r}: pass a 'cuda' or 'cpu' device")
    return dev


def _resolve_devices(spec: ExperimentSpec, *, need: bool) -> Optional[Tuple[str, ...]]:
    """The spec's devices: None stays None unless ``need``, "auto" is every
    visible device of ``spec.device``'s type, a sequence is checked (one
    type, CUDA present where named)."""
    if spec.devices is None:
        return visible_devices(spec.device) if need else None
    if isinstance(spec.devices, str):
        if spec.devices != AUTO:
            raise ValueError(
                f"ExperimentSpec.devices={spec.devices!r}: pass None, 'auto', "
                "or an explicit device sequence"
            )
        return visible_devices(spec.device)
    devices = tuple(str(_resolve_device(str(d))) for d in spec.devices)
    if not devices:
        raise ValueError("ExperimentSpec.devices is empty: pass at least one device")
    if len({torch.device(d).type for d in devices}) > 1:
        raise ValueError(f"ExperimentSpec.devices={devices}: every device must be of one type")
    return devices


def plan(spec: ExperimentSpec) -> ExecutionPlan:
    """Resolve an :class:`ExperimentSpec` into an executable plan.

    Raises before anything runs on unknown protocols or knobs, capability
    violations (e.g. a 2-D ``config × node`` mesh for a protocol registered
    with ``Caps(batch_node_shardable=False)``), topology mismatches
    (device counts that don't divide) and a missing CUDA, with the
    reference's selection rules and messages.
    """
    entry = registry.get_protocol(spec.protocol)
    if not spec.configs:
        raise ValueError("ExperimentSpec.configs is empty: pass at least one knob dict")
    if spec.layout is not None and spec.layout not in LAYOUTS:
        raise ValueError(f"ExperimentSpec.layout={spec.layout!r}: valid layouts {LAYOUTS}")

    # node_shards <= 0 means "no node sharding"
    node_shards = spec.node_shards if spec.node_shards and spec.node_shards >= 1 else None
    layout = spec.layout
    if layout is None:
        if node_shards is not None and len(spec.configs) == 1:
            layout = NODE
        elif node_shards is not None and node_shards >= 2:
            layout = CONFIG_NODE
        else:
            # node_shards in (None, 1) with a multi-config grid degenerates
            # to no node sharding: pick dense/config from the device count
            node_shards = None
            devices = _resolve_devices(spec, need=False)
            layout = CONFIG if devices is not None and len(devices) > 1 else DENSE

    # capability gates come first: a protocol that cannot run a layout should
    # say so before any device-count arithmetic confuses the message
    if layout in (NODE, CONFIG_NODE) and not entry.caps.node_shardable:
        raise ValueError(
            f"protocol {spec.protocol!r} is not node-shardable: its registry entry "
            "sets Caps(node_shardable=False); run it dense or config-sharded, or "
            "re-register via repro_torch.core.registry.register_protocol(...)"
        )
    if layout == CONFIG_NODE and not entry.caps.batch_node_shardable:
        raise ValueError(
            f"protocol {spec.protocol!r} cannot run on a 2-D config × node mesh: "
            "its registry entry sets Caps(batch_node_shardable=False) (configs "
            "cannot batch around its node collectives).  Shard the config axis "
            "only (layout='config'), or node-shard a single config "
            "(layout='node'), or re-register the protocol with different "
            "capabilities via repro_torch.core.registry.register_protocol(...)"
        )

    if layout == NODE:
        devices = _node_devices(spec, node_shards)
        node_shards = len(devices)
        buckets = [BucketPlan(indices=(0,), coroutines=spec.coroutines, records_per_node=spec.records_per_node,
                              knob_configs=(dict(spec.configs[0]),), coroutines_active=None, records_active=None)]
    else:
        devices = _resolve_devices(spec, need=layout in (CONFIG, CONFIG_NODE))
        if layout == DENSE and devices is not None and len(devices) > 1:
            raise ValueError(
                f"layout='dense' places at most one device, got {len(devices)}; "
                "use layout='config' (or devices='auto') to shard the config axis"
            )
        if layout == CONFIG and len(devices) < 2 and spec.layout == CONFIG:
            # an explicit config mesh on one device is the dense run
            layout = DENSE
        if layout == CONFIG_NODE:
            if not node_shards or node_shards < 2:
                raise ValueError(f"layout='config_node' needs node_shards >= 2, got {node_shards}")
            if len(devices) % node_shards:
                raise ValueError(f"node_shards={node_shards} must divide the device count ({len(devices)})")
            if spec.n_nodes % node_shards:
                raise ValueError(f"node_shards={node_shards} must divide n_nodes={spec.n_nodes}")
        else:
            node_shards = None
        buckets = plan_buckets(
            list(spec.configs), coroutines=spec.coroutines, records_per_node=spec.records_per_node, ticks=spec.ticks
        )

    device = _resolve_device(devices[0] if devices is not None else spec.device)
    kernel_plane = _kernel_ops.resolve_plane(spec.kernel_plane, device)
    planned = []
    for i, b in enumerate(buckets):
        knobs = make_knobs(spec.workload, b.knob_configs)
        for name, active in (("coroutines_active", b.coroutines_active), ("records_active", b.records_active),
                             ("ticks_active", b.ticks_active)):
            if active is not None:
                knobs = knobs._replace(**{name: np.array(active, np.int32)})
        gs = GridSpec(
            protocol=spec.protocol,
            workload=spec.workload,
            n_nodes=spec.n_nodes,
            coroutines=b.coroutines,
            records_per_node=b.records_per_node,
            ticks=b.ticks if b.ticks is not None else spec.ticks,
            warmup=spec.warmup,
            history_cap=spec.history_cap,
            mvcc_slots=spec.mvcc_slots,
            doorbell=spec.doorbell,
            tcp=spec.tcp,
            merge_stages=spec.merge_stages,
            kernel_plane=kernel_plane,
            device=str(device),
        )
        planned.append(PlannedBucket(index=i, grid_spec=gs, bucket=b, knobs=knobs))
    return ExecutionPlan(spec=spec, buckets=tuple(planned), kernel_plane=kernel_plane, device=str(device),
                         layout=layout, devices=devices, node_shards=node_shards)


def _node_devices(spec: ExperimentSpec, node_shards: Optional[int]) -> Tuple[str, ...]:
    """The single-config node-sharded layout's checks and devices."""
    if len(spec.configs) != 1:
        raise ValueError(
            f"layout='node' runs ONE config with the n_nodes axis on the mesh, "
            f"got {len(spec.configs)} configs; use layout='config_node' to also "
            "shard the config axis"
        )
    bad_axes = sorted(set(spec.configs[0]) & set(STATIC_AXES))
    if bad_axes:
        raise ValueError(
            f"layout='node' does not bucket static axes; move {bad_axes} to the "
            "ExperimentSpec grid defaults or use a dense/config layout"
        )
    if spec.devices is None or spec.devices == AUTO:
        devices = visible_devices(spec.device)
        if node_shards is not None:
            if node_shards > len(devices):
                raise ValueError(
                    f"node_shards={node_shards} > visible devices ({len(devices)}); "
                    "pass ExperimentSpec.devices, in which a device may repeat"
                )
            devices = devices[:node_shards]
    else:
        devices = _resolve_devices(spec, need=True)
        if node_shards is not None and node_shards != len(devices):
            raise ValueError(
                f"node_shards={node_shards} conflicts with len(devices)={len(devices)}; "
                "pass one or the other"
            )
    if spec.n_nodes % len(devices):
        raise ValueError(
            f"node mesh: {len(devices)} device(s) must divide n_nodes={spec.n_nodes} "
            "(shards own whole simulated nodes)"
        )
    return devices


def execute(pl: ExecutionPlan) -> Results:
    """Run an :class:`ExecutionPlan`, one batched run per bucket (per
    config shard on the ``config`` and ``config_node`` layouts); rows
    follow the reference's row schema (``engine.summarize`` metrics as
    Python values plus ``wall_s``, ``grid_size``, ``n_buckets``,
    ``bucket``, ``n_devices``, ``n_node_shards``, ``protocol``,
    ``workload``, ``hybrid`` and the per-config static axes; a ``node``
    row has the metrics, ``wall_s``, ``protocol``, ``workload``,
    ``n_node_shards`` and ``hybrid``, as the reference's).  ``wall_s`` is
    the bucket's wall time, unrounded."""
    spec = pl.spec
    t0_all = time.perf_counter()
    if pl.layout == NODE:
        return Results(rows=[_execute_node(pl)], plan=pl, wall_s=time.perf_counter() - t0_all)
    rows: List[Optional[Dict]] = [None] * len(spec.configs)
    for pb in pl.buckets:
        b, gs, kn = pb.bucket, pb.grid_spec, pb.knobs
        t0 = time.perf_counter()
        if pl.layout == CONFIG_NODE:
            out = _sweep._run_sharded_2d(gs, kn, pl.devices, pl.node_shards)
        elif pl.layout == CONFIG:
            out = _sweep._run_sharded(gs, kn, pl.devices)
        else:
            out = _sweep._run_one(gs, kn)
        out = {k: v.tolist() for k, v in out.items()}  # waits for the device
        wall = time.perf_counter() - t0
        for g, idx in enumerate(b.indices):
            m = {k: v[g] for k, v in out.items()}
            m["wall_s"] = wall
            m["grid_size"] = len(spec.configs)
            m["n_buckets"] = len(pl.buckets)
            m["bucket"] = pb.index
            m["n_devices"] = pl.n_devices
            m["n_node_shards"] = pl.node_shards or 1
            m["protocol"], m["workload"] = spec.protocol, spec.workload
            m["hybrid"] = "".join(str(int(bit)) for bit in kn.hybrid[g])
            m["coroutines"] = b.coroutines if b.coroutines_active is None else b.coroutines_active[g]
            m["records_per_node"] = b.records_per_node if b.records_active is None else b.records_active[g]
            m["ticks"] = gs.ticks if b.ticks_active is None else b.ticks_active[g]
            rows[idx] = m
    return Results(rows=rows, plan=pl, wall_s=time.perf_counter() - t0_all)  # type: ignore[arg-type]


def _execute_node(pl: ExecutionPlan) -> Dict:
    spec, pb = pl.spec, pl.buckets[0]
    t0 = time.perf_counter()
    m = _sweep._run_node(pb.grid_spec, pb.knobs, pl.devices)
    m["wall_s"] = time.perf_counter() - t0
    m["protocol"], m["workload"] = spec.protocol, spec.workload
    m["n_node_shards"] = len(pl.devices)
    m["hybrid"] = "".join(str(int(bit)) for bit in pb.knobs.hybrid[0])
    return m


def run(spec: ExperimentSpec) -> Results:
    """``execute(plan(spec))`` — the one-call front door."""
    return execute(plan(spec))


__all__ = [
    "AUTO",
    "DENSE",
    "CONFIG",
    "NODE",
    "CONFIG_NODE",
    "LAYOUTS",
    "ExperimentSpec",
    "ExecutionPlan",
    "PlannedBucket",
    "Results",
    "plan",
    "execute",
    "run",
    "all_hybrid_codes",
    "grid_product",
    "normalize_hybrid",
]
