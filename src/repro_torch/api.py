"""One front door for RCC experiments: ``plan(spec)`` -> ``execute(plan)``
(port of ``repro.api``, dense layout).

    from repro_torch.api import ExperimentSpec, run

    rows = run(ExperimentSpec(protocol="nowait", workload="smallbank",
                              configs=[{"hybrid": c} for c in range(64)])).rows

Rows keep the reference's dense row schema.  ``plan`` groups the configs
into power-of-two shape buckets (``sweep.plan_buckets``, as the reference),
and ``execute`` runs each bucket as ONE batched run on one device, its
configs on a leading config axis (the reference's vmapped grid).
``device`` defaults to ``"cuda"``: ``plan`` raises when CUDA is absent and
the caller did not ask for ``device="cpu"``.  Multi-device layouts are not
ported yet and raise at plan time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core import sweep as _sweep
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

DENSE = "dense"  # the one ported layout: one device, each bucket one batched run


@dataclass(frozen=True)
class ExperimentSpec:
    """Declarative description of one experiment sweep (the reference's
    fields, plus ``device``).

    ``configs`` is a sequence of per-run dicts mixing knobs (``hybrid``,
    ``seed``, ``exec_ticks``, ``hot_prob``, ``qp_pressure``) with static
    shape axes (:data:`STATIC_AXES`: ``coroutines``, ``records_per_node``,
    ``ticks``); everything else is grid-level.  ``kernel_plane`` is
    ``"auto"`` (``"kernel"`` on CUDA, ``"torch"`` on the CPU), ``"torch"``
    or ``"kernel"``.
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
    """One shape bucket of the plan: a padded GridSpec (= one batched run),
    the per-config active extents that make the padding inert, and the
    bucket's stacked knobs."""

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
    """What :func:`execute` will run: the buckets, the resolved device and
    kernel plane."""

    spec: ExperimentSpec
    buckets: Tuple[PlannedBucket, ...]
    kernel_plane: str = _kernel_ops.TORCH
    device: str = "cuda"

    @property
    def n_configs(self) -> int:
        return len(self.spec.configs)

    def device_name(self) -> str:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            return f"{dev} ({torch.cuda.get_device_name(dev)})"
        return str(dev)

    def summary(self) -> str:
        """Human-readable plan: buckets, shapes, device and kernel plane."""
        s, g = self.spec, self.buckets[0].grid_spec
        return "\n".join([
            f"ExperimentSpec: protocol={s.protocol} workload={s.workload} configs={self.n_configs}",
            f"layout: {DENSE} — 1 device, {len(self.buckets)} bucket(s), each one batched run",
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


def plan(spec: ExperimentSpec) -> ExecutionPlan:
    """Resolve an :class:`ExperimentSpec` into an executable plan; raises
    before anything runs on unknown protocols, knobs or unported layouts."""
    registry.get_protocol(spec.protocol)
    if not spec.configs:
        raise ValueError("ExperimentSpec.configs is empty: pass at least one knob dict")
    if spec.layout not in (None, DENSE):
        raise NotImplementedError(
            f"layout={spec.layout!r} is not ported yet (ROADMAP A.10); the port runs 'dense'"
        )
    if spec.devices is not None or (spec.node_shards is not None and spec.node_shards >= 1):
        raise NotImplementedError(
            "multi-device runs (devices / node_shards) are not ported yet (ROADMAP A.10); "
            "pick one device with ExperimentSpec.device"
        )
    device = _resolve_device(spec.device)
    kernel_plane = _kernel_ops.resolve_plane(spec.kernel_plane, device)
    buckets = plan_buckets(
        list(spec.configs), coroutines=spec.coroutines, records_per_node=spec.records_per_node, ticks=spec.ticks
    )
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
    return ExecutionPlan(spec=spec, buckets=tuple(planned), kernel_plane=kernel_plane, device=str(device))


def execute(pl: ExecutionPlan) -> Results:
    """Run an :class:`ExecutionPlan`, one batched run per bucket; rows
    follow the reference's dense row schema (``engine.summarize`` metrics
    as Python values plus ``wall_s``, ``grid_size``, ``n_buckets``,
    ``bucket``, ``n_devices``, ``n_node_shards``, ``protocol``,
    ``workload``, ``hybrid`` and the per-config static axes).  ``wall_s``
    is the bucket's wall time, unrounded."""
    spec = pl.spec
    t0_all = time.perf_counter()
    rows: List[Optional[Dict]] = [None] * len(spec.configs)
    for pb in pl.buckets:
        b, gs, kn = pb.bucket, pb.grid_spec, pb.knobs
        t0 = time.perf_counter()
        out = {k: v.tolist() for k, v in _sweep._run_one(gs, kn).items()}  # waits for the device
        wall = time.perf_counter() - t0
        for g, idx in enumerate(b.indices):
            m = {k: v[g] for k, v in out.items()}
            m["wall_s"] = wall
            m["grid_size"] = len(spec.configs)
            m["n_buckets"] = len(pl.buckets)
            m["bucket"] = pb.index
            m["n_devices"] = 1
            m["n_node_shards"] = 1
            m["protocol"], m["workload"] = spec.protocol, spec.workload
            m["hybrid"] = "".join(str(int(bit)) for bit in kn.hybrid[g])
            m["coroutines"] = b.coroutines if b.coroutines_active is None else b.coroutines_active[g]
            m["records_per_node"] = b.records_per_node if b.records_active is None else b.records_active[g]
            m["ticks"] = gs.ticks if b.ticks_active is None else b.ticks_active[g]
            rows[idx] = m
    return Results(rows=rows, plan=pl, wall_s=time.perf_counter() - t0_all)  # type: ignore[arg-type]


def run(spec: ExperimentSpec) -> Results:
    """``execute(plan(spec))`` — the one-call front door."""
    return execute(plan(spec))


__all__ = [
    "DENSE",
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
