"""One front door for RCC experiments: ``plan(spec)`` -> ``execute(plan)``
(port of ``repro.api``, dense layout).

    from repro_torch.api import ExperimentSpec, run

    rows = run(ExperimentSpec(protocol="nowait", workload="smallbank",
                              configs=[{"hybrid": c} for c in (0, 63, 21, 42)])).rows

Rows keep the reference's dense row schema.  The port runs the configs of
a spec one after another on one device (the reference's vmapped grid is
bitwise-equal to that sequential path).  ``device`` defaults to
``"cuda"``: ``plan`` raises when CUDA is absent and the caller did not ask
for ``device="cpu"``.  Multi-device layouts and per-config static shape
axes are not ported yet and raise at plan time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import registry
from repro_torch.core import sweep as _sweep
from repro_torch.core.sweep import (  # noqa: F401  (public planner helpers, re-exported)
    KNOB_KEYS,
    STATIC_AXES,
    GridSpec,
    all_hybrid_codes,
    grid_product,
    normalize_hybrid,
    resolve_knobs,
)
from repro_torch.kernels import ops as _kernel_ops

DENSE = "dense"  # the one ported layout: one device, configs run in turn


@dataclass(frozen=True)
class ExperimentSpec:
    """Declarative description of one experiment sweep (the reference's
    fields, plus ``device``).

    ``configs`` is a sequence of per-run knob dicts (``hybrid``, ``seed``,
    ``exec_ticks``, ``hot_prob``, ``qp_pressure``); everything else is
    grid-level.  ``kernel_plane`` is ``"auto"`` (``"kernel"`` on CUDA,
    ``"torch"`` on the CPU), ``"torch"`` or ``"kernel"``.
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
class ExecutionPlan:
    """What :func:`execute` will run: one grid spec, its configs' knobs,
    the resolved device and kernel plane."""

    spec: ExperimentSpec
    grid_spec: GridSpec
    knobs: Tuple[_sweep.RunKnobs, ...]
    kernel_plane: str = _kernel_ops.TORCH
    device: str = "cuda"

    @property
    def n_configs(self) -> int:
        return len(self.knobs)

    def device_name(self) -> str:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            return f"{dev} ({torch.cuda.get_device_name(dev)})"
        return str(dev)

    def summary(self) -> str:
        """Human-readable plan: shapes, device and kernel plane."""
        s, g = self.spec, self.grid_spec
        return "\n".join([
            f"ExperimentSpec: protocol={s.protocol} workload={s.workload} configs={self.n_configs}",
            f"layout: {DENSE} — 1 device, configs run in turn",
            f"shapes: n_nodes={g.n_nodes}, coroutines={g.coroutines}, "
            f"records_per_node={g.records_per_node}, ticks={g.ticks} (+{g.warmup} warmup)",
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
            f"layout={spec.layout!r} is not ported yet (ROADMAP A.9/A.10); the port runs 'dense'"
        )
    if spec.devices is not None or (spec.node_shards is not None and spec.node_shards >= 1):
        raise NotImplementedError(
            "multi-device runs (devices / node_shards) are not ported yet (ROADMAP A.9/A.10); "
            "pick one device with ExperimentSpec.device"
        )
    swept = sorted({k for c in spec.configs for k in c} & set(STATIC_AXES))
    if swept:
        raise NotImplementedError(
            f"configs sweep the static axes {swept}; shape bucketing is not ported yet "
            "(ROADMAP A.9): set them on the ExperimentSpec instead"
        )
    device = _resolve_device(spec.device)
    kernel_plane = _kernel_ops.resolve_plane(spec.kernel_plane, device)
    knobs = tuple(resolve_knobs(spec.workload, c) for c in spec.configs)
    gs = GridSpec(
        protocol=spec.protocol,
        workload=spec.workload,
        n_nodes=spec.n_nodes,
        coroutines=spec.coroutines,
        records_per_node=spec.records_per_node,
        ticks=spec.ticks,
        warmup=spec.warmup,
        history_cap=spec.history_cap,
        mvcc_slots=spec.mvcc_slots,
        doorbell=spec.doorbell,
        tcp=spec.tcp,
        merge_stages=spec.merge_stages,
        kernel_plane=kernel_plane,
        device=str(device),
    )
    return ExecutionPlan(
        spec=spec, grid_spec=gs, knobs=knobs, kernel_plane=kernel_plane, device=str(device)
    )


def execute(pl: ExecutionPlan) -> Results:
    """Run an :class:`ExecutionPlan`; rows follow the reference's dense row
    schema (``engine.summarize`` metrics as Python values plus ``wall_s``,
    ``grid_size``, ``n_buckets``, ``bucket``, ``n_devices``,
    ``n_node_shards``, ``protocol``, ``workload``, ``hybrid`` and the static
    axes).  ``wall_s`` is this config's own wall time, unrounded."""
    spec, gs = pl.spec, pl.grid_spec
    t0_all = time.perf_counter()
    rows = []
    for kn in pl.knobs:
        t0 = time.perf_counter()
        out = _sweep.run_one(gs, kn)
        m = {k: v.tolist() for k, v in out.items()}  # waits for the device
        m["wall_s"] = time.perf_counter() - t0
        m["grid_size"] = len(pl.knobs)
        m["n_buckets"] = 1
        m["bucket"] = 0
        m["n_devices"] = 1
        m["n_node_shards"] = 1
        m["protocol"], m["workload"] = spec.protocol, spec.workload
        m["hybrid"] = "".join(str(int(b)) for b in kn.hybrid)
        m["coroutines"] = gs.coroutines
        m["records_per_node"] = gs.records_per_node
        m["ticks"] = gs.ticks
        rows.append(m)
    return Results(rows=rows, plan=pl, wall_s=time.perf_counter() - t0_all)


def run(spec: ExperimentSpec) -> Results:
    """``execute(plan(spec))`` — the one-call front door."""
    return execute(plan(spec))


__all__ = [
    "DENSE",
    "ExperimentSpec",
    "ExecutionPlan",
    "Results",
    "plan",
    "execute",
    "run",
    "all_hybrid_codes",
    "grid_product",
    "normalize_hybrid",
]
