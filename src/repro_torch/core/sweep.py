"""Sweep knobs and one engine run per config (subset of ``repro.core.sweep``).

The reference vmaps a grid of knob settings through one compiled program;
its batched grid is bitwise-equal to running each config on its own, which
is what the port does.  This module keeps the reference's knob vocabulary
and resolution rules (:func:`resolve_knobs` mirrors ``make_knobs``,
:func:`run_one` mirrors ``_run_one``).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from repro_torch.core import registry
from repro_torch.core.costmodel import N_HYBRID_STAGES, RPC, CostModel
from repro_torch.core.engine import EngineConfig
from repro_torch.workloads import make_workload

# per-workload knob defaults, mirroring each factory's signature
WL_EXEC_TICKS = {"smallbank": 1, "ycsb": 3, "tpcc": 5}
YCSB_HOT_PROB = 0.10

KNOB_KEYS = ("hybrid", "seed", "exec_ticks", "hot_prob", "qp_pressure")

# static shape axes the reference buckets per config (not ported: ROADMAP A.9)
STATIC_AXES = ("coroutines", "records_per_node", "ticks")


class GridSpec(NamedTuple):
    """Shape and program parameters shared by every config of a sweep."""

    protocol: str
    workload: str
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
    kernel_plane: str = "torch"
    device: str = "cuda"


class RunKnobs(NamedTuple):
    """One config's per-run knobs, resolved to concrete Python values."""

    hybrid: Tuple[int, ...]
    seed: int
    exec_ticks: int
    hot_prob: float
    qp_pressure: float


def normalize_hybrid(code) -> Tuple[int, ...]:
    """Hybrid coding as a stage tuple; ints are bitmasks (bit i = stage i)."""
    if isinstance(code, (int, np.integer)):
        return tuple((int(code) >> i) & 1 for i in range(N_HYBRID_STAGES))
    code = tuple(int(b) for b in code)
    if len(code) != N_HYBRID_STAGES:
        raise ValueError(f"hybrid coding needs {N_HYBRID_STAGES} stages, got {code}")
    return code


def all_hybrid_codes() -> List[Tuple[int, ...]]:
    """All 2^N_HYBRID_STAGES stage codings (the paper's exhaustive sweep)."""
    return [normalize_hybrid(i) for i in range(2**N_HYBRID_STAGES)]


def grid_product(**axes: Sequence) -> List[Dict]:
    """Cartesian product of named knob axes -> list of config dicts."""
    names = list(axes)
    return [dict(zip(names, vals)) for vals in itertools.product(*(axes[n] for n in names))]


def resolve_knobs(workload: str, config: Dict) -> RunKnobs:
    """One config dict -> its knobs, omitted knobs taking the workload's
    defaults; unknown keys raise, as in the reference's ``make_knobs``.
    ``seed`` and ``qp_pressure`` take the reference's int32 / float32 types."""
    c = dict(config)
    hy = normalize_hybrid(c.pop("hybrid", (RPC,) * N_HYBRID_STAGES))
    seed = int(np.int32(c.pop("seed", 0)))
    et = c.pop("exec_ticks", None)
    et = WL_EXEC_TICKS.get(workload, 1) if et is None else int(et)
    hp = c.pop("hot_prob", None)
    if hp is not None and workload != "ycsb":
        raise TypeError(f"hot_prob is a ycsb-only knob; workload={workload!r}")
    hp = YCSB_HOT_PROB if hp is None else float(hp)
    qp = float(np.float32(c.pop("qp_pressure", 0.0)))
    if c:
        raise TypeError(f"unknown knob(s): {sorted(c)}; valid: {KNOB_KEYS}")
    return RunKnobs(hybrid=hy, seed=seed, exec_ticks=et, hot_prob=hp, qp_pressure=qp)


def engine_config(spec: GridSpec, kn: RunKnobs):
    """The (EngineConfig, CostModel, Workload) triple of one config."""
    cm = CostModel.tcp() if spec.tcp else CostModel(qp_pressure=kn.qp_pressure)
    wkw: Dict[str, Any] = {"exec_ticks": kn.exec_ticks}
    if spec.workload == "ycsb":
        wkw["hot_prob"] = kn.hot_prob
    wl = make_workload(spec.workload, spec.n_nodes * spec.records_per_node, **wkw)
    ec = EngineConfig(
        protocol=spec.protocol,
        n_nodes=spec.n_nodes,
        coroutines=spec.coroutines,
        records_per_node=spec.records_per_node,
        rw=wl.rw,
        max_ops=wl.max_ops,
        hybrid=kn.hybrid,
        doorbell=spec.doorbell,
        merge_stages=spec.merge_stages,
        exec_ticks=kn.exec_ticks,
        history_cap=spec.history_cap,
        mvcc_slots=spec.mvcc_slots,
        seed=kn.seed,
        kernel_plane=spec.kernel_plane,
        device=spec.device,
    )
    return ec, cm, wl


def run_one(spec: GridSpec, kn: RunKnobs) -> Dict:
    """One engine run; returns the ``engine.summarize`` metrics (tensors)."""
    ec, cm, wl = engine_config(spec, kn)
    entry = registry.get_protocol(spec.protocol)
    return entry.hooks.grid_run(entry, ec, cm, wl, ticks=spec.ticks, warmup=spec.warmup, ticks_active=None)
