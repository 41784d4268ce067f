"""Batched sweep engine: a bucket of engine configurations as ONE run (port
of ``repro.core.sweep``).

The reference vmaps a grid of knob settings through one compiled program.
The port writes the config axis out instead (``engine.EngineConfig.
n_configs``): :func:`make_knobs` stacks the per-config knobs into arrays
with a leading config axis, and :func:`_run_one` runs a whole bucket as
one ``engine.run`` (or one CALVIN epoch loop) whose state carries that
axis.  A knob that every config of a bucket shares stays one Python value
(:func:`engine.uniform`), so a bucket of one config issues the host work
of a single run, and a 2^6 hybrid sweep pays for both branches of a stage
only where the codes differ.

:func:`plan_buckets` groups configs that sweep the static shape axes
(``coroutines``, ``records_per_node``, ``ticks``) into power-of-two
buckets padded to the bucket's maximum, exactly as the reference does;
the per-config ACTIVE extents ride as knobs, and padded slots, records
and ticks are inert, so every row equals its unpadded run.

The device layouts (``repro_torch.api``): :func:`_run_sharded` splits a
bucket's config axis over devices, :func:`_run_sharded_2d` also runs each
part node-sharded (the ``config × node`` mesh), and :func:`_run_node` runs
one config node-sharded.  One controller drives them: each part is one
run on its device (or node mesh), one after the other.  The reference's
jit caches and compile counters have no counterpart: nothing compiles.

The reference's deprecated entry points :func:`run_grid`,
:func:`run_grid_sharded` and :func:`run_cell_sharded` are here as shims
over ``repro_torch.api`` with the reference's layout rules; each emits one
``DeprecationWarning``.  New code calls ``repro_torch.api``.
"""
from __future__ import annotations

import itertools
import warnings
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import registry
from repro_torch.core.costmodel import N_HYBRID_STAGES, RPC, CostModel
from repro_torch.core.engine import EngineConfig, node_mesh_config, uniform
from repro_torch.core.planes import visible_devices
from repro_torch.workloads import make_workload

# per-workload knob defaults, mirroring each factory's signature
WL_EXEC_TICKS = {"smallbank": 1, "ycsb": 3, "tpcc": 5}
YCSB_HOT_PROB = 0.10

KNOB_KEYS = ("hybrid", "seed", "exec_ticks", "hot_prob", "qp_pressure")

# static shape axes that plan_buckets turns into per-config active extents;
# ``ticks`` is the loop-length axis (dead ticks freeze a config's carry)
STATIC_AXES = ("coroutines", "records_per_node", "ticks")


class GridSpec(NamedTuple):
    """Shape and program parameters shared by every config of a bucket."""

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
    """A bucket's per-run knobs, each a numpy array with a leading config
    axis (the reference's dtypes).  ``coroutines_active`` /
    ``records_active`` / ``ticks_active`` are the bucket-padding active
    extents, None when the matching static axis is unpadded."""

    hybrid: np.ndarray  # int32 (G, N_HYBRID_STAGES)
    seed: np.ndarray  # int32 (G,)
    exec_ticks: np.ndarray  # int32 (G,)
    hot_prob: np.ndarray  # float32 (G,)
    qp_pressure: np.ndarray  # float32 (G,)
    coroutines_active: Optional[np.ndarray] = None  # int32 (G,) live co-routines per node
    records_active: Optional[np.ndarray] = None  # int32 (G,) live records per node
    ticks_active: Optional[np.ndarray] = None  # int32 (G,) live measured ticks

    @property
    def n_configs(self) -> int:
        return int(self.seed.shape[0])


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


def make_knobs(workload: str, configs: Iterable[Dict]) -> RunKnobs:
    """Stack per-config knob dicts into a batched RunKnobs.

    Each config may set any of ``hybrid`` (tuple or int bitmask), ``seed``,
    ``exec_ticks``, ``hot_prob``, ``qp_pressure``; omitted knobs take the
    workload's defaults.
    """
    configs = list(configs)
    if not configs:
        raise ValueError("empty config grid: pass at least one knob dict")
    rows = []
    for c in configs:
        c = dict(c)
        hy = normalize_hybrid(c.pop("hybrid", (RPC,) * N_HYBRID_STAGES))
        seed = int(c.pop("seed", 0))
        et = c.pop("exec_ticks", None)
        et = WL_EXEC_TICKS.get(workload, 1) if et is None else int(et)
        hp = c.pop("hot_prob", None)
        if hp is not None and workload != "ycsb":
            raise TypeError(f"hot_prob is a ycsb-only knob; workload={workload!r}")
        hp = YCSB_HOT_PROB if hp is None else float(hp)
        qp = float(c.pop("qp_pressure", 0.0))
        if c:
            raise TypeError(f"unknown knob(s): {sorted(c)}; valid: {KNOB_KEYS}")
        rows.append((hy, seed, et, hp, qp))
    hy, seed, et, hp, qp = zip(*rows)
    return RunKnobs(
        hybrid=np.array(hy, np.int32),
        seed=np.array(seed, np.int32),
        exec_ticks=np.array(et, np.int32),
        hot_prob=np.array(hp, np.float32),
        qp_pressure=np.array(qp, np.float32),
    )


def _knob(a: Optional[np.ndarray]):
    """A knob array as the engine takes it: None, one Python value when
    every config shares it, else a tuple of one per config."""
    return None if a is None else uniform(a.tolist())


def engine_config(spec: GridSpec, kn: RunKnobs):
    """The (EngineConfig, CostModel, Workload) triple of one bucket: its
    configs' knobs ride the config axis."""
    qp = _knob(kn.qp_pressure)
    cm = CostModel.tcp() if spec.tcp else CostModel(qp_pressure=qp)
    # bucket padding: the workload draws over the LOGICAL (active) record
    # space; the engine owns the padded physical layout
    ra = None if kn.records_active is None else tuple(kn.records_active.tolist())
    n_records = spec.n_nodes * spec.records_per_node if ra is None else tuple(spec.n_nodes * r for r in ra)
    et = _knob(kn.exec_ticks)
    wkw: Dict[str, Any] = {"exec_ticks": et}
    if spec.workload == "ycsb":
        wkw["hot_prob"] = _knob(kn.hot_prob)
    wl = make_workload(spec.workload, n_records, **wkw)
    ec = EngineConfig(
        protocol=spec.protocol,
        n_nodes=spec.n_nodes,
        coroutines=spec.coroutines,
        records_per_node=spec.records_per_node,
        # the active extents stay tuples: the reference traces them whenever
        # the axis is padded, and CALVIN's cost arithmetic follows that
        active_coroutines=None if kn.coroutines_active is None else tuple(kn.coroutines_active.tolist()),
        active_records_per_node=ra,
        rw=wl.rw,
        max_ops=wl.max_ops,
        hybrid=tuple(uniform(col) for col in kn.hybrid.T.tolist()),
        doorbell=spec.doorbell,
        merge_stages=spec.merge_stages,
        exec_ticks=et,
        history_cap=spec.history_cap,
        mvcc_slots=spec.mvcc_slots,
        seed=_knob(kn.seed),
        kernel_plane=spec.kernel_plane,
        device=spec.device,
        n_configs=kn.n_configs,
    )
    return ec, cm, wl


def _run_one(spec: GridSpec, kn: RunKnobs, node_devices: Optional[Sequence[str]] = None) -> Dict:
    """One bucket as one run (node-sharded over ``node_devices`` when
    given); returns the ``engine.summarize`` metrics with a leading config
    axis (tensors on the run's device)."""
    ec, cm, wl = engine_config(spec, kn)
    if node_devices is not None:
        ec = node_mesh_config(ec, node_devices)
    entry = registry.get_protocol(spec.protocol)
    ta = None if kn.ticks_active is None else tuple(kn.ticks_active.tolist())
    # epoch-vs-tick dispatch lives in the registry entry's hooks
    return entry.hooks.grid_run(entry, ec, cm, wl, ticks=spec.ticks, warmup=spec.warmup, ticks_active=ta)


def _knob_rows(kn: RunKnobs, rows) -> RunKnobs:
    """The knobs of the configs at ``rows`` (an index array)."""
    return RunKnobs(*(None if a is None else a[rows] for a in kn))


def _padded_parts(kn: RunKnobs, n_parts: int):
    """A bucket's knobs padded to a multiple of ``n_parts`` configs by
    repeating the last config, in ``n_parts`` equal consecutive parts."""
    size = kn.n_configs
    rows = np.minimum(np.arange(size + (-size) % n_parts), size - 1)
    return [_knob_rows(kn, r) for r in np.split(rows, n_parts)]


def _rows_out(outs: List[Dict], size: int) -> Dict:
    """Per-part metrics laid back on the config axis as numpy arrays, the
    pad rows sliced off."""
    return {k: np.concatenate([o[k].cpu().numpy() for o in outs])[:size] for k in outs[0]}


def _run_sharded(spec: GridSpec, kn: RunKnobs, devices: Sequence) -> Dict:
    """One bucket with its config axis split over ``devices``: padded to a
    multiple of the device count by repeating the last config, each part
    one run on its device, the pad rows sliced off the output (numpy
    arrays with a leading config axis)."""
    parts = _padded_parts(kn, len(devices))
    outs = [_run_one(spec._replace(device=str(dev)), part) for dev, part in zip(devices, parts)]
    return _rows_out(outs, kn.n_configs)


def _run_sharded_2d(spec: GridSpec, kn: RunKnobs, devices: Sequence, node_shards: int) -> Dict:
    """One bucket on a 2-D ``config × node`` mesh: ``devices`` in rows of
    ``node_shards``; the config axis splits over the rows as in
    :func:`_run_sharded`, and each row runs its configs node-sharded."""
    entry = registry.get_protocol(spec.protocol)
    if not entry.caps.batch_node_shardable:
        raise ValueError(
            f"protocol {spec.protocol!r} cannot run on a 2-D config × node mesh: "
            "its registry entry sets Caps(batch_node_shardable=False); shard the "
            "config axis only (node_shards=None)"
        )
    devices = [str(d) for d in devices]
    mesh = [tuple(devices[i:i + node_shards]) for i in range(0, len(devices), node_shards)]
    parts = _padded_parts(kn, len(mesh))
    outs = [_run_one(spec, part, row) for row, part in zip(mesh, parts)]
    return _rows_out(outs, kn.n_configs)


def _run_node(spec: GridSpec, kn: RunKnobs, devices: Sequence) -> Dict:
    """ONE config with the simulated ``n_nodes`` axis node-sharded over
    ``devices`` (the protocol's ``node_run`` hook); the metrics without a
    config axis, as Python values."""
    ec, cm, wl = engine_config(spec._replace(device=str(devices[0])), kn)
    entry = registry.get_protocol(spec.protocol)
    m = entry.hooks.node_run(entry, ec, cm, wl, ticks=spec.ticks, warmup=spec.warmup,
                             devices=tuple(str(d) for d in devices))
    return {k: v[0].tolist() for k, v in m.items()}


# ---------------------------------------------------------------------------
# Bucketing planner: static shape axes -> (padded spec, active extents)
# ---------------------------------------------------------------------------


class BucketPlan(NamedTuple):
    """One shape bucket: configs that share a padded (coroutines,
    records_per_node, ticks) shape and therefore one batched run.

    ``coroutines`` / ``records_per_node`` / ``ticks`` are the PADDED shapes;
    the matching ``*_active`` field carries each config's true extent
    (None when every config already matches the padded shape).
    """

    indices: Tuple[int, ...]  # positions in the caller's config list
    coroutines: int
    records_per_node: int
    knob_configs: Tuple[Dict, ...]  # static axes stripped
    coroutines_active: Optional[Tuple[int, ...]]
    records_active: Optional[Tuple[int, ...]]
    ticks: Optional[int] = None  # None = every config uses the grid default
    ticks_active: Optional[Tuple[int, ...]] = None


def _pow2_ceil(v: int) -> int:
    return 1 << (int(v) - 1).bit_length()


def plan_buckets(
    configs: Sequence[Dict],
    *,
    coroutines: int,
    records_per_node: int,
    ticks: Optional[int] = None,
) -> List[BucketPlan]:
    """Group configs into shape buckets (one batched run each).

    Each config may set the static axes in :data:`STATIC_AXES`; omitted
    axes take the grid-level default.  Bucket key = power-of-two ceiling of
    each axis (so nearby shapes share a run); bucket shape = max actual
    value inside the bucket (no padding beyond what the bucket needs).
    """
    groups: Dict[Tuple[int, int, int], List[Tuple[int, int, int, int, Dict]]] = {}
    for i, cfg in enumerate(configs):
        cfg = dict(cfg)
        c = int(cfg.pop("coroutines", coroutines))
        r = int(cfg.pop("records_per_node", records_per_node))
        has_t = "ticks" in cfg
        t = cfg.pop("ticks", ticks)
        t = 0 if t is None else int(t)  # 0 = axis unset (grid default applies)
        if c < 1 or r < 1:
            raise ValueError(f"config {i}: coroutines/records_per_node must be >= 1, got {c}/{r}")
        if has_t and t < 1:
            raise ValueError(f"config {i}: ticks must be >= 1, got {t}")
        groups.setdefault((_pow2_ceil(c), _pow2_ceil(r), _pow2_ceil(t) if t else 0), []).append(
            (i, c, r, t, cfg)
        )
    buckets = []
    for key in sorted(groups):
        rows = groups[key]
        pad_c = max(c for _, c, _, _, _ in rows)
        pad_r = max(r for _, _, r, _, _ in rows)
        pad_t = max(t for _, _, _, t, _ in rows)
        buckets.append(
            BucketPlan(
                indices=tuple(i for i, _, _, _, _ in rows),
                coroutines=pad_c,
                records_per_node=pad_r,
                knob_configs=tuple(cfg for _, _, _, _, cfg in rows),
                coroutines_active=(
                    None if all(c == pad_c for _, c, _, _, _ in rows)
                    else tuple(c for _, c, _, _, _ in rows)
                ),
                records_active=(
                    None if all(r == pad_r for _, _, r, _, _ in rows)
                    else tuple(r for _, _, r, _, _ in rows)
                ),
                ticks=pad_t or None,
                ticks_active=(
                    None if all(t == pad_t for _, _, _, t, _ in rows)
                    else tuple(t for _, _, _, t, _ in rows)
                ),
            )
        )
    return buckets


# ---------------------------------------------------------------------------
# Deprecated entry points: shims over repro_torch.api
# ---------------------------------------------------------------------------


def _warn_legacy(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.sweep.{name} is deprecated: use repro_torch.api "
        "(ExperimentSpec -> plan -> execute); this shim delegates to it",
        DeprecationWarning,
        stacklevel=3,
    )


def _legacy_grid(
    protocol: str,
    workload: str,
    configs: Iterable[Dict],
    *,
    devices: Optional[Sequence] = None,
    node_shards: Optional[int] = None,
    **kw,
) -> List[Dict]:
    """The reference's ``run_grid`` signature on ``api.plan``/``execute``,
    with its layout rules: ``node_shards > 1`` -> the ``config × node``
    mesh (the devices passed explicitly, their count a multiple of
    ``node_shards``); more than one device -> config-axis sharding;
    otherwise dense (on the one device, if one is given).  ``kw`` holds
    the other ``ExperimentSpec`` fields, ``device`` among them."""
    from repro_torch import api

    devices = list(devices) if devices is not None else None
    node_shards = node_shards if node_shards and node_shards > 1 else None
    if node_shards is not None:
        n_dev = len(devices) if devices is not None else 1
        if n_dev % node_shards:
            raise ValueError(f"node_shards={node_shards} must divide the device count ({n_dev})")
        layout = api.CONFIG_NODE
    elif devices is not None and len(devices) > 1:
        layout = api.CONFIG
    else:
        layout = api.DENSE
    spec = api.ExperimentSpec(
        protocol=protocol,
        workload=workload,
        configs=tuple(dict(c) for c in configs),
        devices=tuple(devices) if devices is not None else None,
        node_shards=node_shards,
        layout=layout,
        **kw,
    )
    return api.execute(api.plan(spec)).rows


def run_grid(
    protocol: str,
    workload: str,
    configs: Iterable[Dict],
    *,
    devices: Optional[Sequence] = None,
    node_shards: Optional[int] = None,
    **kw,
) -> List[Dict]:
    """DEPRECATED shim: use :mod:`repro_torch.api` (``plan``/``execute``).

    The reference's layout rules on the planner (:func:`_legacy_grid`), so
    the rows are ``api.execute``'s.  Emits one :class:`DeprecationWarning`.
    """
    _warn_legacy("run_grid")
    return _legacy_grid(protocol, workload, configs, devices=devices, node_shards=node_shards, **kw)


def run_grid_sharded(
    protocol: str,
    workload: str,
    configs: Iterable[Dict],
    *,
    devices: Optional[Sequence] = None,
    **kw,
) -> List[Dict]:
    """DEPRECATED shim: use :mod:`repro_torch.api` with ``devices="auto"``.

    ``devices`` defaults to every visible device of the spec's ``device``
    type (the reference's ``jax.devices()``); on one device this is the
    dense run.
    """
    _warn_legacy("run_grid_sharded")
    from repro_torch import api

    if devices is None:
        devices = visible_devices(kw.get("device", api.ExperimentSpec.device))
    return _legacy_grid(protocol, workload, configs, devices=list(devices), **kw)


def run_cell_sharded(
    protocol: str,
    workload: str,
    config: Optional[Dict] = None,
    *,
    node_shards: Optional[int] = None,
    devices: Optional[Sequence] = None,
    **kw,
) -> Dict:
    """DEPRECATED shim: use :mod:`repro_torch.api` with ``layout="node"``.

    One run of ``config`` with the simulated ``n_nodes`` axis sharded over
    ``devices``, or over the first ``node_shards`` visible devices (their
    count must divide ``n_nodes``); returns the node row.
    """
    _warn_legacy("run_cell_sharded")
    from repro_torch import api

    spec = api.ExperimentSpec(
        protocol=protocol,
        workload=workload,
        configs=(dict(config or {}),),
        devices=tuple(devices) if devices is not None else None,
        node_shards=node_shards,
        layout=api.NODE,
        **kw,
    )
    return api.execute(api.plan(spec)).rows[0]
