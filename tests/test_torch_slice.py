"""The port's main path end to end against the JAX reference.

``repro_torch.api.run(ExperimentSpec(..., device="cpu"))`` and
``repro.api.run(...)`` on the same spec: integer counters, the ratios
built only from them and the final stores match BITWISE on both port
planes; the float latency metrics match to rtol=1e-5, because the float32
per-round sum in ``account_round`` (``per_txn.sum()``) runs in another
order in each framework.  The full-size golden counters that
``chip_smoke.py`` checks on the card are recomputed here from the JAX
reference (run this file as a script to rewrite them).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import engine as jeng
from repro.core.costmodel import CostModel as JCostModel
from repro.core.registry import get_protocol as jget_protocol
from repro.workloads import make_workload as jmake_workload
from repro_torch import api as tapi
from repro_torch.core import engine as teng
from repro_torch.core.costmodel import CostModel as TCostModel
from repro_torch.core.registry import get_protocol as tget_protocol
from repro_torch.workloads import make_workload as tmake_workload

KW = dict(n_nodes=2, coroutines=6, records_per_node=64, ticks=32, warmup=4)
CODES = (0, 63, 21, 42)
EXACT = ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips")
# float32 latency sums accumulate in another order in torch than in XLA
LATENCY = ("avg_latency_us", "stage_us_per_commit")
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores, where a thread pool per
    worker loses far more to contention than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(
    os.path.dirname(__file__), "..", "src", "repro_torch", "data", "golden_nowait_smallbank.json"
)
# the full-size spec chip_smoke.py runs: ExperimentSpec defaults
# (n_nodes=4, coroutines=60, records_per_node=65536, ticks=400, warmup=80)
GOLDEN_SPEC = dict(protocol="nowait", workload="smallbank")


# (protocol, workload, knobs of every config, spec overrides).  At this size
# NOWAIT starves on ycsb's 64-record nodes (0 commits), so its cell has 256.
CELLS = [
    ("nowait", "smallbank", {}, {}),
    ("waitdie", "smallbank", {}, {}),
    ("nowait", "ycsb", {}, dict(records_per_node=256)),
    ("waitdie", "ycsb", {"hot_prob": 0.6}, {}),
    ("occ", "smallbank", {}, {}),
    ("occ", "ycsb", {"hot_prob": 0.6}, {}),
    ("mvcc", "smallbank", {}, {}),
    ("mvcc", "ycsb", {"hot_prob": 0.6}, {}),
    ("sundial", "smallbank", {}, {}),
    ("sundial", "ycsb", {"hot_prob": 0.6}, {}),
]
_JROWS = {}


def _jax_rows(proto, workload, configs, kw):
    """repro.api rows, run once per distinct spec for the whole module."""
    key = (proto, workload, repr(configs), repr(sorted(kw.items())))
    if key not in _JROWS:
        _JROWS[key] = japi.run(japi.ExperimentSpec(protocol=proto, workload=workload, configs=configs, **kw)).rows
    return _JROWS[key]


def _rows_both(proto, plane, workload="smallbank", knobs=None, **over):
    kw = dict(KW, **over)
    configs = kw.pop("configs", [dict({"hybrid": c}, **(knobs or {})) for c in CODES])
    j = _jax_rows(proto, workload, configs, kw)
    t = tapi.run(
        tapi.ExperimentSpec(
            protocol=proto, workload=workload, configs=configs, kernel_plane=plane, device="cpu", **kw
        )
    ).rows
    return j, t


def _cell_id(proto, workload):
    return proto if workload == "smallbank" else f"{proto}-{workload}"


@pytest.mark.parametrize("plane", ["torch", "kernel"])
@pytest.mark.parametrize("proto,workload,knobs,over", CELLS, ids=[_cell_id(*c[:2]) for c in CELLS])
def test_slice_rows_match_reference(proto, workload, knobs, over, plane):
    j_rows, t_rows = _rows_both(proto, plane, workload, knobs, **over)
    assert len(j_rows) == len(t_rows) == len(CODES)
    assert sum(r["commits"] for r in j_rows) > 0 and sum(r["aborts"] for r in j_rows) > 0
    for a, b in zip(j_rows, t_rows):
        for k in EXACT:
            assert a[k] == b[k], (proto, workload, plane, a["hybrid"], k, a[k], b[k])
        for k in LATENCY:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=k)
        for k in ("hybrid", "protocol", "workload", "grid_size", "coroutines", "records_per_node", "ticks"):
            assert a[k] == b[k], k
        assert set(a) == set(b)


@pytest.mark.parametrize("plane", ["torch", "kernel"])
def test_slice_merge_stages_matches_reference(plane):
    j_rows, t_rows = _rows_both("nowait", plane, merge_stages=True, configs=[{"hybrid": 63}, {"hybrid": 21}])
    for a, b in zip(j_rows, t_rows):
        for k in EXACT:
            assert a[k] == b[k], (plane, a["hybrid"], k)
        for k in LATENCY:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=k)


STORE_CELLS = [
    ("nowait", 21, "smallbank", {}),
    ("waitdie", 42, "smallbank", {}),
    ("waitdie", 63, "ycsb", dict(hot_prob=0.6)),
    ("occ", 42, "ycsb", dict(hot_prob=0.6)),
    ("mvcc", 63, "ycsb", dict(hot_prob=0.6)),
    ("mvcc", 21, "smallbank", {}),
    ("sundial", 21, "ycsb", dict(hot_prob=0.6)),
    ("sundial", 63, "tpcc", {}),
]
_JRUNS = {}


def _jax_engine_run(proto, code, workload, wkw):
    key = (proto, code, workload, repr(sorted(wkw.items())))
    if key not in _JRUNS:
        n_rec = KW["n_nodes"] * KW["records_per_node"]
        wl = jmake_workload(workload, n_rec, **wkw)
        ec = jeng.EngineConfig(**_engine_common(proto, code, wl))
        _JRUNS[key] = jeng.run(jget_protocol(proto).tick, ec, JCostModel(), wl, KW["ticks"], warmup=KW["warmup"])
    return _JRUNS[key]


def _engine_common(proto, code, wl):
    return dict(
        protocol=proto, n_nodes=KW["n_nodes"], coroutines=KW["coroutines"],
        records_per_node=KW["records_per_node"], rw=wl.rw, max_ops=wl.max_ops,
        hybrid=tuple((code >> i) & 1 for i in range(6)), seed=5,
    )


@pytest.mark.parametrize("plane", ["torch", "kernel"])
@pytest.mark.parametrize(
    "proto,code,workload,wkw", STORE_CELLS,
    ids=[f"{p}-{c}" if w == "smallbank" else f"{p}-{c}-{w}" for p, c, w, _ in STORE_CELLS],
)
def test_final_store_matches_reference(proto, code, workload, wkw, plane):
    """engine.run on both sides: final store and state counters bitwise."""
    jst, jstore, jm = _jax_engine_run(proto, code, workload, wkw)
    twl = tmake_workload(workload, KW["n_nodes"] * KW["records_per_node"], **wkw)
    tst, tstore, tm = teng.run(
        tget_protocol(proto).tick,
        teng.EngineConfig(**_engine_common(proto, code, twl), kernel_plane=plane, device="cpu"),
        TCostModel(), twl, KW["ticks"], warmup=KW["warmup"],
    )
    assert set(jstore) == set(tstore)
    for k in jstore:
        np.testing.assert_array_equal(tstore[k].numpy(), np.asarray(jstore[k]), err_msg=k)
    for k in ("n_commit", "n_abort", "txn_no", "keys", "stage", "rounds", "clock", "ts_hi"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    assert int(tm["commits"]) == int(jm["commits"]) > 0


def test_plan_defaults_to_cuda_and_refuses_without_it():
    spec = tapi.ExperimentSpec(protocol="nowait", workload="smallbank", **KW)
    assert spec.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is what a CPU-only machine shows")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.plan(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.plan(tapi.ExperimentSpec(protocol="nowait", workload="smallbank", kernel_plane="kernel", **KW))


def test_plan_names_plane_and_device_and_rejects_unported_layouts():
    """The plane and device in the summary.  The layouts this test once
    refused (node, devices, node_shards) are ported: each case now plans
    as the reference's planner does and runs to the reference's rows (the
    node layout to its dense row, the reference's own contract), and
    node_shards with no devices named meets the reference's error on one
    device.  A per-config static axis and calvin, refused here once too,
    run to the reference's rows as well."""
    pl = tapi.plan(tapi.ExperimentSpec(protocol="nowait", workload="smallbank", device="cpu", **KW))
    assert pl.kernel_plane == "torch"  # "auto" on the CPU
    s = pl.summary()
    assert "kernel plane: torch" in s and "device: cpu" in s and "layout: dense" in s
    pk = tapi.plan(tapi.ExperimentSpec(protocol="nowait", workload="smallbank", device="cpu",
                                       kernel_plane="kernel", **KW))
    assert "kernel plane: kernel" in pk.summary()
    cases = [("nowait", "smallbank", dict(layout="node", devices=("cpu",) * 2), "node"),
             ("nowait", "smallbank", dict(devices="auto"), "dense"),
             ("nowait", "smallbank", dict(node_shards=2, devices=("cpu",) * 2), "node"),
             ("mvcc", "ycsb", dict(layout="node", devices=("cpu",) * 2), "node")]
    for proto, workload, over, layout in cases:
        spec = dict(protocol=proto, workload=workload, **KW)
        tp = tapi.plan(tapi.ExperimentSpec(device="cpu", **spec, **over))
        assert tp.layout == layout, over
        a, b = _jax_rows(proto, workload, [{}], KW)[0], tapi.execute(tp).row
        for k in EXACT:
            assert a[k] == b[k], (proto, over, k)
        for k in LATENCY:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=k)
        assert b["n_node_shards"] == (2 if layout == "node" else 1)
    with pytest.raises(ValueError, match=r"node_shards=2 > visible devices \(1\)"):
        tapi.plan(tapi.ExperimentSpec(protocol="nowait", workload="smallbank", device="cpu", node_shards=2, **KW))
    with pytest.raises(ValueError, match=r"node_shards=2 > visible devices \(1\)"):
        japi.plan(japi.ExperimentSpec(protocol="nowait", workload="smallbank", node_shards=2, **KW))
    # a config that sweeps a static axis plans into the reference's buckets and runs to its rows
    configs = [{"hybrid": 21, "coroutines": 4}, {"hybrid": 42}]
    j_rows, t_rows = _rows_both("nowait", "torch", configs=configs)
    assert [r["bucket"] for r in t_rows] == [r["bucket"] for r in j_rows]
    assert [r["coroutines"] for r in t_rows] == [4, KW["coroutines"]]
    for a, b in zip(j_rows, t_rows):
        for k in EXACT + ("n_buckets",):
            assert a[k] == b[k], (a["hybrid"], k)
    # calvin, the sixth protocol, runs through the same front door to the reference's rows
    j_rows, t_rows = _rows_both("calvin", "torch")
    for a, b in zip(j_rows, t_rows):
        for k in ("commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves"):
            assert a[k] == b[k], ("calvin", a["hybrid"], k)
        for k in ("throughput_mtps", "avg_latency_us"):
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=k)


def golden_rows():
    """The JAX reference's counters at the full-size spec (about 17 s on a CPU)."""
    rows = japi.run(japi.ExperimentSpec(configs=[{"hybrid": c} for c in CODES], **GOLDEN_SPEC)).rows
    return [{"hybrid": r["hybrid"], "commits": r["commits"], "aborts": r["aborts"]} for r in rows]


def test_golden_file_matches_jax_reference():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["spec"] == dict(GOLDEN_SPEC, configs=[{"hybrid": c} for c in CODES])
    assert golden["rows"] == golden_rows()


if __name__ == "__main__":
    # rewrite the golden file from the JAX reference
    golden = {
        "about": "JAX reference (repro.api) counters for chip_smoke.py's full-size "
        "NOWAIT/SmallBank spec, default jax_threefry_partitionable=True PRNG mode; "
        "written by tests/test_torch_slice.py",
        "spec": dict(GOLDEN_SPEC, configs=[{"hybrid": c} for c in CODES]),
        "rows": golden_rows(),
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
