"""The front door's device layouts in the port against the JAX reference.

``repro_torch.api``'s ``config``, ``node`` and ``config_node`` layouts,
every device the CPU (a device may repeat), against the reference's DENSE
rows for six protocols on smallbank and mvcc on ycsb, on both planes:
mixed codes, a static axis bucketed and a padded remainder.  The
reference's node-sharded layouts cannot run on jax 0.9.0 (its
``shard_map(check_rep=...)``), and its own contract is that they equal
its dense rows.  Its ``config`` layout does run: the port's is held to it
on 4 forced host devices (a subprocess).  Counters and the ratios of
counters match BITWISE, float32 sums to rtol=1e-5.  Last, the planner's
errors against the reference planner's.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_nodes=4, coroutines=4, records_per_node=64, ticks=32, warmup=4)
LATENCY = ("avg_latency_us", "stage_us_per_commit")
RTOL = 1e-5

# three configs: mixed codes, one with fewer co-routines and fewer ticks (one padded bucket), and a
# remainder on two config shards; the node layout runs the config that sets no static axis
CONFIGS = [{"hybrid": 21, "coroutines": 3, "ticks": 24}, {"hybrid": 63}, {"hybrid": 42, "seed": 3}]
LAYOUT_CELLS = [("nowait", "smallbank"), ("waitdie", "smallbank"), ("occ", "smallbank"), ("mvcc", "smallbank"),
                ("sundial", "smallbank"), ("calvin", "smallbank"), ("mvcc", "ycsb")]
_JROWS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rows(proto, workload):
    if (proto, workload) not in _JROWS:
        _JROWS[proto, workload] = japi.run(japi.ExperimentSpec(protocol=proto, workload=workload, configs=CONFIGS,
                                                               **KW)).rows
    return _JROWS[proto, workload]


def _same_row(a, b, label):
    """Counters and the ratios of counters exactly, float32 sums to RTOL
    (CALVIN's throughput too: its float32 sum over epochs)."""
    calvin = a["protocol"] == "calvin"
    exact = ("commits", "aborts", "abort_rate", "avg_round_trips") + (("avg_waves",) if calvin else
                                                                      ("throughput_mtps",))
    for k in exact:
        assert a[k] == b[k], (label, a["hybrid"], k, a[k], b[k])
    for k in LATENCY + (("throughput_mtps",) if calvin else ()):
        np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=f"{label} {k}")


@pytest.mark.parametrize("plane", ["torch", "kernel"])
@pytest.mark.parametrize("proto,workload", LAYOUT_CELLS, ids=[f"{p}-{w}" for p, w in LAYOUT_CELLS])
def test_layouts_match_reference_dense_rows(proto, workload, plane):
    """``config`` on 2 devices, ``config_node`` on 2 × 2 (CALVIN: refused,
    as by the reference) and ``node`` on 4, every device the CPU: each row
    equals the reference's dense row of its config, with the reference's
    row keys (the node row's own, shorter set, as the reference's)."""
    j_rows = _jax_rows(proto, workload)
    common = dict(protocol=proto, workload=workload, kernel_plane=plane, device="cpu", **KW)
    layouts = [("config", dict(devices=("cpu",) * 2)), ("config_node", dict(devices=("cpu",) * 4, node_shards=2))]
    for layout, over in layouts:
        spec = tapi.ExperimentSpec(configs=CONFIGS, **common, **over)
        if proto == "calvin" and layout == "config_node":
            with pytest.raises(ValueError, match="batch_node_shardable=False"):
                tapi.plan(spec)
            continue
        pl = tapi.plan(spec)
        assert pl.layout == layout and len(pl.buckets) == 1
        rows = tapi.execute(pl).rows
        for a, b in zip(j_rows, rows):
            assert set(a) == set(b)
            _same_row(a, b, f"{proto}/{workload}/{layout}")
            for k in ("hybrid", "grid_size", "n_buckets", "bucket", "coroutines", "records_per_node", "ticks"):
                assert a[k] == b[k], k
            assert (b["n_devices"], b["n_node_shards"]) == ((2, 1) if layout == "config" else (4, 2))
    node = tapi.run(tapi.ExperimentSpec(configs=[CONFIGS[1]], layout="node", devices=("cpu",) * 4, **common)).row
    assert set(node) == set(j_rows[1]) - {"grid_size", "n_buckets", "bucket", "n_devices", "coroutines",
                                          "records_per_node", "ticks"}
    _same_row(j_rows[1], node, f"{proto}/{workload}/node")
    assert node["n_node_shards"] == 4 and node["hybrid"] == j_rows[1]["hybrid"]
    assert all(r["commits"] > 0 for r in j_rows)


_REF_CONFIG = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro import api
assert len(__import__("jax").devices()) == 4
configs = [{"hybrid": c, "seed": i} for i, c in enumerate((0, 1, 5, 21, 42, 63))] + [{"hybrid": 7, "coroutines": 2}]
rows = api.run(api.ExperimentSpec(protocol="occ", workload="smallbank", configs=configs, devices="auto",
                                  n_nodes=2, coroutines=4, records_per_node=64, ticks=32, warmup=4)).rows
print(json.dumps({"configs": configs, "rows": rows}))
"""


def test_config_layout_matches_reference_config_sharded_rows():
    """Six configs (a remainder on four devices) and a seventh in a bucket
    of its own (three pad rows):
    the port's ``config`` layout on ``("cpu",) * 4`` against the
    reference's on 4 forced host devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_CONFIG], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    res = tapi.run(tapi.ExperimentSpec(protocol="occ", workload="smallbank", configs=ref["configs"],
                                       devices=("cpu",) * 4, device="cpu", n_nodes=2, coroutines=4,
                                       records_per_node=64, ticks=32, warmup=4))
    assert res.plan.layout == "config" and len(res.plan.buckets) == 2
    for a, b in zip(ref["rows"], res.rows):
        assert set(a) == set(b)
        _same_row(a, b, "occ/config")
        for k in ("hybrid", "n_devices", "n_node_shards", "grid_size", "n_buckets", "bucket", "coroutines"):
            assert a[k] == b[k], k
    assert res.rows[0]["n_devices"] == 4


# (ExperimentSpec overrides, whether the port's message equals the reference's); the reference runs
# its planner with its one CPU device repeated, as the port runs with ("cpu",) * n
ERRORS = [
    (dict(protocol="calvin", configs=[{}, {}], node_shards=2, n=4), False),  # calvin on config_node
    (dict(configs=[{}, {}], node_shards=3, n=6), True),  # node_shards does not divide n_nodes
    (dict(configs=[{}, {}], node_shards=2, n=3), True),  # ... nor the device count
    (dict(configs=[{}], layout="node", n=3), True),  # node mesh: 3 devices, 4 nodes
    (dict(configs=[{}], node_shards=2, n=4), True),  # node_shards conflicts with the devices
    (dict(configs=[{}, {}], layout="dense", n=2), True),  # dense with two devices
    (dict(configs=[{}, {}], layout="node", n=2), True),  # node with several configs
    (dict(configs=[{"coroutines": 3}], layout="node", n=2), True),  # node buckets no static axis
    (dict(configs=[{}, {}], layout="config_node", node_shards=1, n=2), True),
    (dict(configs=[{}], layout="mesh", n=1), True),
]


@pytest.mark.parametrize("over,same", ERRORS, ids=[str(i) for i in range(len(ERRORS))])
def test_planner_errors_match_reference(over, same):
    over = dict(over)
    n = over.pop("n")
    base = dict(dict(protocol="nowait", workload="smallbank", **KW), **over)
    with pytest.raises(ValueError) as want:
        japi.plan(japi.ExperimentSpec(**base, devices=(jax.devices()[0],) * n))
    with pytest.raises(ValueError) as got:
        tapi.plan(tapi.ExperimentSpec(**base, devices=("cpu",) * n, device="cpu"))
    if same:
        assert str(got.value) == str(want.value)
    else:
        assert str(got.value).split(" (configs")[0] == str(want.value).split(" (configs")[0]


def test_devices_auto_and_node_shards_on_the_cpu_follow_the_reference():
    """On the CPU, "auto" names the one CPU (as ``jax.devices()`` on one
    host device): a grid plans dense, and node_shards=2 finds one device."""
    spec = dict(protocol="nowait", workload="smallbank", configs=[{"hybrid": 63}], **KW)
    assert tapi.plan(tapi.ExperimentSpec(**spec, devices="auto", device="cpu")).layout == "dense"
    assert japi.plan(japi.ExperimentSpec(**spec, devices="auto")).layout == "dense"
    for mod, extra in ((japi, {}), (tapi, dict(device="cpu"))):
        with pytest.raises(ValueError, match=r"node_shards=2 > visible devices \(1\)"):
            mod.plan(mod.ExperimentSpec(**spec, node_shards=2, **extra))
    with pytest.raises(ValueError, match="pass None, 'auto'"):
        tapi.plan(tapi.ExperimentSpec(**spec, devices="all", device="cpu"))
