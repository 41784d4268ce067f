"""Bucketed static-axis padding in the port against the JAX reference
(the port's counterpart of ``tests/test_bucketed.py``).

Configs that sweep ``coroutines``, ``records_per_node`` or ``ticks`` plan
into power-of-two buckets padded to the bucket's maximum; each bucket runs
as one batched run in which padded slots, records and ticks are inert.
Rows must equal the reference's padded grid (integer counters bitwise,
float latencies to rtol=1e-5) and the port's own unpadded run of each
config, and ``plan_buckets`` must group, pad and reject exactly as the
reference's.  CALVIN's bucketed cases are in ``tests/test_torch_calvin.py``.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import sweep as jsweep
from repro_torch import api as tapi
from repro_torch.core import sweep as tsweep
from repro_torch.core.costmodel import CostModel

KW = dict(n_nodes=2, coroutines=6, records_per_node=64, ticks=32, warmup=4)
EXACT = ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips")
LATENCY = ("avg_latency_us", "stage_us_per_commit")
META = ("hybrid", "protocol", "workload", "grid_size", "n_buckets", "bucket", "coroutines", "records_per_node", "ticks")
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare(protocol, workload, configs, plane="torch", **over):
    kw = dict(KW, **over)
    j = japi.run(japi.ExperimentSpec(protocol=protocol, workload=workload, configs=configs, **kw)).rows
    t = tapi.run(tapi.ExperimentSpec(protocol=protocol, workload=workload, configs=configs, kernel_plane=plane,
                                     device="cpu", **kw)).rows
    assert len(j) == len(t) == len(configs)
    for a, b in zip(j, t):
        assert set(a) == set(b)
        for k in EXACT:
            assert a[k] == b[k], (protocol, workload, plane, a["hybrid"], k, a[k], b[k])
        for k in LATENCY:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-5, err_msg=k)
        for k in META:
            assert a[k] == b[k], (k, a[k], b[k])
    return j, t


@pytest.mark.parametrize("case", ["coroutines", "records", "ticks", "all_axes"])
def test_bucketed_sweeps_match_reference(case):
    """Bucket-padded sweeps of each static axis against the reference's
    padded grid, and each padded row against the port's own unpadded run."""
    protocol, workload, configs, over = {
        "coroutines": ("occ", "smallbank", [{"hybrid": 21, "coroutines": 5}, {"hybrid": 42, "coroutines": 8}],
                       dict(coroutines=8, records_per_node=128)),
        "records": ("sundial", "ycsb", [{"hybrid": 21, "records_per_node": 48, "hot_prob": 0.6},
                                        {"hybrid": 42, "records_per_node": 64, "hot_prob": 0.3}],
                    dict(coroutines=8, records_per_node=64)),
        "ticks": ("occ", "smallbank", [{"hybrid": 21, "ticks": 48}, {"hybrid": 21, "ticks": 37},
                                       {"hybrid": 42, "ticks": 48}], dict(coroutines=8, records_per_node=128, ticks=48)),
        # all three axes padded in one bucket
        "all_axes": ("mvcc", "tpcc", [{"hybrid": 3, "coroutines": 5, "records_per_node": 40, "ticks": 20},
                                      {"hybrid": 60, "coroutines": 7, "ticks": 30, "seed": 4}],
                     dict(coroutines=8, records_per_node=64, ticks=24)),
    }[case]
    j, t = _compare(protocol, workload, configs, "kernel" if case in ("records", "all_axes") else "torch", **over)
    kw = dict(KW, **over)
    for cfg, row in zip(configs, t):
        cfg, one = dict(cfg), dict(kw)
        for ax in tsweep.STATIC_AXES:
            if ax in cfg:
                one[ax] = cfg.pop(ax)
        (ref,) = tapi.run(tapi.ExperimentSpec(protocol=protocol, workload=workload, configs=[cfg], device="cpu",
                                              **one)).rows
        for k in EXACT:
            if k != "throughput_mtps":
                assert row[k] == ref[k], (case, cfg, k)
        # throughput is commits over sim_us, rounded as the reference rounds it: a bucket whose tick counts differ
        # divides by each config's count, an unpadded run's constant divisor is XLA's product with its float32
        # reciprocal (ROADMAP.md C.16)
        commits, sim_us = np.float32(row["commits"]), np.float32(row["ticks"] * CostModel().tick_us)
        ticks_padded = len({r["ticks"] for r in t}) > 1
        product = commits * (np.float32(1) / sim_us)
        assert row["throughput_mtps"] == (commits / sim_us if ticks_padded else product), (case, cfg)
        assert ref["throughput_mtps"] == product, (case, cfg)
        np.testing.assert_allclose(row["avg_latency_us"], ref["avg_latency_us"], rtol=RTOL)
    if case == "ticks":
        assert [r["ticks"] for r in t] == [48, 37, 48] and t[0]["commits"] > t[1]["commits"]


def test_multi_bucket_order_and_metadata_match_reference():
    configs = [{"hybrid": 0, "coroutines": 16}, {"hybrid": 63, "coroutines": 5}, {"hybrid": 21, "coroutines": 6}]
    j, t = _compare("nowait", "smallbank", configs, coroutines=8, records_per_node=128)
    assert [r["coroutines"] for r in t] == [16, 5, 6]
    assert all(r["n_buckets"] == 2 for r in t)
    assert t[1]["bucket"] == t[2]["bucket"] != t[0]["bucket"]


PLAN_CASES = [
    ([{"hybrid": 1, "coroutines": 5}, {"hybrid": 2, "coroutines": 8}, {"hybrid": 3, "coroutines": 20}, {"hybrid": 4}],
     dict(coroutines=8, records_per_node=128)),
    ([{"records_per_node": 33}, {"records_per_node": 48}], dict(coroutines=8, records_per_node=64)),
    ([{"ticks": 48}, {"ticks": 37}, {"ticks": 96}], dict(coroutines=8, records_per_node=64, ticks=48)),
    ([{"coroutines": 3, "records_per_node": 100, "ticks": 9}, {"seed": 2}, {"coroutines": 4, "ticks": 16},
      {"records_per_node": 129}], dict(coroutines=4, records_per_node=128, ticks=12)),
    ([{}], dict(coroutines=60, records_per_node=65536)),
]


@pytest.mark.parametrize("configs,kw", PLAN_CASES)
def test_plan_buckets_equals_reference(configs, kw):
    assert tsweep.plan_buckets(configs, **kw) == jsweep.plan_buckets(configs, **kw)


@pytest.mark.parametrize("bad", [[{"coroutines": 0}], [{"records_per_node": 0}], [{"ticks": 0}]])
def test_plan_buckets_rejects_what_the_reference_rejects(bad):
    kw = dict(coroutines=8, records_per_node=64, ticks=48)
    with pytest.raises(ValueError) as want:
        jsweep.plan_buckets(bad, **kw)
    with pytest.raises(ValueError) as got:
        tsweep.plan_buckets(bad, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_bucketed_grids_match_reference(seed):
    """Seeded random grids over codes, seeds and both padded shape axes (the
    reference's random-grid property, against its padded grid)."""
    rng = np.random.default_rng(seed)
    configs = []
    for _ in range(int(rng.integers(2, 5))):
        cfg = {"hybrid": int(rng.integers(0, 64)), "seed": int(rng.integers(0, 3))}
        if rng.random() < 0.8:
            cfg["coroutines"] = int(rng.integers(4, 9))  # one pow2 bucket (<= 8)
        if rng.random() < 0.5:
            cfg["records_per_node"] = int(rng.integers(33, 65))  # one bucket (<= 64)
        configs.append(cfg)
    _compare("occ", "smallbank", configs, coroutines=8, records_per_node=64)
