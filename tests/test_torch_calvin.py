"""CALVIN, the sixth protocol, in the port against the JAX reference.

``repro_torch.api.run`` against ``repro.api.run`` on smallbank, ycsb and
tpcc at hybrid codes {0, 63, 21, 42} on both planes, and
``calvin.run_epochs`` against the reference's on the same inputs: commits,
aborts, the round-trip and wave averages and the final store match
BITWISE; ``throughput_mtps`` and ``avg_latency_us`` divide by a float32
sum over epochs that runs in another order in each framework, so they
match to rtol=1e-5.  The full-size golden counters that ``chip_smoke.py``
checks on the card are written by this file run as a script.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import engine as jeng
from repro.core.costmodel import CostModel as JCostModel
from repro.core.protocols import calvin as jcalvin
from repro.core.registry import get_protocol as jget_protocol
from repro.core.registry import protocol_names as jprotocol_names
from repro.workloads import make_workload as jmake_workload
from repro_torch import api as tapi
from repro_torch.core import engine as teng
from repro_torch.core.costmodel import CostModel as TCostModel
from repro_torch.core.protocols import calvin as tcalvin
from repro_torch.core.registry import get_protocol as tget_protocol
from repro_torch.core.registry import protocol_names as tprotocol_names
from repro_torch.workloads import make_workload as tmake_workload

KW = dict(n_nodes=2, coroutines=6, records_per_node=64, ticks=32, warmup=4)
CODES = (0, 63, 21, 42)
WORKLOADS = ("smallbank", "ycsb", "tpcc")
EXACT = ("commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves")
FLOAT = ("throughput_mtps", "avg_latency_us")  # a float32 sum over epochs
RTOL = 1e-5

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch", "data", "golden_calvin.json")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_rows(j_rows, t_rows, label):
    assert len(j_rows) == len(t_rows)
    for a, b in zip(j_rows, t_rows):
        assert set(a) == set(b), label
        for k in EXACT:
            assert a[k] == b[k], (label, a["hybrid"], k, a[k], b[k])
        for k in FLOAT:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=f"{label} {k}")
        assert b["stage_us_per_commit"] == [0.0] * 8
        for k in ("hybrid", "protocol", "workload", "grid_size", "n_buckets", "bucket", "coroutines",
                  "records_per_node", "ticks"):
            assert a[k] == b[k], (label, k)


_JROWS = {}


def _jax_rows(workload, configs, kw):
    key = (workload, repr(configs), repr(sorted(kw.items())))
    if key not in _JROWS:
        _JROWS[key] = japi.run(japi.ExperimentSpec(protocol="calvin", workload=workload, configs=configs, **kw)).rows
    return _JROWS[key]


@pytest.mark.parametrize("plane", ["torch", "kernel"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_calvin_rows_match_reference(workload, plane):
    configs = [{"hybrid": c} for c in CODES]
    j_rows = _jax_rows(workload, configs, KW)
    t_rows = tapi.run(tapi.ExperimentSpec(protocol="calvin", workload=workload, configs=configs,
                                          kernel_plane=plane, device="cpu", **KW)).rows
    _assert_rows(j_rows, t_rows, f"calvin/{workload}/{plane}")
    assert all(r["commits"] > 0 and r["aborts"] == 0 and r["avg_waves"] > 1 for r in t_rows)
    # one-sided sequencing (code bit 0) takes 4 rounds, RPC 2
    assert [r["avg_round_trips"] for r in t_rows] == [2.0, 4.0, 4.0, 2.0]


def _engine_configs(workload, code, seed=7, **over):
    n_rec = KW["n_nodes"] * KW["records_per_node"]
    jwl, twl = jmake_workload(workload, n_rec), tmake_workload(workload, n_rec)
    common = dict(protocol="calvin", n_nodes=KW["n_nodes"], coroutines=KW["coroutines"],
                  records_per_node=KW["records_per_node"], rw=jwl.rw, max_ops=jwl.max_ops,
                  hybrid=tuple((code >> i) & 1 for i in range(6)), seed=seed, **over)
    return jeng.EngineConfig(**common), jwl, common, twl


_JEPOCHS = {}


def _jax_epochs(workload, code, n_epochs=10):
    key = (workload, code, n_epochs)
    if key not in _JEPOCHS:
        jec, jwl, _, _ = _engine_configs(workload, code)
        _JEPOCHS[key] = jcalvin.run_epochs(jec, JCostModel(), jwl, n_epochs)
    return _JEPOCHS[key]


@pytest.mark.parametrize("plane", ["torch", "kernel"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_epochs_store_and_metrics_match_reference(workload, plane):
    """``run_epochs`` on both sides, one config at a time: the final store
    bitwise and every metric."""
    for code in CODES:
        jstore, jm = _jax_epochs(workload, code)
        _, _, common, twl = _engine_configs(workload, code)
        tstore, tm = tcalvin.run_epochs(
            teng.EngineConfig(**common, kernel_plane=plane, device="cpu"), TCostModel(), twl, 10
        )
        assert set(jstore) == set(tstore)
        for k in jstore:
            np.testing.assert_array_equal(tstore[k].numpy(), np.asarray(jstore[k]), err_msg=k)
        assert set(jm) == set(tm)
        for k in ("commits", "aborts", "avg_round_trips", "avg_waves", "abort_rate"):
            assert tm[k].shape == (1,) and tm[k].numpy()[0] == np.asarray(jm[k]), k
        for k in FLOAT:
            np.testing.assert_allclose(tm[k].numpy()[0], np.asarray(jm[k]), rtol=RTOL, err_msg=k)
        assert int(np.asarray(jstore["ver"]).sum()) > 0


def test_batched_run_epochs_store_slices_match_reference():
    """One batched ``run_epochs`` of four codes (the config axis): each
    config's slice of the store equals the reference's run of that config,
    and a middle config's last rows are its own."""
    workload = "smallbank"
    _, _, common, twl = _engine_configs(workload, 0)
    common = dict(common, hybrid=tuple(tuple((c >> i) & 1 for c in CODES) for i in range(6)), n_configs=len(CODES))
    tstore, tm = tcalvin.run_epochs(teng.EngineConfig(**common, device="cpu"), TCostModel(), twl, 10)
    R = KW["n_nodes"] * KW["records_per_node"]
    for g, code in enumerate(CODES):
        jstore, jm = _jax_epochs(workload, code)
        for k in jstore:
            np.testing.assert_array_equal(tstore[k][g * R:(g + 1) * R].numpy(), np.asarray(jstore[k]),
                                          err_msg=f"{code} {k}")
        assert tm["avg_waves"][g].item() == float(np.asarray(jm["avg_waves"]))
        assert tm["commits"][g].item() == int(np.asarray(jm["commits"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_waves_match_reference_including_int32_wrap(seed):
    """``_waves`` on drawn batches with repeated keys inside a txn, inactive
    ops, and keys large enough that ``key*(M+1)`` passes the 2**30
    sentinel and wraps int32: the same waves as the reference's."""
    rng = np.random.default_rng(seed)
    N, K = 24, 5
    for hi in (7, 40, 2**27):
        keys = rng.integers(0, hi, (N, K)).astype(np.int32)
        keys[:, 1] = np.where(rng.random(N) < 0.3, keys[:, 0], keys[:, 1])  # a key twice in one txn
        is_w = rng.random((N, K)) < 0.5
        valid = rng.random((N, K)) < 0.85
        ec = teng.EngineConfig(protocol="calvin", n_nodes=1, coroutines=N, records_per_node=2**31 - 1, device="cpu")
        want = np.asarray(jcalvin._waves(None, *map(jnp.asarray, (keys, is_w, valid))))
        got = tcalvin._waves(ec, *map(torch.tensor, (keys, is_w, valid)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"hi={hi}")
        assert want.max() > 0


def test_dead_epochs_leave_each_config_store_alone():
    """One batched ``run_epochs`` of four codes whose epochs end at
    different counts: the batch's wave loop runs to the largest wave count
    of the live configs, and a config past its own epochs executes no wave,
    so its slice of the store and its metrics equal the reference's run of
    exactly that many epochs."""
    workload, active = "smallbank", (10, 4, 10, 7)
    _, _, common, twl = _engine_configs(workload, 0)
    common = dict(common, hybrid=tuple(tuple((c >> i) & 1 for c in CODES) for i in range(6)), n_configs=len(CODES))
    tstore, tm = tcalvin.run_epochs(teng.EngineConfig(**common, device="cpu"), TCostModel(), twl, 10,
                                    epochs_active=active)
    R = KW["n_nodes"] * KW["records_per_node"]
    for g, (code, n) in enumerate(zip(CODES, active)):
        jstore, jm = _jax_epochs(workload, code, n)
        for k in jstore:
            np.testing.assert_array_equal(tstore[k][g * R:(g + 1) * R].numpy(), np.asarray(jstore[k]),
                                          err_msg=f"{code} {k}")
        for k in ("commits", "avg_waves", "avg_round_trips"):
            assert tm[k][g].item() == np.asarray(jm[k]).item(), (code, k)
        for k in FLOAT:
            np.testing.assert_allclose(tm[k][g].item(), np.asarray(jm[k]), rtol=RTOL, err_msg=f"{code} {k}")


def test_registry_entry_and_order_match_reference():
    assert tprotocol_names() == jprotocol_names()
    t, j = tget_protocol("calvin"), jget_protocol("calvin")
    assert t.tick is None and j.tick is None
    assert t.stages == j.stages == tcalvin.STAGES_USED
    assert tuple(t.caps) == tuple(j.caps)
    assert tcalvin.epochs_for_ticks(400) == jcalvin.epochs_for_ticks(400) == 50
    assert tcalvin.epochs_for_ticks(17) == jcalvin.epochs_for_ticks(17) == 8
    # the node hook runs the epochs node-sharded (run_epochs_sharded), to the reference's dense metrics
    jec, jwl, common, twl = _engine_configs("ycsb", 42)
    _, jm = jcalvin.run_epochs(jec, JCostModel(), jwl, tcalvin.epochs_for_ticks(72))
    tm = t.hooks.node_run(t, teng.EngineConfig(**common, device="cpu"), TCostModel(), twl, ticks=72, warmup=0,
                          devices=("cpu",) * 2)
    for k in ("commits", "aborts", "avg_round_trips", "avg_waves", "abort_rate"):
        assert tm[k].shape == (1,) and tm[k].item() == np.asarray(jm[k]).item(), k
    for k in FLOAT:
        np.testing.assert_allclose(tm[k].item(), np.asarray(jm[k]), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("configs,over", [
    ([{"ticks": 96}, {"ticks": 72}], dict(coroutines=8, records_per_node=128, ticks=96, warmup=8)),
    ([{"coroutines": 5}, {"coroutines": 8}], dict(coroutines=8, records_per_node=128, ticks=48, warmup=8)),
    ([{"hybrid": 1, "records_per_node": 40, "ticks": 100}, {"hybrid": 0, "exec_ticks": 2, "coroutines": 3, "seed": 3},
      {"hybrid": 63, "coroutines": 20, "qp_pressure": 0.7}], dict(coroutines=8, records_per_node=64)),
], ids=["ticks", "coroutines", "mixed"])
def test_calvin_bucketed_rows_match_reference(configs, over):
    """Bucket-padded CALVIN sweeps (ticks as epochs, co-routines, records)
    against the reference's padded grid, and each padded row against the
    port's unpadded run of its config."""
    kw = dict(KW, **over)
    j_rows = japi.run(japi.ExperimentSpec(protocol="calvin", workload="ycsb", configs=configs, **kw)).rows
    t_rows = tapi.run(tapi.ExperimentSpec(protocol="calvin", workload="ycsb", configs=configs, device="cpu", **kw)).rows
    _assert_rows(j_rows, t_rows, "calvin/bucketed")
    for cfg, row in zip(configs, t_rows):
        cfg, one = dict(cfg), dict(kw)
        for ax in ("coroutines", "records_per_node", "ticks"):
            if ax in cfg:
                one[ax] = cfg.pop(ax)
        (ref,) = tapi.run(tapi.ExperimentSpec(protocol="calvin", workload="ycsb", configs=[cfg], device="cpu", **one)).rows
        for k in ("commits", "aborts", "avg_waves", "avg_round_trips"):
            assert row[k] == ref[k], (cfg, k)


def golden_spec(workload):
    return {"protocol": "calvin", "workload": workload, "configs": [{"hybrid": c} for c in CODES]}


def golden_rows(workload):
    """The JAX reference's CALVIN rows at the full ExperimentSpec defaults
    (4 nodes x 60 co-routines, 65536 records per node, 400 ticks = 50
    epochs)."""
    rows = japi.run(japi.ExperimentSpec(**golden_spec(workload))).rows
    return [{k: r[k] for k in ("hybrid", "commits", "aborts") + EXACT[2:] + FLOAT} for r in rows]


def test_golden_file_spec():
    """The golden file holds the spec ``chip_smoke.py`` runs (the full-size
    reference run is written by hand: run this file as a script)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert [g["spec"] for g in golden["cells"]] == [golden_spec(w) for w in WORKLOADS]
    for g in golden["cells"]:
        assert [r["hybrid"] for r in g["rows"]] == ["".join(str((c >> i) & 1) for i in range(6)) for c in CODES]
        assert all(r["aborts"] == 0 and r["commits"] == 50 * 240 for r in g["rows"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    golden = {
        "about": "JAX reference (repro.api) CALVIN rows for chip_smoke.py's full-size specs (ExperimentSpec "
        "defaults: 4 nodes x 60 co-routines, 65536 records per node, 400 ticks = 50 epochs), default "
        "jax_threefry_partitionable=True PRNG mode; commits, aborts, abort_rate, avg_round_trips and "
        "avg_waves are exact, throughput_mtps and avg_latency_us hold a float32 sum over epochs "
        "(compare to rtol 1e-5); written by tests/test_torch_calvin.py",
        "cells": [{"spec": golden_spec(w), "rows": golden_rows(w)} for w in WORKLOADS],
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
