"""The node-sharded runs of the port against the JAX reference.

The reference's node-sharded runs cannot run on jax 0.9.0 (its
``shard_map(check_rep=...)``), so they are held against the reference's
DENSE runs, which is the reference's own contract (sharded == dense,
bitwise).  ``engine.run_sharded`` at 2 and 4 node shards, all on the CPU,
against ``repro.core.engine.run`` for nowait, waitdie, occ, mvcc and
sundial on smallbank and mvcc on ycsb, on both planes, and CALVIN's
``run_epochs_sharded`` against ``run_epochs``: counters, state and the
final global store BITWISE, the float latency metrics to rtol=1e-5 (a
float32 sum over slots, or over epochs, runs in another order in each
framework).  The front door's layouts are in ``test_torch_layouts.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.costmodel import CostModel as JCostModel
from repro.core.protocols import calvin as jcalvin
from repro.core.registry import get_protocol as jget_protocol
from repro.workloads import make_workload as jmake_workload
from repro_torch.core import engine as teng
from repro_torch.core.costmodel import CostModel as TCostModel
from repro_torch.core.protocols import calvin as tcalvin
from repro_torch.core.registry import get_protocol as tget_protocol
from repro_torch.workloads import make_workload as tmake_workload

KW = dict(n_nodes=4, coroutines=4, records_per_node=64, ticks=32, warmup=4)
LATENCY = ("avg_latency_us", "stage_us_per_commit")
RTOL = 1e-5

# (protocol, workload, hybrid code, workload knobs)
ENGINE_CELLS = [
    ("nowait", "smallbank", 21, {}),
    ("waitdie", "smallbank", 42, {}),
    ("occ", "smallbank", 63, {}),
    ("mvcc", "smallbank", 21, {}),
    ("sundial", "smallbank", 42, {}),
    ("mvcc", "ycsb", 63, dict(hot_prob=0.6)),
]
_JRUNS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _common(proto, code, wl):
    return dict(protocol=proto, n_nodes=KW["n_nodes"], coroutines=KW["coroutines"],
                records_per_node=KW["records_per_node"], rw=wl.rw, max_ops=wl.max_ops,
                hybrid=tuple((code >> i) & 1 for i in range(6)), seed=5)


def _jax_run(proto, workload, code, wkw):
    key = (proto, workload, code)
    if key not in _JRUNS:
        wl = jmake_workload(workload, KW["n_nodes"] * KW["records_per_node"], **wkw)
        _JRUNS[key] = jeng.run(jget_protocol(proto).tick, jeng.EngineConfig(**_common(proto, code, wl)),
                               JCostModel(), wl, KW["ticks"], warmup=KW["warmup"])
    return _JRUNS[key]


@pytest.mark.parametrize("plane", ["torch", "kernel"])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("proto,workload,code,wkw", ENGINE_CELLS, ids=[f"{c[0]}-{c[1]}" for c in ENGINE_CELLS])
def test_run_sharded_matches_dense_reference(proto, workload, code, wkw, n_shards, plane):
    jst, jstore, jm = _jax_run(proto, workload, code, wkw)
    wl = tmake_workload(workload, KW["n_nodes"] * KW["records_per_node"], **wkw)
    ec = teng.EngineConfig(**_common(proto, code, wl), kernel_plane=plane, device="cpu")
    tst, tstore, tm = teng.run_sharded(tget_protocol(proto).tick, ec, TCostModel(), wl, KW["ticks"],
                                       warmup=KW["warmup"], devices=("cpu",) * n_shards)
    assert set(tstore) == set(jstore)
    for k in jstore:
        np.testing.assert_array_equal(tstore[k].numpy(), np.asarray(jstore[k]), err_msg=k)
    for k in ("n_commit", "n_abort", "txn_no", "keys", "stage", "rounds", "clock", "ts_hi", "ts_lo"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    for k in ("commits", "aborts", "abort_rate", "avg_round_trips"):
        assert tm[k][0].item() == np.asarray(jm[k]).item(), k
    for k in LATENCY:
        np.testing.assert_allclose(tm[k][0].numpy(), np.asarray(jm[k]), rtol=RTOL, err_msg=k)
    assert int(tm["commits"][0]) > 0 and int(tm["aborts"][0]) > 0


def _calvin_configs(workload, code):
    n_rec = KW["n_nodes"] * KW["records_per_node"]
    jwl, twl = jmake_workload(workload, n_rec), tmake_workload(workload, n_rec)
    common = dict(protocol="calvin", n_nodes=KW["n_nodes"], coroutines=KW["coroutines"],
                  records_per_node=KW["records_per_node"], rw=jwl.rw, max_ops=jwl.max_ops,
                  hybrid=tuple((code >> i) & 1 for i in range(6)), seed=7)
    return jeng.EngineConfig(**common), jwl, common, twl


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("workload,code,active", [("smallbank", 63, None), ("ycsb", 21, None), ("tpcc", 0, 5)])
def test_calvin_run_epochs_sharded_matches_dense_reference(workload, code, active, n_shards):
    """The final global store and every metric; with ``active`` the dead
    epochs past it must leave every shard's rows alone."""
    jec, jwl, common, twl = _calvin_configs(workload, code)
    jstore, jm = jcalvin.run_epochs(jec, JCostModel(), jwl, 8, epochs_active=active)
    tstore, tm = tcalvin.run_epochs_sharded(teng.EngineConfig(**common, device="cpu"), TCostModel(), twl, 8,
                                            devices=("cpu",) * n_shards, epochs_active=active)
    assert set(tstore) == set(jstore)
    for k in jstore:
        np.testing.assert_array_equal(tstore[k].numpy(), np.asarray(jstore[k]), err_msg=k)
    for k in ("commits", "aborts", "avg_round_trips", "avg_waves", "abort_rate"):
        assert tm[k][0].item() == np.asarray(jm[k]).item(), k
    for k in ("throughput_mtps", "avg_latency_us"):
        np.testing.assert_allclose(tm[k][0].item(), np.asarray(jm[k]), rtol=RTOL, err_msg=k)
    assert int(np.asarray(jstore["ver"]).sum()) > 0 and tm["avg_waves"][0].item() > 1
