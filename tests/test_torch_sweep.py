"""The batched config axis and shape bucketing against the JAX reference.

A multi-config ``repro_torch.api`` spec runs each shape bucket as ONE
``engine.run`` whose state carries a leading config axis; its rows must
equal the reference's vmapped dense grid (``repro.api``): integer
counters and the ratios built only from them bitwise, float latencies to
rtol=1e-5 (float32 sums run in another order).  Each config's slice of a
batched run's final store equals the run of that config alone, and the
knob stacking rejects what the reference's rejects.  Bucketing is in
``tests/test_torch_bucketed.py``.  The 64-code golden file
``chip_smoke.py`` checks on the card is written by this file run as a
script.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import engine as jeng
from repro.core import sweep as jsweep
from repro.core.costmodel import CostModel as JCostModel
from repro.core.registry import get_protocol as jget_protocol
from repro.workloads import make_workload as jmake_workload
from repro_torch import api as tapi
from repro_torch.core import engine as teng
from repro_torch.core import sweep as tsweep
from repro_torch.core.costmodel import CostModel as TCostModel
from repro_torch.core.registry import get_protocol as tget_protocol
from repro_torch.kernels import ops as kops
from repro_torch.workloads import make_workload as tmake_workload

KW = dict(n_nodes=2, coroutines=6, records_per_node=64, ticks=32, warmup=4)
EXACT = ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips")
LATENCY = ("avg_latency_us", "stage_us_per_commit")
META = ("hybrid", "protocol", "workload", "grid_size", "n_buckets", "bucket", "n_devices", "n_node_shards",
        "coroutines", "records_per_node", "ticks")
RTOL = 1e-5
DATA = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch", "data")
GOLDEN4 = os.path.join(DATA, "golden_nowait_smallbank.json")
GOLDEN64 = os.path.join(DATA, "golden_nowait_smallbank_sweep64.json")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores, where a thread pool per
    worker loses far more to contention than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JROWS = {}


def _jax_rows(protocol, workload, configs, kw):
    """repro.api rows, run once per distinct spec for the whole module."""
    key = (protocol, workload, repr(configs), repr(sorted(kw.items())))
    if key not in _JROWS:
        _JROWS[key] = japi.run(japi.ExperimentSpec(protocol=protocol, workload=workload, configs=configs, **kw)).rows
    return _JROWS[key]


def _compare(protocol, workload, configs, plane="torch", **over):
    kw = dict(KW, **over)
    j = _jax_rows(protocol, workload, configs, kw)
    t = tapi.run(tapi.ExperimentSpec(protocol=protocol, workload=workload, configs=configs, kernel_plane=plane,
                                     device="cpu", **kw)).rows
    assert len(j) == len(t) == len(configs)
    for a, b in zip(j, t):
        assert set(a) == set(b)
        exact = EXACT if protocol != "calvin" else ("commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves")
        for k in exact:
            assert a[k] == b[k], (protocol, workload, plane, a["hybrid"], k, a[k], b[k])
        for k in LATENCY if protocol != "calvin" else ("avg_latency_us", "throughput_mtps"):
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-5, err_msg=k)
        for k in META:
            assert a[k] == b[k], (k, a[k], b[k])
    return j, t


MIXED = [{"hybrid": c} for c in (0, 63, 21, 42, 5, 58)]


@pytest.mark.parametrize("protocol", ["nowait", "waitdie", "occ", "mvcc", "sundial", "calvin"])
def test_mixed_codes_one_bucket_match_reference_grid(protocol):
    """Six hybrid codes in one bucket: every stage's primitive differs
    between the configs, so each predicate runs per config."""
    j, t = _compare(protocol, "smallbank", MIXED, "kernel" if protocol in ("waitdie", "mvcc") else "torch")
    assert all(r["n_buckets"] == 1 for r in t)
    assert sum(r["commits"] for r in t) > 0


@pytest.mark.parametrize("plane", ["torch", "kernel"])
def test_knob_grid_ycsb_matches_reference(plane):
    """``grid_product(hybrid=[0, 63], hot_prob=[0.0, 0.9], seed=[0, 1])``:
    per-config hot-set probabilities and seeds ride the config axis."""
    configs = tapi.grid_product(hybrid=[0, 63], hot_prob=[0.0, 0.9], seed=[0, 1])
    j, t = _compare("mvcc", "ycsb", configs, plane)
    assert len({r["commits"] for r in t}) > 2


def test_exec_ticks_and_qp_pressure_match_reference():
    configs = [{"hybrid": 63, "exec_ticks": 1}, {"hybrid": 21, "exec_ticks": 4}, {"hybrid": 42, "qp_pressure": 0.5},
               {"hybrid": 63, "qp_pressure": 3.0, "exec_ticks": 2}, {"hybrid": 63, "qp_pressure": 1e4}]
    j, t = _compare("occ", "smallbank", configs)
    assert t[0]["commits"] != t[1]["commits"] and t[0]["avg_latency_us"] != t[4]["avg_latency_us"]


def test_merge_stages_mixed_codes_match_reference():
    """Cross-stage doorbell merging decided per config (occ's VALIDATE→LOG
    and COMMIT→LOG pairs)."""
    _compare("occ", "smallbank", [{"hybrid": c} for c in (63, 21, 42, 0, 59)], merge_stages=True)


@pytest.mark.parametrize("configs,kind", [
    ([], ValueError), ([{"hot_prob": 0.3}], TypeError), ([{"hybrid": 1, "nope": 2}], TypeError),
    ([{"hybrid": (1, 0)}], ValueError),
])
def test_make_knobs_messages_match_reference(configs, kind):
    with pytest.raises(kind) as want:
        jsweep.make_knobs("smallbank", configs)
    with pytest.raises(kind) as got:
        tsweep.make_knobs("smallbank", configs)
    assert str(got.value) == str(want.value)


def test_make_knobs_stacks_like_the_reference():
    configs = [{"hybrid": 5, "seed": -3, "exec_ticks": 2, "hot_prob": 0.37, "qp_pressure": 0.1}, {}]
    j, t = jsweep.make_knobs("ycsb", configs), tsweep.make_knobs("ycsb", configs)
    for name in ("hybrid", "seed", "exec_ticks", "hot_prob", "qp_pressure"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_one_bucket_is_one_engine_run(monkeypatch):
    calls = []
    real = teng.run

    def counted(*a, **k):
        calls.append(a[1].n_configs)
        return real(*a, **k)

    monkeypatch.setattr(teng, "run", counted)
    spec = dict(protocol="nowait", workload="smallbank", device="cpu", **KW)
    rows = tapi.run(tapi.ExperimentSpec(configs=[{"hybrid": c} for c in range(8)], **spec)).rows
    assert calls == [8] and len(rows) == 8
    calls.clear()
    tapi.run(tapi.ExperimentSpec(configs=[{"hybrid": 1, "coroutines": 3}, {"hybrid": 2}, {"hybrid": 3}], **spec))
    assert calls == [1, 2]  # two buckets: coroutines 3 (pow2 4) and 6 (pow2 8)


_JSTORES = {}


def _jax_store(protocol, workload, code, seed):
    key = (protocol, workload, code, seed)
    if key not in _JSTORES:
        n_rec = KW["n_nodes"] * KW["records_per_node"]
        wl = jmake_workload(workload, n_rec)
        ec = jeng.EngineConfig(protocol=protocol, n_nodes=KW["n_nodes"], coroutines=KW["coroutines"],
                               records_per_node=KW["records_per_node"], rw=wl.rw, max_ops=wl.max_ops,
                               hybrid=tuple((code >> i) & 1 for i in range(6)), seed=seed)
        _JSTORES[key] = jeng.run(jget_protocol(protocol).tick, ec, JCostModel(), wl, KW["ticks"], warmup=KW["warmup"])
    return _JSTORES[key]


@pytest.mark.parametrize("protocol,workload,plane,against", [
    ("waitdie", "smallbank", "kernel", "reference"),
    ("mvcc", "ycsb", "kernel", "port"),
    ("sundial", "smallbank", "torch", "port"),
])
def test_batched_store_slices_match_single_runs(protocol, workload, plane, against):
    """A batched engine.run of three configs that differ in code and seed:
    config g's slice of every store array and state counter equals the run
    of that config alone, the reference's (``against="reference"``) or the
    port's own, which ``tests/test_torch_slice.py`` holds to the
    reference's store bitwise."""
    codes, seeds = (63, 21, 42), (5, 6, 5)
    n_rec = KW["n_nodes"] * KW["records_per_node"]
    wl = tmake_workload(workload, n_rec)
    common = dict(protocol=protocol, n_nodes=KW["n_nodes"], coroutines=KW["coroutines"],
                  records_per_node=KW["records_per_node"], rw=wl.rw, max_ops=wl.max_ops, kernel_plane=plane,
                  device="cpu")
    ec = teng.EngineConfig(**common, hybrid=tuple(tuple((c >> i) & 1 for c in codes) for i in range(6)), seed=seeds,
                           n_configs=3)
    tick = tget_protocol(protocol).tick
    st, store, m = teng.run(tick, ec, TCostModel(), wl, KW["ticks"], warmup=KW["warmup"])
    R, N = n_rec, ec.n_slots
    for g, (code, seed) in enumerate(zip(codes, seeds)):
        if against == "reference":
            one_st, one_store, one_m = _jax_store(protocol, workload, code, seed)
        else:
            one = teng.EngineConfig(**common, hybrid=tuple((code >> i) & 1 for i in range(6)), seed=seed)
            one_st, one_store, one_m = teng.run(tick, one, TCostModel(), wl, KW["ticks"], warmup=KW["warmup"])
        for k in one_store:
            np.testing.assert_array_equal(store[k][g * R:(g + 1) * R].numpy(), np.asarray(one_store[k]), err_msg=k)
        np.testing.assert_array_equal(teng.local_keys(ec, st["keys"])[g * N:(g + 1) * N].numpy(),
                                      np.asarray(one_st["keys"]))
        for k in ("n_commit", "n_abort", "txn_no", "stage", "rounds", "clock", "ts_hi", "ts_lo"):
            np.testing.assert_array_equal(st[k][g * N:(g + 1) * N].numpy(), np.asarray(one_st[k]), err_msg=k)
        assert int(m["commits"][g]) == int(np.asarray(one_m["commits"]).reshape(-1)[0]) > 0


@pytest.mark.parametrize("protocol,plane", [("occ", "torch"), ("mvcc", "kernel")])
def test_batched_histories_pass_the_oracle(protocol, plane):
    """One history per config: each config's slice of a batched run with a
    history equals the run of that config alone and passes the
    serializability oracle (the single runs are held to the reference's
    validator in ``tests/test_torch_protocols.py``)."""
    from repro_torch.core import validate as tval
    from repro_torch.core.protocols import mvcc, occ

    commit_stage = {"occ": occ.S_COMMIT, "mvcc": mvcc.S_COMMIT}[protocol]
    codes, n_rec = (63, 21, 42), KW["n_nodes"] * KW["records_per_node"]
    wl = tmake_workload("smallbank", n_rec)
    common = dict(protocol=protocol, n_nodes=KW["n_nodes"], coroutines=KW["coroutines"],
                  records_per_node=KW["records_per_node"], rw=wl.rw, max_ops=wl.max_ops, history_cap=2048,
                  kernel_plane=plane, device="cpu")
    tick = tget_protocol(protocol).tick
    ec = teng.EngineConfig(**common, hybrid=tuple(tuple((c >> i) & 1 for c in codes) for i in range(6)), n_configs=3)
    st, store, m = teng.run(tick, ec, TCostModel(), wl, 64)
    for g, code in enumerate(codes):
        one = teng.EngineConfig(**common, hybrid=tuple((code >> i) & 1 for i in range(6)))
        st1, store1, m1 = teng.run(tick, one, TCostModel(), wl, 64)
        sg, storeg = teng.config_slice(ec, st, g), teng.config_slice(ec, store, g)
        for k in st1:
            assert torch.equal(sg[k], st1[k]), (code, k)
        for k in store1:
            assert torch.equal(storeg[k], store1[k]), (code, k)
        hist = tval.extract_history(sg)
        assert len(hist) == int(m["commits"][g]) > 20
        assert tval.is_serializable(hist) == (True, [])
        assert tval.check_no_lost_updates(hist, storeg) == (True, "")
        replay, final = tval.replay_committed(sg, wl, n_rec), tval.final_data(storeg)
        keep = np.ones(n_rec, bool)
        keep[tval.inflight_commit_writes(sg, commit_stage)] = False
        np.testing.assert_array_equal(replay[keep], final[keep])


def test_config_slice_and_freeze_split_by_config_and_refuse_other_sizes():
    """Every tensor but the shared tick counter splits into G equal parts,
    one per config; a leading size that is no multiple of G raises."""
    G, N = 3, 4
    ec = teng.EngineConfig(protocol="nowait", n_nodes=1, coroutines=N, records_per_node=N, n_configs=G, device="cpu")
    st = {"tick": torch.tensor([7]), "stage": torch.arange(G * N), "keys": torch.arange(G * N * 2).view(G * N, 2)}
    one = teng.config_slice(ec, st, 1)
    assert one["tick"].tolist() == [7]
    assert one["stage"].tolist() == [4, 5, 6, 7]
    assert one["keys"].tolist() == [[8 - N + 2 * i, 9 - N + 2 * i] for i in range(N)]  # own keys: rows - g*R
    old = {k: -v for k, v in st.items()}
    out = teng._freeze(ec, torch.tensor([True, False, True]), st, old)
    assert out["tick"].tolist() == [7]
    assert out["stage"].tolist() == [0, 1, 2, 3, -4, -5, -6, -7, 8, 9, 10, 11]
    for bad in ({"h_idx": torch.zeros(G + 1)}, {"wait_us": torch.zeros(1)}):
        with pytest.raises(ValueError, match="no multiple"):
            teng.config_slice(ec, bad, 0)
        with pytest.raises(ValueError, match="no multiple"):
            teng._freeze(ec, torch.ones(G, dtype=torch.bool), bad, bad)


def test_middle_config_boundaries_and_drop_sentinel():
    """Keys are store rows g*R + key: a middle config's last row, the
    next config's first row and the drop sentinel G*R stay apart on both
    planes, in the gathers, the scatters and the arbitration."""
    G, R = 3, 8
    ec = teng.EngineConfig(protocol="nowait", n_nodes=2, coroutines=2, records_per_node=R // 2, device="cpu",
                           n_configs=G)
    assert ec.store_rows == G * R
    arr = torch.arange(G * R, dtype=torch.int32) * 10
    lock = torch.arange(G * R, dtype=torch.int32) + 1000
    # config 1's last row, config 2's first row, the sentinel, config 1's first row
    idx = torch.tensor([2 * R - 1, 2 * R, G * R, R], dtype=torch.int32)
    out = teng.write_rows(ec, arr, idx, torch.tensor([-1, -2, -3, -4], dtype=torch.int32))
    want = arr.clone()
    want[2 * R - 1], want[2 * R], want[R] = -1, -2, -4
    assert torch.equal(out, want) and out.shape == (G * R,)
    added = teng.write_rows(ec, arr, idx, 1, op="add")
    assert int(added.sum() - arr.sum()) == 3  # the sentinel's add dropped
    keys = torch.tensor([[2 * R - 1, 2 * R], [R, 0]], dtype=torch.int32)
    for plane in kops.KERNEL_PLANES:
        ecp = teng.EngineConfig(**{**ec.__dict__, "kernel_plane": plane})
        got = teng.read_rows_many(ecp, (arr, lock), keys)
        assert torch.equal(got[0], arr[keys.long()]) and torch.equal(got[1], lock[keys.long()])
    # past the whole store (the kernels' padding keys) a gather reads zero rows
    far = torch.tensor([[G * R, G * R + 5]], dtype=torch.int32)
    for t in kops.gather_many((arr, lock), far, plane=kops.KERNEL):
        assert not t.any()
    # arbitration: the same key in two configs is two rows, two contests
    keys_f = torch.tensor([R - 1, R - 1, 2 * R - 1, 2 * R - 1, 3 * R - 1, 3 * R - 1], dtype=torch.int32)
    hi = torch.tensor([3, 1, 3, 1, 3, 1], dtype=torch.int32)
    lo = torch.zeros(6, dtype=torch.int32)
    act = torch.ones(6, dtype=torch.bool)
    for plane in kops.KERNEL_PLANES:
        won = kops.cas_arbitrate(keys_f, hi, lo, act, ec.store_rows, plane=plane, groups=G)
        assert won.tolist() == [False, True] * 3


def golden64_spec():
    return {"protocol": "nowait", "workload": "smallbank", "configs": [{"hybrid": c} for c in range(64)]}


def test_sweep64_golden_file_spec_and_its_four_codes():
    """The 64-code golden file holds the spec ``chip_smoke.py`` runs, and its
    rows for codes {0, 63, 21, 42} equal golden_nowait_smallbank.json (the
    full-size reference run is written by hand: run this file as a script)."""
    with open(GOLDEN64) as f:
        g64 = json.load(f)
    with open(GOLDEN4) as f:
        g4 = json.load(f)
    assert g64["spec"] == golden64_spec()
    assert [r["hybrid"] for r in g64["rows"]] == ["".join(str((c >> i) & 1) for i in range(6)) for c in range(64)]
    by_code = {r["hybrid"]: r for r in g64["rows"]}
    assert [by_code[r["hybrid"]] for r in g4["rows"]] == g4["rows"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    rows = japi.run(japi.ExperimentSpec(**golden64_spec())).rows
    golden = {
        "about": "JAX reference (repro.api, one vmapped dense bucket) counters for chip_smoke.py's batched "
        "sweep: NOWAIT/SmallBank at the full ExperimentSpec defaults (4 nodes x 60 co-routines, 65536 records "
        "per node, 400 + 80 ticks), all 64 hybrid codes, default jax_threefry_partitionable=True PRNG mode; "
        "ticks not cut; written by tests/test_torch_sweep.py",
        "spec": golden64_spec(),
        "rows": [{"hybrid": r["hybrid"], "commits": r["commits"], "aborts": r["aborts"]} for r in rows],
    }
    with open(GOLDEN64, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
