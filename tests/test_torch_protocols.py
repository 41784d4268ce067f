"""The port's serializability oracle (``repro_torch.core.validate``) on the
port's own histories, and against the reference's ``repro.core.validate``.

Every slot protocol runs in the port with a commit history (``history_cap``)
on smallbank and ycsb.  The port's oracle must find the history
serializable, lose no update, and replay it in commit order to the store's
final data; the reference's validator, fed the same history as numpy
arrays, must give the same graph, verdict, replay and final data.  The
cycle finder that replaces networkx is also held to a hand-made cycle.
"""
import numpy as np
import pytest
import torch

from repro.core import validate as jval
from repro.workloads import make_workload as jmake_workload
from repro_torch import convert
from repro_torch.core import validate as tval
from repro_torch.core.costmodel import ONE_SIDED, RPC, CostModel
from repro_torch.core.engine import EngineConfig, run
from repro_torch.core.protocols import mvcc, occ, sundial, twopl
from repro_torch.core.registry import get_protocol
from repro_torch.workloads import make_workload

COMMIT_STAGE = {
    "nowait": twopl.S_COMMIT,
    "waitdie": twopl.S_COMMIT,
    "occ": occ.S_COMMIT,
    "mvcc": mvcc.S_COMMIT,
    "sundial": sundial.S_COMMIT,
}
# a mixed coding so both communication planes execute
MIXED = (ONE_SIDED, RPC, ONE_SIDED, RPC, ONE_SIDED, RPC)


def _truncate(wl, k):
    """The workload with each txn cut to its first ``k`` ops."""

    def gen(keys, node, slot):
        return tuple(x[:, :k] for x in wl.gen(keys, node, slot))

    return wl._replace(max_ops=k, gen=gen)


def _run(proto, workload, plane):
    """The port's run with a history, as tests/test_oracle.py sets it up."""
    n_rec = 2 * 64
    if workload == "ycsb":
        # 2PL starves outright at hot_prob 0.5 on this tiny hot set
        hot = 0.15 if proto in ("nowait", "waitdie") else 0.5
        wl = _truncate(make_workload("ycsb", n_rec, hot_prob=hot), 4)
        jwl = jmake_workload("ycsb", n_rec, hot_prob=hot)._replace(max_ops=4)
    else:
        wl, jwl = make_workload(workload, n_rec), jmake_workload(workload, n_rec)
    ec = EngineConfig(
        protocol=proto, n_nodes=2, coroutines=8, records_per_node=64, rw=wl.rw, max_ops=wl.max_ops,
        hybrid=MIXED, history_cap=4096, kernel_plane=plane, device="cpu",
    )
    st, store, m = run(get_protocol(proto).tick, ec, CostModel(), wl, 96)
    return ec, wl, jwl, st, store, m


@pytest.mark.parametrize("workload", ["smallbank", "ycsb"])
@pytest.mark.parametrize("proto,plane", [("nowait", "torch"), ("waitdie", "kernel"), ("occ", "torch"),
                                         ("mvcc", "kernel"), ("sundial", "torch")])
def test_port_history_passes_the_oracle_and_matches_reference_validator(proto, plane, workload):
    ec, wl, jwl, st, store, m = _run(proto, workload, plane)
    commits = int(m["commits"])
    assert commits > 30, m
    assert int(st["h_idx"][0]) == commits  # every commit left one history row
    hist = tval.extract_history(st)
    st_np, store_np = convert.to_numpy(st), convert.to_numpy(store)
    assert hist == jval.extract_history(st_np)

    ok, cycle = tval.is_serializable(hist)
    assert ok and cycle == [], cycle
    assert jval.is_serializable(hist) == (True, [])
    assert sorted(tval.precedence_graph(hist).edges) == sorted(jval.precedence_graph(hist).edges)
    assert tval.check_no_lost_updates(hist, store) == (True, "")

    replay = tval.replay_committed(st, wl, ec.n_records)
    final = tval.final_data(store)
    np.testing.assert_array_equal(replay, jval.replay_committed(st_np, jwl, ec.n_records))
    np.testing.assert_array_equal(final, jval.final_data(store_np))
    keep = np.ones(ec.n_records, bool)
    inflight = tval.inflight_commit_writes(st, COMMIT_STAGE[proto])
    np.testing.assert_array_equal(inflight, jval.inflight_commit_writes(st_np, COMMIT_STAGE[proto]))
    keep[inflight] = False
    np.testing.assert_array_equal(replay[keep], final[keep])


def _hist(*txns):
    """txns: lists of (key, ver_r, ver_w, is_w)."""
    return [dict(txn=i, ts=(i, 1), ops=[dict(key=k, ver_r=r, ver_w=w, is_w=iw) for k, r, w, iw in ops])
            for i, ops in enumerate(txns)]


@pytest.mark.parametrize("case", ["write_skew", "lost_update", "chain", "empty"])
def test_cycle_finder_matches_networkx_verdict(case):
    hist = {
        # T0 reads x@0 and writes y@1, T1 reads y@0 and writes x@1: RW both ways
        "write_skew": _hist([(0, 0, 0, False), (1, 0, 1, True)], [(1, 0, 0, False), (0, 0, 1, True)]),
        # both read x@0; T0 writes x@1, T1 writes x@2: T1 -> T0 (RW) and T0 -> T1 (WW)
        "lost_update": _hist([(0, 0, 1, True)], [(0, 0, 2, True)]),
        # a serial chain: T0 writes x@1, T1 reads x@1 and writes x@2, T2 reads x@2
        "chain": _hist([(0, 0, 1, True)], [(0, 1, 2, True)], [(0, 2, 2, False)]),
        "empty": [],
    }[case]
    ok, cycle = tval.is_serializable(hist)
    j_ok, _ = jval.is_serializable(hist)
    assert ok == j_ok == (case in ("chain", "empty"))
    g = tval.precedence_graph(hist)
    if not ok:
        assert cycle and all(v in g.succ[u] for u, v in cycle)
        assert [v for _, v in cycle] == [u for u, _ in cycle[1:] + cycle[:1]]  # the edges close a loop
    else:
        assert cycle == []


def test_final_data_picks_the_newest_mvcc_version():
    store = {
        "wts_hi": torch.tensor([[0, 3, 3, 1], [0, 0, 0, 0]], dtype=torch.int32),
        "wts_lo": torch.tensor([[1, 2, 5, 9], [1, 0, 0, 0]], dtype=torch.int32),
        "vdata": torch.arange(16, dtype=torch.int32).reshape(2, 4, 2),
    }
    want = jval.final_data(convert.to_numpy(store))
    np.testing.assert_array_equal(tval.final_data(store), want)
    np.testing.assert_array_equal(want, [[4, 5], [8, 9]])
