"""The port's MVCC against the JAX reference's, piece by piece.

The version-pick helpers bitwise against ``repro.core.protocols.mvcc`` on
both port planes (the kernel plane reads non-contiguous row views in
place), the fused version read against the reference's gathers and pick,
the kernel-plane calls one MVCC tick makes
(what ``chip_smoke.py`` asserts as launches on the card), and the
full-size golden counters of ``chip_smoke.py``'s MVCC·YCSB main path,
recomputed from the JAX reference (run this file as a script to rewrite
them).  End-to-end rows and final stores are in ``tests/test_torch_slice.py``,
tick by tick in ``tests/test_torch_engine.py``.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import engine as jeng
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.protocols import mvcc as jmvcc
from repro.core.timestamps import TS as JTS
from repro_torch.core import engine as teng
from repro_torch.core.costmodel import CostModel
from repro_torch.core.engine import EngineConfig
from repro_torch.core.protocols import mvcc as tmvcc
from repro_torch.core.registry import get_protocol
from repro_torch.core.store import init_store
from repro_torch.core.timestamps import TS
from repro_torch.kernels import ops
from repro_torch.workloads import make_workload

CODES = (0, 63, 21, 42)
GOLDEN = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch", "data", "golden_mvcc_ycsb.json")
# the full-size spec chip_smoke.py runs: ExperimentSpec defaults
# (n_nodes=4, coroutines=60, records_per_node=65536, ticks=400, warmup=80)
GOLDEN_SPEC = dict(protocol="mvcc", workload="ycsb")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wts_case(N, K, S, seed):
    """Narrow timestamps, so empty slots, ties and ctts == wts all occur."""
    rng = np.random.default_rng(seed)
    wh, wl = (rng.integers(0, 3, (N, K, S)).astype(np.int32) for _ in range(2))
    ch, cl = (rng.integers(0, 3, (N, 1)).astype(np.int32) for _ in range(2))
    lh, ll = (rng.integers(-1, 2, (N, K)).astype(np.int32) for _ in range(2))
    return wh, wl, ch, cl, lh, ll


def _ec(plane, **kw):
    return EngineConfig(protocol="mvcc", n_nodes=2, coroutines=6, records_per_node=64, device="cpu",
                        kernel_plane=plane, **kw)


@pytest.mark.parametrize("S", [1, 2, 4, 16])
@pytest.mark.parametrize("with_lock", [True, False])
def test_version_pick_matches_reference_on_both_planes(S, with_lock):
    wh, wl, ch, cl, lh, ll = _wts_case(12, 10, S, S * 7 + with_lock)
    want = {}
    for jplane in ("jnp", "pallas_interpret"):
        jec = JEngineConfig(protocol="mvcc", kernel_plane=jplane)
        jlock = JTS(jnp.asarray(lh), jnp.asarray(ll)) if with_lock else None
        out = jmvcc._version_pick(jec, JTS(jnp.asarray(wh), jnp.asarray(wl)), JTS(jnp.asarray(ch), jnp.asarray(cl)), jlock)
        want[jplane] = [None if o is None else np.asarray(o) for o in out]
    # the kernel plane reads row views in place: column slices of one packed (M, 2S) table
    table = torch.tensor(np.concatenate([wh.reshape(120, S), wl.reshape(120, S)], axis=1))
    vh, vl = table[:, :S].reshape(12, 10, S), table[:, S:].reshape(12, 10, S)
    assert not vh.is_contiguous()
    for plane in ("torch", "kernel"):
        lock = TS(torch.tensor(lh), torch.tensor(ll)) if with_lock else None
        got = tmvcc._version_pick(_ec(plane), TS(vh, vl), TS(torch.tensor(ch), torch.tensor(cl)), lock)
        for name, g, a, b in zip(("found", "slot", "r2_ok"), got, want["jnp"], want["pallas_interpret"]):
            if a is None:
                assert g is None and b is None
                continue
            assert g.numpy().dtype == a.dtype, name
            np.testing.assert_array_equal(g.numpy(), a, err_msg=f"{plane} {name}")
            np.testing.assert_array_equal(g.numpy(), b, err_msg=f"{plane} {name}")


def _store_case(R, N, K, S, seed, *, outside=False):
    """An MVCC store's wts and lock words (narrow, so empty slots, ties,
    ctts == wts and lock == ctts all occur), keys (N, K) into it (with
    ``outside``, also keys in [-3, 0) and [R, R + 3)) and one ctts pair per
    transaction."""
    rng = np.random.default_rng(seed)
    wh, wl = (rng.integers(0, 3, (R, S)).astype(np.int32) for _ in range(2))
    lh, ll = (rng.integers(-1, 2, R).astype(np.int32) for _ in range(2))
    keys = rng.integers(-3 if outside else 0, R + 3 if outside else R, (N, K)).astype(np.int32)
    ch, cl = (rng.integers(0, 3, N).astype(np.int32) for _ in range(2))
    return wh, wl, lh, ll, keys, ch, cl


@pytest.mark.parametrize("S", [1, 2, 4, 16])
@pytest.mark.parametrize("with_lock", [True, False])
def test_version_read_matches_reference_on_both_planes(S, with_lock):
    """The fused read (wts rows at keys, then the pick; the lock at the same
    keys when asked) on both port planes, bitwise against the reference's
    ``_vts`` + lock gather + ``_version_pick`` on its jnp and
    pallas_interpret planes."""
    wh, wl, lh, ll, keys, ch, cl = _store_case(50, 12, 10, S, 60 + S + with_lock)
    want = {}
    for jplane in ("jnp", "pallas_interpret"):
        jec = JEngineConfig(protocol="mvcc", kernel_plane=jplane)
        jstore = {k: jnp.asarray(v) for k, v in (("wts_hi", wh), ("wts_lo", wl), ("lock_hi", lh), ("lock_lo", ll))}
        jkeys = jnp.asarray(keys)
        jw = jmvcc._vts(jec, jstore, jkeys)
        jlock = JTS(*jeng.read_rows_many(jec, (jstore["lock_hi"], jstore["lock_lo"]), jkeys)) if with_lock else None
        out = jmvcc._version_pick(jec, jw, JTS(jnp.asarray(ch)[:, None], jnp.asarray(cl)[:, None]), jlock)
        want[jplane] = [np.asarray(jw.hi), np.asarray(jw.lo)] + [None if o is None else np.asarray(o) for o in out]
    store = {k: torch.tensor(v) for k, v in (("wts_hi", wh), ("wts_lo", wl), ("lock_hi", lh), ("lock_lo", ll))}
    ctts = TS(torch.tensor(ch)[:, None], torch.tensor(cl)[:, None])
    for plane in ("torch", "kernel"):
        wts, *picked = tmvcc._version_read(_ec(plane), store, torch.tensor(keys), ctts, with_lock)
        for name, g, a, b in zip(("wts_hi", "wts_lo", "found", "slot", "r2_ok"), [wts.hi, wts.lo] + picked,
                                 want["jnp"], want["pallas_interpret"]):
            if a is None:
                assert g is None and b is None
                continue
            assert g.numpy().dtype == a.dtype and g.shape == a.shape, name
            np.testing.assert_array_equal(g.numpy(), a, err_msg=f"{plane} {name}")
            np.testing.assert_array_equal(g.numpy(), b, err_msg=f"{plane} {name}")


@pytest.mark.parametrize("S", [1, 3, 4])
def test_slot_helpers_match_reference(S):
    wh, wl, ch, cl, _, _ = _wts_case(12, 10, S, 40 + S)
    jw, tw = JTS(jnp.asarray(wh), jnp.asarray(wl)), TS(torch.tensor(wh), torch.tensor(wl))
    for a, b in zip(jmvcc._max_wts(jw), tmvcc._max_wts(tw)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tmvcc._oldest_slot(tw).numpy(), np.asarray(jmvcc._oldest_slot(jw)))
    jbest = jmvcc._best_version(jw, JTS(jnp.asarray(ch), jnp.asarray(cl)))
    tbest = tmvcc._best_version(tw, TS(torch.tensor(ch), torch.tensor(cl)))
    for a, b in zip(jbest, tbest):
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_kernel_plane_calls_per_tick(monkeypatch):
    """One MVCC tick calls the fused version_read 3 times (read, rts, lock
    effects: one mvcc_version_select launch each), gather_many 5 times (one
    multi_read launch each: the read effect's rts_hi, the W1 checks' rts
    pair in the read and lock effects, try_lock's lock pair, the commit's
    wts|ver) and cas_arbitrate once, whatever the stages hold: the launch
    counts chip_smoke.py asserts for the CUDA kernels."""
    calls = {"version_read": 0, "version_select": 0, "gather_many": 0, "cas_arbitrate": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    wl = make_workload("ycsb", 128, hot_prob=0.6)
    for plane, per_tick in (("kernel", {"version_read": 3, "version_select": 0, "gather_many": 5, "cas_arbitrate": 1}),
                            ("torch", {"version_read": 0, "version_select": 0, "gather_many": 0, "cas_arbitrate": 1})):
        ec = _ec(plane, rw=wl.rw, max_ops=wl.max_ops, hybrid=(1, 0, 1, 0, 1, 0))
        st = teng.init_state(ec, wl)
        store = init_store("mvcc", ec.n_records, wl.rw, wl.init_value, device="cpu")
        tick = get_protocol("mvcc").tick
        for k in calls:
            calls[k] = 0
        for t in range(6):
            st, store = tick(ec, CostModel(), wl, st, store, t)
        assert calls == {k: 6 * v for k, v in per_tick.items()}, plane
        assert int(st["n_commit"].sum()) + int(st["n_abort"].sum()) > 0


def golden_rows():
    """The JAX reference's counters at the full-size spec (about 34 s on a CPU)."""
    rows = japi.run(japi.ExperimentSpec(configs=[{"hybrid": c} for c in CODES], **GOLDEN_SPEC)).rows
    return [{"hybrid": r["hybrid"], "commits": r["commits"], "aborts": r["aborts"]} for r in rows]


def test_golden_mvcc_file_matches_jax_reference():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["spec"] == dict(GOLDEN_SPEC, configs=[{"hybrid": c} for c in CODES])
    assert golden["rows"] == golden_rows()


if __name__ == "__main__":
    # rewrite the golden file from the JAX reference
    golden = {
        "about": "JAX reference (repro.api) counters for chip_smoke.py's full-size "
        "MVCC/YCSB spec, default jax_threefry_partitionable=True PRNG mode; "
        "written by tests/test_torch_mvcc.py",
        "spec": dict(GOLDEN_SPEC, configs=[{"hybrid": c} for c in CODES]),
        "rows": golden_rows(),
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
