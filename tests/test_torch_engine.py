"""Module parity of the port's engine with the JAX engine.

Each test hands the same state to both sides (``repro_torch.convert``) and
compares the results: integer and bool tensors bitwise, float32 latency
tensors to rtol=1e-5 (sums over a round run in another order in each
framework), dtypes and shapes exactly.  The tick-by-tick test runs the JAX
protocol tick and the port's side by side for 32 ticks and reports the
first tick and key that differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arbiter as jarb
from repro.core import costmodel as jcm
from repro.core import engine as jeng
from repro.core.registry import get_protocol as jget_protocol
from repro.core.registry import protocol_family
from repro.core.store import init_store as jinit_store
from repro.workloads import make_workload as jmake_workload
from repro_torch import convert
from repro_torch.core import arbiter as tarb
from repro_torch.core import costmodel as tcm
from repro_torch.core import engine as teng
from repro_torch.core.registry import get_protocol as tget_protocol
from repro_torch.core.store import init_store as tinit_store
from repro_torch.workloads import make_workload as tmake_workload

SHAPE = dict(n_nodes=2, coroutines=6, records_per_node=64)
RTOL = 1e-5  # float32 sums in another order


_JTICKS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jtick(proto):
    """The JAX protocol tick, jitted once per protocol for the whole module."""
    if proto not in _JTICKS:
        _JTICKS[proto] = jax.jit(jget_protocol(proto).tick, static_argnums=(0, 1, 2))
    return _JTICKS[proto]


def _hybrid(code):
    return tuple((code >> i) & 1 for i in range(6))


def _pair(proto, code, plane="torch", *, active_coroutines=None, active_records_per_node=None,
          merge_stages=False, cm=None, seed=3, workload="smallbank", wkw=None):
    """(JAX side, port side): each an (ec, cm, wl, tick) tuple.  Under record
    padding the workload draws over the active (logical) record space."""
    n_rec = SHAPE["n_nodes"] * (active_records_per_node or SHAPE["records_per_node"])
    jwl = jmake_workload(workload, n_rec, **(wkw or {}))
    twl = tmake_workload(workload, n_rec, **(wkw or {}))
    common = dict(
        protocol=proto, **SHAPE, rw=jwl.rw, max_ops=jwl.max_ops, hybrid=_hybrid(code), seed=seed,
        active_coroutines=active_coroutines, active_records_per_node=active_records_per_node,
        merge_stages=merge_stages,
    )
    jside = (jeng.EngineConfig(**common), cm[0] if cm else jcm.CostModel(), jwl, _jtick(proto))
    tside = (
        teng.EngineConfig(**common, kernel_plane=plane, device="cpu"), cm[1] if cm else tcm.CostModel(),
        twl, tget_protocol(proto).tick,
    )
    return jside, tside


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _assert_same(jd, td, where=""):
    """Every key: same dtype and shape; ints/bools bitwise, floats to RTOL."""
    jd, td = _np(jd), convert.to_numpy(td)
    assert set(jd) == set(td), f"{where}: keys {sorted(set(jd) ^ set(td))}"
    for k in sorted(jd):
        a, b = jd[k], td[k]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f"{where} key {k}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6, err_msg=f"{where} key {k}")
        else:
            assert np.array_equal(a, b), f"{where} key {k} differs first at {np.argwhere(a != b)[0]}"


@pytest.fixture(scope="module")
def mid_run():
    """A JAX NOWAIT state/store after 12 ticks at hybrid 21, plus both sides' configs."""
    (jec, jc, jwl, jtick), tside = _pair("nowait", 21)
    st = jeng.init_state(jec, jwl)
    store = jinit_store("twopl", jec.n_records, jwl.rw, jwl.init_value)
    for t in range(12):
        st, store = jtick(jec, jc, jwl, st, store, t)
    return (jec, jc, jwl), tside, st, store


CASES = [
    ("nowait", 63, "torch", {}),
    ("nowait", 21, "kernel", {}),
    ("nowait", 0, "torch", {}),
    ("waitdie", 42, "kernel", {}),
    ("waitdie", 63, "torch", {}),
    ("nowait", 21, "torch", dict(active_coroutines=4)),
    ("waitdie", 63, "kernel", dict(active_coroutines=5, active_records_per_node=48)),
    ("nowait", 63, "kernel", dict(merge_stages=True)),
    ("waitdie", 0, "torch", dict(cm=(jcm.CostModel.tcp(), tcm.CostModel.tcp()))),
    ("mvcc", 63, "kernel", dict(workload="ycsb", wkw=dict(hot_prob=0.6))),
    ("mvcc", 21, "torch", dict(workload="ycsb", wkw=dict(hot_prob=0.6))),
    ("mvcc", 42, "kernel", dict(active_coroutines=5, active_records_per_node=48)),
    ("occ", 21, "kernel", dict(workload="ycsb", wkw=dict(hot_prob=0.6))),
    ("occ", 63, "torch", dict(merge_stages=True)),
    ("sundial", 42, "kernel", dict(workload="ycsb", wkw=dict(hot_prob=0.6))),
    ("sundial", 0, "torch", {}),
    ("waitdie", 63, "kernel", dict(workload="ycsb", wkw=dict(hot_prob=0.6))),
    ("waitdie", 21, "torch", dict(workload="tpcc")),
]


@pytest.mark.parametrize("proto,code,plane,over", CASES, ids=[
    f"{c[0]}-{c[1]}-{c[2]}-{'-'.join(str(v) if k == 'workload' else k for k, v in c[3].items() if k != 'wkw') or 'plain'}"
    for c in CASES])
def test_tick_by_tick_matches_jax(proto, code, plane, over):
    (jec, jc, jwl, jtick), (tec, tc, twl, ttick) = _pair(proto, code, plane, **over)
    family = protocol_family(proto)
    jst = jeng.init_state(jec, jwl)
    jstore = jinit_store(family, jec.n_records, jwl.rw, jwl.init_value)
    tst, tstore = convert.from_numpy(_np(jst), "cpu"), convert.from_numpy(_np(jstore), "cpu")
    _assert_same(jstore, tinit_store(family, tec.n_records, twl.rw, twl.init_value, device="cpu"), "init store")
    _assert_same(jst, teng.init_state(tec, twl), "init state")
    commits = 0
    for t in range(32):
        jst, jstore = jtick(jec, jc, jwl, jst, jstore, t)
        tst, tstore = ttick(tec, tc, twl, tst, tstore, t)
        _assert_same(jst, tst, f"tick {t} st")
        _assert_same(jstore, tstore, f"tick {t} store")
        commits = int(np.asarray(jst["n_commit"]).sum())
    assert commits > 0 and int(np.asarray(jst["n_abort"]).sum()) >= 0


def test_port_continues_from_a_jax_mid_run_state():
    (jec, jc, jwl, jtick), (tec, tc, twl, ttick) = _pair("waitdie", 42)
    st = jeng.init_state(jec, jwl)
    store = jinit_store("twopl", jec.n_records, jwl.rw, jwl.init_value)
    for t in range(12):
        st, store = jtick(jec, jc, jwl, st, store, t)
    tst, tstore = convert.from_numpy(_np(st), "cpu"), convert.from_numpy(_np(store), "cpu")
    for t in range(12, 20):
        st, store = jtick(jec, jc, jwl, st, store, t)
        tst, tstore = ttick(tec, tc, twl, tst, tstore, t)
    _assert_same(st, tst, "st")
    _assert_same(store, tstore, "store")


def test_hash_prio_matches():
    rng = np.random.default_rng(0)
    x = rng.integers(-(2**31), 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    for salt in (0, 1, 17 * 479 + 4, 2**31 - 1):
        want = np.asarray(jarb.hash_prio(jnp.asarray(x), salt))
        got = tarb.hash_prio(torch.tensor(x), salt).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("is_rpc", [True, False])
def test_service_ops_matches(mid_run, is_rpc):
    (jec, jc, _), (tec, tc, _, _), st, _ = mid_run
    mask = np.asarray(st["valid"]) & (np.random.default_rng(1).random(np.asarray(st["valid"]).shape) < 0.8)
    tst = convert.from_numpy(_np(st), "cpu")
    j_served, j_load = jeng.service_ops(jec, jc, st, jnp.asarray(mask), is_rpc, 37)
    t_served, t_load = teng.service_ops(tec, tc, tst, torch.tensor(mask), is_rpc, 37)
    _assert_same({"served": j_served, "load": j_load}, {"served": t_served, "load": t_load})
    assert np.asarray(j_served).any()


@pytest.mark.parametrize("plane", ["torch", "kernel"])
def test_try_lock_matches(mid_run, plane):
    (jec, jc, _), (tec, tc, _, _), st, store = mid_run
    tec = teng.EngineConfig(**{**tec.__dict__, "kernel_plane": plane})
    tst, tstore = convert.from_numpy(_np(st), "cpu"), convert.from_numpy(_np(store), "cpu")
    base = np.arange(np.asarray(st["keys"]).size, dtype=np.int32).reshape(np.asarray(st["keys"]).shape)
    mask = np.asarray(st["valid"])
    hi = np.asarray(jarb.hash_prio(jnp.asarray(base) + st["ts_lo"][:, None], 5))
    jwon, jstore = jeng.try_lock(jec, store, st, jnp.asarray(mask), jnp.asarray(hi), jnp.asarray(base))
    twon, tstore = teng.try_lock(tec, tstore, tst, torch.tensor(mask), torch.tensor(hi), torch.tensor(base))
    _assert_same({"won": jwon, **jstore}, {"won": twon, **tstore})
    assert np.asarray(jwon).any()


@pytest.mark.parametrize("primitive", [jcm.RPC, jcm.ONE_SIDED])
@pytest.mark.parametrize("tensor_bytes", [False, True])
def test_account_round_matches(mid_run, primitive, tensor_bytes):
    (jec, jc, _), (tec, tc, _, _), st, _ = mid_run
    tst = convert.from_numpy(_np(st), "cpu")
    rng = np.random.default_rng(2)
    mask = np.asarray(st["valid"]) & (rng.random(np.asarray(st["valid"]).shape) < 0.7)
    load = rng.integers(0, 40, mask.shape).astype(np.float32)
    nb = rng.integers(8, 200, mask.shape).astype(np.float32) if tensor_bytes else 36.0
    jnb = jnp.asarray(nb) if tensor_bytes else nb
    tnb = torch.tensor(nb) if tensor_bytes else nb
    jout = jeng.account_round(jec, jc, st, jcm.ST_LOCK, jnp.asarray(mask), jnp.asarray(load), primitive, jnb, n_verbs=2)
    tout = teng.account_round(tec, tc, tst, jcm.ST_LOCK, torch.tensor(mask), torch.tensor(load), primitive, tnb, n_verbs=2)
    _assert_same(jout, tout)


@pytest.mark.parametrize("tcp", [False, True])
@pytest.mark.parametrize("is_rpc", [True, False])
@pytest.mark.parametrize("doorbell", [True, False])
def test_round_latency_us_bitwise(tcp, is_rpc, doorbell):
    jc, tc = (jcm.CostModel.tcp(), tcm.CostModel.tcp()) if tcp else (jcm.CostModel(qp_pressure=0.3), tcm.CostModel(qp_pressure=0.3))
    load = np.arange(0, 700, 7, dtype=np.float32)
    for nb in (0.0, 36.0, np.linspace(8, 400, load.size).astype(np.float32)):
        jnb = jnp.asarray(nb) if isinstance(nb, np.ndarray) else nb
        tnb = torch.tensor(nb) if isinstance(nb, np.ndarray) else nb
        want = np.asarray(jcm.round_latency_us(jc, jnp.asarray(is_rpc), jnp.asarray(load), jnb, n_verbs=2, doorbell=doorbell))
        got = tcm.round_latency_us(tc, is_rpc, torch.tensor(load), tnb, n_verbs=2, doorbell=doorbell).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_summarize_matches(mid_run):
    (jec, jc, _), (tec, tc, _, _), st, _ = mid_run
    tst = convert.from_numpy(_np(st), "cpu")
    want = jeng.summarize(jec, jc, st, 12)
    got = teng.summarize(tec, tc, tst, 12)
    assert set(want) == set(got)
    # the port's metrics carry a leading config axis: this run's one config is row 0
    for k in ("commits", "aborts", "throughput_mtps", "abort_rate", "avg_round_trips"):
        assert tuple(got[k].shape) == (1,) + np.asarray(want[k]).shape, k
        assert np.asarray(want[k]).dtype == got[k].numpy().dtype, k
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("avg_latency_us", "stage_us_per_commit"):
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("M,n_records,seed", [(1, 4, 0), (37, 9, 1), (2400, 262144, 2), (2400, 64, 3), (0, 8, 4)])
def test_scatter_ts_max_matches_jax(M, n_records, seed):
    """Lexicographic scatter-max with duplicate keys, ties on hi, inactive
    requests and drop-sentinel indices (>= n_records), against the JAX one."""
    rng = np.random.default_rng(seed)
    hi_arr = rng.integers(-3, 4, n_records).astype(np.int32)
    lo_arr = rng.integers(-3, 4, n_records).astype(np.int32)
    idx = rng.integers(0, min(n_records, 16), M).astype(np.int32)  # many duplicate keys
    idx[rng.random(M) < 0.1] = n_records  # the drop sentinel
    ch = rng.integers(-3, 4, M).astype(np.int32)  # narrow: hi ties are common
    cl = rng.integers(-(2**31), 2**31 - 1, M, dtype=np.int64).astype(np.int32)
    active = rng.random(M) < 0.7
    common = dict(protocol="mvcc", n_nodes=1, coroutines=1, records_per_node=n_records)
    want = jeng.scatter_ts_max(jeng.EngineConfig(**common), *map(jnp.asarray, (hi_arr, lo_arr, idx, ch, cl, active)))
    got = teng.scatter_ts_max(teng.EngineConfig(**common, device="cpu"), *map(torch.tensor, (hi_arr, lo_arr, idx, ch, cl, active)))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert M < 37 or (got[0].numpy() != hi_arr).any()  # some maxima land
