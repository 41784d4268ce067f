"""The legacy PRNG mode and the deprecated sweep shims against the JAX
reference, on the CPU.

``prng.threefry_partitionable(False)`` is jax's ``jax_threefry_partitionable
= False``: every reference call here runs inside
``jax.threefry_partitionable(False)`` and every port call inside the
port's own block.  Held bitwise: ``split``, ``random_bits``, ``uniform``,
``randint``, ``normal`` and ``truncated_normal`` (2 ulp, their documented
bound; measured bitwise) over many seeds and shapes, batched keys and
chunked draws; the three workloads' ``gen``; ``fold_in`` and
``prng_key``, which do not depend on the mode; all 24 rows of
``tests/data/stage_graph_golden.json`` (captured in the legacy mode) from
the port's ``run_grid``; the LM stack's draws (``init_lm``, the data
pipeline, ``serve``'s prompts).  Then the shims ``run_grid``,
``run_grid_sharded`` and ``run_cell_sharded`` against the port's
``api`` and the reference's dense runs (its sharded runs fail on jax
0.9.0, ROADMAP.md C.1), and ``PROTOCOLS`` against the reference's view.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_legacy.py

rewrites ``src/repro_torch/data/golden_legacy_prng.json``: the reference's
counters in the legacy mode at the full ``ExperimentSpec`` defaults for
NOWAIT/SmallBank and MVCC/YCSB on ``chip_smoke.py``'s four codes (about
1 min), which ``chip_smoke.py`` holds the port to on the card.
"""
import contextlib
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import reduced_config as jreduced_config
from repro.core import sweep as jsweep
from repro.core.protocols import PROTOCOLS as JPROTOCOLS
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.sharding import unzip_params
from repro.workloads import make_workload as jmake_workload
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import engine as teng
from repro_torch.core import prng, registry
from repro_torch.core import sweep as tsweep
from repro_torch.core.protocols import PROTOCOLS
from repro_torch.core.sweep import GridSpec, engine_config, make_knobs
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch.serve import serve
from repro_torch.models.lm import init_lm
from repro_torch.workloads import make_workload as tmake_workload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_GOLDEN = os.path.join(ROOT, "tests", "data", "stage_graph_golden.json")
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_legacy_prng.json")
# tests/test_sweep.py's pinned grid
STAGE_KW = dict(n_nodes=2, coroutines=8, records_per_node=128, ticks=64, warmup=8)
STAGE_CODES = (0, 63, 0b010101, 0b101010)
# tests/test_api.py's grid
KW = dict(n_nodes=2, coroutines=8, records_per_node=128, ticks=48, warmup=8)
COUNTERS = ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips")
# CALVIN's throughput is a float32 sum over epochs: rtol 1e-5 (its waves and counters exact)
CALVIN_EXACT = ("commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves")
# chip_smoke.py's codes and full-size paths
CODES = (0, 63, 21, 42)
GOLDEN_PATHS = (("nowait", "smallbank"), ("mvcc", "ycsb"))

I32 = np.iinfo(np.int32)
SEEDS = np.concatenate(
    [[0, 1, 3, 42, -1, I32.min, I32.max], np.random.default_rng(5).integers(I32.min, I32.max, 41)]
).astype(np.int32)
SHAPES = [(), (1,), (2,), (10,), (15,), (7, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores, where a thread pool per
    worker loses far more to contention than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _flags_restored():
    """Both modes back to what they were when the file ends, whatever a
    test left (the blocks below restore them themselves)."""
    j, t = jax.config.jax_threefry_partitionable, prng.partitionable()
    yield
    jax.config.update("jax_threefry_partitionable", j)
    assert prng.partitionable() == t


@contextlib.contextmanager
def legacy():
    """Both generators in the legacy mode inside the block."""
    with jax.threefry_partitionable(False), prng.threefry_partitionable(False):
        yield


def _jkeys(seeds=SEEDS):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))


def _tkeys(seeds=SEEDS):
    return torch.stack([prng.prng_key(int(s)) for s in seeds])


def _eq(jax_out, torch_out):
    a, b = np.asarray(jax_out), torch_out.numpy()
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)  # bitwise, not approximately
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b, a)


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------


def test_mode_flag_and_context_manager():
    assert prng.partitionable()
    with prng.threefry_partitionable(False):
        assert not prng.partitionable()
        with prng.threefry_partitionable(True):
            assert prng.partitionable()
        assert not prng.partitionable()
    assert prng.partitionable()
    with pytest.raises(RuntimeError):
        with prng.threefry_partitionable(False):
            raise RuntimeError
    assert prng.partitionable()


@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_split_matches(num):
    with legacy():
        _eq(jax.vmap(lambda k: jax.random.split(k, num))(_jkeys()), prng.split(_tkeys(), num))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_randint_match(shape):
    jk, tk = _jkeys(), _tkeys()
    with legacy():
        _eq(jax.vmap(lambda k: jax.random.bits(k, shape))(jk), prng.random_bits(tk, shape))
        _eq(jax.vmap(lambda k: jax.random.uniform(k, shape))(jk), prng.uniform(tk, shape))
        _eq(jax.vmap(lambda k: jax.random.uniform(k, shape, minval=-2.5, maxval=7.0))(jk),
            prng.uniform(tk, shape, -2.5, 7.0))
        for lo, hi in ((0, 6), (-7, 1000), (I32.min, I32.max), (5, 5)):
            _eq(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(jk), prng.randint(tk, shape, lo, hi))


def test_batched_keys_match():
    """Keys with two batch dimensions (as the workloads' (N, R, 2) passes)."""
    with legacy():
        jk = jax.vmap(lambda k: jax.random.split(k, 3))(_jkeys())
        tk = prng.split(_tkeys(), 3)
        _eq(jk, tk)
        _eq(jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (15,))))(jk), prng.random_bits(tk, (15,)))
        _eq(jax.vmap(jax.vmap(lambda k: jax.random.split(k, 2)))(jk), prng.split(tk, 2))


@pytest.mark.parametrize("seed,shape,chunk", [(0, (7, 3), 4), (3, (1000,), 64), (-5, (33, 31), 100), (11, (2, 15), 1)])
def test_normal_and_truncated_normal_match(seed, shape, chunk):
    """Several chunks of ``_chunked_draw``'s blocks, an odd size among them
    (1023 elements: the last block's y1 word falls off)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    with legacy():
        tk = prng.fold_in(prng.prng_key(seed), 11)
        _eq(jax.random.normal(jk, shape, jnp.float32), prng.normal(tk, shape, chunk=chunk))
        want = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape, jnp.float32))
        got = prng.truncated_normal(tk, -2.0, 2.0, shape, chunk=chunk).numpy()
    assert got.shape == want.shape
    assert _ulp(got, want).max() <= 2  # the documented bound; measured: bitwise equal
    assert (got > -2).all() and (got < 2).all()


def test_chunked_draw_size_error_in_both_modes():
    """Draws past 2**32 (partitionable) and 2**32 - 1 (legacy) elements are
    jax's (``tests/test_torch_kimi.py`` holds their windows to it); a draw
    past jax's 64-bit counts and a window outside the draw raise."""
    key = prng.prng_key(0)
    fn = prng._normal_fn()
    with pytest.raises(ValueError, match="64-bit"):
        prng._chunked_draw(key, (2**33, 2**31 + 1), fn, 0, 4)
    for flag, n in ((True, 2**32), (False, 2**32 - 1)):
        with prng.threefry_partitionable(flag):
            assert torch.isfinite(prng._chunked_draw(key, (n + 5,), fn, n - 3, n + 5)).all()
            with pytest.raises(ValueError, match="window"):
                prng._chunked_draw(key, (n,), fn, n - 3, n + 5)


def test_modes_differ_in_every_primitive():
    """The partitionable mode's identity that the batched passes leaned on
    (a shape-() draw is element 0 of a shape-(2,) one) fails in the legacy
    mode, and each primitive draws other values there."""
    k = prng.prng_key(3)
    assert int(prng.random_bits(k, ())) == int(prng.random_bits(k, (2,))[0])
    with legacy():
        assert int(prng.random_bits(k, ())) == 3716834203 == int(jax.random.bits(jax.random.PRNGKey(3), ()))
        assert prng.random_bits(k, (2,)).tolist() == [1946498123, 2217676430]
        legacy_out = [prng.split(k, 3), prng.random_bits(k, (10,)), prng.uniform(k, (10,)),
                      prng.randint(k, (10,), 0, 1000), prng.normal(k, (10,)), prng.truncated_normal(k, -2, 2, (10,))]
    default_out = [prng.split(k, 3), prng.random_bits(k, (10,)), prng.uniform(k, (10,)),
                   prng.randint(k, (10,), 0, 1000), prng.normal(k, (10,)), prng.truncated_normal(k, -2, 2, (10,))]
    for a, b in zip(legacy_out, default_out):
        assert not torch.equal(a, b)


@pytest.mark.parametrize("partitionable", [True, False])
def test_row_bits_is_each_rows_own_draw(partitionable):
    """``row_bits``' one pass equals each row's own ``random_bits``, at
    mixed shapes (SmallBank's and TPC-C's passes, and one of three sizes)."""
    keys = prng.split(_tkeys(), 7)
    with prng.threefry_partitionable(partitionable):
        for shapes in (((),) * 2 + ((2,),) * 5, ((),) * 2 + ((15,),) * 5, ((3,), (), (2, 4), (7,))):
            sub = keys[:, : len(shapes)]
            got = prng.row_bits(sub, shapes)
            for j, sh in enumerate(shapes):
                n = int(np.prod(sh))
                assert torch.equal(got[:, j, :n], prng.random_bits(sub[:, j], sh).reshape(-1, n))
            c0, c1, pick = prng.draw_counts(shapes)
            assert (pick is None) == partitionable


def test_fold_in_and_prng_key_do_not_depend_on_the_mode():
    data = np.random.default_rng(1).integers(0, 10**6, len(SEEDS)).astype(np.int32)
    want_key, want_fold = _jkeys(), jax.vmap(jax.random.fold_in)(_jkeys(), jnp.asarray(data))
    default = prng.fold_in(_tkeys(), torch.tensor(data))
    with legacy():
        _eq(_jkeys(), _tkeys())
        _eq(jax.vmap(jax.random.fold_in)(_jkeys(), jnp.asarray(data)), prng.fold_in(_tkeys(), torch.tensor(data)))
        assert torch.equal(prng.fold_in(_tkeys(), torch.tensor(data)), default)
    _eq(want_key, _tkeys())
    _eq(want_fold, default)


def test_engine_and_calvin_keys_do_not_depend_on_the_mode():
    """``engine.slot_keys`` (cached per EngineConfig) and the per-txn and
    per-epoch keys folded from it are the reference's in both modes."""
    gs = GridSpec(protocol="nowait", workload="smallbank", device="cpu", **STAGE_KW)
    ec, _, _ = engine_config(gs, make_knobs("smallbank", [{"seed": 9}]))
    lsid = np.arange(ec.n_slots, dtype=np.int32)
    txn = np.random.default_rng(2).integers(0, 5000, ec.n_slots).astype(np.int32)
    default = prng.fold_in(teng.slot_keys(ec), torch.tensor(txn))
    teng.slot_keys.cache_clear()
    with legacy():
        key0 = jax.random.PRNGKey(9)
        want = jax.vmap(lambda s, t: jax.random.fold_in(jax.random.fold_in(key0, s), t))(jnp.asarray(lsid),
                                                                                        jnp.asarray(txn))
        got = prng.fold_in(teng.slot_keys(ec), torch.tensor(txn))
    _eq(want, got)
    assert torch.equal(got, default)


# ---------------------------------------------------------------------------
# The workloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_records", [128, 262144, 50])
@pytest.mark.parametrize("workload,kw", [("smallbank", {}), ("ycsb", {}), ("ycsb", {"hot_prob": 0.6}), ("tpcc", {})])
def test_gen_matches_vmapped_reference(workload, kw, n_records):
    jw, tw = jmake_workload(workload, n_records, **kw), tmake_workload(workload, n_records, **kw)
    rng = np.random.default_rng(n_records)
    lsid = np.arange(240, dtype=np.int32)
    node = lsid // 60
    txn_no = rng.integers(0, 5000, 240).astype(np.int32)
    with legacy():
        key0 = jax.random.PRNGKey(3)
        want = jax.vmap(lambda s, n, t: jw.gen(jax.random.fold_in(jax.random.fold_in(key0, s), t), n, s))(
            jnp.asarray(lsid), jnp.asarray(node), jnp.asarray(txn_no))
        keys = prng.fold_in(prng.fold_in(prng.prng_key(3), torch.tensor(lsid)), torch.tensor(txn_no))
        got = tw.gen(keys, torch.tensor(node), torch.tensor(lsid))
    for w, g in zip(want, got):
        assert np.asarray(w).dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    default = tw.gen(keys, torch.tensor(node), torch.tensor(lsid))
    assert not torch.equal(default[0], got[0])  # the mode moves the draws


# ---------------------------------------------------------------------------
# The pinned stage-graph counters, end to end
# ---------------------------------------------------------------------------


def _stage_golden():
    with open(STAGE_GOLDEN) as f:
        return json.load(f)


def _quiet(call, *args, **kw):
    """Run a deprecated shim with its DeprecationWarning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return call(*args, **kw)


STAGE_CELLS = [(p, "smallbank", STAGE_CODES) for p in ("nowait", "waitdie", "occ", "mvcc", "sundial")] + [
    (p, "ycsb", (0b010101,)) for p in ("nowait", "occ", "sundial", "mvcc")]


@pytest.mark.parametrize("proto,workload,codes", STAGE_CELLS, ids=lambda c: c if isinstance(c, str) else None)
def test_run_grid_meets_stage_graph_golden(proto, workload, codes):
    """tests/test_sweep.py's pinned counters, all 24 rows: the port's
    ``run_grid`` in the legacy mode on the CPU (torch plane)."""
    golden = _stage_golden()
    with prng.threefry_partitionable(False):
        rows = _quiet(tsweep.run_grid, proto, workload, [{"hybrid": c} for c in codes], device="cpu", **STAGE_KW)
    assert len(rows) == len(codes)
    for r in rows:
        g = golden[f"{proto}/{workload}/{r['hybrid']}"]
        assert (r["commits"], r["aborts"]) == (g["commits"], g["aborts"]), (proto, workload, r["hybrid"])


_JROWS = {}


def _jax_rows(proto, workload, configs, kw, partitionable=True):
    """The reference's dense ``repro.api`` rows, run once per spec for the file."""
    key = (proto, workload, repr(configs), repr(sorted(kw.items())), partitionable)
    if key not in _JROWS:
        with jax.threefry_partitionable(partitionable):
            _JROWS[key] = japi.run(japi.ExperimentSpec(protocol=proto, workload=workload, configs=configs,
                                                       **kw)).rows
    return _JROWS[key]


def test_stage_graph_rows_against_live_legacy_reference():
    """Two golden rows from a live legacy reference run beside the port's
    (both planes)."""
    configs = [{"hybrid": 0}, {"hybrid": 63}]
    want = _jax_rows("nowait", "smallbank", configs, STAGE_KW, partitionable=False)
    golden = _stage_golden()
    for plane in ("torch", "kernel"):
        with prng.threefry_partitionable(False):
            got = tapi.run(tapi.ExperimentSpec(protocol="nowait", workload="smallbank", configs=configs,
                                               kernel_plane=plane, device="cpu", **STAGE_KW)).rows
        for a, b in zip(want, got):
            for k in COUNTERS:
                assert a[k] == b[k], (plane, a["hybrid"], k)
            assert (b["commits"], b["aborts"]) == tuple(golden[f"nowait/smallbank/{b['hybrid']}"][k]
                                                        for k in ("commits", "aborts"))


def test_default_mode_unchanged_after_a_legacy_block():
    """After a legacy block has exited, the default mode draws the golden
    file's values (stablelm's served prompts), and the stage-graph grid
    gives the reference's default-mode counters, not the file's (240
    commits and 45 aborts for NOWAIT at codes 0 and 63, ROADMAP.md C.2)."""
    with prng.threefry_partitionable(False):
        prng.random_bits(prng.prng_key(0), (4,))
    assert prng.partitionable()
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_stablelm.json")) as f:
        g = json.load(f)
    B, P = g["batch"], g["prompt_len"]
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (B, P), 0, get_config(g["arch"])[0].vocab_size)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    configs = [{"hybrid": 0}, {"hybrid": 63}]
    got = tapi.run(tapi.ExperimentSpec(protocol="nowait", workload="smallbank", configs=configs, device="cpu",
                                       **STAGE_KW)).rows
    assert [(r["commits"], r["aborts"]) for r in got] == [(240, 45)] * 2


# ---------------------------------------------------------------------------
# The LM stack's draws in the legacy mode
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "falcon-mamba-7b"])
def test_init_lm_matches_reference_leaf_by_leaf(arch):
    """``dense_init``'s ``truncated_normal`` and the SSM's ``uniform``
    draws in the legacy mode, every leaf."""
    with legacy():
        want = dict(_leaves(unzip_params(jlm.init_lm(jax.random.PRNGKey(0), jreduced_config(arch), jnp.float32))[0]))
        got = dict(_leaves(convert.lm_params_to_numpy(init_lm(prng.prng_key(0), reduced_config(arch), device="cpu"))))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        assert _ulp(got[name], w).max() <= 2, name  # measured: bitwise equal
    default = convert.lm_params_to_numpy(init_lm(prng.prng_key(0), reduced_config(arch), device="cpu"))
    assert not np.array_equal(dict(_leaves(default))["embed"], want["embed"])


def test_pipeline_tokens_match_reference():
    vocab, batch, seq, seed = 512, 4, 33, 3
    with legacy():
        ji, jn = jpipeline.make_pipeline(vocab, batch, seq, seed=seed)
        ti, tn = tpipeline.make_pipeline(vocab, batch, seq, seed=seed, device="cpu")
        js, ts = ji(), ti()
        for step in range(2):
            js, jb = jn(js)
            ts, tb = tn(ts)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=f"{k} step {step}")


def test_serve_prompts_match_reference():
    B, P = 2, 8
    cfg = reduced_config("stablelm-1.6b")
    with legacy():
        res = serve(cfg, batch=B, prompt_len=P, gen_len=2, device="cpu")
        want = jax.random.randint(jax.random.PRNGKey(1), (B, P), 0, cfg.vocab_size)
    np.testing.assert_array_equal(res.prompts.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The deprecated shims (after tests/test_api.py)
# ---------------------------------------------------------------------------


def _tspec(proto, configs, **over):
    return tapi.ExperimentSpec(protocol=proto, workload="smallbank", configs=tuple(configs),
                               **dict(KW, device="cpu", **over))


def _same(a, b, keys=COUNTERS):
    for k in keys:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("proto", ["nowait", "occ", "calvin"])
def test_run_grid_matches_api_and_reference(proto):
    cfgs = [{"hybrid": 0}, {"hybrid": 63}]
    rows = _quiet(tsweep.run_grid, proto, "smallbank", cfgs, device="cpu", **KW)
    rows_api = tapi.execute(tapi.plan(_tspec(proto, cfgs))).rows
    rows_ref = _jax_rows(proto, "smallbank", cfgs, KW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rows_ref_shim = jsweep.run_grid(proto, "smallbank", cfgs, **KW)
    assert len(rows) == len(rows_api) == len(rows_ref) == 2
    for a, b, c, d in zip(rows, rows_api, rows_ref, rows_ref_shim):
        _same(a, b)
        if proto == "calvin":
            for ref in (c, d):
                _same(a, ref, CALVIN_EXACT)
                np.testing.assert_allclose(a["throughput_mtps"], ref["throughput_mtps"], rtol=1e-5)
        else:
            _same(a, c)
            _same(a, d)
        assert a["hybrid"] == b["hybrid"] == c["hybrid"]
        assert a["n_devices"] == c["n_devices"] == 1


# the reference's vmapped rows of these codes: each equals its single-config run (its own contract)
SHARD_CODES = [{"hybrid": 21}, {"hybrid": 42}]


@pytest.mark.parametrize("node_shards", [1, 2])
def test_run_cell_sharded_matches_api_and_dense_reference(node_shards):
    devices = ("cpu",) * 2 if node_shards == 2 else None
    row = _quiet(tsweep.run_cell_sharded, "nowait", "smallbank", {"hybrid": 21}, node_shards=node_shards,
                 devices=devices, device="cpu", **KW)
    row_api = tapi.run(_tspec("nowait", [{"hybrid": 21}], node_shards=node_shards, devices=devices)).row
    ref = _jax_rows("nowait", "smallbank", SHARD_CODES, KW)[0]
    _same(row, row_api)
    _same(row, ref)
    assert row["n_node_shards"] == row_api["n_node_shards"] == node_shards
    assert row["hybrid"] == ref["hybrid"] == "101010"


def test_run_grid_sharded_matches_api_and_dense_reference():
    cfgs = SHARD_CODES
    rows = _quiet(tsweep.run_grid_sharded, "nowait", "smallbank", cfgs, devices=("cpu",) * 2, device="cpu", **KW)
    rows_api = tapi.run(_tspec("nowait", cfgs, devices=("cpu",) * 2)).rows
    assert tapi.plan(_tspec("nowait", cfgs, devices=("cpu",) * 2)).layout == tapi.CONFIG
    for a, b, c in zip(rows, rows_api, _jax_rows("nowait", "smallbank", cfgs, KW)):
        _same(a, b)
        _same(a, c)
        assert a["n_devices"] == b["n_devices"] == 2
    # by default every visible device of the spec's type: the one CPU, the dense run
    (row,) = _quiet(tsweep.run_grid_sharded, "nowait", "smallbank", cfgs[:1], device="cpu", **KW)
    assert row["n_devices"] == 1
    _same(row, rows[0])


def test_run_grid_node_shards_layout_and_divisibility():
    cfgs = SHARD_CODES
    rows = _quiet(tsweep.run_grid, "nowait", "smallbank", cfgs, devices=("cpu",) * 4, node_shards=2, device="cpu",
                  **KW)
    for a, b in zip(rows, _jax_rows("nowait", "smallbank", cfgs, KW)):
        _same(a, b)
        assert a["n_node_shards"] == 2 and a["n_devices"] == 4
    with pytest.raises(ValueError, match="must divide the device count"):
        _quiet(tsweep.run_grid, "nowait", "smallbank", cfgs, devices=("cpu",) * 3, node_shards=2, device="cpu", **KW)
    with pytest.raises(ValueError, match=r"must divide the device count \(1\)"):
        _quiet(tsweep.run_grid, "nowait", "smallbank", cfgs, node_shards=2, device="cpu", **KW)


def test_shims_warn_once_each_naming_the_api():
    cfgs = [{"hybrid": 21}]
    calls = [
        ("run_grid", lambda: tsweep.run_grid("nowait", "smallbank", cfgs, device="cpu", **KW)),
        ("run_grid_sharded", lambda: tsweep.run_grid_sharded("nowait", "smallbank", cfgs, device="cpu", **KW)),
        ("run_cell_sharded",
         lambda: tsweep.run_cell_sharded("nowait", "smallbank", cfgs[0], node_shards=1, device="cpu", **KW)),
    ]
    for name, call in calls:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = call()
        assert out, name
        dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
        assert len(dep) == 1, (name, [str(x.message) for x in dep])
        assert name in str(dep[0].message) and "repro_torch.api" in str(dep[0].message)
        assert dep[0].filename == __file__  # attributed to the caller


def test_shims_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _quiet(tsweep.run_grid, "nowait", "smallbank", [{"hybrid": 0}], **KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _quiet(tsweep.run_grid_sharded, "nowait", "smallbank", [{"hybrid": 0}], **KW)


# ---------------------------------------------------------------------------
# PROTOCOLS
# ---------------------------------------------------------------------------


def test_protocols_view_matches_reference():
    assert list(PROTOCOLS) == list(JPROTOCOLS) == list(registry.protocol_names())
    assert len(PROTOCOLS) == len(JPROTOCOLS) == 6
    for name in JPROTOCOLS:
        assert name in PROTOCOLS
        assert PROTOCOLS[name] is registry.get_protocol(name)
        assert PROTOCOLS[name].tick is registry.get_protocol(name).tick
        assert (PROTOCOLS[name].tick is None) == (JPROTOCOLS[name].tick is None)
    assert "2pl" not in PROTOCOLS and 3 not in PROTOCOLS
    with pytest.raises(KeyError, match="unknown protocol"):
        PROTOCOLS["2pl"]
    with pytest.raises(TypeError):
        PROTOCOLS["x"] = PROTOCOLS["nowait"]  # read-only
    assert repr(PROTOCOLS) == f"ProtocolsView({registry.protocol_names()})"


def test_protocols_view_is_live():
    entry = registry.get_protocol("nowait")
    registry.register_protocol("nowait_copy", tick=entry.tick, stages=entry.stages, family="nowait")
    try:
        assert list(PROTOCOLS)[-1] == "nowait_copy" and len(PROTOCOLS) == 7
        assert PROTOCOLS["nowait_copy"].tick is entry.tick
    finally:
        registry.unregister_protocol("nowait_copy")
    assert "nowait_copy" not in PROTOCOLS and len(PROTOCOLS) == 6


# ---------------------------------------------------------------------------
# The full-size golden file
# ---------------------------------------------------------------------------


def test_golden_file_specs():
    """``chip_smoke.py``'s legacy paths: the file's specs and its mode (the
    rows are the reference's full-size runs, rewritten outside tier-1)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert "jax_threefry_partitionable=False" in golden["about"]
    assert [c["spec"] for c in golden["cells"]] == [
        {"protocol": p, "workload": w, "configs": [{"hybrid": c} for c in CODES]} for p, w in GOLDEN_PATHS]
    for cell in golden["cells"]:
        assert [r["hybrid"] for r in cell["rows"]] == ["".join(map(str, tsweep.normalize_hybrid(c))) for c in CODES]
        assert all(r["commits"] > 0 and r["aborts"] > 0 for r in cell["rows"])


def golden_cells():
    """The reference's counters at the full-size specs in the legacy mode."""
    cells = []
    for proto, workload in GOLDEN_PATHS:
        spec = {"protocol": proto, "workload": workload, "configs": [{"hybrid": c} for c in CODES]}
        with jax.threefry_partitionable(False):
            rows = japi.run(japi.ExperimentSpec(**spec)).rows
        cells.append({"spec": spec, "rows": [{"hybrid": r["hybrid"], "commits": r["commits"],
                                              "aborts": r["aborts"]} for r in rows]})
    return cells


if __name__ == "__main__":
    golden = {
        "about": "JAX reference (repro.api) counters in the legacy PRNG mode (jax_threefry_partitionable=False, "
        "as tests/data/stage_graph_golden.json) at the full ExperimentSpec defaults for chip_smoke.py's "
        "NOWAIT/SmallBank and MVCC/YCSB legacy paths; written by tests/test_torch_legacy.py",
        "cells": golden_cells(),
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
