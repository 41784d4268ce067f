"""The port's user entry points against the JAX reference, on the CPU:
``examples/torch_{quickstart,hybrid_search,txn_serving,train_lm}.py``,
``scripts/torch_dev_smoke.py`` and ``scripts/torch_check_api_boundary.py``.

RCC counters (commits, aborts and the ratios built only from them) are
held bitwise, float latencies to rtol 1e-5 (PERF.md §2), the admission
workload's draws bitwise per slot, training tokens bitwise and losses
within 1e-5 (``tests/test_torch_substrate.py``'s rule), at CPU-sized cuts
of the examples' knobs.  The hybrid search's ranking is the reference's,
but for neighbours whose keys lie within the float tolerance of each other
(``chip_smoke.ranking_swaps``).

Run as a script, this file writes ``src/repro_torch/data/golden_examples.json``
(outside tier-1): the reference at the examples' own knobs, then, in a
second process, the port on the CPU, whose gaps set the card's tolerances
at 10x (no tighter than 1e-6).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_examples.py
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.core.costmodel import ONE_SIDED, CostModel as JCostModel
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import run as jrun
from repro.core.registry import get_protocol as jget_protocol
from repro.data import pipeline as jpipeline
from repro.ft.runner import TrainRunner as JRunner
from repro.models.lm import init_lm as jinit_lm
from repro.models.lm import lm_apply as jlm_apply
from repro.sharding import AxisRules, unzip_params
from repro.train.steps import build_train_step as jbuild
from repro_torch.core import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_examples.json")
EXACT = ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips")
CALVIN_EXACT = ("commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves")
RTOL = 1e-5
LOSS_TOL = 1e-5
LOGIT_TOL = 1e-5
# CPU cuts of the examples' knobs
QUICK_KW = dict(n_nodes=2, coroutines=4, records_per_node=64, ticks=24, warmup=6)
SEARCH_KW = dict(n_nodes=2, coroutines=8, records_per_node=256, warmup=8)
SEARCH_TICKS = 48
ADMISSION_TICKS, ADMISSION_WARMUP = 40, 10


def _load(name, rel):
    """A module of the checkout by file path (examples/ and scripts/ are no packages)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tq = _load("torch_quickstart", "examples/torch_quickstart.py")
th = _load("torch_hybrid_search", "examples/torch_hybrid_search.py")
tt = _load("torch_txn_serving", "examples/torch_txn_serving.py")
ttl = _load("torch_train_lm", "examples/torch_train_lm.py")
tds = _load("torch_dev_smoke", "scripts/torch_dev_smoke.py")
gate = _load("torch_check_api_boundary", "scripts/torch_check_api_boundary.py")
jtxn = _load("ref_txn_serving", "examples/txn_serving.py")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


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


def _jax_rows(protocol, configs, kw, workload="smallbank"):
    """repro.api rows, run once per distinct spec for the whole module."""
    key = (protocol, workload, repr(configs), repr(sorted(kw.items())))
    if key not in _JROWS:
        _JROWS[key] = japi.run(japi.ExperimentSpec(protocol=protocol, workload=workload, configs=configs, **kw)).rows
    return _JROWS[key]


def _same_row(a, b, protocol):
    """Port row ``b`` against reference row ``a``: counters bitwise, float
    latencies (CALVIN: also its float32 throughput) to RTOL."""
    exact = CALVIN_EXACT if protocol == "calvin" else EXACT
    for k in exact:
        assert a[k] == b[k], (protocol, a["hybrid"], k, a[k], b[k])
    for k in ("avg_latency_us", "throughput_mtps") if protocol == "calvin" else ("avg_latency_us",):
        np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=f"{protocol} {a['hybrid']} {k}")


def _sha(t):
    """sha256 of a token batch's int32 words (little-endian)."""
    return hashlib.sha256(np.ascontiguousarray(np.asarray(t, np.int32)).astype("<i4").tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


_PORT_PAIRS = {}


def _port_pairs():
    if not _PORT_PAIRS:
        _PORT_PAIRS["rows"] = tq.protocol_pairs("cpu", QUICK_KW)
    return _PORT_PAIRS["rows"]


@pytest.mark.parametrize("protocol", ["nowait", "waitdie", "occ", "mvcc", "sundial", "calvin"])
def test_quickstart_pairs_match_reference(protocol):
    """Section 1: each protocol's RPC / one-sided pair, one 2-config plan."""
    got = [m for p, _, m in _port_pairs() if p == protocol]
    want = _jax_rows(protocol, [{"hybrid": c} for _, c in tq.PLANES], QUICK_KW)
    assert [m["hybrid"] for m in got] == [m["hybrid"] for m in want] == ["000000", "111111"]
    for a, b in zip(want, got):
        _same_row(a, b, protocol)


def test_quickstart_hybrid_row_matches_reference():
    """Section 2: the hybrid MVCC code, one 1-config plan."""
    got = tq.hybrid_mvcc("cpu", QUICK_KW)
    (want,) = _jax_rows("mvcc", [{"hybrid": tq.HYBRID_CODE}], QUICK_KW)
    assert got["hybrid"] == want["hybrid"] == "010111"
    _same_row(want, got, "mvcc")


def test_quickstart_lm_section_matches_golden():
    """Section 3 on the CPU against the reference's logits and loss in the
    golden file (the reference wrote them at these very knobs)."""
    g = json.load(open(GOLDEN))["quickstart"]["lm"]
    out = tq.lm_substrate("cpu")
    logits = out["logits"].double()
    assert list(logits.shape) == g["logits_shape"]
    np.testing.assert_allclose(logits[:, :, : g["head"]].numpy(), g["logits_head"], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(float(logits.sum()), g["logits_sum"], rtol=0, atol=LOGIT_TOL * g["logits_abs_sum"])
    np.testing.assert_allclose(out["loss"], g["loss"], rtol=0, atol=LOSS_TOL)


# ---------------------------------------------------------------------------
# hybrid search
# ---------------------------------------------------------------------------


_SEARCH = {}


def _search():
    if not _SEARCH:
        _SEARCH["port"] = th.search("sundial", "smallbank", SEARCH_TICKS, device="cpu", **SEARCH_KW)
        _SEARCH["ref"] = _jax_rows("sundial", [{"hybrid": c} for c in range(64)], dict(SEARCH_KW, ticks=SEARCH_TICKS))
    return _SEARCH["port"], _SEARCH["ref"]


def test_hybrid_search_ranking_matches_reference():
    """All 64 codes as one batched plan against the reference's batched
    run: every row, and the ranking (neighbours within the float tolerance
    may swap)."""
    got, want = _search()
    assert len(got) == len(want) == 64
    for a, b in zip(want, got):
        assert a["hybrid"] == b["hybrid"]
        _same_row(a, b, "sundial")
    swaps = chip_smoke.ranking_swaps(th.rank(got), th.rank(want), RTOL)
    assert len(swaps) < 8, swaps
    assert len({r["avg_latency_us"] for r in got}) > 8  # the codes really differ


@pytest.mark.parametrize("code", ["000000", "101101", "111111"])
def test_hybrid_search_codes_match_run_cell(code):
    """Three codes of the batched search against the JAX example's own path,
    ``benchmarks.common.run_cell`` (one jit per code)."""
    sys.path.insert(0, ROOT)
    from benchmarks.common import run_cell

    got = next(r for r in _search()[0] if r["hybrid"] == code)
    want, _, _ = run_cell("sundial", "smallbank", tuple(int(c) for c in code), ticks=SEARCH_TICKS, **SEARCH_KW)
    assert want["hybrid"] == code
    _same_row(want, got, "sundial")


def test_ranking_swaps_rule():
    """Only neighbours of equal throughput and latencies within rtol may
    swap; any other difference of order fails."""
    want = [(2.0, 10.0, "a"), (1.0, 5.0000001, "b"), (1.0, 5.0, "c"), (0.5, 1.0, "d")]
    assert chip_smoke.ranking_swaps(want, want, RTOL) == []
    swapped = [want[0], want[2], want[1], want[3]]
    assert chip_smoke.ranking_swaps(swapped, want, RTOL) == [("b", "c")]
    with pytest.raises(AssertionError):
        chip_smoke.ranking_swaps([want[1], want[0], want[2], want[3]], want, RTOL)
    far = [(2.0, 10.0, "a"), (1.0, 5.1, "b"), (1.0, 5.0, "c"), (0.5, 1.0, "d")]
    with pytest.raises(AssertionError):
        chip_smoke.ranking_swaps([far[0], far[2], far[1], far[3]], far, RTOL)


# ---------------------------------------------------------------------------
# txn_serving: the user-written admission workload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pages", [2048, 8, 7])
def test_admission_gen_bitwise_per_slot(n_pages):
    """The batched ``gen`` against the reference's per-slot ``gen`` (vmapped,
    as its engine calls it, and slot by slot), over 4096 slots' keys; at 8
    and 7 pages nearly every request clashes, so every dedup round acts."""
    n = 4096
    keys_t = prng.fold_in(prng.prng_key(3), torch.arange(n, dtype=torch.int32))
    node = torch.arange(n, dtype=torch.int32) // 1024
    slot = torch.arange(n, dtype=torch.int32)
    got = tt.make_admission_workload(n_pages).gen(keys_t, node, slot)
    keys_j = jax.vmap(lambda c: jax.random.fold_in(jax.random.PRNGKey(3), c))(jnp.arange(n, dtype=jnp.int32))
    jgen = jtxn.make_admission_workload(n_pages).gen
    want = jax.vmap(jgen)(keys_j, jnp.asarray(node.numpy()), jnp.asarray(slot.numpy()))
    assert np.array_equal(np.asarray(keys_j, np.uint32).astype(np.int64), keys_t.numpy())
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if w.dtype == jnp.int32 else torch.bool)
        assert np.array_equal(g.numpy(), np.asarray(w))
    for i in (0, 1, 1023, 1024, 4095):
        one = jgen(keys_j[i], jnp.int32(int(node[i])), jnp.int32(i))
        assert np.array_equal(got[0][i].numpy(), np.asarray(one[0]))


def test_admission_run_matches_reference():
    """NOWAIT admission at the example's config, ticks cut: counters, page
    generations and the final store bitwise (past about tick 15 every slot
    aborts every tick, as the reference's does: ROADMAP.md C.22)."""
    _, store, m = tt.admission("cpu", ticks=ADMISSION_TICKS, warmup=ADMISSION_WARMUP)
    ec = JEngineConfig(protocol="nowait", n_nodes=tt.N_NODES, coroutines=tt.COROUTINES,
                       records_per_node=tt.PAGES_PER_NODE, rw=1, max_ops=tt.PAGES_PER_REQ, hybrid=(ONE_SIDED,) * 6)
    wl = jtxn.make_admission_workload(ec.n_records)
    _, jstore, jm = jax.jit(lambda: jrun(jget_protocol("nowait").tick, ec, JCostModel(), wl, ADMISSION_TICKS,
                                         warmup=ADMISSION_WARMUP))()
    for k in EXACT:
        assert m[k] == jm[k].tolist(), (k, m[k], jm[k])
    np.testing.assert_allclose(m["avg_latency_us"], float(jm["avg_latency_us"]), rtol=RTOL)
    assert int(store["data"].sum()) == int(jstore["data"].sum()) > 0
    for k in jstore:
        assert np.array_equal(store[k].numpy(), np.asarray(jstore[k])), k


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------


def test_train_lm_failure_equals_uninterrupted_and_reference(tmp_path):
    """The runner with a failure at step 5 (checkpoints every 3) replays
    steps 3 and 4 and then gives the uninterrupted stream; the first losses
    and every token batch are the reference's ``TrainRunner``'s on the
    example's reduced config."""
    steps = 8
    clean = ttl.train(steps, device="cpu", ckpt_every=3, log_every=1000)
    failed = ttl.train(steps, device="cpu", ckpt=str(tmp_path), fail_at=5, ckpt_every=3, log_every=1000)
    assert clean["final_step"] == failed["final_step"] == steps
    c, f = clean["losses"], failed["losses"]
    assert f[:5] == c[:5] and f[5:] == c[3:]
    assert [_sha(t.numpy()) for t in failed["tokens"][5:]] == [_sha(t.numpy()) for t in clean["tokens"][3:]]
    cfg, batch, seq = ttl.config(False)
    jcfg = jreduced_config("stablelm-1.6b")
    assert (jcfg.n_layers, jcfg.d_model, jcfg.vocab_size) == (cfg.n_layers, cfg.d_model, cfg.vocab_size)
    ref = _ref_train(jcfg, batch, seq, steps)
    assert [_sha(t) for t in ref["tokens"]] == [_sha(t.numpy()) for t in clean["tokens"]]
    np.testing.assert_allclose(c, ref["losses"], atol=LOSS_TOL, rtol=0)


def test_train_lm_full_config_is_the_reference_example_s():
    """``--full``'s 8-layer, d 768 model: the reference example's replace
    of stablelm-1.6b, field for field that both configs have."""
    cfg, batch, seq = ttl.config(True)
    jcfg = _ref_full_config()
    for f in dataclasses.fields(jcfg):
        if hasattr(cfg, f.name):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (batch, seq) == (8, 512) and cfg.param_count() == jcfg.param_count()


def _ref_full_config():
    base, _ = jget_config("stablelm-1.6b")
    return dataclasses.replace(base, n_layers=8, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64, d_ff=2048,
                               vocab_size=32000, microbatch=1, remat="none")


def _ref_train(cfg, batch, seq, steps, ckpt_dir=None):
    """The JAX example's run (``examples/train_lm.py``): its losses and the
    tokens of every batch."""
    shd = AxisRules(None)
    step_fn, optimizer = jbuild(cfg, shd)
    jitted = jax.jit(step_fn, donate_argnums=(0, 1))

    def init_state():
        params = unzip_params(jinit_lm(jax.random.PRNGKey(0), cfg, jnp.float32))[0]
        return params, optimizer.init(params)

    init_data, draw = jpipeline.make_pipeline(cfg.vocab_size, batch, seq, copy_frac=ttl.COPY_FRAC)
    tokens = []

    def next_batch(ds):
        ds, b = draw(ds)
        tokens.append(np.asarray(b["tokens"]))
        return ds, b

    out = JRunner(jitted, init_state, next_batch, init_data, ckpt_dir=ckpt_dir, ckpt_every=ttl.CKPT_EVERY).run(
        steps, log_every=1000)
    return {"losses": [float(x) for x in out["losses"]], "tokens": tokens}


# ---------------------------------------------------------------------------
# dev smoke
# ---------------------------------------------------------------------------


_MATRIX = {}


def _fast_matrix():
    if not _MATRIX:
        _MATRIX["fast"] = tds.protocol_matrix(True, "cpu")
    return _MATRIX["fast"]


def test_dev_smoke_matrix_fast_equals_sequential():
    """The batched matrix (one 2-config bucket a protocol) and the
    sequential one (a plan a cell) commit the same counts."""
    fast = _fast_matrix()
    assert fast == tds.protocol_matrix(False, "cpu")
    assert set(fast) == {"nowait", "waitdie", "occ", "mvcc", "sundial", "calvin"}


def test_dev_smoke_matrix_matches_golden():
    assert {k: list(v) for k, v in _fast_matrix().items()} == json.load(open(GOLDEN))["dev_smoke_matrix"]["commits"]


def test_dev_smoke_lm_checks():
    """One reduced arch through forward, AdamW step, prefill and decode,
    whose consistency gaps lie well under the reference's 2e-2."""
    out = tds.lm_checks(["stablelm-1.6b", "qwen2-vl-72b"], "cpu")
    for aid, r in out.items():
        assert r["err_prefill"] < 1e-4 and r["err_decode"] < 1e-4, (aid, r)
        assert np.isfinite(r["loss"])


# ---------------------------------------------------------------------------
# entry points and the boundary gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["quickstart", "hybrid_search", "txn_serving", "train_lm", "dev_smoke"])
def test_entry_points_refuse_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    mod = {"quickstart": tq, "hybrid_search": th, "txn_serving": tt, "train_lm": ttl, "dev_smoke": tds}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_boundary_gate_clean():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "torch_check_api_boundary.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "api boundary ok" in out.stdout and "kernel liveness ok" in out.stdout


def _tree(root, files):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def test_boundary_gate_flags_planted_violations(tmp_path):
    """Gate (a) flags each banned form outside the allow-list and exempts
    the allow-listed functions; gate (b) flags a kernel module nothing
    reaches and a CUDA source ``_build.py`` does not name, follows
    transitive imports and exempts __init__, ref and _build."""
    root = str(tmp_path)
    kdir = "src/repro_torch/kernels/"
    _tree(root, {
        "examples/torch_bad.py": "from repro_torch.core.sweep import run_grid\nfrom repro_torch.core import sweep\n"
                                 "sweep.run_cell_sharded()\nimport repro_torch.core.sweep\n",
        "scripts/torch_bad.py": "from repro_torch.core.protocols import PROTOCOLS\nx = PROTOCOLS\n",
        "scripts/other.py": "from repro_torch.core.sweep import run_grid\n",  # not a port script: not scanned
        "chip_smoke.py": "def phase_legacy():\n    from repro_torch.core import sweep\n    sweep.run_grid()\n"
                         "def phase_new():\n    from repro_torch.core import sweep\n",
        "src/repro_torch/api.py": "from repro_torch.kernels import ops\n",
        kdir + "__init__.py": "", kdir + "ref.py": "", kdir + "_build.py": "SIGNATURES = {'good': 1}\n",
        kdir + "ops.py": "from repro_torch.kernels.good import f\n",
        kdir + "good.py": "from repro_torch.kernels import _build\n", kdir + "dead.py": "",
        kdir + "csrc/good.cu": "", kdir + "csrc/stray.cu": "",
    })
    bad = gate.violations(root)
    assert len([v for v in bad if v.startswith("examples/torch_bad.py")]) == 4, bad
    assert len([v for v in bad if v.startswith("scripts/torch_bad.py")]) == 2, bad
    assert [v.split(":")[:2] for v in bad if v.startswith("chip_smoke.py")] == [["chip_smoke.py", "5"]], bad
    assert not any(v.startswith("scripts/other.py") for v in bad)
    dead = gate.kernel_liveness(root)
    assert len(dead) == 2 and "kernels/dead.py" in dead[0] and "csrc/stray.cu" in dead[1], dead


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------


def test_golden_file_holds_the_examples_knobs():
    g = json.load(open(GOLDEN))
    q = g["quickstart"]
    assert q["kw"] == tq.KW and len(q["rows"]) == 13
    assert [(r["protocol"], r["impl"]) for r in q["rows"][:12]] == [
        (p, impl) for p in ("nowait", "waitdie", "occ", "mvcc", "sundial", "calvin") for impl, _ in tq.PLANES]
    assert q["rows"][12]["hybrid"] == "010111" and q["lm"]["arch"] == tq.LM_ARCH
    h = g["hybrid_search"]
    assert h["spec"] == dict(th.CELL, protocol="sundial", workload="smallbank", ticks=160)
    assert [r["hybrid"] for r in h["rows"]] == ["".join(str((c >> i) & 1) for i in range(6)) for c in range(64)]
    assert sorted(h["ranking"]) == sorted(r["hybrid"] for r in h["rows"])
    a = g["admission"]
    assert (a["ticks"], a["warmup"], a["coroutines"]) == (300, 50, 24) and a["page_sum"] > 0
    t = g["train_lm"]
    assert len(t["losses"]) == len(t["tokens_sha256"]) == 120 and t["losses"][-1] < t["losses"][0]
    assert len(g["train_lm_full"]["losses"]) == 3
    for k in ("quickstart_logits", "quickstart_loss", "train_lm_losses", "train_lm_full_losses"):
        assert g["tolerance"][k] == max(10 * g["port_cpu_gap"][k], 1e-6)


# ---------------------------------------------------------------------------
# the golden file's writer (outside tier-1)
# ---------------------------------------------------------------------------


def _row(m, **extra):
    keep = ("hybrid", "commits", "aborts", "abort_rate", "avg_round_trips", "throughput_mtps", "avg_latency_us")
    out = dict(extra, **{k: m[k] for k in keep})
    if "avg_waves" in m:
        out["avg_waves"] = m["avg_waves"]
    return out


def _logits_record(logits, head=8):
    x = np.asarray(logits, np.float64)
    return {"logits_shape": list(x.shape), "head": head, "logits_head": x[:, :, :head].tolist(),
            "logits_sum": float(x.sum()), "logits_abs_sum": float(np.abs(x).sum())}


def write_golden():
    times, t_all = {}, time.time()

    def lap(name, t0):
        times[name] = round(time.time() - t0, 1)
        print(f"reference {name}: {times[name]} s", flush=True)

    t0 = time.time()
    rows = []
    for proto in ("nowait", "waitdie", "occ", "mvcc", "sundial", "calvin"):
        for (impl, _), m in zip(tq.PLANES, _jax_rows(proto, [{"hybrid": c} for _, c in tq.PLANES], tq.KW)):
            rows.append(_row(m, protocol=proto, impl=impl))
    (m,) = _jax_rows("mvcc", [{"hybrid": tq.HYBRID_CODE}], tq.KW)
    rows.append(_row(m, protocol="mvcc", impl="hybrid"))
    cfg = jreduced_config(tq.LM_ARCH)
    shd = AxisRules(None)
    params = unzip_params(jinit_lm(jax.random.PRNGKey(0), cfg, jnp.float32))[0]
    tokens = jax.random.randint(jax.random.PRNGKey(1), (tq.LM_BATCH, tq.LM_SEQ), 0, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    logits = jax.jit(lambda p, b: jlm_apply(p, cfg, shd, b))(params, batch)
    step, opt = jbuild(cfg, shd)
    _, _, metrics = jax.jit(step)(params, opt.init(params), jnp.int32(0), batch)
    lm = dict(arch=tq.LM_ARCH, batch=tq.LM_BATCH, seq=tq.LM_SEQ, loss=float(metrics["loss"]), **_logits_record(logits))
    lap("quickstart", t0)

    t0 = time.time()
    spec = dict(th.CELL, protocol="sundial", workload="smallbank", ticks=160)
    kw = {k: v for k, v in spec.items() if k not in ("protocol", "workload")}
    hrows = _jax_rows("sundial", [{"hybrid": c} for c in range(64)], kw)
    ranking = sorted(((r["throughput_mtps"], r["avg_latency_us"], r["hybrid"]) for r in hrows), reverse=True)
    lap("hybrid_search (one batched bucket)", t0)
    t0 = time.time()
    sys.path.insert(0, ROOT)
    from benchmarks.common import run_cell

    for code in (ranking[0][2], ranking[-1][2]):  # the example's own path, at its best and worst code
        cell, _, _ = run_cell("sundial", "smallbank", tuple(int(c) for c in code), ticks=160, coroutines=40)
        want = next(r for r in hrows if r["hybrid"] == code)
        assert all(cell[k] == want[k] for k in EXACT), (code, cell, want)
    lap("hybrid_search run_cell at the best and worst code", t0)

    t0 = time.time()
    ec = JEngineConfig(protocol="nowait", n_nodes=tt.N_NODES, coroutines=tt.COROUTINES,
                       records_per_node=tt.PAGES_PER_NODE, rw=1, max_ops=tt.PAGES_PER_REQ, hybrid=(ONE_SIDED,) * 6)
    wl = jtxn.make_admission_workload(ec.n_records)
    _, store, am = jax.jit(lambda: jrun(jget_protocol("nowait").tick, ec, JCostModel(), wl, 300, warmup=50))()
    admission = dict(ticks=300, warmup=50, coroutines=tt.COROUTINES, page_sum=int(store["data"].sum()),
                     **{k: am[k].tolist() for k in EXACT + ("avg_latency_us",)})
    lap("admission", t0)

    t0 = time.time()
    rcfg, rb, rs = ttl.config(False)
    with tempfile.TemporaryDirectory() as d:
        red = _ref_train(jreduced_config("stablelm-1.6b"), rb, rs, 120, ckpt_dir=d)
    lap("train_lm reduced, 120 steps", t0)
    t0 = time.time()
    full = _ref_train(_ref_full_config(), 8, 512, 3)
    lap("train_lm --full, 3 steps", t0)

    t0 = time.time()
    matrix = {p: [r["commits"] for r in _jax_rows(p, [{"hybrid": c} for _, c in tq.PLANES], tds.MATRIX_KW)]
              for p in ("nowait", "waitdie", "occ", "mvcc", "sundial", "calvin")}
    lap("dev_smoke matrix", t0)

    out = {
        "about": "JAX reference (CPU, jax_threefry_partitionable=True) outputs of the four examples at their own "
                 "knobs, the held-to values of chip_smoke.py's examples phase: quickstart's 13 rows (repro.api, "
                 "as examples/quickstart.py runs them) and its LM section's logits (the first `head` of each "
                 "row's vocabulary, the float64 sum and |sum|) and loss; hybrid_search's 64 rows in bitmask "
                 "order and their ranking, from one batched repro.api bucket (the reference's batched == "
                 "sequential contract; benchmarks.common.run_cell, the example's path, gave the best and worst "
                 "codes' counters equal); the admission run's counters and page generations; train_lm's 120 "
                 "losses and each batch's token sha256 (int32, little-endian); --full's first 3 losses only: "
                 "300 steps of the 100M-parameter model at 8 x 512 take too long on this CPU, so the card's 300 "
                 "are held to the first 3 and to a run of their own without the failure; dev_smoke's --fast "
                 "matrix commits (rpc, one-sided)",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_examples.py",
        "quickstart": {"kw": tq.KW, "rows": rows, "lm": lm},
        "hybrid_search": {"spec": spec, "rows": [_row(r) for r in hrows], "ranking": [c for _, _, c in ranking]},
        "admission": admission,
        "train_lm": {"steps": 120, "batch": rb, "seq": rs, "losses": red["losses"],
                     "tokens_sha256": [_sha(t) for t in red["tokens"]]},
        "train_lm_full": {"batch": 8, "seq": 512, "losses": full["losses"],
                          "tokens_sha256": [_sha(t) for t in full["tokens"]]},
        "dev_smoke_matrix": {"kw": tds.MATRIX_KW, "commits": matrix},
    }
    times["reference total"] = round(time.time() - t_all, 1)
    out["writer_times_s"] = times
    with open(GOLDEN, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(f"wrote {GOLDEN} ({times['reference total']} s); measuring the port's CPU gap in a new process", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap"], env=env, check=True)


def _port_cpu_gap():
    """The port on the CPU at the golden file's knobs, in a process of its
    own: its counters must equal the file's, its float gaps set the card's
    tolerances."""
    g = json.load(open(GOLDEN))
    t_all = time.time()
    q = tq.main(["--device", "cpu"])
    got = [_row(m, protocol=p, impl=impl) for p, impl, m in q["pairs"]] + [_row(q["hybrid"], protocol="mvcc",
                                                                                  impl="hybrid")]
    for a, b in zip(g["quickstart"]["rows"], got):
        _same_row(a, b, a["protocol"])
    lm, logits = g["quickstart"]["lm"], q["lm"]["logits"].double().numpy()
    gap = {
        "quickstart_logits": max(float(np.abs(logits[:, :, : lm["head"]] - np.asarray(lm["logits_head"])).max()),
                                 abs(float(logits.sum()) - lm["logits_sum"]) / lm["logits_abs_sum"]),
        "quickstart_loss": abs(q["lm"]["loss"] - lm["loss"]) / abs(lm["loss"]),
    }
    _, store, m = tt.admission("cpu")
    a = g["admission"]
    assert [m[k] for k in EXACT] == [a[k] for k in EXACT] and int(store["data"].sum()) == a["page_sum"]
    for key, full, steps in (("train_lm", False, 120), ("train_lm_full", True, 3)):
        out = ttl.train(steps, full=full, device="cpu")
        assert [_sha(t.numpy()) for t in out["tokens"]] == g[key]["tokens_sha256"], key
        want = np.asarray(g[key]["losses"])
        gap[f"{key}_losses"] = float((np.abs(np.asarray(out["losses"]) - want) / np.abs(want)).max())
    assert {k: list(v) for k, v in tds.protocol_matrix(True, "cpu").items()} == g["dev_smoke_matrix"]["commits"]
    g["port_cpu_gap"] = gap
    # the card is held to 10x the CPU's gap, and no tighter than 1e-6 (PERF.md §2)
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in gap.items()}
    g["writer_times_s"]["port on the CPU"] = round(time.time() - t_all, 1)
    with open(GOLDEN, "w") as f:
        json.dump(g, f)
        f.write("\n")
    print(f"port on the CPU: gaps {gap}; tolerances {g['tolerance']}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(_port_cpu_gap() if sys.argv[1:] == ["--port-gap"] else write_golden())
