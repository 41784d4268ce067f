"""The port's training substrate against the JAX reference, on the CPU:
XLA's float32 ``exp``, the data pipeline, checkpoints, the fault-tolerant
runner and the training launcher.

Tokens, labels, data states, step counters and checkpoint leaf paths are
held bitwise.  Losses of runs that cross between the packages (a
checkpoint one wrote, the other restored) are held within 1e-5: the two
train in float32 with sums in another order (``tests/test_torch_train.py``
measures the gaps).  A run of the port against itself (with and without
an injected failure) is exact.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.configs import reduced_config as jreduced_config
from repro.data import pipeline as jpipeline
from repro.ft.runner import TrainRunner as JRunner
from repro.models.lm import init_lm as jinit_lm
from repro.sharding import AxisRules, unzip_params
from repro.train.steps import build_train_step as jbuild
from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import reduced_config
from repro_torch.core import prng
from repro_torch.data import pipeline as tpipeline
from repro_torch.ft.runner import TrainRunner, remesh_restore
from repro_torch.launch import train as train_launch
from repro_torch.models.lm import init_lm
from repro_torch.train.steps import build_train_step

ARCH = "stablelm-1.6b"
LOSS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores, where a thread pool per
    worker loses far more to contention than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# XLA's exp, the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi,n", [(0.0, float(np.log(np.float32(100352))), 2_000_001), (-87.0, 88.0, 1_000_001)])
def test_exp_matches_xla_bitwise(lo, hi, n):
    """The pipeline's ``exp(u log V)`` runs over [0, log V]: there the
    port's ``prng.exp`` equals XLA's on every point of a dense grid, and
    ``torch.exp`` differs on more than 1 % of them."""
    x = np.linspace(lo, hi, n).astype(np.float32)
    want = np.asarray(jnp.exp(x))
    got = prng.exp(torch.tensor(x)).numpy()
    assert _ulp(got, want).max() == 0
    if lo == 0.0:
        assert (torch.exp(torch.tensor(x)).numpy() != want).mean() > 0.01


def test_torch_exp_would_move_pipeline_tokens():
    """The trap the written-out ``exp`` avoids: over the full-vocabulary
    batches of ``test_pipeline_matches_reference_bitwise``, ``torch.exp``
    differs from XLA's on a large share of the inputs and moves tokens."""
    V = 100352
    log_v = prng.log(torch.tensor(float(V), dtype=torch.float32))
    moved = differ = total = 0
    for step in range(10):
        k1 = prng.split(prng.fold_in(prng.prng_key(0), step), 3)[0]
        x = prng.uniform(k1, (4, 2048), 1e-6, 1.0) * log_v
        a, b = prng.exp(x), torch.exp(x)
        differ += int((a != b).sum())
        moved += int(((a - 1.0).to(torch.int32) != (b - 1.0).to(torch.int32)).sum())
        total += x.numel()
    assert differ > 0.01 * total and moved > 0, (differ, moved, total)


def test_log_of_the_vocabulary_is_xlas():
    for v in (97, 512, 100352):
        want = np.asarray(jnp.log(float(v)))
        got = prng.log(torch.tensor(float(v), dtype=torch.float32)).numpy()
        assert got.view(np.int32) == want.view(np.int32), v


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 33, 0), (100352, 4, 2048, 0), (97, 3, 16, 3)])
def test_pipeline_matches_reference_bitwise(vocab, batch, seq, seed):
    ji, jn = jpipeline.make_pipeline(vocab, batch, seq, seed=seed)
    ti, tn = tpipeline.make_pipeline(vocab, batch, seq, seed=seed, device="cpu")
    js, ts = ji(), ti()
    assert ts == (int(js.step), js.seed)
    for step in range(10):
        js, jb = jn(js)
        ts, tb = tn(ts)
        assert ts == (int(js.step), js.seed) == (step + 1, seed)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32 and tb[k].shape == (batch, seq)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=f"step {step} {k}")


def test_pipeline_restartable_and_host_sharded():
    init, nxt = tpipeline.make_pipeline(97, 4, 16, seed=3, device="cpu")
    s1, b1 = nxt(init())
    s2, b2 = nxt(s1)
    assert torch.equal(nxt(init())[1]["tokens"], b1["tokens"]) and torch.equal(nxt(s1)[1]["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b2["tokens"])
    h = [tpipeline.shard_for_host(b1, i, 2) for i in range(2)]
    assert torch.equal(torch.cat([h[0]["tokens"], h[1]["tokens"]]), b1["tokens"])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_layout_and_bf16(tmp_path):
    tree = {"b": {"c": torch.tensor(7, dtype=torch.int32), "a": torch.ones((4, 3), dtype=torch.bfloat16) / 3},
            "a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "z": np.float32(2.5)}
    path = save_checkpoint(str(tmp_path), 5, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["step"] == 5
    assert m["leaves"] == {  # JAX's keystr paths, numbered in its sorted-key leaf order
        "['a']": {"file": "leaf_00000.npy", "shape": [2, 3], "dtype": "float32"},
        "['b']['a']": {"file": "leaf_00001.npy", "shape": [4, 3], "dtype": "bfloat16"},
        "['b']['c']": {"file": "leaf_00002.npy", "shape": [], "dtype": "int32"},
        "['z']": {"file": "leaf_00003.npy", "shape": [], "dtype": "float32"},
    }
    raw = np.load(os.path.join(path, "leaf_00001.npy"))
    assert raw.dtype == np.uint8 and raw.shape == (4, 6)  # the raw bytes, as the reference stores ml_dtypes
    step, back = restore_checkpoint(str(tmp_path), tree)
    assert step == 5 and back["b"]["a"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["a"], tree["b"]["a"]) and torch.equal(back["a"], tree["a"])
    assert int(back["b"]["c"]) == 7 and float(back["z"]) == 2.5
    _, whole = restore_checkpoint(str(tmp_path))  # no proto: the manifest's own tree
    assert {k: sorted(v) if isinstance(v, dict) else None for k, v in whole.items()} == {"a": None, "b": ["a", "c"],
                                                                                          "z": None}
    assert torch.equal(whole["b"]["a"], tree["b"]["a"])
    # the reference reads the port's file, bfloat16 included
    jstep, jback = jrestore(str(tmp_path), {"a": 0, "b": {"a": 0, "c": 0}, "z": 0})
    assert jstep == 5 and str(jback["b"]["a"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jback["b"]["a"], np.float32), tree["b"]["a"].float().numpy())


def test_checkpoint_prunes_and_is_atomic(tmp_path, monkeypatch):
    d = str(tmp_path)
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, tree, keep=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == ["step_00000004", "step_00000005"]
    # a save that dies midway leaves only its temporary directory: the newest complete step stays
    calls = []

    def dying_save(*a, **k):
        calls.append(a)
        raise OSError("disk gone")

    monkeypatch.setattr(tckpt.np, "save", dying_save)
    with pytest.raises(OSError):
        save_checkpoint(d, 6, {"x": torch.ones(2), "y": torch.ones(2)})
    monkeypatch.undo()
    assert calls and latest_step(d) == 5 and not os.path.exists(os.path.join(d, "step_00000006"))
    assert any(x.startswith(".tmp_") for x in os.listdir(d))
    os.makedirs(os.path.join(d, "step_00000009"))  # a step without a manifest is not complete
    assert latest_step(d) == 5 and latest_step(os.path.join(d, "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(os.path.join(d, "none"), tree)


# ---------------------------------------------------------------------------
# The runner, across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's runner (``tests/test_substrate.py``'s scenario,
    seed-1 data, 4 x 32 tokens): a clean 14-step run, and a 9-step run that
    checkpoints every 3 steps, then continues to 14 from its checkpoint."""
    cfg = jreduced_config(ARCH)
    step, opt = jbuild(cfg, AxisRules(None), "adamw")
    jitted = jax.jit(step)

    def init_state():
        params = unzip_params(jinit_lm(jax.random.PRNGKey(0), cfg, jnp.float32))[0]
        return params, opt.init(params)

    init_data, nxt = jpipeline.make_pipeline(cfg.vocab_size, 4, 32, seed=1)
    clean = JRunner(jitted, init_state, nxt, init_data).run(14, log_every=1000)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    first = JRunner(jitted, init_state, nxt, init_data, ckpt_dir=d, ckpt_every=3).run(9, log_every=1000)
    snapshot = str(tmp_path_factory.mktemp("jax_ckpt_9"))
    shutil.copytree(d, snapshot, dirs_exist_ok=True)
    resumed = JRunner(jitted, init_state, nxt, init_data, ckpt_dir=d, ckpt_every=3).run(14, log_every=1000)
    return {"clean": clean["losses"], "first": first["losses"], "resumed": resumed["losses"], "ckpt_9": snapshot}


def _port_runner(ckpt_dir=None, fail_at=None, ckpt_every=5, device="cpu"):
    cfg = reduced_config(ARCH)
    step, opt = build_train_step(cfg, "adamw")

    def init_state():
        params = init_lm(prng.prng_key(0), cfg, torch.float32, device=device)
        return params, opt.init(dict(params.named_parameters()))

    init_data, nxt = tpipeline.make_pipeline(cfg.vocab_size, 4, 32, seed=1, device=device)
    return TrainRunner(step, init_state, nxt, init_data, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, fail_at=fail_at)


def test_runner_with_failure_equals_clean_run_and_reference(reference_runs, tmp_path):
    clean = _port_runner().run(14, log_every=1000)
    failed = _port_runner(str(tmp_path), fail_at=9).run(14, log_every=1000)
    assert clean["final_step"] == failed["final_step"] == 14
    # the failure at step 9 restores step 5 and replays 5..8: the stream resumes exactly
    assert failed["losses"][:9] == clean["losses"][:9] and failed["losses"][9:] == clean["losses"][5:]
    np.testing.assert_allclose(clean["losses"], reference_runs["clean"], atol=LOSS_TOL, rtol=0)
    assert latest_step(str(tmp_path)) == 14


def test_port_resumes_a_reference_checkpoint(reference_runs, tmp_path):
    """The reference's runner wrote step 9; the port's runner restores it
    and continues with the reference's own resumed losses."""
    d = str(tmp_path / "ckpt")
    shutil.copytree(reference_runs["ckpt_9"], d)
    assert latest_step(d) == 9
    out = _port_runner(d, ckpt_every=3).run(14, log_every=1000)
    assert out["final_step"] == 14 and len(out["losses"]) == 5
    np.testing.assert_allclose(out["losses"], reference_runs["resumed"], atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(out["losses"], reference_runs["clean"][9:], atol=LOSS_TOL, rtol=0)


def test_reference_restores_a_port_checkpoint(tmp_path):
    d = str(tmp_path)
    out = _port_runner(d, ckpt_every=3).run(4, log_every=1000)
    cfg = jreduced_config(ARCH)
    params = unzip_params(jinit_lm(jax.random.PRNGKey(0), cfg, jnp.float32))[0]
    _, opt = jbuild(cfg, AxisRules(None), "adamw")
    proto = {"params": params, "opt": opt.init(params), "data": {"step": 0, "seed": 0}, "step": 0}
    step, tree = jrestore(d, proto)
    assert step == 4 and int(tree["step"]) == 4 and int(tree["data"]["step"]) == 4 and int(tree["data"]["seed"]) == 1
    want = convert.bundle_to_tree(out["params"], out["opt"], tpipeline.DataState(4, 1), 4)
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat = dict(tckpt._flatten(want))
    assert [jax.tree_util.keystr(k) for k, _ in got] == list(flat)
    for k, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), flat[jax.tree_util.keystr(k)].numpy())
    # and back: the port's bundle from the reference's tree
    s, model, opt_state, data = convert.bundle_from_tree(
        jax.tree.map(np.asarray, tree), reduced_config(ARCH), device="cpu")
    assert (s, data) == (4, (4, 1)) and set(opt_state) == {"m", "v"}
    for n, p in model.state_dict().items():
        assert torch.equal(p, out["params"].state_dict()[n]), n


def test_remesh_restore_onto_a_device_and_a_device_list(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8), "s": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 1, tree)
    step, one = remesh_restore(str(tmp_path), tree, "cpu")
    assert step == 1 and torch.equal(one["w"], tree["w"]) and one["w"].device.type == "cpu"
    step, replicas = remesh_restore(str(tmp_path), tree, ("cpu",) * 4)
    assert step == 1 and len(replicas) == 4
    assert all(torch.equal(r["w"], tree["w"]) for r in replicas)
    assert len({r["w"].data_ptr() for r in replicas}) == 4  # each replica owns its copy


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_train_launcher_flags_and_run(tmp_path, capsys):
    out = train_launch.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                             "--ckpt", str(tmp_path), "--ckpt-every", "2", "--fail-at", "2"])
    text = capsys.readouterr().out
    assert "params=787,456 reduced=True device=cpu" in text and "injected node failure at step 2" in text
    assert out["final_step"] == 3 and latest_step(str(tmp_path)) == 3
    with pytest.raises(SystemExit):
        train_launch.main(["--lr", "3e-3"])  # parsed and ignored by the reference (ROADMAP.md C.7)
    args = train_launch.parse_args([])
    assert args.reduced is False and args.device == "cuda" and args.ckpt is None and args.fail_at is None
    assert (args.arch, args.steps, args.batch, args.seq, args.ckpt_every) == (ARCH, 100, 8, 128, 50)


def test_train_launcher_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipeline.make_pipeline(97, 1, 4)
