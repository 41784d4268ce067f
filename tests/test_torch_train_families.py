"""The SSM, hybrid and encoder-decoder families' training runs against the
JAX reference, on the CPU, and their golden files.

``golden.port_run``, the run that ``chip_smoke.py`` holds the card to, goes
through the port at each family's reduced config (``remat`` "full", as at
full width): falcon-mamba-7b (4 layers, d_inner 256), recurrentgemma-2b
(5 layers, W = 16, at S = 2W + 8, so the local mask bites) and whisper-small
(2 + 2 layers, 24 frames).  The reference runs the same launcher batches
(the pipeline's tokens; whisper's frames ``normal(fold_in(PRNGKey(7),
step))``) through its jitted ``build_train_step`` for 3 AdamW steps, as the
writer below does at full width.  Tolerances are those of each family's
training test (``tests/test_torch_{ssm,hybrid,whisper}.py``): losses within
1e-5 absolute, ``grad_norm`` within 1e-5 relative, and each leaf's float64
sum and |sum| (parameters, m and v) within 1e-5 of its |sum|, the m and v
tolerance of those tests taken over the sum.  The draws are bitwise.

Each golden file is checked for its config, cut and leaves, its draws
against the port's, and tolerances of at least 10x its recorded CPU gap.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_families.py [ARCH ...]

rewrites ``src/repro_torch/data/golden_train_{falcon_mamba,recurrentgemma,whisper}.json``
(all three by default): the jitted reference at full width, depth cut as
``GOLDEN_RUNS`` says, 3 AdamW steps on the launcher's batches; then, in a
process of its own, the port's run on the CPU (``golden.port_run``), whose
gap sets the card's tolerances at ``max(10 x gap, 1e-6)``.
"""
import dataclasses
import json
import os
import resource
import subprocess
import sys
import time
import types
import weakref
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro.train import steps as jsteps
from repro_torch.configs import get_config, reduced_config
from repro_torch.layers import ssm as tssm
from repro_torch.train.golden import (GOLDEN_TRAIN_FAMILIES, batch_draws, draw_mismatches, file_config, port_run,
                                      rel_gaps, train_record)
from repro_torch.train.steps import train_batches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHD = AxisRules(None)
FAMILIES = tuple(GOLDEN_TRAIN_FAMILIES)
# each file's run at full width, depth cut so that the writer's CPU (62 GB) holds the reference's AdamW step
GOLDEN_RUNS = {
    "falcon-mamba-7b": dict(seed=0, n_layers=2, batch=1, seq=2048, steps=3, optimizer="adamw"),
    "recurrentgemma-2b": dict(seed=0, n_layers=3, batch=1, seq=4096, steps=3, optimizer="adamw"),
    "whisper-small": dict(seed=0, n_layers=12, batch=2, seq=448, steps=3, optimizer="adamw"),
}
CUTS = {
    "falcon-mamba-7b": "64 -> 2 layers (0.74 B parameters; the whole model's five float32 AdamW copies are about "
                       "145 GB); B x S = 1 x 2048",
    "recurrentgemma-2b": "26 -> 3 layers, the first group (rglru, rglru, attn; 1.54 B parameters); B x S = 1 x 4096, "
                         "train_4k's sequence, twice the 2048-token local window",
    "whisper-small": "whole (12 encoder + 12 decoder layers, 1500 frames); B x S = 2 x 448, the decoder's text context",
}
# leaves of each family, in the reference's tree: the embedding and the family's own projections and gates
LEAVES = {
    "falcon-mamba-7b": ("embed", "layers/ssm/in_proj", "layers/ssm/x_proj", "layers/ssm/A_log", "layers/ssm/out_proj"),
    "recurrentgemma-2b": ("embed", "groups/g0_rglru/rglru/wa", "groups/g1_rglru/rglru/w_in",
                          "groups/g2_attn/attn/wq", "groups/g2_attn/mlp/wd"),
    "whisper-small": ("embed", "enc_layers/attn/wq", "dec_layers/attn/wq", "dec_layers/xattn/wq"),
}
# the reduced runs: recurrentgemma's at 2W + 8 tokens (past the window of 16), whisper's at its 24 frames
REDUCED_RUNS = {
    "falcon-mamba-7b": dict(seed=0, batch=2, seq=32, steps=3, optimizer="adamw"),
    "recurrentgemma-2b": dict(seed=0, batch=2, seq=40, steps=3, optimizer="adamw"),
    "whisper-small": dict(seed=0, batch=2, seq=16, steps=3, optimizer="adamw"),
}
LOSS_TOL = 1e-5  # absolute
GNORM_TOL = 1e-5  # relative
SUM_TOL = 1e-5  # of the leaf's |sum|


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_run(jcfg, run, leaves):
    """The reference launcher's training at ``jcfg``: ``init_lm(PRNGKey(seed))``,
    its pipeline's batches at ``seed`` (an encoder-decoder's frames drawn as
    ``src/repro/launch/train.py`` draws them), ``run["steps"]`` steps of its
    jitted ``build_train_step``.  Returns the record over ``leaves`` and the
    draws (``golden.batch_draws``)."""
    params = unzip_params(jlm.init_lm(jax.random.PRNGKey(run["seed"]), jcfg, jnp.float32))[0]
    step_fn, opt = jsteps.build_train_step(jcfg, SHD, run["optimizer"])
    step_fn = jax.jit(step_fn, donate_argnums=(0, 1))
    state = opt.init(params)
    init, nxt = jpipeline.make_pipeline(jcfg.vocab_size, run["batch"], run["seq"], seed=run["seed"])
    ds, losses, gnorms, batches = init(), [], [], []
    t0 = time.time()
    for step in range(run["steps"]):
        ds, b = nxt(ds)
        if jcfg.encoder_decoder:
            key = jax.random.fold_in(jax.random.PRNGKey(7), ds.step)
            b["frames"] = jax.random.normal(key, (run["batch"], jcfg.enc_seq_len, jcfg.d_model))
        batches.append(b)
        params, state, m = step_fn(params, state, jnp.int32(step), b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if __name__ == "__main__":
            print(f"reference step {step}: loss {losses[-1]} grad_norm {gnorms[-1]} ({time.time() - t0:.1f} s)",
                  flush=True)
    return train_record(losses, gnorms, params, state, leaves), batch_draws(batches)


def _reduced(arch, get):
    return dataclasses.replace(get(arch), remat="full")


def _reduced_reference(arch):
    """The reference's run at ``arch``'s reduced config, as a golden record."""
    rec, draws = reference_run(_reduced(arch, jreduced_config), REDUCED_RUNS[arch], LEAVES[arch])
    return {"arch": arch, **REDUCED_RUNS[arch], **rec, **draws}


@pytest.fixture(scope="module")
def references():
    """The three reduced reference runs, made once, side by side in threads
    (their time is mostly XLA's compiles)."""
    with ThreadPoolExecutor(len(FAMILIES)) as pool:
        return dict(zip(FAMILIES, pool.map(_reduced_reference, FAMILIES)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_run_matches_the_reference_at_the_reduced_config(references, arch):
    want = references[arch]
    got, draws = port_run(want, device="cpu", cfg=_reduced(arch, reduced_config))
    assert draw_mismatches(draws, want) == []
    assert ("frames_sha256" in draws) == (arch == "whisper-small")
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g - w) <= LOSS_TOL, (got["losses"], want["losses"])
    gaps = rel_gaps(got, want)
    assert gaps["grad_norm"] <= GNORM_TOL, gaps
    assert gaps["leaf_sums"] <= SUM_TOL, gaps
    assert sorted(got["leaf_sums"]) == sorted(f"{p}/{n}" for p in ("params", "m", "v") for n in LEAVES[arch])


def _saved_bytes_and_grads(seed=0, chunk=16):
    """The bytes of the distinct storages one ``_ssm_core`` call keeps for
    its backward, and the gradients of its readout's sum, at B 1, S 256,
    d_inner 64, N 16 over chunks of ``chunk`` channels.  A storage counts
    if a tensor that autograd packed still holds it once the forward has
    returned: tensors packed and freed during the forward are not kept,
    and their addresses may be handed out again, so each packed tensor is
    held by a weak reference and the storages are told apart only among
    the tensors still alive."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape).astype(np.float32), requires_grad=True)  # noqa: E731
    p = types.SimpleNamespace(dt_proj=t(8, 64), dt_bias=t(64), A_log=t(64, 16), Dp=t(64))
    x, dt_r, Bs, Cs = t(1, 256, 64), t(1, 256, 8), t(1, 256, 16), t(1, 256, 16)
    packed = []

    def pack(s):
        packed.append(weakref.ref(s))
        return s

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda s: s):
        y, _ = tssm._ssm_core(p, x, dt_r, Bs, Cs, chunk=chunk)
    kept = {}
    for s in (r() for r in packed):
        if s is not None:
            kept[s.untyped_storage().data_ptr()] = s.untyped_storage().nbytes()
    with torch.no_grad():
        y0, _ = tssm._ssm_core(p, x, dt_r, Bs, Cs, chunk=chunk)
    assert torch.equal(y.detach(), y0)
    inputs = [x, dt_r, Bs, Cs, p.dt_proj, p.dt_bias, p.A_log, p.Dp]
    return sum(kept.values()), torch.autograd.grad(y.sum(), inputs)


def test_ssm_core_keeps_no_scan_tree_for_the_backward(monkeypatch):
    """ROADMAP.md C.23: under autograd ``_ssm_core`` checkpoints each chunk
    of channels, so what one call keeps for the backward is less than one
    (B, S, d_inner, N) tensor (0.30 of one); without the checkpoints every
    chunk's tree of products stays, more than 6 such tensors (6.34) whatever
    the chunk.  Only the storages still held once the forward has returned
    count (C.24).  The readout is bitwise the run without autograd, and the
    gradients bitwise those of the same chunks kept whole."""
    whole = 256 * 64 * 16 * 4
    kept, grads = _saved_bytes_and_grads()
    assert kept < whole, kept / whole
    monkeypatch.setattr(tssm, "checkpoint", lambda fn, *args, **kw: fn(*args))
    kept_all, want = _saved_bytes_and_grads()
    assert kept_all > 6 * whole, kept_all / whole
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_reduced_hybrid_run_reaches_past_the_window():
    cfg = _reduced("recurrentgemma-2b", reduced_config)
    assert REDUCED_RUNS["recurrentgemma-2b"]["seq"] > 2 * cfg.local_window


@pytest.mark.parametrize("arch", FAMILIES)
def test_golden_file_states_its_run_and_matches_the_port_draws(arch):
    """The file's config, cut, optimizer and leaves; its tokens (and
    whisper's frames, by sha256) bitwise the port's launcher batches; its
    tolerances at least 10x its CPU gap and no tighter than 1e-6."""
    with open(GOLDEN_TRAIN_FAMILIES[arch]) as f:
        g = json.load(f)
    cfg = file_config(g)
    assert g["arch"] == arch and {k: g[k] for k in GOLDEN_RUNS[arch]} == GOLDEN_RUNS[arch]
    assert g["cut"] == CUTS[arch] and g["writer"].endswith(f"tests/test_torch_train_families.py {arch}")
    assert g["d_model"] == cfg.d_model and g["vocab_size"] == cfg.vocab_size and g["dtype"] == "float32"
    assert sorted({k.split("/", 1)[1] for k in g["leaf_sums"]}) == sorted(LEAVES[arch])
    if cfg.is_hybrid:
        assert g["seq"] > cfg.local_window and g["n_layers"] == len(cfg.block_pattern)
    if cfg.encoder_decoder:
        assert g["n_enc_layers"] == cfg.n_enc_layers == 12 and g["enc_seq_len"] == cfg.enc_seq_len == 1500
    init, nxt = train_batches(cfg, g["batch"], g["seq"], seed=g["seed"], device="cpu")
    ds, batches = init(), []
    for _ in range(g["steps"]):
        ds, b = nxt(ds)
        batches.append(b)
    assert draw_mismatches(batch_draws(batches), g) == []
    assert ("frames_sha256" in g) == cfg.encoder_decoder
    gap, tol = g["port_cpu_gap"], g["tolerance"]
    for key in ("loss", "grad_norm", "leaf_sums"):
        assert tol[key] >= 10 * gap[key] and tol[key] >= 1e-6, key


# ---------------------------------------------------------------------------
# The writer (full width, reference on the CPU)
# ---------------------------------------------------------------------------


def _peak_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _port_cpu_gap(arch):
    """The port on the CPU as the card runs it (``golden.port_run``), in a
    process of its own: its gaps to the file and the card's tolerances."""
    path = GOLDEN_TRAIN_FAMILIES[arch]
    with open(path) as f:
        g = json.load(f)
    t0 = time.time()
    rec, draws = port_run(g, device="cpu")
    bad = draw_mismatches(draws, g)
    if bad:
        raise AssertionError(f"{arch}: the port's draws differ from the reference's: {bad}")
    gap = rel_gaps(rec, g)
    g["port_cpu_gap"] = gap
    # the card is held to 10x the CPU's gap (the rule of the other golden files), and no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in gap.items()}
    g["port_cpu_losses"] = rec["losses"]
    with open(path, "w") as f:
        json.dump(g, f)
    print(f"{arch}: port on the CPU ({time.time() - t0:.1f} s, peak RSS {_peak_gb():.1f} GB): losses "
          f"{rec['losses']}, gaps {gap}; tolerances {g['tolerance']}", flush=True)


def write_golden(arch):
    r = GOLDEN_RUNS[arch]
    cfg_j = file_config(r | {"arch": arch}, jget_config)
    t0 = time.time()
    rec, draws = reference_run(cfg_j, r, LEAVES[arch])
    out = {
        "what": f"JAX reference on the CPU: {arch} at full width, depth cut as `cut` says, float32; "
                "init_lm(PRNGKey(seed)), the training launcher's batches (make_pipeline(vocab, batch, seq, "
                "seed=seed); an encoder-decoder's frames normal(fold_in(PRNGKey(7), step)) after the pipeline's "
                "step, kept as the sha256 of their float32 bytes), the jitted build_train_step(optimizer) under "
                "the config's remat for `steps` steps; losses and grad_norms per step, float64 sums of named "
                "leaves of the parameters, m and v after the last step",
        "writer": f"PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_families.py {arch}",
        "arch": arch, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size, "remat": cfg_j.remat,
        **({"n_enc_layers": cfg_j.n_enc_layers, "enc_seq_len": cfg_j.enc_seq_len} if cfg_j.encoder_decoder else {}),
        "cut": CUTS[arch], **r, "dtype": "float32", "reference_s": round(time.time() - t0, 1), **draws, **rec,
    }
    with open(GOLDEN_TRAIN_FAMILIES[arch], "w") as f:
        json.dump(out, f)
    print(f"{arch}: wrote {GOLDEN_TRAIN_FAMILIES[arch]} ({time.time() - t0:.1f} s, peak RSS {_peak_gb():.1f} GB); "
          "measuring the port's CPU gap in a new process", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap", arch], env=env, check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--port-gap"]:
        _port_cpu_gap(sys.argv[2])
    else:
        for a in sys.argv[1:] or FAMILIES:
            write_golden(a)
