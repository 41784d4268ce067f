"""qwen2-vl-72b's training path against the JAX reference, on the CPU:
M-RoPE's backward under image layouts (three position ids that differ) and
gradient accumulation over microbatches; and its golden gradient file.

* Two AdamW steps of a microbatched (2, 2, S) batch with (2, 2, 3, S)
  positions, an image grid in some rows of each microbatch, through the
  port's ``build_train_step`` against the reference's jitted
  ``train_step`` at ``reduced_config("qwen2-vl-72b")`` (4 layers, d_model
  128, sections (4, 6, 6)).  Tolerances are ``tests/test_torch_train.py``'s:
  losses within 1e-5 absolute, ``grad_norm`` within 1e-6 relative,
  parameters within 1e-6 absolute, m and v within 1e-5 of each leaf's
  largest |value|.  The reference runs once for every case.
* The golden file states its run, cut, leaves, writer and dtype, its
  tokens and positions are bitwise the port's construction of them
  (``golden.vlm_batch``), and its tolerances are at least 10x its CPU gap
  and no tighter than 1e-6.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_vlm_train.py

rewrites ``src/repro_torch/data/golden_train_qwen2_vl.json``: one jitted
``jax.value_and_grad`` of the reference's ``lm_loss`` at full width with 1
of 80 layers (seed 0) on ``golden.VLM_RUN``'s request (2048 tokens: 64 of
text, a 1 x 32 x 32 image grid of the reserved last id, 960 of text) with
its (1, 3, 2048) positions passed explicitly (the reference's own default
positions break under M-RoPE, ROADMAP.md C.15); the loss, the global
gradient norm and the float64 sum and |sum| of every gradient leaf.  Then,
in a process of its own, the port on the CPU with the reference's weights
(``golden.grad_record``), whose gap sets the card's tolerances at
``max(10 x gap, 1e-6)``.  Gradients only, no optimizer state: the
reference's parameters and gradients are 27 GB.
"""
import dataclasses
import json
import os
import resource
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.core import prng
from repro_torch.launch.serve import vlm_layout
from repro_torch.models import lm as tlm
from repro_torch.train import golden as tgolden
from repro_torch.train.steps import build_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-vl-72b"
SHD = AxisRules(None)
VAL_TOL = 1e-5  # losses, absolute (tests/test_torch_train.py)
GNORM_RTOL = 1e-6  # grad_norm, relative (tests/test_torch_train.py, float32 accumulation)
PARAM_TOL = 1e-6  # parameters, absolute (tests/test_torch_train.py)
STATE_TOL = 1e-5  # m and v, of each leaf's largest |value| (tests/test_torch_train.py)
N_MICRO, B, S, STEPS = 2, 2, 32, 2
# the image of each microbatch's row 0: (offset, (t, h, w)); its row 1 is text only
IMAGES = ((4, (2, 2, 3)), (10, (1, 4, 4)))
CUT = ("80 -> 1 layer: 0.878 B float32 parameters a layer beside 2.49 B of embedding and head (3.37 B, 13.5 GB); "
       "the reference's value_and_grad holds them and their gradients, 27 GB, on the 62 GB CPU that writes this file")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _batches(cfg, seed):
    """STEPS microbatched batches: tokens (N_MICRO, B, S) with each
    microbatch's row 0 holding its image grid of the reserved last id, and
    positions (N_MICRO, B, 3, S) from ``vlm_layout``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size - 1, (N_MICRO, B, S)).astype(np.int32)
        pos = np.zeros((N_MICRO, B, 3, S), np.int32)
        for i, image in enumerate(IMAGES):
            ids, mask, _ = vlm_layout(S, image)
            toks[i, 0, mask.numpy()] = cfg.vocab_size - 1
            pos[i, 0] = ids.numpy()
            pos[i, 1] = vlm_layout(S)[0].numpy()
            assert (pos[i, 0, 0] != pos[i, 0, 1]).any()  # the three ids differ inside the image
        out.append({"tokens": toks, "labels": toks, "positions": pos})
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference's jitted ``train_step`` and the port's
    ``build_train_step`` over the same STEPS batches from the same weights:
    per step (metrics, parameters, optimizer state) of each."""
    cfg, jcfg = reduced_config(ARCH), jreduced_config(ARCH)
    assert cfg.mrope_sections == jcfg.mrope_sections == (4, 6, 6)
    jp = jax.jit(lambda k: unzip_params(jlm.init_lm(k, jcfg, jnp.float32))[0])(jax.random.PRNGKey(0))
    jstep, jopt = jsteps.build_train_step(jcfg, SHD, "adamw")
    jstep = jax.jit(jstep)
    js = jopt.init(jp)
    model = convert.lm_params_from_numpy(jp, cfg, device="cpu")
    tstep, topt = build_train_step(cfg, "adamw")
    ts = topt.init(dict(model.named_parameters()))
    want, got = [], []
    for step, b in enumerate(_batches(cfg, 3)):
        jp, js, jm = jstep(jp, js, jnp.int32(step), b)
        want.append(({k: float(jm[k]) for k in ("loss", "grad_norm")}, dict(_leaves(jp)), dict(_leaves(js))))
        model, ts, tm = tstep(model, ts, step, {k: torch.tensor(v) for k, v in b.items()})
        assert tm["step"] == step + 1
        got.append(({k: float(tm[k]) for k in ("loss", "grad_norm")},
                    {k: v.copy() for k, v in _leaves(convert.lm_params_to_numpy(model))},
                    {k: _np32(v).copy() for k, v in _leaves(convert.opt_state_to_tree(ts))}))
    return got, want


@pytest.mark.parametrize("step", range(STEPS))
def test_accumulated_loss_and_grad_norm_match_the_reference(runs, step):
    (gm, _, _), (wm, _, _) = runs[0][step], runs[1][step]
    assert abs(gm["loss"] - wm["loss"]) <= VAL_TOL, (gm, wm)
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"], rtol=GNORM_RTOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_accumulated_parameters_match_the_reference(runs, step):
    (_, gp, _), (_, wp, _) = runs[0][step], runs[1][step]
    assert sorted(gp) == sorted(wp)
    for name, w in wp.items():
        np.testing.assert_allclose(gp[name], np.asarray(w), atol=PARAM_TOL, rtol=0, err_msg=f"step {step} {name}")


@pytest.mark.parametrize("step", range(STEPS))
def test_accumulated_adamw_state_matches_the_reference(runs, step):
    (_, _, gs), (_, _, ws) = runs[0][step], runs[1][step]
    assert sorted(gs) == sorted(ws)
    for name, w in ws.items():
        w = np.asarray(w, np.float32)
        gap = float(np.abs(gs[name] - w).max())
        assert gap <= STATE_TOL * max(float(np.abs(w).max()), 1e-30), (step, name, gap)


# ---------------------------------------------------------------------------
# The golden file (full width, reference on the CPU)
# ---------------------------------------------------------------------------


def test_golden_file_states_its_run_and_matches_the_port_batch():
    """The file's config, cut, writer, dtype and leaves (every leaf of the
    reference's tree); its tokens and positions bitwise ``vlm_batch``'s;
    its tolerances at least 10x its CPU gap and no tighter than 1e-6."""
    with open(tgolden.GOLDEN_TRAIN_VLM) as f:
        g = json.load(f)
    cfg = tgolden.file_config(g)
    run = dict(tgolden.VLM_RUN, image=[tgolden.VLM_RUN["image"][0], list(tgolden.VLM_RUN["image"][1])])
    assert g["arch"] == ARCH and {k: g[k] for k in run} == run
    assert g["cut"] == CUT and g["writer"] == "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_vlm_train.py"
    assert (g["d_model"], g["vocab_size"], g["remat"]) == (cfg.d_model, cfg.vocab_size, cfg.remat)
    assert g["dtype"] == "float32"
    assert cfg.n_layers == 1 and cfg.d_model == 8192 and cfg.vocab_size == 152064
    small = tlm.init_lm(prng.prng_key(0), dataclasses.replace(reduced_config(ARCH), n_layers=1), torch.float32,
                        device="cpu")
    assert sorted(g["leaf_sums"]) == sorted({"/".join(p for p in n.split(".") if not p.isdigit())
                                             for n, _ in small.named_parameters()})
    batch = tgolden.vlm_batch(g, "cpu")
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.array(g["tokens"]))
    np.testing.assert_array_equal(batch["positions"].numpy(), np.array(g["positions"]))
    assert int((batch["tokens"] == cfg.vocab_size - 1).sum()) >= 32 * 32
    gap, tol = g["port_cpu_gap"], g["tolerance"]
    for key in ("loss", "grad_norm", "leaf_sums"):
        assert tol[key] >= 10 * gap[key] and tol[key] >= 1e-6, key


def _peak_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def write_golden():
    """The reference at full width, ``VLM_RUN``'s layers: one jitted
    ``value_and_grad`` of ``lm_loss`` whose gradients never leave the
    program (their sums over the last axis do); then the port's CPU gap in
    another process."""
    r = tgolden.VLM_RUN
    cfg_j = tgolden.file_config({"arch": ARCH, **r}, jget_config)
    batch = {k: v.numpy() for k, v in tgolden.vlm_batch(dict(r, arch=ARCH), "cpu").items()}

    def loss_and_grad_sums(p, b):
        # the loss, the global gradient norm (the reference's clip_by_global_norm's, over its leaves in order), and
        # float32 sums of each gradient leaf (and of |g|) over its last axis, which the host sums in float64
        loss, g = jax.value_and_grad(lambda q: jlm.lm_loss(q, cfg_j, SHD, b))(p)
        gn = jnp.sqrt(sum(jnp.sum(jnp.square(v.astype(jnp.float32))) for v in jax.tree.leaves(g)))
        return loss, gn, {k: (v.sum(-1), jnp.abs(v).sum(-1)) for k, v in _leaves(g)}

    t0 = time.time()
    params = unzip_params(jlm.init_lm(jax.random.PRNGKey(r["seed"]), cfg_j, jnp.float32))[0]
    init_s = time.time() - t0
    print(f"reference init: {init_s:.1f} s", flush=True)
    t0 = time.time()
    loss, gn, sums = jax.jit(loss_and_grad_sums)(params, batch)
    loss = float(loss)
    grad_s = time.time() - t0
    del params
    leaf_sums = {k: {"sum": float(np.asarray(s, np.float64).sum()), "abs_sum": float(np.asarray(a, np.float64).sum())}
                 for k, (s, a) in sums.items()}
    out = {
        "what": "JAX reference on the CPU: qwen2-vl-72b at full width with the depth cut to n_layers, float32, "
                "init_lm(PRNGKey(seed)); tokens = labels = randint(PRNGKey(seed + 1), (batch, seq), 0, vocab) with "
                "the image grid's tokens set to the last vocabulary id, positions (batch, 3, seq) at Qwen2-VL's "
                "M-RoPE ids (text, then the grid at (s + frame, s + row, s + col), then text from the largest id "
                "+ 1), passed explicitly; one jitted value_and_grad of lm_loss under the config's remat: the loss, "
                "the global gradient norm and the float64 sum and |sum| of every gradient leaf (of float32 sums "
                "over its last axis)",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_vlm_train.py",
        "arch": ARCH, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size, "remat": cfg_j.remat, "cut": CUT,
        **r, "dtype": "float32", "tokens": batch["tokens"].tolist(), "positions": batch["positions"].tolist(),
        "loss": loss, "grad_norm": float(gn), "leaf_sums": leaf_sums,
        "reference_s": {"init": round(init_s, 1), "value_and_grad": round(grad_s, 1)},
        "reference_peak_rss_gb": round(_peak_gb(), 1),
    }
    with open(tgolden.GOLDEN_TRAIN_VLM, "w") as f:
        json.dump(out, f)
    print(f"wrote {tgolden.GOLDEN_TRAIN_VLM} (loss {loss}, grad_norm {float(gn)}; value_and_grad {grad_s:.1f} s, "
          f"peak RSS {_peak_gb():.1f} GB); measuring the port's CPU gap in a new process", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap"], env=env, check=True)


def _reference_weights_in_the_port(cfg_j, cfg, seed):
    """The reference's weights (its ``init_lm``) as the port's LM through
    ``convert``, one leaf at a time, each reference leaf freed once copied."""
    tree = unzip_params(jlm.init_lm(jax.random.PRNGKey(seed), cfg_j, jnp.float32))[0]
    state = {}
    for path in [p for p, _ in _leaves(tree)]:
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node[p]
        sub = {parts[-1]: node.pop(parts[-1])}
        for p in reversed(parts[:-1]):
            sub = {p: sub}
        state.update(convert.unstack_tree(sub, cfg.n_layers, "cpu"))
        del sub
    return tlm.lm_from_state(cfg, state)


def _port_cpu_gap():
    """The port on the CPU with the reference's weights and the file's
    batch (``grad_record``): its gaps to the reference's loss, gradient norm
    and leaf sums, which set the card's tolerances at 10x."""
    with open(tgolden.GOLDEN_TRAIN_VLM) as f:
        g = json.load(f)
    cfg = tgolden.file_config(g)
    t0 = time.time()
    model = _reference_weights_in_the_port(tgolden.file_config(g, jget_config), cfg, g["seed"])
    print(f"reference weights in the port: {time.time() - t0:.1f} s", flush=True)
    batch = tgolden.vlm_batch(g, "cpu")
    assert batch["tokens"].tolist() == g["tokens"] and batch["positions"].tolist() == g["positions"]
    t0 = time.time()
    rec, _ = tgolden.grad_record(model, cfg, batch)
    port_s = time.time() - t0
    gaps = tgolden.grad_gaps(rec, g, cfg)
    g["port_cpu_gap"] = gaps
    g["port_cpu_record"] = {"loss": rec["loss"], "grad_norm": rec["grad_norm"]}
    g["port_cpu_s"] = round(port_s, 1)
    g["port_cpu_peak_rss_gb"] = round(_peak_gb(), 1)
    g["port_cpu_gap_note"] = ("the port on the CPU (torch plane) with the reference's weights through convert: "
                              "relative gaps of the loss and the gradient norm, and of each leaf's sum and |sum| "
                              "against its |sum|")
    # the card is held to 10x the CPU's gaps (the rule of the other golden files), no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in gaps.items()}
    with open(tgolden.GOLDEN_TRAIN_VLM, "w") as f:
        json.dump(g, f)
    print(f"port on the CPU ({port_s:.1f} s, peak RSS {_peak_gb():.1f} GB): loss {rec['loss']} grad_norm "
          f"{rec['grad_norm']}; gaps {gaps}; tolerances {g['tolerance']}", flush=True)


if __name__ == "__main__":
    sys.exit(_port_cpu_gap() if sys.argv[1:2] == ["--port-gap"] else write_golden())
