"""The port's last three dense configs (nemotron-4-15b: squared ReLU,
bias-free layernorm, half the head rotated; qwen2.5-32b: QKV biases under
GQA, theta 1e6; command-r-35b: parallel block, bias-free layernorm, tied
head, theta 8e6) against the JAX reference, on the CPU.

Each case runs over the three archs:

* the config and its sharding overrides equal the reference's
  (``dataclasses.asdict``, ``param_count``, ``reduced_config``);
* ``init_lm`` leaf by leaf within 2 ulp of the reference's, and
  ``convert`` both ways;
* ``lm_apply``, ``lm_prefill`` (its cache) and 4 chained
  ``lm_decode_step``s on both kernel planes, and ``serve`` against the
  reference launcher's loop, at ``reduced_config`` (4 layers, d_model 128,
  4 heads of 32, d_ff 256, vocab 512), and once more at 2 kv heads (GQA,
  which the reduced config's 4 kv heads of 4 do not reach);
* the golden files' own draws.

Every reference call is jitted, as the reference's launchers call it (its
rotary table differs between eager and ``jit``, ROADMAP.md C.20).  The
reference runs once an arch (``_reference``) and the cases share it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dense_configs.py [ARCH ...]

rewrites ``src/repro_torch/data/golden_serve_{nemotron,qwen2_5,command_r}.json``
(all three, or the archs named): the reference at full width with its
first 2 layers (seed 0, one 2048-token request, 8 greedy steps) and, from a
second process, the port's CPU gap to it on the reference's weights, which
sets the card's tolerance at 10x (``chip_smoke.py``).
"""
import dataclasses
import functools
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

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.models import decode as jdecode
from repro.models import lm as jlm
from repro.sharding import AxisRules, unzip_params
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models import lm as tlm
from repro_torch.models.decode import lm_decode_step, lm_prefill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "src", "repro_torch", "data")
ARCHS = ("nemotron-4-15b", "command-r-35b", "qwen2.5-32b")  # the reference's order
GOLDEN = {"nemotron-4-15b": "golden_serve_nemotron.json", "command-r-35b": "golden_serve_command_r.json",
          "qwen2.5-32b": "golden_serve_qwen2_5.json"}
# the reduced configs, and each again at 2 kv heads of 4 (GQA)
CASES = {**{a: (a, {}) for a in ARCHS}, **{f"{a}@gqa": (a, {"n_kv_heads": 2}) for a in ARCHS}}
SHD = AxisRules(None)
PLANES = (ops.TORCH, ops.KERNEL)
LOGIT_TOL = 1e-5  # absolute, float32 logits of std 0.2-0.9 (measured at most 3.8e-6)
CACHE_TOL = 1e-5  # absolute, the k/v cache (measured at most 3.3e-6)
B, S, STEPS = 2, 24, 4  # requests, prompt tokens, decode steps after them
# the golden run: full width, the first 2 layers, one 2048-token request, 8 greedy steps
GOLDEN_LAYERS = 2
GOLDEN_RUN = dict(seed=0, batch=1, prompt_len=2048, gen_len=8)


def golden_leaves(cfg):
    """Leaves the card's init is checked on, in the port's names: (name,
    layer, corner); qwen2.5's biases are zeros."""
    out = [("embed", None, "head"), ("embed", None, "tail") if cfg.tie_embeddings else ("lm_head", None, "tail"),
           ("layers/attn/wq", 0, "head"), ("layers/attn/wk", 1, "tail"), ("layers/attn/wv", 0, "tail"),
           ("layers/attn/wo", 1, "head"), ("layers/mlp/wu", 0, "head"), ("layers/mlp/wd", 1, "tail")]
    if cfg.mlp_act == "swiglu":
        out.append(("layers/mlp/wg", 1, "head"))
    return tuple(out)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _ulp(a, b):
    """Elementwise distance in float32 ulp (same-sign values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _jax_params(cfg, seed=0):
    return unzip_params(jlm.init_lm(jax.random.PRNGKey(seed), cfg, jnp.float32))[0]


def _configs(case):
    arch, kw = CASES[case]
    return dataclasses.replace(reduced_config(arch), **kw), dataclasses.replace(jreduced_config(arch), **kw)


def _reference_serve(jcfg, jparams, Bn, P, G):
    """The reference launcher's loop at seed 0 (``repro/launch/serve.py``):
    prompts, tokens (B, G), logits (G, B, V)."""
    prompts = jax.random.randint(jax.random.PRNGKey(1), (Bn, P), 0, jcfg.vocab_size)
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, jcfg, SHD, b, pad_to=P + G))(
        jparams, {"tokens": prompts})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, jcfg, SHD, c, b))
    tok = jnp.argmax(logits, -1)
    toks, steps = [tok], [logits]
    for _ in range(G - 1):
        logits, cache = step(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, -1)
        toks.append(tok)
        steps.append(logits)
    return np.asarray(prompts), np.stack([np.asarray(t) for t in toks], 1), np.stack([np.asarray(s) for s in steps])


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The jitted reference at a case's config, once: its parameters, the
    forward over S + STEPS tokens, the prefill of the first S (logits,
    cache), STEPS teacher-forced decode steps, and the serve loop of 3
    requests of 20 tokens, 6 tokens each."""
    cfg, jcfg = _configs(case)
    jparams = _jax_params(jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    run = {"jparams": jparams, "tokens": toks}
    run["apply"] = np.asarray(jax.jit(lambda p, t: jlm.lm_apply(p, jcfg, SHD, {"tokens": t}))(jparams, toks))
    lg, cache = jax.jit(lambda p, t: jdecode.lm_prefill(p, jcfg, SHD, {"tokens": t}, pad_to=S + STEPS))(
        jparams, toks[:, :S])
    run["prefill"], run["cache"] = np.asarray(lg), {k: np.asarray(v) for k, v in cache["layers"].items()}
    step = jax.jit(lambda p, c, t: jdecode.lm_decode_step(p, jcfg, SHD, c, {"token": t}))
    run["decode"] = []
    for i in range(STEPS):
        lg, cache = step(jparams, cache, toks[:, S + i])
        run["decode"].append(np.asarray(lg))
    run["decode_cache"] = {k: np.asarray(v) for k, v in cache["layers"].items()}
    run["serve"] = _reference_serve(jcfg, jparams, 3, 20, 6)
    return run


@functools.lru_cache(maxsize=None)
def _model(case):
    """The port's LM holding the reference's weights at a case's config."""
    return convert.lm_params_from_numpy(_reference(case)["jparams"], _configs(case)[0], device="cpu")


# ---------------------------------------------------------------------------
# Configs and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference(arch):
    cfg, over = get_config(arch)
    jcfg, jover = jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and over == jover == {"fsdp": ("data",)}
    assert dataclasses.asdict(reduced_config(arch)) == dataclasses.asdict(jreduced_config(arch))
    assert cfg.param_count() == jcfg.param_count() and cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.family == "dense" and cfg.head_dim == 128
    # the depths the card serves them at (chip_smoke.DENSE_LAYERS) and their parameters, reckoned
    n = {"nemotron-4-15b": (16, 9_387_048_960), "qwen2.5-32b": (8, 5_457_977_344),
         "command-r-35b": (6, 6_325_108_736)}[arch]
    assert dataclasses.replace(cfg, n_layers=n[0]).param_count() == n[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_leaf_by_leaf(arch):
    cfg = reduced_config(arch)
    want = dict(_leaves(_reference(arch)["jparams"]))
    got = dict(_leaves(convert.lm_params_to_numpy(tlm.init_lm(prng.prng_key(0), cfg, device="cpu"))))
    assert sorted(got) == sorted(want)
    assert ("lm_head" in got) == (not cfg.tie_embeddings) and ("layers/attn/bq" in got) == cfg.qkv_bias
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        assert _ulp(got[name], w).max() <= 2, name  # measured: bitwise equal


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_both_ways(arch):
    """The reference's tree into the port and back, bitwise; the port's own
    init out and in again, bitwise."""
    model = _model(arch)
    back = dict(_leaves(convert.lm_params_to_numpy(model)))
    for name, w in _leaves(_reference(arch)["jparams"]):
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    cfg = reduced_config(arch)
    mine = tlm.init_lm(prng.prng_key(3), cfg, device="cpu")
    again = convert.lm_params_from_numpy(convert.lm_params_to_numpy(mine), cfg, device="cpu")
    want = mine.state_dict()
    assert sorted(again.state_dict()) == sorted(want)
    for name, t in again.state_dict().items():
        assert torch.equal(t, want[name]), name


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_prefill_and_decode_match_reference(case, plane):
    cfg = _configs(case)[0]
    run, model = _reference(case), _model(case)
    toks = torch.tensor(run["tokens"])
    got = tlm.lm_apply(model, cfg, {"tokens": toks}, plane=plane).numpy()
    assert got.shape == (B, S + STEPS, cfg.vocab_size)
    np.testing.assert_allclose(got, run["apply"], atol=LOGIT_TOL, rtol=0)
    tl, tc = lm_prefill(model, cfg, {"tokens": toks[:, :S]}, pad_to=S + STEPS, plane=plane)
    np.testing.assert_allclose(tl.numpy(), run["prefill"], atol=LOGIT_TOL, rtol=0)
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == (cfg.n_layers, B, S + STEPS, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(tc["layers"][name].numpy(), run["cache"][name], atol=CACHE_TOL, rtol=0)
    for i in range(STEPS):  # teacher-forced, so both sides see the same tokens
        tl, tc = lm_decode_step(model, cfg, tc, {"token": toks[:, S + i]})
        np.testing.assert_allclose(tl.numpy(), run["decode"][i], atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(tl.numpy(), run["apply"][:, S + i], atol=LOGIT_TOL, rtol=0, err_msg=f"step {i}")
    assert tc["len"] == S + STEPS
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][name].numpy(), run["decode_cache"][name], atol=CACHE_TOL, rtol=0)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_loop(arch, plane):
    cfg = reduced_config(arch)
    prompts, toks, logits = _reference(arch)["serve"]
    res = serve(cfg, batch=3, prompt_len=20, gen_len=6, page_size=8, seed=0, device="cpu", plane=plane,
                params=_model(arch))
    assert res.plane == plane
    np.testing.assert_array_equal(res.prompts.numpy(), prompts)
    np.testing.assert_array_equal(res.tokens.numpy(), toks)
    np.testing.assert_allclose(res.logits.numpy(), logits, atol=LOGIT_TOL, rtol=0)
    assert res.pages_used == 3 * (26 // 8 + 1) and res.pages_used_after_release == 0


# ---------------------------------------------------------------------------
# The golden files (full width, the reference on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_file_matches_the_port_draws(arch):
    """A golden file's prompt is the port's ``randint(PRNGKey(1))``, its
    leaves are ``golden_leaves``', its steps are self-consistent, and its
    tolerance is 10x the port's CPU gap."""
    with open(os.path.join(DATA, GOLDEN[arch])) as f:
        g = json.load(f)
    cfg, _ = get_config(arch)
    assert g["arch"] == arch and (g["n_layers"], g["d_model"], g["vocab_size"]) == (
        GOLDEN_LAYERS, cfg.d_model, cfg.vocab_size)
    assert {k: g[k] for k in GOLDEN_RUN} == GOLDEN_RUN
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (g["batch"], g["prompt_len"]), 0, cfg.vocab_size)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    assert len(g["steps"]) == g["gen_len"] == len(g["tokens"][0])
    for s, step in enumerate(g["steps"]):
        for b in range(g["batch"]):
            assert step["top_ids"][b][0] == g["tokens"][b][s]
            assert step["lse"][b] >= step["max"][b] == step["top_logits"][b][0]
            assert step["top_logits"][b] == sorted(step["top_logits"][b], reverse=True)
    assert [(n, layer, c) for n, layer, c in golden_leaves(cfg)] == [
        (k.split("@")[0], v["layer"], v["corner"]) for k, v in g["leaves"].items()]
    assert len(g["port_cpu_logit_gap_per_step"]) == g["gen_len"]
    assert g["port_cpu_gap"]["logits"] == max(g["port_cpu_logit_gap_per_step"])
    assert g["tolerance"]["logits"] == max(10 * g["port_cpu_gap"]["logits"], 1e-6)


def _step_record(logits):
    lf = np.asarray(logits, np.float32)
    top = np.argsort(-lf, axis=-1, kind="stable")[:, :8]
    m = lf.max(-1)
    lse = m + np.log(np.exp(lf - m[:, None]).sum(-1, dtype=np.float64))
    return {"top_ids": top.tolist(), "top_logits": np.take_along_axis(lf, top, -1).astype(float).tolist(),
            "max": m.astype(float).tolist(), "lse": lse.astype(float).tolist()}


def _abs_sum(a):
    """float64 sum of |a| over a large array, a slab at a time."""
    flat = np.asarray(a).reshape(-1)
    return float(sum(np.abs(flat[i:i + (1 << 24)]).sum(dtype=np.float64) for i in range(0, flat.size, 1 << 24)))


def _golden_cfg(get, arch):
    return dataclasses.replace(get(arch)[0], n_layers=GOLDEN_LAYERS)


def write_golden(arch):
    """The reference at full width, its first 2 layers: prefill and greedy
    decode of the golden request; then the port's CPU gap in a second
    process."""
    cfg_j = _golden_cfg(jget_config, arch)
    r = GOLDEN_RUN
    P, G = r["prompt_len"], r["gen_len"]
    t0 = time.time()
    params = _jax_params(cfg_j, r["seed"])
    print(f"{arch}: reference init: {time.time() - t0:.1f} s", flush=True)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(r["seed"] + 1), (r["batch"], P), 0,
                                            cfg_j.vocab_size))
    t0 = time.time()
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, cfg_j, SHD, b, pad_to=P + G))(
        params, {"tokens": prompts})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, cfg_j, SHD, c, b))
    steps, toks = [np.asarray(logits)], [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(G - 1):
        logits, cache = step(params, cache, {"token": jnp.asarray(toks[-1])})
        steps.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    assert int(cache["len"]) == P + G - 1
    del cache
    print(f"{arch}: reference prefill + {G - 1} steps: {time.time() - t0:.1f} s", flush=True)
    leaves = {}
    for name, layer, corner in golden_leaves(cfg_j):
        a = params
        for part in name.split("/"):
            a = a[part]
        a = np.asarray(a if layer is None else a[layer])
        rows = a.reshape(-1, a.shape[-1])
        sample = rows[:2, :8] if corner == "head" else rows[-2:, -8:]
        leaves[f"{name}@{layer}@{corner}"] = {"layer": layer, "corner": corner, "sample": sample.astype(float).tolist(),
                                              "abs_sum": _abs_sum(a)}
        del a, rows
    del params
    full = get_config(arch)[0]
    head = full.d_model * full.vocab_size * (1 if full.tie_embeddings else 2)
    per_layer = (full.param_count() - head) / full.n_layers
    out = {
        "what": f"JAX reference, {arch} at full width with the depth cut to n_layers, float32, on the CPU, jitted: "
                "init_lm(PRNGKey(seed)); prompts randint(PRNGKey(seed + 1), (batch, prompt_len), 0, vocab); "
                "lm_prefill(pad_to=prompt_len + gen_len), then greedy lm_decode_step; step 0 is the prefill's "
                "last-token logits; leaves are named as the port names them (name@layer@corner)",
        "writer": f"PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dense_configs.py {arch}",
        "arch": arch, "n_layers": GOLDEN_LAYERS, "d_model": cfg_j.d_model, "vocab_size": cfg_j.vocab_size,
        "depth_cut": f"{full.n_layers} -> {GOLDEN_LAYERS} layers: the reference builds the whole parameter tree on "
                     f"the CPU, {per_layer / 1e9:.3f} B float32 parameters a layer beside {head / 1e9:.3f} B of "
                     f"embedding and head ({cfg_j.param_count() * 4 / 1e9:.1f} GB at {GOLDEN_LAYERS} layers)",
        **r, "dtype": "float32",
        "prompts": prompts.tolist(),
        "tokens": np.stack(toks, 1).tolist(),
        "steps": [_step_record(s) for s in steps],
        "top1_top2_margin_min": [float(np.min(np.diff(np.sort(s, -1)[:, -2:], axis=-1))) for s in steps],
        "leaves": leaves,
    }
    path = os.path.join(DATA, GOLDEN[arch])
    with open(path, "w") as f:
        json.dump(out, f)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "steps.npy"), np.stack(steps))
        print(f"wrote {path}; measuring the port's CPU gap in a new process", flush=True)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap", arch, d], env=env, check=True)


def _reference_weights_in_the_port(cfg_j, cfg, seed):
    """The reference's weights (its ``init_lm``) as the port's LM through
    ``convert``, one leaf at a time, each reference leaf freed once copied."""
    tree = _jax_params(cfg_j, seed)
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


def _port_cpu_gap(arch, d):
    """The port on the CPU (torch plane) with the reference's weights and
    the golden request: its gap to the reference's logits (each step
    teacher-forced with the reference's tokens), into the golden file."""
    path = os.path.join(DATA, GOLDEN[arch])
    with open(path) as f:
        g = json.load(f)
    t0 = time.time()
    model = _reference_weights_in_the_port(_golden_cfg(jget_config, arch), _golden_cfg(get_config, arch), g["seed"])
    cfg = model.cfg
    print(f"{arch}: reference weights in the port: {time.time() - t0:.1f} s", flush=True)
    ref_steps = np.load(os.path.join(d, "steps.npy"))
    P, G = g["prompt_len"], g["gen_len"]
    t0 = time.time()
    with torch.inference_mode():
        tl, tc = lm_prefill(model, cfg, {"tokens": torch.tensor(g["prompts"], dtype=torch.int32)}, pad_to=P + G,
                            plane=ops.TORCH)
        gaps = [float(np.abs(tl.numpy() - ref_steps[0]).max())]
        for s in range(1, G):
            tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(g["tokens"], dtype=torch.int32)[:, s - 1]})
            gaps.append(float(np.abs(tl.numpy() - ref_steps[s]).max()))
    print(f"{arch}: port (CPU, torch plane): {time.time() - t0:.1f} s; logit gaps {gaps}", flush=True)
    g["port_cpu_gap"] = {"logits": max(gaps)}
    g["port_cpu_logit_gap_per_step"] = gaps
    g["port_cpu_gap_note"] = ("max |port - reference| over every logit of each step (the port on the CPU, torch "
                              "plane, with the reference's weights through convert, teacher-forced with the "
                              "reference's tokens)")
    # the card is held to 10x the CPU's gap (the rule of the other golden files), no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in g["port_cpu_gap"].items()}
    with open(path, "w") as f:
        json.dump(g, f)
    print(f"{arch}: port on the CPU: gap {g['port_cpu_gap']}; tolerance {g['tolerance']}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--port-gap"]:
        sys.exit(_port_cpu_gap(sys.argv[2], sys.argv[3]))
    for a in sys.argv[1:] or ARCHS:
        write_golden(a)
