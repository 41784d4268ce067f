"""The port's two mesh branches, the sequence-sharded decode attention and
the expert-parallel MoE, against the JAX reference's ``shard_map`` runs,
on the CPU.

The reference runs in one subprocess with 4 forced host devices (the main
test process must keep seeing one device, ``tests/conftest.py``): at
``reduced_config``, its jitted ``lm_prefill`` and 8 greedy
``lm_decode_step``s on ``make_host_mesh(1, 4)`` for llama4-scout
(expert-parallel, top-1), kimi-k2 (top-2: two shards add to a token),
stablelm-1.6b (the cache write), recurrentgemma-2b (the window's ring,
wrapping across shard boundaries) and whisper-small (the cross-attention,
which writes nothing); llama4-scout on ``make_host_mesh(2, 2)`` at
capacity factor 1.0, where each data shard routes its own tokens at its
own capacity (the reduced config's 8.0 drops nothing and would hide it);
and stablelm with P + G = 31, which 4 does not divide (``kv_seq`` drops
the axis: the unsharded branch).  The same inputs, made with numpy from a
seed, and the same weights (the reference's ``init_lm``, carried across by
``convert``) go through the port on ``devices=("cpu",) * n``.

Tolerances: logits and caches within 1e-5 absolute of the reference's
sharded run (2e-5 for the hybrid, its CPU tolerance in PERF.md §2), every
token equal, MoE loads and drops equal per layer.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.layers import moe as jmoe
from repro.models import lm as jlm
from repro.sharding import unzip_params
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import attention as tattn
from repro_torch.layers import moe as tmoe
from repro_torch.sharding import AxisRules
from repro_torch.train.steps import build_decode_step, build_prefill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA4, KIMI, STABLELM, HYBRID, WHISPER = (
    "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "stablelm-1.6b", "recurrentgemma-2b", "whisper-small")
G = 8  # greedy decode steps after the prefill
# name: (arch, (data, model), config replacements, batch, prompt length); the cache holds P + G slots
CASES = {
    "llama4": (LLAMA4, (1, 4), {}, 2, 24),
    "kimi": (KIMI, (1, 4), {}, 2, 24),
    "stablelm": (STABLELM, (1, 4), {}, 2, 24),
    "hybrid": (HYBRID, (1, 4), {}, 2, 32),  # W = 16: a ring of 4 slots a shard, 32 + 8 tokens wrap it
    "whisper": (WHISPER, (1, 4), {}, 2, 24),  # 24 frames: 6 a shard, read without a write
    "llama4_2x2": (LLAMA4, (2, 2), {"capacity_factor": 1.0}, 4, 24),
    "stablelm_fallback": (STABLELM, (1, 4), {}, 2, 23),  # S = 31: kv_seq drops the model axis
}
TOL = {"hybrid": 2e-5}
ATTN_CASE = dict(B=2, S=32, H=4, Dh=8, n=4)  # decode_attention_local / combine_partials: 8 slots a shard
ATTN_LENS = (1, 7, 8, 9, 16, 24, 31, 32)  # cache lengths on and beside the shard boundaries
FULL_S = 16  # decode_attn_cached at cache lengths S - 1 and S (a full cache)

_REFERENCE = r'''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.launch.mesh import make_host_mesh
from repro.layers import attention, moe
from repro.layers.common import apply_norm
from repro.models import decode, lm
from repro.sharding import AxisRules, unzip_params
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

assert len(jax.devices()) == 4, jax.devices()
inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
out = {}

def leaves(tree, prefix=()):
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(map(str, prefix + (k,))), v

def routing(params, cfg, shd, toks):
    """Per layer of the sharded prefill, the reference's layers replayed:
    loads over all tokens, drops counted per data shard at its capacity."""
    B, S = toks.shape
    n_b = shd.axis_sizes["data"] if shd.resolve(P("batch"), (B,))[0] is not None else 1

    @jax.jit
    def layer(lp, x, positions):
        x = x + lm._attn_full(lp["attn"], cfg, shd, apply_norm(cfg.norm, lp["norm1"], x), positions)
        h = apply_norm(cfg.norm, lp["norm2"], x)
        _, idx = moe._route(cfg, lp["moe"]["wr"], h.reshape(B * S, -1))
        return x + moe.apply_moe(lp["moe"], cfg, shd, h), idx

    x = lm.embed_tokens(params, cfg, shd, toks)
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    loads, drops = [], []
    for i in range(cfg.n_layers):
        x, idx = layer(jax.tree.map(lambda a: a[i], params["layers"]), x, positions)
        ids = np.asarray(idx).reshape(n_b, -1)
        C = moe._capacity(cfg, ids.shape[1] // cfg.top_k, cfg.n_experts)
        per = [np.bincount(r, minlength=cfg.n_experts) for r in ids]
        loads.append(sum(per))
        drops.append(sum(int(np.maximum(p - C, 0).sum()) for p in per))
    return np.stack(loads), np.array(drops)

for name, (arch, (d, m), kw, B, Pl) in spec["cases"].items():
    cfg = dataclasses.replace(reduced_config(arch), **kw)
    params = unzip_params(lm.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32))[0]
    shd = AxisRules(make_host_mesh(d, m), get_config(arch)[1])
    toks = inp[name + "/tokens"]
    batch = {"tokens": toks}
    if cfg.encoder_decoder:
        batch["frames"] = inp[name + "/frames"]
    G = spec["G"]
    prefill = jax.jit(lambda p, b: decode.lm_prefill(p, cfg, shd, b, pad_to=Pl + G))
    step = jax.jit(lambda p, c, b: decode.lm_decode_step(p, cfg, shd, c, b))
    logits, cache = prefill(params, batch)
    steps, tokens = [logits], [jnp.argmax(logits, -1)]
    for _ in range(G):
        logits, cache = step(params, cache, {"token": tokens[-1]})
        steps.append(logits)
        tokens.append(jnp.argmax(logits, -1))
    out[name + "/logits"] = np.stack([np.asarray(s) for s in steps])
    out[name + "/tokens"] = np.stack([np.asarray(t) for t in tokens], 1)
    for path, leaf in leaves(cache):
        out[name + "/cache/" + path] = np.asarray(leaf)
    if cfg.is_moe:
        out[name + "/loads"], out[name + "/drops"] = routing(params, cfg, shd, jnp.asarray(toks))

# decode_attention_local per shard and combine_partials over the model axis, at cache lengths on shard boundaries
mesh = make_host_mesh(1, 4)
q, k, v = inp["attn/q"], inp["attn/k"], inp["attn/v"]

@jax.jit
def sharded(q, k, v, clen):
    def body(q, k, v, clen):
        off = jax.lax.axis_index("model") * k.shape[1]
        num, den, m = attention.decode_attention_local(q, k, v, clen, pos_offset=off)
        return attention.combine_partials(num, den, m, "model"), num[None], den[None], m[None]
    return shard_map(body, mesh=mesh, in_specs=(P(), P(None, "model"), P(None, "model"), P()),
                     out_specs=(P(), P("model"), P("model"), P("model")))(q, k, v, clen)

for L in spec["attn_lens"]:
    comb, num, den, m = sharded(q, k, v, jnp.int32(L))
    out[f"attn/{L}/out"], out[f"attn/{L}/num"], out[f"attn/{L}/den"], out[f"attn/{L}/m"] = map(
        np.asarray, (comb, num, den, m))
    out[f"attn/{L}/whole"] = np.asarray(attention.combine_partials(
        *attention.decode_attention_local(q, k, v, jnp.int32(L)), None))

# decode_attn_cached on a full cache and one slot before it, with and without the 4-way mesh (ROADMAP.md C.17)
cfg = reduced_config("stablelm-1.6b")
for tag, rules in (("sharded", AxisRules(make_host_mesh(1, 4), {})), ("whole", AxisRules(None))):
    attend = jax.jit(lambda *a, rules=rules: attention.decode_attn_cached(cfg, rules, *a))
    for L in spec["full_lens"]:
        o, kc, vc = attend(*(inp["full/" + x] for x in ("q", "kn", "vn", "kc", "vc")), jnp.int32(L))
        out[f"full/{tag}/{L}/out"], out[f"full/{tag}/{L}/k"] = np.asarray(o), np.asarray(kc)

# apply_moe on a 3-way model axis: 4 experts do not split, the local branch runs
cfg = reduced_config("llama4-scout-17b-a16e")
mp = unzip_params(moe.init_moe(jax.random.PRNGKey(3), cfg))[0]
out["moe3/y"] = np.asarray(jax.jit(lambda p, x: moe.apply_moe(p, cfg, AxisRules(make_host_mesh(1, 3)), x))(
    mp, inp["moe3/x"]))
np.savez(sys.argv[2], **out)
print("REFERENCE SHARDED OK")
'''


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several test workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    arch, _, kw, _, _ = CASES[name]
    return dataclasses.replace(reduced_config(arch), **kw), dataclasses.replace(jreduced_config(arch), **kw)


def _inputs():
    """Every case's tokens (and whisper's frames) and the unit checks'
    arrays, from numpy at fixed seeds."""
    rng = np.random.default_rng(25)
    inp = {}
    for name, (arch, _, _, B, P) in CASES.items():
        cfg = reduced_config(arch)
        inp[name + "/tokens"] = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
        if cfg.encoder_decoder:
            inp[name + "/frames"] = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    a = ATTN_CASE
    inp["attn/q"] = rng.standard_normal((a["B"], a["H"], a["Dh"])).astype(np.float32)
    inp["attn/k"] = rng.standard_normal((a["B"], a["S"], a["H"], a["Dh"])).astype(np.float32)
    inp["attn/v"] = rng.standard_normal((a["B"], a["S"], a["H"], a["Dh"])).astype(np.float32)
    inp["moe3/x"] = rng.standard_normal((2, 12, 128)).astype(np.float32)
    cfg = reduced_config(STABLELM)
    B, S, H, KV, Dh = 2, FULL_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for x, shape in (("q", (B, H, Dh)), ("kn", (B, KV, Dh)), ("vn", (B, KV, Dh)), ("kc", (B, S, KV, Dh)),
                     ("vc", (B, S, KV, Dh))):
        inp["full/" + x] = rng.standard_normal(shape).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The inputs, and the reference's subprocess on 4 forced host devices,
    started here so that it runs while the port does (``reference``)."""
    d = tmp_path_factory.mktemp("shard")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    spec = json.dumps({"cases": CASES, "G": G, "attn_lens": ATTN_LENS, "full_lens": (FULL_S - 1, FULL_S)})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d / "in.npz"), str(d / "out.npz"), spec],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield inp, proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(started, port_runs):
    """(inputs, the reference's outputs), once the port's runs are done."""
    inp, proc, d = started
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE SHARDED OK" in out, err[-4000:]
    return inp, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def models():
    """Each case's port model on the reference's ``init_lm(PRNGKey(0))`` weights."""
    out = {}
    for name in CASES:
        cfg, jcfg = _cfgs(name)
        jparams = unzip_params(jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32))[0]
        out[name] = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    return out


def _mesh_rules(name):
    arch, (d, m), _, _, _ = CASES[name]
    return AxisRules(make_host_mesh(d, m, devices=("cpu",) * (d * m)), get_config(arch)[1])


def _serve(model, cfg, shd, inp, name):
    """The reference's loop through the port's builders: prefill with G
    slots of headroom, G greedy steps. Returns (logits (G+1, B, V), tokens
    (B, G+1), cache, the prefill's Record)."""
    batch = {"tokens": torch.tensor(inp[name + "/tokens"])}
    if cfg.encoder_decoder:
        batch["frames"] = torch.tensor(inp[name + "/frames"])
    P = batch["tokens"].shape[1]
    with torch.inference_mode():
        with tmoe.Record() as rec:
            logits, cache = build_prefill(cfg, shd)(model, batch, P + G)
        step = build_decode_step(cfg, shd)
        steps, tokens = [logits], [logits.argmax(-1)]
        for _ in range(G):
            logits, cache = step(model, cache, {"token": tokens[-1]})
            steps.append(logits)
            tokens.append(logits.argmax(-1))
    return torch.stack(steps), torch.stack(tokens, 1), cache, rec


@pytest.fixture(scope="module")
def port_runs(started, models):
    inp = started[0]
    runs = {}
    for name in CASES:
        cfg, _ = _cfgs(name)
        runs[name] = _serve(models[name], cfg, _mesh_rules(name), inp, name)
    return runs


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serve_matches_the_reference_shard_map(reference, port_runs, name):
    """Prefill and 8 greedy decode steps on the mesh: logits and every
    cache leaf within the tolerance of the reference's sharded run, every
    token equal."""
    _, ref = reference
    logits, tokens, cache, _ = port_runs[name]
    tol = TOL.get(name, 1e-5)
    np.testing.assert_array_equal(tokens.numpy(), ref[name + "/tokens"])
    np.testing.assert_allclose(logits.numpy(), ref[name + "/logits"], atol=tol, rtol=0)
    want = {k[len(name) + 7:]: v for k, v in ref.items() if k.startswith(name + "/cache/")}
    got = {"/".join(map(str, path)): t for path, t in convert._leaves(cache)}
    assert set(got) == set(want)
    for path, t in got.items():
        if path == "len":
            assert t == int(want["len"]) == tokens.shape[1] - 1 + CASES[name][4]
            continue
        np.testing.assert_allclose(t.numpy(), want[path], atol=tol, rtol=0, err_msg=path)


@pytest.mark.parametrize("name", ["llama4", "kimi", "llama4_2x2"])
def test_expert_parallel_routing_matches_the_reference_per_layer(reference, port_runs, name):
    """What the port's expert-parallel prefill routed, layer by layer (one
    ``Record`` call a layer, the batch shards' routing joined): loads and
    drops equal the reference's sharded layers', whose drops count each
    data shard at its own capacity.  At (2, 2) and capacity factor 1.0
    every layer drops, and the drops differ from those of one call over
    the whole batch."""
    _, ref = reference
    cfg, _ = _cfgs(name)
    rec = port_runs[name][3]
    assert len(rec.calls) == cfg.n_layers
    stats = [tmoe.route_stats(cfg, c) for c in rec.calls]
    assert [s["loads"] for s in stats] == ref[name + "/loads"].tolist()
    assert [s["dropped"] for s in stats] == ref[name + "/drops"].tolist()
    if name == "llama4_2x2":
        B, P = CASES[name][3:]
        assert all(s["capacity"] == tmoe._capacity(cfg, B // 2 * P) for s in stats)
        assert all(s["dropped"] > 0 for s in stats)
        whole = [np.maximum(np.array(s["loads"]) - tmoe._capacity(cfg, B * P), 0).sum() for s in stats]
        assert [s["dropped"] for s in stats] != whole


@pytest.mark.parametrize("L", ATTN_LENS)
def test_decode_attention_local_and_combine_match_the_reference(reference, L):
    """Each shard's partials (``decode_attention_local`` at its offset) and
    their combine over 4 shards, at cache lengths on and beside shard
    boundaries; and one shard's partials combined alone (the reference's
    ``axis_name=None``)."""
    inp, ref = reference
    a = ATTN_CASE
    q, k, v = (torch.tensor(inp[f"attn/{x}"]) for x in "qkv")
    C = a["S"] // a["n"]
    parts = [tattn.decode_attention_local(q, k[:, i * C:(i + 1) * C], v[:, i * C:(i + 1) * C], L, pos_offset=i * C)
             for i in range(a["n"])]
    for j, key in enumerate(("num", "den", "m")):
        want = ref[f"attn/{L}/{key}"]
        for i, part in enumerate(parts):
            np.testing.assert_allclose(part[j].numpy(), want[i], atol=1e-6, rtol=1e-6, err_msg=f"{key} shard {i}")
    np.testing.assert_allclose(tattn.combine_partials(parts).numpy(), ref[f"attn/{L}/out"], atol=1e-6, rtol=0)
    whole = tattn.combine_partials([tattn.decode_attention_local(q, k, v, L)])
    np.testing.assert_allclose(whole.numpy(), ref[f"attn/{L}/whole"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("L", (FULL_S - 1, FULL_S))
def test_decode_past_a_full_cache_follows_each_reference_branch(reference, L):
    """A write at cache length L into a cache of S slots: the port's
    sharded and whole branches each equal the reference's.  At L = S (the
    cache full) the reference's branches disagree (ROADMAP.md C.17): the
    whole branch clips the slot and overwrites slot S - 1, the sharded
    branch finds no shard that owns slot S and drops the token, then both
    attend over all S slots."""
    inp, ref = reference
    q, kn, vn, kc, vc = (torch.tensor(inp["full/" + x]) for x in ("q", "kn", "vn", "kc", "vc"))
    shd = AxisRules(make_host_mesh(1, 4, devices=("cpu",) * 4), {})
    for tag, rules in (("sharded", shd), ("whole", None)):
        out, k2, _ = tattn.decode_attn_cached(q, kn, vn, kc.clone(), vc.clone(), L, shd=rules)
        np.testing.assert_allclose(out.numpy(), ref[f"full/{tag}/{L}/out"], atol=1e-6, rtol=0, err_msg=tag)
        np.testing.assert_array_equal(k2.numpy(), ref[f"full/{tag}/{L}/k"], err_msg=tag)
    same = np.array_equal(ref[f"full/sharded/{L}/k"], ref[f"full/whole/{L}/k"])
    assert same == (L < FULL_S)


def test_moe_falls_back_to_one_call_where_the_experts_do_not_split(reference):
    """4 experts on a 3-way model axis: the local branch, as the reference's."""
    inp, ref = reference
    cfg = reduced_config(LLAMA4)
    jp = unzip_params(jmoe.init_moe(jax.random.PRNGKey(3), jreduced_config(LLAMA4)))[0]
    params = tmoe.MoE({k: torch.tensor(np.asarray(v)) for k, v in jp.items()})
    shd = AxisRules(make_host_mesh(1, 3, devices=("cpu",) * 3), {})
    x = torch.tensor(inp["moe3/x"])
    with tmoe.Record() as rec:
        y = tmoe.apply_moe(params, cfg, x, shd)
    assert len(rec.calls) == 1 and rec.calls[0]["keep"].all()
    assert torch.equal(y, tmoe.apply_moe(params, cfg, x))
    np.testing.assert_allclose(y.numpy(), ref["moe3/y"], atol=1e-5 * float(np.abs(ref["moe3/y"]).max()), rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_port_sharded_against_port_unsharded(reference, models, port_runs, name):
    """The port's mesh run against its own run without a mesh, teacher-forced
    on the mesh run's tokens.  What it finds: the expert-parallel MoE is
    bitwise the single call where one batch shard routes all tokens (other
    shards add exact zeros, top-1 and top-2 alike: a prefill's logits are
    bitwise equal); with two batch shards at capacity factor 1.0 routing
    differs (per-shard capacity), so the logits part; and the sharded
    decode's combine of four partials differs from one softmax by
    rounding, within the tolerance.  Where the cache's S does not divide
    (the fallback) the decode is the unsharded one, bitwise."""
    inp, _ = reference
    cfg, _ = _cfgs(name)
    logits, tokens, _, _ = port_runs[name]
    batch = {"tokens": torch.tensor(inp[name + "/tokens"])}
    if cfg.encoder_decoder:
        batch["frames"] = torch.tensor(inp[name + "/frames"])
    P = batch["tokens"].shape[1]
    with torch.inference_mode():
        lg, cache = build_prefill(cfg)(models[name], batch, P + G)
        whole = [lg]
        step = build_decode_step(cfg)
        for i in range(G):
            lg, cache = step(models[name], cache, {"token": tokens[:, i]})
            whole.append(lg)
    whole = torch.stack(whole)
    if name == "llama4_2x2":
        assert not torch.equal(whole[0], logits[0])
        return
    assert torch.equal(whole[0], logits[0]), "the prefill does not split the cache: bitwise"
    if name == "stablelm_fallback":
        assert torch.equal(whole, logits)
    else:
        np.testing.assert_allclose(whole.numpy(), logits.numpy(), atol=TOL.get(name, 1e-5), rtol=0)
