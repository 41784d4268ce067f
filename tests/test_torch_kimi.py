"""kimi-k2-1t-a32b at its published widths: the 64-bit threefry counts of
the port's ``core/prng`` in both modes, and the golden file of the model
served at full width, 1 of its 61 layers, on the CPU.

kimi's expert leaves hold 384 x 7168 x 2048 = 5.64 B elements each, more
than 2**32, and a 62 GB host holds no draw of that size whole (XLA asks
for 90 GB to draw one on the CPU).  So everything here works on windows:

* jax's own transforms (``truncated_normal``, ``normal``) applied to any
  window of a partitionable draw through a key type whose ``random_bits``
  hashes the counts offset + iota (``WINDOW``, ``window_key``);
* the port's windows (``prng._chunked_draw``, ``sharding._dense_draw``)
  against it past 2**32 and at 2**33 + 7, bitwise; the legacy mode's
  blocks of 2**32 - 1 against jax's ``threefry_split`` and
  ``threefry2x32_p`` at the blocks' (i, i + 2**31) pairs, and its block
  structure at a block of 7 against jax's own ``threefry_2x32``; windows
  against the whole draw at small shapes in both modes;
* the reference's MoE layer summed over ranges of experts whose leaves are
  drawn window by window (``RefRangeMoE``: ``_moe_local`` sizes its capacity
  from ``cfg.n_experts``, so the layer is the sum of its calls over
  disjoint ranges), held to the reference's unpatched jitted prefill and
  decode at the reduced configs, and its window keys to the reference's
  ``init_lm`` expert leaves bitwise; the port's counterpart
  (``PortRangeMoE``) to the port's own path;
* ``dense_init``'s in-place scale, bitwise the out-of-place product.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_kimi.py

rewrites ``src/repro_torch/data/golden_serve_kimi_k2.json``: the reference
at full width, 1 layer, seed 0, one 2048-token prompt, the prefill's token
and 8 greedy decode steps, with ``repro.layers.moe.apply_moe`` replaced in
the writer's process (never in the file) by ``RefRangeMoE``'s
``pure_callback``; every leaf's sample and sum of |w| (the expert leaves'
window by window) and raw windows of the expert leaves; layer 0's routing.
A second process runs the port's own path the same way on the CPU
(``PortRangeMoE``, its draws windowed) and writes its gap to the reference,
which sets the card's tolerance at 10x (``chip_smoke.py``'s kimi phase).
"""
import base64
import dataclasses
import functools
import json
import math
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
from jax import lax
from jax._src import prng as jprng
from jax.extend import random as jexr

from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.layers import moe as jmoe
from repro.models import decode as jdecode
from repro.models import lm as jlm
from repro.sharding import AxisRules, name_key as jname_key, unzip_params
from repro_torch import sharding
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.layers import moe as tmoe
from repro_torch.models import lm as tlm
from repro_torch.models.decode import lm_decode_step, lm_prefill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_kimi_k2.json")
KIMI = "kimi-k2-1t-a32b"
SHD = AxisRules(None)
EXPERTS = ("wg", "wu", "wd")
M32 = 0xFFFFFFFF
# the golden run: full width, 1 of 61 layers, one 2048-token prompt, its prefill's token and 8 decode steps
GOLDEN_LAYERS = 1
GOLDEN_RUN = dict(seed=0, batch=1, prompt_len=2048, gen_len=9)
RANGE = 16  # experts per range of the full-width prefill's MoE (3 x 16 x 14.7 M elements drawn at once)
WINDOW_N = 4096  # elements of each raw window of an expert leaf in the golden file
# the reduced config with enough experts for several ranges, capacity dropping on (kimi's own factor)
WIDE = dict(n_experts=16, top_k=4, capacity_factor=1.25)
WIDE_RANGE = 4
# the range-summed MoE against the one call at top-4, of the largest |logit|: the ranges' outputs add in another order
MOE_TOL = 1e-6
PORT_TOL = 5e-5  # the port against the reference at the reduced configs (tests/test_torch_moe.py's logit tolerance)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs: tier-1 runs
    several test workers on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Windows of jax's partitionable draw
# ---------------------------------------------------------------------------


def _window_bits(k, bit_width, shape):
    """32 random bits of the counts offset + iota(prod(shape)), offset the
    64-bit (k[2], k[3]), hashed as ``_threefry_random_bits_partitionable``
    hashes ``iota_2x32_shape``'s (hi, lo) words."""
    if bit_width != 32:
        raise NotImplementedError(bit_width)
    i = lax.iota(np.uint32, math.prod(shape))
    lo = k[3] + i
    hi = k[2] + (lo < i).astype(np.uint32)  # the carry of the low word
    b1, b2 = jexr.threefry2x32_p.bind(k[0], k[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def _no(*args, **kw):
    raise NotImplementedError("a window key only draws")


WINDOW = jexr.define_prng_impl(key_shape=(4,), seed=_no, split=_no, random_bits=_window_bits, fold_in=_no,
                               name="threefry_window")


def window_data(key, offset: int):
    """The window key's data: a raw threefry key (2,) and the 64-bit offset."""
    return jnp.concatenate([jnp.asarray(key, jnp.uint32).reshape(2),
                            jnp.array([offset >> 32, offset & M32], jnp.uint32)])


def window_key(key, offset: int):
    """A key whose draw of shape s is elements [offset, offset + prod(s))
    of ``key``'s partitionable draw, jax's transforms applied."""
    return jax.random.wrap_key_data(window_data(key, offset), impl=WINDOW)


@functools.lru_cache(maxsize=None)
def _ref_dense_fn(shape, scale):
    """The reference's ``dense_init`` arithmetic on a window key's draw."""
    return jax.jit(lambda data: jax.random.truncated_normal(jax.random.wrap_key_data(data, impl=WINDOW), -2.0, 2.0,
                                                            shape, jnp.float32) * scale)


def ref_expert_key(key, cfg, layer: int, name: str):
    """Layer ``layer``'s ``name_key`` for an expert leaf, as ``_stack_init``
    (a split of ``name_key(key, "layers")`` over the layers) and
    ``dense_init`` derive it."""
    return jname_key(jax.random.split(jname_key(key, "layers"), cfg.n_layers)[layer], name)


def _expert_shape(cfg, name, n):
    D, F = cfg.d_model, cfg.d_ff
    return (n, F, D) if name == "wd" else (n, D, F)


def ref_expert_window(key, cfg, layer: int, name: str, e0: int, n: int):
    """Experts [e0, e0 + n) of an expert leaf, as the reference's
    ``init_lm`` draws it: the truncated normal times the float32 scale
    1/sqrt(fan_in), fan_in = E (``dense_init`` takes shape[0])."""
    per = cfg.d_model * cfg.d_ff
    data = window_data(ref_expert_key(key, cfg, layer, name), e0 * per)
    return _ref_dense_fn(_expert_shape(cfg, name, n), 1.0 / np.sqrt(max(cfg.n_experts, 1)))(data)


def ref_flat_window(key, cfg, layer: int, name: str, start: int, n: int):
    """Flat elements [start, start + n) of an expert leaf, the reference's values."""
    data = window_data(ref_expert_key(key, cfg, layer, name), start)
    return np.asarray(_ref_dense_fn((n,), 1.0 / np.sqrt(max(cfg.n_experts, 1)))(data))


def port_expert_window(layer_key, cfg, name: str, e0: int, n: int):
    """The port's experts [e0, e0 + n) of an expert leaf (``dense_init``'s
    values, drawn as a window)."""
    per = cfg.d_model * cfg.d_ff
    shape = _expert_shape(cfg, name, cfg.n_experts)
    return sharding._dense_draw(layer_key, name, shape, None, e0 * per, (e0 + n) * per).reshape(
        _expert_shape(cfg, name, n))


# ---------------------------------------------------------------------------
# The MoE layer summed over ranges of experts
# ---------------------------------------------------------------------------


def _ranges(E: int, step: int, used):
    """Experts [e0, e0 + n) in ranges of ``step``, skipping a range no
    assignment routes to (its output is exactly zero)."""
    used = set(int(e) for e in used)
    for e0 in range(0, E, step):
        n = min(step, E - e0)
        if used.intersection(range(e0, e0 + n)):
            yield e0, n


def _route_stats(cfg, logits, idx):
    """Loads, dropped assignments, capacity and smallest top-k / next
    router-probability margin of one MoE call (numpy)."""
    T, k = idx.shape
    C = jmoe._capacity(cfg, T, cfg.n_experts)
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)), -1)[:, ::-1]
    loads = np.bincount(np.asarray(idx).reshape(-1), minlength=cfg.n_experts)
    margin = float((probs[:, k - 1] - probs[:, k]).min()) if cfg.n_experts > k else float("inf")
    return {"loads": loads.tolist(), "dropped": int(np.maximum(loads - C, 0).sum()), "capacity": C, "margin": margin}


class RefRangeMoE:
    """``with RefRangeMoE(cfg, key, step):`` replaces the reference's
    ``apply_moe`` (``repro.layers.moe`` and the name ``repro.models.lm``
    calls) in this process by a ``jax.pure_callback``: the reference's
    ``_moe_local`` over ranges of ``step`` experts (one expert at a time
    for a one-token call), each range's leaves drawn as windows
    (``ref_expert_window``), the ranges' outputs summed in order.  The
    params' expert leaves hold each layer's index (``ref_params``).  Each
    prefill call (S > 1) appends its router logits and routing to
    ``calls``."""

    def __init__(self, cfg, key, step: int):
        self.cfg, self.key, self.step, self.calls = cfg, key, step, []
        self._local = functools.lru_cache(maxsize=None)(
            lambda n: jax.jit(lambda p, x, e0: jmoe._moe_local(self.cfg, p, x, e0, n)))
        self._route = jax.jit(lambda wr, x: (
            jnp.einsum("td,de->te", x.astype(jnp.float32), wr.astype(jnp.float32)), jmoe._route(self.cfg, wr, x)[1]))

    def __enter__(self):
        self._saved = jmoe.apply_moe, jlm.apply_moe
        jmoe.apply_moe = jlm.apply_moe = self.apply_moe
        return self

    def __exit__(self, *exc):
        jmoe.apply_moe, jlm.apply_moe = self._saved

    def apply_moe(self, params, cfg, shd, x):
        return jax.pure_callback(self._host, jax.ShapeDtypeStruct(x.shape, x.dtype), x, params["wr"], params["wg"])

    def _host(self, x, wr, layer):
        cfg = self.cfg
        x, wr, layer = np.asarray(x), np.asarray(wr), int(np.asarray(layer).reshape(-1)[0])
        B, S, D = x.shape
        logits, idx = self._route(wr, x.reshape(B * S, D))
        y = None
        for e0, n in _ranges(cfg.n_experts, 1 if B * S == 1 else self.step, np.unique(np.asarray(idx))):
            p = {"wr": wr, **{nm: ref_expert_window(self.key, cfg, layer, nm, e0, n) for nm in EXPERTS}}
            part = self._local(n)(p, x, jnp.int32(e0))
            y = part if y is None else y + part
        if S > 1:
            self.calls.append(dict(_route_stats(cfg, np.asarray(logits), np.asarray(idx)), layer=layer,
                                   logits=np.asarray(logits)))
        return np.asarray(y, dtype=x.dtype)


def ref_params(cfg, seed: int):
    """The reference's ``init_lm`` under ``jit``, returning every leaf but
    the experts' (XLA drops their draws); each expert leaf is replaced by
    the layer indices (L, 1), which ``RefRangeMoE`` reads."""
    def leaves(key):
        p = unzip_params(jlm.init_lm(key, cfg, jnp.float32))[0]
        return {**p, "layers": {**p["layers"], "moe": {"wr": p["layers"]["moe"]["wr"]}}}

    p = jax.jit(leaves)(jax.random.PRNGKey(seed))
    p["layers"]["moe"].update({nm: jnp.arange(cfg.n_layers, dtype=jnp.float32)[:, None] for nm in EXPERTS})
    return p


def ref_serve(cfg, params, prompts, G):
    """The reference launcher's loop: jitted prefill, then G - 1 jitted
    greedy decode steps: tokens (B, G), logits (G, B, V)."""
    P = prompts.shape[1]
    logits, cache = jax.jit(lambda p, b: jdecode.lm_prefill(p, cfg, SHD, b, pad_to=P + G))(params, {"tokens": prompts})
    step = jax.jit(lambda p, c, b: jdecode.lm_decode_step(p, cfg, SHD, c, b))
    toks, steps = [np.asarray(jnp.argmax(logits, -1))], [np.asarray(logits)]
    for _ in range(G - 1):
        logits, cache = step(params, cache, {"token": jnp.asarray(toks[-1])})
        toks.append(np.asarray(jnp.argmax(logits, -1)))
        steps.append(np.asarray(logits))
    return np.stack(toks, 1), np.stack(steps)


class PortRangeMoE:
    """The port's counterpart of ``RefRangeMoE``: ``with PortRangeMoE(cfg,
    step):`` makes ``repro_torch.models.lm``'s ``init_moe`` draw the router
    only (the expert leaves are zero-stride placeholders of their shapes,
    the layer's key kept beside them) and its ``apply_moe`` run the port's
    ``moe_local`` over the same ranges, each range's leaves drawn as the
    port's windows (``port_expert_window``), summed in order.  Each prefill
    call appends its router logits and ``route_stats`` to ``calls``."""

    def __init__(self, cfg, step: int):
        self.cfg, self.step, self.calls = cfg, step, []

    def __enter__(self):
        self._saved = tlm.init_moe, tlm.apply_moe
        tlm.init_moe, tlm.apply_moe = self.init_moe, self.apply_moe
        return self

    def __exit__(self, *exc):
        tlm.init_moe, tlm.apply_moe = self._saved

    def init_moe(self, key, cfg, dtype=torch.float32):
        zero = torch.zeros((), dtype=dtype, device=key.device)
        m = tmoe.MoE({"wr": sharding.dense_init(key, "wr", (cfg.d_model, cfg.n_experts), sharding.P("embed", None)),
                      **{nm: zero.expand(_expert_shape(cfg, nm, cfg.n_experts)) for nm in EXPERTS}})
        m.layer_key = key
        return m

    def apply_moe(self, params, cfg, x, shd=None):
        cfg = self.cfg
        B, S, D = x.shape
        x_flat = x.reshape(B * S, D)
        gates, idx, logits = tmoe._route(cfg, params.wr, x_flat)
        y = None
        for e0, n in _ranges(cfg.n_experts, 1 if B * S == 1 else self.step, idx.unique().tolist()):
            w = {nm: port_expert_window(params.layer_key, cfg, nm, e0, n) for nm in EXPERTS}
            part = tmoe.moe_local(tmoe.Experts(params.wr, w["wg"], w["wu"], w["wd"]), cfg, x, e0, n)
            y = part if y is None else y + part
        if S > 1:
            keep = tmoe._slots(cfg, idx, B * S, 0, cfg.n_experts)[0]
            self.calls.append(dict(tmoe.route_stats(cfg, {"logits": logits, "ids": idx, "keep": keep,
                                                          "capacity": tmoe._capacity(cfg, B * S)}),
                                   logits=logits.numpy()))
        return y


# ---------------------------------------------------------------------------
# (a) partitionable draws past 2**32
# ---------------------------------------------------------------------------

BIG = (384, 7168, 2048)  # kimi's expert leaf: 5.64 B elements
WINDOWS = ((BIG, 0), (BIG, 2**32 - WINDOW_N // 2), (BIG, math.prod(BIG) - WINDOW_N), ((4, 2**32), 2**33 + 7))


def _tkey(seed=3, data=11):
    return prng.fold_in(prng.prng_key(seed), data)


def _jkey(seed=3, data=11):
    return jax.random.fold_in(jax.random.PRNGKey(seed), data)


@pytest.mark.parametrize("big,start", WINDOWS)
def test_partitionable_windows_past_2_32_match_jax(big, start):
    """bits, ``normal``, ``truncated_normal`` and ``dense_init`` windows of
    a draw of kimi's expert leaf, at its head, across 2**32 and at its tail,
    and of a draw of 2**34 at 2**33 + 7, bitwise jax's (the window key
    applies jax's transforms)."""
    tk, jk, n = _tkey(), _jkey(), WINDOW_N
    bits = prng._chunked_draw(tk, big, lambda b: b, start, start + n, chunk=1000, dtype=torch.int64)
    want = np.asarray(jax.random.bits(window_key(jk, start), (n,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(bits.numpy(), want)
    got = prng._chunked_draw(tk, big, prng._normal_fn(), start, start + n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.normal(window_key(jk, start), (n,), jnp.float32)))
    got = prng._chunked_draw(tk, big, prng._truncated_normal_fn(-2.0, 2.0), start, start + n)
    want = jax.random.truncated_normal(window_key(jk, start), -2.0, 2.0, (n,), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # dense_init's leaf: the truncated normal of name_key(key, name) times 1/sqrt(fan_in) in float32
    got = sharding._dense_draw(tk, "wg", big, None, start, start + n)
    want = _ref_dense_fn((n,), 1.0 / np.sqrt(big[0]))(window_data(jname_key(jk, "wg"), start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_bits_and_random_bits_split_64_bit_counts():
    """``draw_counts`` past 2**32 counts: the (hi, lo) words of each count,
    no silent wrap to the low word; below it, the counts as they were."""
    c0, c1, pick = prng.draw_counts([(3,)])
    assert c0 == 0 and pick is None and c1.tolist() == [0, 1, 2]
    counts = torch.tensor([2**32 - 1, 2**32, 2**33 + 7])
    y0, y1 = prng._hash_counts(_tkey(), counts, 2**33 + 8)
    k = jax.random.key_data(_jkey()).astype(jnp.uint32)
    want = jexr.threefry2x32_p.bind(k[0], k[1], jnp.array([0, 1, 2], jnp.uint32),
                                    jnp.array([M32, 0, 7], jnp.uint32))
    np.testing.assert_array_equal(y0.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(y1.numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# (b) legacy draws of 2**32 - 1 elements or more
# ---------------------------------------------------------------------------


def _legacy_ref_bits(jkey, n: int, idx, block: int = 2**32 - 1):
    """Elements ``idx`` of jax's legacy draw of n elements, from its
    primitives: ``threefry_split(key, (nb + 1,))`` in the legacy mode, then
    element r of a block of m elements is y0 of the pair (r, r + h) below h =
    ceil(m/2), y1 of (r - h, r) above (a count past m - 1 padded to 0)."""
    idx = np.asarray(idx, np.int64)
    nb, rem = divmod(n, block)
    with jax.threefry_partitionable(False):  # one block draws under the key itself
        keys = jax.random.key_data(jax.random.split(jkey, nb + 1) if nb else jkey[None])
    keys = np.asarray(keys).astype(np.uint32)
    b = idx // block
    r = idx - b * block
    m = np.where(b < nb, block, rem)
    h = (m + 1) // 2
    x0 = np.where(r < h, r, r - h)
    x1 = np.where(r < h, r + h, r)
    x1 = np.where(x1 < m, x1, 0)
    y = jexr.threefry2x32_p.bind(jnp.asarray(keys[b, 0]), jnp.asarray(keys[b, 1]), jnp.asarray(x0, jnp.uint32),
                                 jnp.asarray(x1, jnp.uint32))
    return np.where(r < h, np.asarray(y[0]), np.asarray(y[1])).astype(np.int64)


LEGACY_N = 2 * (2**32 - 1) + 1000  # two whole blocks and a remainder of 1000
LEGACY_WINDOWS = ((0, 6), (2**31 - 3, 2**31 + 3), (2**32 - 6, 2**32 + 4), (2 * (2**32 - 1) - 4, 2 * (2**32 - 1) + 4),
                  (2 * (2**32 - 1) + 495, 2 * (2**32 - 1) + 505), (LEGACY_N - 5, LEGACY_N))


@pytest.mark.parametrize("start,stop", LEGACY_WINDOWS)
def test_legacy_windows_past_a_block_match_jax(start, stop):
    """Windows of a legacy draw of two blocks of 2**32 - 1 and a remainder:
    each block's half boundary (2**31), the boundaries between blocks and
    into the remainder, the remainder's own halves, bitwise jax's split keys
    and pairs.  Bits and ``truncated_normal``'s floats."""
    with prng.threefry_partitionable(False):
        got = prng._chunked_draw(_tkey(), (LEGACY_N,), lambda b: b, start, stop, chunk=4, dtype=torch.int64)
        tn = prng._chunked_draw(_tkey(), (LEGACY_N,), prng._truncated_normal_fn(-2.0, 2.0), start, stop)
    want = _legacy_ref_bits(_jkey(), LEGACY_N, np.arange(start, stop))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tn.numpy(), prng._truncated_normal_fn(-2.0, 2.0)(torch.from_numpy(want)).numpy())


@pytest.mark.parametrize("n", [6, 7, 8, 21, 30, 33])
def test_legacy_block_structure_at_a_small_block(monkeypatch, n):
    """The multi-block path with the block cut to 7 elements, against the
    same structure built from jax's legacy ``split`` and ``threefry_2x32``:
    ``random_bits`` (so ``split`` of many keys), ``row_bits`` and
    ``draw_counts`` with mixed sizes, and windows; a size that is a multiple
    of the block has an empty remainder."""
    monkeypatch.setattr(prng, "_LEGACY_BLOCK", 7)
    prng._legacy_rows.cache_clear()  # its layouts depend on the block: none made here may outlive the test
    try:
        _check_small_block(n)
    finally:
        prng._legacy_rows.cache_clear()


def _check_small_block(n):
    jk = _jkey()
    nb, rem = divmod(n, 7)
    with jax.threefry_partitionable(False):
        if nb:
            keys = jax.random.key_data(jax.random.split(jk, nb + 1)).astype(jnp.uint32)
            parts = [jprng.threefry_2x32(keys[b], lax.iota(np.uint32, 7)) for b in range(nb)]
            parts.append(jprng.threefry_2x32(keys[nb], lax.iota(np.uint32, rem)))
            want = np.concatenate([np.asarray(p) for p in parts])
        else:
            want = np.asarray(jprng.threefry_2x32(jax.random.key_data(jk).astype(jnp.uint32), lax.iota(np.uint32, n)))
    want = want.astype(np.int64)
    np.testing.assert_array_equal(_legacy_ref_bits(jk, n, np.arange(n), block=7), want)
    with prng.threefry_partitionable(False):
        np.testing.assert_array_equal(prng.random_bits(_tkey(), (n,)).numpy(), want)
        for start in range(0, n, 3):
            got = prng._chunked_draw(_tkey(), (n,), lambda b: b, start, min(n, start + 5), chunk=2, dtype=torch.int64)
            np.testing.assert_array_equal(got.numpy(), want[start:start + 5])
        shapes = ((n,), (3,), (2, 4))
        keys = torch.stack([_tkey(), _tkey(5), _tkey(7)])[None]
        rows = prng.row_bits(keys, shapes)
        for j, sh in enumerate(shapes):
            m = math.prod(sh)
            assert torch.equal(rows[0, j, :m], prng.random_bits(keys[0, j], sh).reshape(m))
        assert torch.equal(rows[0, 0, :n], torch.from_numpy(want))


# ---------------------------------------------------------------------------
# (c) windows against the whole draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("shape,chunk", [((1023,), 64), ((7, 13), 10), ((2, 3, 5), 1)])
def test_windows_equal_the_whole_draw(partitionable, shape, chunk):
    n = math.prod(shape)
    rng = np.random.default_rng(n + chunk)
    with prng.threefry_partitionable(partitionable):
        whole = prng.truncated_normal(_tkey(), -2.0, 2.0, shape).reshape(-1)
        assert torch.equal(prng.normal(_tkey(), shape, chunk=chunk).reshape(-1),
                           prng._chunked_draw(_tkey(), shape, prng._normal_fn()))
        bits = prng.random_bits(_tkey(), shape).reshape(-1)
        fn = prng._truncated_normal_fn(-2.0, 2.0)
        for start, stop in [(0, n), (0, 1), (n - 1, n), (n // 2, n // 2)] + [
                tuple(sorted(rng.integers(0, n + 1, 2))) for _ in range(6)]:
            assert torch.equal(prng._chunked_draw(_tkey(), shape, fn, start, stop, chunk=chunk), whole[start:stop])
            got = prng._chunked_draw(_tkey(), shape, lambda b: b, start, stop, chunk=chunk, dtype=torch.int64)
            assert torch.equal(got, bits[start:stop])


# ---------------------------------------------------------------------------
# dense_init: the scale in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((64, 48), None), ((4, 32, 16), None), ((512, 8), 0.02), ((3,), None)])
def test_dense_init_scales_in_place_bitwise(shape, scale):
    """``dense_init`` equals the truncated normal times the float32 scale
    computed out of place, bitwise, and the reference's ``dense_init``."""
    from repro.sharding import dense_init as jdense_init

    key = _tkey()
    got = sharding.dense_init(key, "w", shape, (None,) * len(shape), scale=scale).value
    s = 1.0 / np.sqrt(max(shape[0], 1)) if scale is None else scale
    want = prng.truncated_normal(sharding.name_key(key, "w"), -2.0, 2.0, shape) * float(np.float32(s))
    assert torch.equal(got, want)
    ref = jdense_init(_jkey(), "w", shape, None, scale=scale).value
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# (d) the writer's key derivation and range-summed MoE at the reduced configs
# ---------------------------------------------------------------------------


def _cfgs(wide: bool):
    """(port, reference) configs: kimi's reduced config, or one with enough
    experts for several ranges of WIDE_RANGE and kimi's capacity factor."""
    cfg, jcfg = reduced_config(KIMI), jreduced_config(KIMI)
    if wide:
        cfg, jcfg = dataclasses.replace(cfg, **WIDE), dataclasses.replace(jcfg, **WIDE)
    return cfg, jcfg


@pytest.mark.parametrize("wide", [False, True])
def test_expert_windows_match_reference_init(wide):
    """The writer's expert windows (``ref_expert_window``) and the port's
    (``port_expert_window``) are the reference's own ``init_lm`` expert
    leaves, bitwise, range by range."""
    cfg, jcfg = _cfgs(wide)
    full = unzip_params(jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32))[0]["layers"]["moe"]
    keys = tlm.layer_keys(prng.prng_key(0), cfg)
    for layer in range(jcfg.n_layers):
        for nm in EXPERTS:
            want = np.asarray(full[nm][layer])
            for e0, n in _ranges(jcfg.n_experts, 3, range(jcfg.n_experts)):
                got = np.asarray(ref_expert_window(jax.random.PRNGKey(0), jcfg, layer, nm, e0, n))
                np.testing.assert_array_equal(got, want[e0:e0 + n])
                np.testing.assert_array_equal(port_expert_window(keys[layer], cfg, nm, e0, n).numpy(), want[e0:e0 + n])


@pytest.mark.parametrize("wide", [False, True])
def test_range_summed_moe_matches_reference(wide):
    """The reference's jitted prefill and greedy decode with ``apply_moe``
    summed over ranges of experts drawn as windows, against the same
    unpatched: tokens equal, logits bitwise at kimi's reduced config (top-2,
    where the order of a token's sum does not matter) and within MOE_TOL of
    the largest logit at top-4 (the ranges' sum runs in another order); and
    the port's range-summed path against the port's own."""
    cfg, jcfg = _cfgs(wide)
    step = WIDE_RANGE if wide else 1
    B, P, G = 2, 24, 5
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, P), 0, jcfg.vocab_size)
    full = unzip_params(jlm.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32))[0]
    want_tok, want = ref_serve(jcfg, full, prompts, G)
    with RefRangeMoE(jcfg, jax.random.PRNGKey(0), step) as patched:
        got_tok, got = ref_serve(jcfg, ref_params(jcfg, 0), prompts, G)
    np.testing.assert_array_equal(got_tok, want_tok)
    if wide:
        np.testing.assert_allclose(got, want, atol=MOE_TOL * np.abs(want).max(), rtol=0)
    else:  # top-2: a token's two contributions add in either order to the same float
        np.testing.assert_array_equal(got, want)
    assert [c["layer"] for c in patched.calls] == list(range(jcfg.n_layers))
    assert sum(c["dropped"] for c in patched.calls) > 0 or not wide  # kimi's factor drops assignments here

    model = tlm.init_lm(prng.prng_key(0), cfg, device="cpu")
    tp = torch.tensor(np.asarray(prompts))
    with torch.inference_mode():
        base, _ = lm_prefill(model, cfg, {"tokens": tp}, pad_to=P + G, plane=ops.TORCH)
        with PortRangeMoE(cfg, step) as port:
            ranged = tlm.init_lm(prng.prng_key(0), cfg, device="cpu")
            lg, cache = lm_prefill(ranged, cfg, {"tokens": tp}, pad_to=P + G, plane=ops.TORCH)
            lg2, _ = lm_decode_step(ranged, cfg, cache, {"token": torch.from_numpy(want_tok[:, 0])})
    np.testing.assert_allclose(lg.numpy(), base.numpy(), atol=MOE_TOL * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(lg.numpy(), want[0], atol=PORT_TOL, rtol=0)
    np.testing.assert_allclose(lg2.numpy(), want[1], atol=PORT_TOL, rtol=0)
    for mine, ref in zip(port.calls, patched.calls):
        assert (mine["loads"], mine["dropped"], mine["capacity"]) == (ref["loads"], ref["dropped"], ref["capacity"])


def test_param_specs_take_kimi_at_full_width():
    """``param_specs`` builds kimi-k2's tree on ``meta`` (no draw), its
    expert leaves at the published shapes."""
    cfg = get_config(KIMI)[0]
    shapes, specs = tlm.param_specs(cfg)
    assert tuple(shapes["layers"]["moe"]["wg"].shape) == (cfg.n_layers,) + BIG
    assert shapes["layers"]["moe"]["wd"].device.type == "meta"


# ---------------------------------------------------------------------------
# (e) the golden file
# ---------------------------------------------------------------------------


def _unpack(b64):
    return np.frombuffer(base64.b64decode(b64), dtype="<f4")


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_file_windows_match_the_port_draws():
    """Each expert leaf's raw windows in the golden file (its head, the 4096
    elements around flat index 2**32, its tail) are the port's windowed
    draws, bitwise; the prompts are the port's ``randint(PRNGKey(1))``; the
    steps, routing and tolerances are self-consistent."""
    g = _golden()
    cfg = dataclasses.replace(get_config(KIMI)[0], n_layers=g["n_layers"])
    assert g["arch"] == KIMI and g["d_model"] == cfg.d_model and g["n_experts"] == cfg.n_experts
    layer_key = tlm.layer_keys(prng.prng_key(g["seed"]), cfg)[0]
    for name, wins in g["windows"].items():
        nm = name.split("/")[-1]
        for w in wins:
            got = sharding._dense_draw(layer_key, nm, _expert_shape(cfg, nm, cfg.n_experts), None, w["start"],
                                       w["start"] + w["n"])
            np.testing.assert_array_equal(got.numpy(), _unpack(w["values"]))
    B, P = g["batch"], g["prompt_len"]
    prompts = prng.randint(prng.prng_key(g["seed"] + 1), (B, P), 0, cfg.vocab_size)
    np.testing.assert_array_equal(prompts.numpy(), np.array(g["prompts"]))
    assert len(g["steps"]) == g["gen_len"] == len(g["tokens"][0])
    for s, step in enumerate(g["steps"]):
        for b in range(B):
            assert step["top_ids"][b][0] == g["tokens"][b][s]
            assert step["lse"][b] >= step["max"][b] == step["top_logits"][b][0]
    r = g["routing"][0]
    C = tmoe._capacity(cfg, B * P)
    assert sum(r["loads"]) == B * P * cfg.top_k and r["capacity"] == C
    assert r["dropped"] == sum(max(n - C, 0) for n in r["loads"])
    for name in ("logits", "router_logits"):
        assert g["tolerance"][name] == max(10 * g["port_cpu_gap"][name], 1e-6)


# ---------------------------------------------------------------------------
# The golden file's writer (full width, on the CPU; not part of the tests)
# ---------------------------------------------------------------------------


def _peak_rss_gb():
    """This process's peak resident memory (``VmHWM``: of its own image,
    where ``ru_maxrss`` would carry the parent's over the port's exec)."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmHWM:"))
    return kb * 1024 / 1e9


def _pack(a):
    return base64.b64encode(np.ascontiguousarray(a, dtype="<f4").tobytes()).decode()


def _step_record(logits):
    lf = np.asarray(logits, np.float32)
    top = np.argsort(-lf, axis=-1, kind="stable")[:, :8]
    m = lf.max(-1)
    lse = m + np.log(np.exp(lf - m[:, None]).sum(-1, dtype=np.float64))
    return {"top_ids": top.tolist(), "top_logits": np.take_along_axis(lf, top, -1).astype(float).tolist(),
            "max": m.astype(float).tolist(), "lse": lse.astype(float).tolist()}


def _abs_sum(a):
    flat = np.asarray(a).reshape(-1)
    return float(sum(np.abs(flat[i:i + (1 << 24)]).sum(dtype=np.float64) for i in range(0, flat.size, 1 << 24)))


def _golden_cfg(get):
    return dataclasses.replace(get(KIMI)[0], n_layers=GOLDEN_LAYERS)


def _leaf_record(a, corner, layer):
    rows = np.asarray(a).reshape(-1, a.shape[-1])
    sample = rows[:2, :8] if corner == "head" else rows[-2:, -8:]
    return {"layer": layer, "corner": corner, "sample": sample.astype(float).tolist(), "abs_sum": _abs_sum(a)}


def write_golden():
    """The reference at full width, 1 layer: the leaves, the expert leaves
    window by window, the range-summed prefill and greedy decode; then the
    port's CPU gap in a second process."""
    cfg = _golden_cfg(jget_config)
    r = GOLDEN_RUN
    B, P, G = r["batch"], r["prompt_len"], r["gen_len"]
    key = jax.random.PRNGKey(r["seed"])
    t_all = t0 = time.time()
    params = jax.block_until_ready(ref_params(cfg, r["seed"]))
    init_s, init_rss = time.time() - t0, _peak_rss_gb()
    print(f"reference init_lm under jit, the expert leaves left out: {init_s:.1f} s, peak RSS {init_rss:.2f} GB",
          flush=True)
    leaves = {"embed": _leaf_record(params["embed"], "head", None),
              "lm_head": _leaf_record(params["lm_head"], "tail", None),
              "final_norm/scale": _leaf_record(params["final_norm"]["scale"], "head", None)}
    lp = params["layers"]
    for name, a, corner in (("norm1/scale", lp["norm1"]["scale"], "head"),
                            ("norm2/scale", lp["norm2"]["scale"], "tail"),
                            ("attn/wq", lp["attn"]["wq"], "head"), ("attn/wk", lp["attn"]["wk"], "tail"),
                            ("attn/wv", lp["attn"]["wv"], "head"), ("attn/wo", lp["attn"]["wo"], "tail"),
                            ("moe/wr", lp["moe"]["wr"], "head")):
        leaves[f"layers/{name}"] = _leaf_record(a[0], corner, 0)
    # the expert leaves, window by window: samples of the first and last experts, float64 sums of |w|, raw windows
    t0 = time.time()
    E, per = cfg.n_experts, cfg.d_model * cfg.d_ff
    windows = {}
    for nm, corner in (("wg", "head"), ("wu", "tail"), ("wd", "tail")):
        total = 0.0
        for e0 in range(0, E, RANGE):
            w = np.asarray(ref_expert_window(key, cfg, 0, nm, e0, RANGE))
            total += _abs_sum(w)
            if (corner == "head" and e0 == 0) or (corner == "tail" and e0 + RANGE == E):
                rows = w.reshape(-1, w.shape[-1])
                sample = rows[:2, :8] if corner == "head" else rows[-2:, -8:]
            del w
        leaves[f"layers/moe/{nm}"] = {"layer": 0, "corner": corner, "sample": sample.astype(float).tolist(),
                                      "abs_sum": total}
        windows[f"layers/moe/{nm}"] = [
            {"start": s, "n": WINDOW_N, "values": _pack(ref_flat_window(key, cfg, 0, nm, s, WINDOW_N))}
            for s in (0, 2**32 - WINDOW_N // 2, E * per - WINDOW_N) if s + WINDOW_N <= E * per]
    experts_s = time.time() - t0
    print(f"expert leaves window by window: {experts_s:.1f} s, peak RSS {_peak_rss_gb():.2f} GB", flush=True)

    prompts = jax.random.randint(jax.random.PRNGKey(r["seed"] + 1), (B, P), 0, cfg.vocab_size)
    t0 = time.time()
    with RefRangeMoE(cfg, key, RANGE) as patched:
        toks, steps = ref_serve(cfg, params, prompts, G)
    serve_s = time.time() - t0
    call = patched.calls[0]
    print(f"reference prefill + {G - 1} decode steps, the MoE over ranges of {RANGE} experts: {serve_s:.1f} s, "
          f"tokens {toks.tolist()}, routing dropped {call['dropped']}, margin {call['margin']:.3e}", flush=True)
    out = {
        "what": "JAX reference, kimi-k2-1t-a32b at full width with the depth cut to n_layers, float32, on the CPU: "
                "init_lm(PRNGKey(seed)) (under jit, the expert leaves drawn window by window through a key whose "
                "random_bits hashes offset + iota), prompts randint(PRNGKey(seed + 1), (batch, prompt_len), 0, "
                "vocab), jitted lm_prefill(pad_to=prompt_len + gen_len), then greedy jitted lm_decode_step; step 0 "
                "is the prefill's last-token logits.  apply_moe replaced in the writer's process by a pure_callback "
                "that sums the reference's _moe_local over ranges of experts (16 in prefill, the routed experts "
                "one by one in decode), each drawn as a window.  routing: layer 0's prefill call.  windows: raw "
                "float32 values (base64, little-endian) of each expert leaf at flat offsets",
        "writer": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_kimi.py",
        "arch": KIMI, "n_layers": GOLDEN_LAYERS, "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
        "n_experts": E, "top_k": cfg.top_k,
        "depth_cut": "61 -> 1 layer: one layer is 17.03 B float32 parameters beside 2.35 B of embedding and head "
                     "(77.5 GB); the card holds one",
        **r, "dtype": "float32", "moe_range": RANGE,
        "prompts": np.asarray(prompts).tolist(),
        "tokens": toks.tolist(),
        "steps": [_step_record(s) for s in steps],
        "top1_top2_margin_min": [float(np.min(np.diff(np.sort(s, -1)[:, -2:], axis=-1))) for s in steps],
        "routing": [{k: call[k] for k in ("loads", "dropped", "capacity", "margin")}],
        "leaves": leaves,
        "windows": windows,
        "writer_reference": {"init_s": init_s, "init_peak_rss_gb": init_rss, "expert_leaves_s": experts_s,
                             "serve_s": serve_s, "total_s": time.time() - t_all, "peak_rss_gb": _peak_rss_gb()},
    }
    with open(GOLDEN, "w") as f:
        json.dump(out, f)
    del params
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "steps.npy"), steps)
        np.save(os.path.join(d, "router_logits.npy"), call["logits"])
        print(f"wrote {GOLDEN}; measuring the port's CPU gap in a new process", flush=True)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--port-gap", d], env=env, check=True)


def _port_cpu_gap(d):
    """The port on the CPU (torch plane) at full width, 1 layer: its own
    draws (the router and the rest through ``init_lm``, the experts as
    windows in ``PortRangeMoE``), teacher-forced with the reference's
    tokens: its gaps to the reference's logits and router logits."""
    with open(GOLDEN) as f:
        g = json.load(f)
    cfg = _golden_cfg(get_config)
    t_all = t0 = time.time()
    ref_steps, ref_router = np.load(os.path.join(d, "steps.npy")), np.load(os.path.join(d, "router_logits.npy"))
    P, G = g["prompt_len"], g["gen_len"]
    with torch.inference_mode(), PortRangeMoE(cfg, g["moe_range"]) as port:
        model = tlm.init_lm(prng.prng_key(g["seed"]), cfg, device="cpu")
        print(f"port init_lm, the expert leaves left out: {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        prompts = torch.tensor(g["prompts"], dtype=torch.int32)
        tl, tc = lm_prefill(model, cfg, {"tokens": prompts}, pad_to=P + G, plane=ops.TORCH)
        gaps = [float(np.abs(tl.numpy() - ref_steps[0]).max())]
        print(f"port prefill: {time.time() - t0:.1f} s, gap {gaps[0]:.3e}", flush=True)
        for s in range(1, G):
            tl, tc = lm_decode_step(model, cfg, tc, {"token": torch.tensor(g["tokens"], dtype=torch.int32)[:, s - 1]})
            gaps.append(float(np.abs(tl.numpy() - ref_steps[s]).max()))
    call = port.calls[0]
    router_gap = float(np.abs(call["logits"] - ref_router).max())
    routing = {k: call[k] for k in ("loads", "dropped", "capacity", "margin")}
    print(f"port (CPU, torch plane): {time.time() - t_all:.1f} s; logit gaps {gaps}; router-logit gap {router_gap}; "
          f"dropped {routing['dropped']}", flush=True)
    ref = g["routing"][0]
    if ref["margin"] > 10 * router_gap:
        assert (routing["loads"], routing["dropped"]) == (ref["loads"], ref["dropped"]), (routing, ref)
    g["port_cpu_gap"] = {"logits": max(gaps), "router_logits": router_gap}
    g["port_cpu_logit_gap_per_step"] = gaps
    g["port_cpu_routing"] = [routing]
    g["port_cpu_gap_note"] = ("max |port - reference| over every logit of each step (the port on the CPU, torch "
                              "plane, its own draws, the MoE summed over the reference's ranges of experts, "
                              "teacher-forced with the reference's tokens) and over layer 0's prefill router logits")
    # the card is held to 10x the CPU's gaps (the rule of the other golden files), no tighter than 1e-6
    g["tolerance"] = {k: max(10 * v, 1e-6) for k, v in g["port_cpu_gap"].items()}
    g["writer_port"] = {"total_s": time.time() - t_all, "peak_rss_gb": _peak_rss_gb(),
                        "torch_threads": torch.get_num_threads()}
    with open(GOLDEN, "w") as f:
        json.dump(g, f)
    print(f"port on the CPU: gaps {g['port_cpu_gap']}; tolerances {g['tolerance']}")


if __name__ == "__main__":
    sys.exit(_port_cpu_gap(sys.argv[2]) if sys.argv[1:2] == ["--port-gap"] else write_golden())
