"""The port's rotary table against the reference's under ``jit`` (ROADMAP.md
C.20), on the CPU.

The reference's launchers run the model jitted, and under ``jit`` XLA
computes ``rope_freqs``' ``1 / theta ** (2i / rot)`` as ``pow(theta, -e)``
(the rewrite C.14 found in M-RoPE and the Whisper sinusoid).  The port's
``rope_freqs`` is that table (``jit_freqs`` over the rotated slice):

* bitwise the jitted reference's ``rope_freqs`` at every arch's
  (head_dim, rope_pct, rope_theta);
* ``apply_rope`` within 1e-6 of the jitted reference's at positions 0 to
  2079 (x of std 1) at five settings, among them each dense and MoE
  config's;
* the eager table differs from the jitted one in some bands at each of
  those settings, and so does torch's ``1 / theta ** e``: a port of the
  eager form would miss the jitted reference by up to 4.7e-4 there.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS, get_config as jget_config
from repro.layers import common as jcommon
from repro_torch.configs import ARCH_IDS
from repro_torch.layers import common

# (head_dim, rope_pct, theta): stablelm-1.6b, llama4-scout, nemotron-4-15b, qwen2.5-32b, command-r-35b, and the
# bands where the jitted table differs from the eager one (measured)
SETTINGS = {"stablelm": (64, 0.25, 1e4, 3), "llama4-scout": (128, 1.0, 5e5, 18), "nemotron": (128, 0.5, 1e4, 10),
            "qwen2.5": (128, 1.0, 1e6, 25), "command-r": (128, 1.0, 8e6, 13)}
ROPE_TOL = 1e-6  # absolute, x of std 1 (measured 4.77e-7 at each setting: the rotation's own rounding)
N_POS = 2080  # the serving prompts' 2048 tokens and 32 decode steps


def _jit_table(head_dim, pct, theta):
    return np.asarray(jax.jit(jcommon.rope_freqs, static_argnums=(0, 1, 2))(head_dim, pct, theta))


def _rope_inputs(Dh):
    """x (1, N_POS, 4, Dh) of std 1 from seed 0, positions 0..N_POS-1."""
    x = np.random.default_rng(0).standard_normal((1, N_POS, 4, Dh)).astype(np.float32)
    return x, np.arange(N_POS, dtype=np.int32)[None]


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_rope_freqs_is_the_jitted_reference_table(arch):
    assert arch in ARCH_IDS
    cfg = jget_config(arch)[0]
    got = common.rope_freqs(cfg.head_dim, cfg.rope_pct, cfg.rope_theta)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _jit_table(cfg.head_dim, cfg.rope_pct, cfg.rope_theta))


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_apply_rope_matches_the_jitted_reference(setting):
    Dh, pct, theta, _ = SETTINGS[setting]
    x, pos = _rope_inputs(Dh)
    want = np.asarray(jax.jit(jcommon.apply_rope, static_argnums=(2, 3))(x, pos, pct, theta))
    got = common.apply_rope(torch.tensor(x), torch.tensor(pos), pct, theta).numpy()
    rot = int(Dh * pct)
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])  # the slice past rope_pct is kept
    np.testing.assert_allclose(got, want, atol=ROPE_TOL, rtol=0)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_the_eager_table_differs_from_the_jitted_one(setting):
    """Why the port takes the jitted table: the reference's eager table and
    torch's ``1 / theta ** e`` each miss it in some bands, by an ulp of
    the band's frequency, which the angle at position p carries p times:
    rotated by torch's table, x misses the jitted reference by more than
    10x ``ROPE_TOL`` (measured 2.97e-5 to 4.71e-4)."""
    Dh, pct, theta, n_eager = SETTINGS[setting]
    want = _jit_table(Dh, pct, theta)
    eager = np.asarray(jcommon.rope_freqs(Dh, pct, theta))
    assert int((eager != want).sum()) == n_eager
    rot = int(Dh * pct)
    naive = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32) / rot))
    assert (naive.numpy() != want).any()
    x, pos = _rope_inputs(Dh)
    ang = torch.tensor(pos)[..., None].float() * naive
    xt = torch.tensor(x)
    got = torch.cat([common.rotate_halves(xt[..., :rot], ang.cos()[..., None, :], ang.sin()[..., None, :]),
                     xt[..., rot:]], dim=-1).numpy()
    ref = np.asarray(jax.jit(jcommon.apply_rope, static_argnums=(2, 3))(x, pos, pct, theta))
    assert np.abs(got - ref).max() > 10 * ROPE_TOL


def test_rope_table_made_in_inference_mode_serves_autograd():
    """The table is made once per (rot, theta, device), outside inference
    mode even when a serve asks first, so a training step may take it."""
    common._ROPE_TABLES.clear()
    with torch.inference_mode():
        t = common.rope_freqs(32, 1.0, 3e5)
    assert not t.is_inference() and common.rope_freqs(32, 1.0, 3e5) is t
    x = torch.randn(1, 5, 2, 32, requires_grad=True)
    common.apply_rope(x, torch.arange(5)[None], 1.0, 3e5).square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
