"""The optimizers' in-place update and the train step's in-place gradient
accumulation, bitwise against the out-of-place formulas they replaced.

``adamw().update`` and ``momentum_bf16().update`` clip the gradients they
are given in place and update the parameters and state with leaf-sized
temporaries reused; ``build_train_step`` sums a microbatched batch's
gradients into zeros with ``add_`` and divides them with ``div_``.  The
formulas below are the port's earlier out-of-place ones, kept here as
plain functions: every bit of the parameters, m and v (and of the clipped
gradients) must be theirs, for float32 and bfloat16 gradients.
``tests/test_torch_optim.py`` and ``tests/test_torch_train.py`` hold the
optimizers and the train step against the JAX reference.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import prng
from repro_torch.models.lm import init_lm, lm_loss
from repro_torch.optim import optimizers as topt
from repro_torch.train.steps import build_train_step

f = np.float32
PEAK_LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread while this file runs (tier-1 runs
    several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, dtype=torch.float32, scale=1.0):
    """A flat parameter tree of a stacked leaf's layers, a matrix, a vector
    and a scalar leaf, drawn with numpy; a few exact zeros and -0.0s."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (64, 16), "final_norm.scale": (16,), "layers.0.w": (16, 24), "layers.1.w": (16, 24),
              "layers.0.b": (24,), "layers.1.b": (24,), "gate": ()}
    out = {}
    for n, s in shapes.items():
        a = (rng.standard_normal(s) * scale).astype(np.float32)
        if a.ndim:
            a.reshape(-1)[:3] = (0.0, -0.0, 0.0)
        out[n] = torch.tensor(a).to(dtype)
    return out


def plain_clip(grads, max_norm):
    gn = topt.global_norm(grads)
    scale = torch.clamp(float(np.float32(max_norm)) / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gn


def plain_adamw(grads, state, params, step, peak_lr=PEAK_LR, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                max_grad_norm=1.0):
    lr = topt.wsd_schedule(peak_lr)
    grads, gnorm = plain_clip(grads, max_grad_norm)
    t = f(int(step)) + f(1)
    bc1 = float(f(1) - f(b1) ** t)
    bc2 = float(f(1) - f(b2) ** t)
    lr_t = float(lr(step))
    c1, c2 = float(f(1 - b1)), float(f(1 - b2))
    for n, p in params.items():
        g = grads[n].float()
        m, v = state["m"][n], state["v"][n]
        m.mul_(float(f(b1))).add_(c1 * g)
        v.mul_(float(f(b2))).add_(c2 * g.square())
        u = (m / bc1) / (torch.sqrt(v / bc2) + float(f(eps))) + float(f(weight_decay)) * p.float()
        p.copy_((p.float() - lr_t * u).to(p.dtype))
    return params, state, gnorm, grads


def plain_momentum_bf16(grads, state, params, step, peak_lr=PEAK_LR, beta=0.9, weight_decay=0.0, max_grad_norm=1.0):
    lr = topt.wsd_schedule(peak_lr)
    grads, gnorm = plain_clip(grads, max_grad_norm)
    lr_t = float(lr(step))
    for n, p in params.items():
        m = state["m"][n]
        m.copy_((float(f(beta)) * m.float() + grads[n].float()).to(torch.bfloat16))
        u = m.float() + float(f(weight_decay)) * p.float()
        p.copy_((p.float() - lr_t * u).to(p.dtype))
    return params, state, gnorm, grads


PLAIN = {"adamw": plain_adamw, "momentum_bf16": plain_momentum_bf16}


def _bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got.view(-1).view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32),
                       want.view(-1).view(torch.int16 if want.dtype == torch.bfloat16 else torch.int32)), what


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["f32_grads", "bf16_grads"])
@pytest.mark.parametrize("name", ["adamw", "momentum_bf16"])
@pytest.mark.parametrize("max_norm_scale", [3.0, 0.01], ids=["clipped", "unclipped"])
def test_update_in_place_is_the_out_of_place_formula(name, grad_dtype, max_norm_scale):
    """Three steps of the same gradients: the in-place update's parameters,
    state and norm bitwise the plain formula's, and the clipped gradients
    written into the storages the caller passed."""
    opt = topt.make_optimizer(name, peak_lr=PEAK_LR)
    params = _tree(0)
    want_p = copy.deepcopy(params)
    state = opt.init(params)
    want_s = copy.deepcopy(state)
    for step in range(3):
        grads = _tree(10 + step, grad_dtype, scale=max_norm_scale)
        plain_in = copy.deepcopy(grads)
        ptrs = {n: g.data_ptr() for n, g in grads.items()}
        _, state, gn = opt.update(grads, state, params, step)
        want_p, want_s, want_gn, clipped = PLAIN[name](plain_in, want_s, want_p, step)
        _bitwise(gn, want_gn, "grad norm")
        for n in params:
            assert grads[n].data_ptr() == ptrs[n], n
            _bitwise(grads[n], clipped[n], f"step {step} clipped {n}")
            _bitwise(params[n], want_p[n], f"step {step} param {n}")
            for k in state:
                _bitwise(state[k][n], want_s[k][n], f"step {step} {k} {n}")


def test_clip_in_place_copies_a_gradient_it_cannot_write():
    """A gradient that two entries hold, or whose elements overlap (an
    expanded tensor), is clipped as a copy: each entry scaled once."""
    grads = _tree(3, scale=3.0)
    shared = grads["layers.0.b"]
    grads["layers.1.b"] = shared
    grads["gate"] = torch.tensor(2.5).expand(5)
    want, want_gn = plain_clip(grads, 1.0)
    got, gn = topt.clip_by_global_norm_(dict(grads), 1.0)
    _bitwise(gn, want_gn, "grad norm")
    for n in want:
        _bitwise(got[n], want[n], n)
    assert got["layers.0.b"].data_ptr() == shared.data_ptr() != got["layers.1.b"].data_ptr()


def _plain_train_step(cfg, name, params, state, step, batch):
    """``build_train_step``'s microbatched step as it was: out-of-place sums
    and division, then the plain update."""
    acc_dtype = torch.float32 if name == "adamw" else torch.bfloat16
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    g_acc = {n: torch.zeros(p.shape, dtype=acc_dtype) for n, p in named.items()}
    l_acc = torch.zeros((), dtype=torch.float32)
    n_micro = batch["tokens"].shape[0]
    for i in range(n_micro):
        loss = lm_loss(params, cfg, {k: v[i] for k, v in batch.items()})
        g = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        for n in named:
            g_acc[n] = g_acc[n] + g[n].to(acc_dtype)
        l_acc = l_acc + loss.detach()
    grads = {n: g / n_micro for n, g in g_acc.items()}
    with torch.no_grad():
        _, state, gn, _ = PLAIN[name](grads, state, named, step, peak_lr=3e-4)  # make_optimizer's default
    return l_acc / n_micro, gn


@pytest.mark.parametrize("name", ["adamw", "momentum_bf16"])
def test_accumulation_in_place_is_the_out_of_place_sum(name):
    """Two steps of a (2, 2, 16) microbatched batch through
    ``build_train_step`` (float32 sums for AdamW, bfloat16 for bf16
    momentum), bitwise the out-of-place sums, division and update."""
    cfg = reduced_config("stablelm-1.6b")
    model = init_lm(prng.prng_key(0), cfg, torch.float32, device="cpu")
    plain = copy.deepcopy(model)
    step_fn, opt = build_train_step(cfg, name)
    state = opt.init(dict(model.named_parameters()))
    plain_state = copy.deepcopy(state)
    rng = np.random.default_rng(5)
    for step in range(2):
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 2, 16)).astype(np.int32))
        batch = {"tokens": toks, "labels": toks}
        model, state, m = step_fn(model, state, step, batch)
        want_loss, want_gn = _plain_train_step(cfg, name, plain, plain_state, step, batch)
        _bitwise(m["loss"], want_loss, "loss")
        _bitwise(m["grad_norm"], want_gn, "grad norm")
        got_p, want_p = dict(model.named_parameters()), dict(plain.named_parameters())
        for n in got_p:
            _bitwise(got_p[n].detach(), want_p[n].detach(), f"step {step} {n}")
            for k in state:
                _bitwise(state[k][n], plain_state[k][n], f"step {step} {k} {n}")
