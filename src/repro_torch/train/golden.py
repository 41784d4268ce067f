"""The training golden files: what a run records and how two records compare.

``data/golden_train_stablelm.json`` holds the JAX reference's training run
at stablelm-1.6b's full width (its writer is ``tests/test_torch_train.py``
run as a script).  A run of either package is reduced to ``train_record``:
per-step losses and grad_norms, and the float64 sum and |sum| of named
leaves of the parameters, ``m`` and ``v``.  ``port_run`` runs the file's
spec through the port on a device, and ``rel_gaps`` is the one rule by
which the port's record is held to the reference's, on the CPU and on the
card, against the file's ``tolerance``.

``data/golden_train_llama4_scout_mesh.json`` holds the reference's
gradient of ``lm_loss`` at llama4-scout's full width on several meshes
(its writer is ``tests/test_torch_mesh_train.py`` run as a script):
``mesh_record`` is the port's counterpart on a mesh, ``mesh_gaps`` and
``routing_checks`` the rules it is held by.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import moe
from repro_torch.models.lm import LM, init_lm, lm_loss
from repro_torch.optim.optimizers import global_norm
from repro_torch.sharding import AxisRules
from repro_torch.train.steps import build_train_step

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
GOLDEN_TRAIN = os.path.join(DATA, "golden_train_stablelm.json")
GOLDEN_TRAIN_MESH = os.path.join(DATA, "golden_train_llama4_scout_mesh.json")
# the mesh file's run: llama4-scout at full width, depth cut to n_layers, one value_and_grad of lm_loss at
# batch x seq on each (data, model) mesh
MESH_RUN = dict(seed=0, n_layers=1, batch=2, seq=512, meshes=((1, 1), (1, 4), (2, 2)))
# leaves in the reference's tree (layers stacked): both embeddings, a norm, a projection of each sublayer
LEAVES = ("embed", "lm_head", "final_norm/scale", "layers/attn/wq", "layers/mlp/wd", "layers/norm1/bias")


def _leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


def _sums(a):
    """float64 sum and |sum| of a tensor (on its device, 2**24 elements at a
    time) or an array."""
    if isinstance(a, torch.Tensor):
        parts = [p.double() for p in a.detach().reshape(-1).split(1 << 24)]
        return sum(float(p.sum()) for p in parts), sum(float(p.abs().sum()) for p in parts)
    a = np.asarray(a, np.float64)
    return float(a.sum()), float(np.abs(a).sum())


def train_record(losses: Sequence[float], gnorms: Sequence[float], params: Dict, opt: Dict,
                 names: Iterable[str] = LEAVES) -> Dict:
    """A run's record: per-step losses and grad_norms, and the float64 sum
    and |sum| of the ``names`` leaves of ``params``, ``opt["m"]`` and
    ``opt["v"]``, each a tree in the reference's layout (layers stacked)."""
    sums = {}
    for part, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        for name in names:
            s, a = _sums(_leaf(tree, name))
            sums[f"{part}/{name}"] = {"sum": s, "abs_sum": a}
    return {"losses": [float(x) for x in losses], "grad_norms": [float(x) for x in gnorms], "leaf_sums": sums}


def rel_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """Largest relative gap per family between record ``got`` and reference
    ``want``; a leaf's sum and |sum| are both taken relative to its |sum| (a
    sum of both signs may lie near zero)."""
    def rel(x, y, scale=None):
        return abs(x - y) / max(abs(y if scale is None else scale), 1e-30)

    return {
        "loss": max(rel(x, y) for x, y in zip(got["losses"], want["losses"])),
        "grad_norm": max(rel(x, y) for x, y in zip(got["grad_norms"], want["grad_norms"])),
        "leaf_sums": max(rel(got["leaf_sums"][k][s], want["leaf_sums"][k][s], want["leaf_sums"][k]["abs_sum"])
                         for k in want["leaf_sums"] for s in ("sum", "abs_sum")),
    }


def port_run(golden: Dict, device="cuda") -> Tuple[Dict, List]:
    """The golden file's run through the port on ``device``: its own
    ``init_lm``, pipeline and train step at the file's config, batch and
    steps.  Returns the run's record (over the file's leaves) and each
    step's pipeline tokens, as lists."""
    cfg = dataclasses.replace(get_config(golden["arch"])[0], n_layers=golden["n_layers"])
    params = init_lm(prng.prng_key(golden["seed"]), cfg, torch.float32, device=device)
    step_fn, opt = build_train_step(cfg, golden["optimizer"])
    state = opt.init(dict(params.named_parameters()))
    init, nxt = make_pipeline(cfg.vocab_size, golden["batch"], golden["seq"], seed=golden["seed"], device=device)
    ds, losses, gnorms, tokens = init(), [], [], []
    for step in range(golden["steps"]):
        ds, b = nxt(ds)
        tokens.append(b["tokens"].cpu().tolist())
        params, state, m = step_fn(params, state, step, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    names = sorted({k.split("/", 1)[1] for k in golden["leaf_sums"]})
    record = train_record(losses, gnorms, convert.stack_named(params.state_dict(), cfg),
                          convert.opt_state_to_tree(state, cfg), names)
    return record, tokens


def mesh_config(golden: Dict, get=get_config):
    """The mesh file's config: its arch at full width, depth cut."""
    return dataclasses.replace(get(golden["arch"])[0], n_layers=golden["n_layers"])


def mesh_tokens(golden: Dict, device) -> torch.Tensor:
    """The mesh file's tokens (and labels): ``randint(PRNGKey(seed + 1),
    (batch, seq), 0, vocab)``."""
    V = mesh_config(golden).vocab_size
    return prng.randint(prng.prng_key(golden["seed"] + 1, device), (golden["batch"], golden["seq"]), 0, V)


def mesh_rules(golden: Dict, mesh: str, device) -> AxisRules:
    """The arch's rules on a ``"dxm"`` mesh whose every shard is on ``device``."""
    d, m = map(int, mesh.split("x"))
    return AxisRules(make_host_mesh(d, m, devices=(device,) * (d * m)), get_config(golden["arch"])[1])


def mesh_record(params: LM, cfg, shd: AxisRules, tokens) -> Tuple[Dict, List]:
    """The port's counterpart of one of the file's records: ``lm_loss`` and
    its gradient on ``shd``, the global norm (``optimizers.global_norm``),
    the float64 sum and |sum| of each of the reference's leaves (a layer's
    leaf summed over the layers), and per layer and data shard the MoE's
    ``route_stats``.  Also returns the recorded calls (their router
    logits).  The gradients are dropped before it returns."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    with moe.Record() as rec, torch.enable_grad():
        loss = lm_loss(params, cfg, {"tokens": tokens, "labels": tokens}, shd=shd)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    sums = {}
    for name, g in grads.items():
        leaf = "/".join(p for p in name.split(".") if not p.isdigit())
        s, a = _sums(g)
        acc = sums.setdefault(leaf, {"sum": 0.0, "abs_sum": 0.0})
        acc["sum"] += s
        acc["abs_sum"] += a
    record = {"loss": float(loss.detach()), "grad_norm": float(global_norm(grads)), "leaf_sums": sums,
              "routing": [[moe.route_stats(cfg, c) for c in moe.split_call(call)] for call in rec.calls]}
    return record, rec.calls


ROUTER_LEAF = "layers/moe/wr"


def mesh_gaps(got: Dict, want: Dict, cfg) -> Dict[str, float]:
    """``rel_gaps`` of one mesh's record against the file's.  At top-1 the
    router's gradient is rounding noise (the gate is p / p), so its leaf
    sums are held apart, absolutely (``router_leaf_abs``)."""
    noise = {ROUTER_LEAF} if cfg.is_moe and cfg.top_k == 1 else set()

    def as_run(r):
        return {"losses": [r["loss"]], "grad_norms": [r["grad_norm"]],
                "leaf_sums": {k: v for k, v in r["leaf_sums"].items() if k not in noise}}

    gaps = rel_gaps(as_run(got), as_run(want))
    if noise:
        gaps["router_leaf_abs"] = max(abs(got["leaf_sums"][k][s] - want["leaf_sums"][k][s])
                                      for k in noise for s in ("sum", "abs_sum"))
    return gaps


def routing_checks(got: List, want: List, router_gap: float) -> List[Dict]:
    """Each layer and data shard of a record against the file's: held
    (loads and drops must be equal) where the reference's smallest router
    margin exceeds 10x the port's CPU router-logit gap, else only shown."""
    return [{"layer": i, "shard": j, "held": w["margin"] > 10 * router_gap,
             "equal": (g["loads"], g["dropped"]) == (w["loads"], w["dropped"]), "got": g, "want": w}
            for i, (gl, wl) in enumerate(zip(got, want)) for j, (g, w) in enumerate(zip(gl, wl))]
