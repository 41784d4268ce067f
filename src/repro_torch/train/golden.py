"""The training golden file: what a run records and how two records compare.

``data/golden_train_stablelm.json`` holds the JAX reference's training run
at stablelm-1.6b's full width (its writer is ``tests/test_torch_train.py``
run as a script).  A run of either package is reduced to ``train_record``:
per-step losses and grad_norms, and the float64 sum and |sum| of named
leaves of the parameters, ``m`` and ``v``.  ``port_run`` runs the file's
spec through the port on a device, and ``rel_gaps`` is the one rule by
which the port's record is held to the reference's, on the CPU and on the
card, against the file's ``tolerance``.
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
from repro_torch.models.lm import init_lm
from repro_torch.train.steps import build_train_step

GOLDEN_TRAIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                            "golden_train_stablelm.json")
# leaves in the reference's tree (layers stacked): both embeddings, a norm, a projection of each sublayer
LEAVES = ("embed", "lm_head", "final_norm/scale", "layers/attn/wq", "layers/mlp/wd", "layers/norm1/bias")


def _leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


def _sums(a):
    """float64 sum and |sum| of a tensor (on its device) or an array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().double()
        return float(a.sum()), float(a.abs().sum())
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
