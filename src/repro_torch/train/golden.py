"""The training golden files: what a run records and how two records compare.

``data/golden_train_stablelm.json`` holds the JAX reference's training run
at stablelm-1.6b's full width (its writer is ``tests/test_torch_train.py``
run as a script).  A run of either package is reduced to ``train_record``:
per-step losses and grad_norms, and the float64 sum and |sum| of named
leaves of the parameters, ``m`` and ``v``.  ``port_run`` runs the file's
spec through the port on a device, and ``rel_gaps`` is the one rule by
which the port's record is held to the reference's, on the CPU and on the
card, against the file's ``tolerance``.

``data/golden_train_{falcon_mamba,recurrentgemma,whisper}.json`` hold the
same record for the SSM, hybrid and encoder-decoder families
(``GOLDEN_TRAIN_FAMILIES``; their writer is
``tests/test_torch_train_families.py`` run as a script), each over leaves
of its own family and each at the cut its file states.  An
encoder-decoder's file also holds the sha256 of each step's frames
(``batch_draws``), which are too many to keep.

``data/golden_train_llama4_scout_mesh.json`` holds the reference's
gradient of ``lm_loss`` at llama4-scout's full width on several meshes
(its writer is ``tests/test_torch_mesh_train.py`` run as a script), and
``data/golden_train_qwen2_vl.json`` its gradient at qwen2-vl-72b's full
width on one request holding an image (``VLM_RUN``; its writer is
``tests/test_torch_vlm_train.py`` run as a script): ``grad_record`` is the
port's counterpart of either, on one device or a mesh, ``grad_gaps`` and
``routing_checks`` the rules it is held by.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import vlm_layout
from repro_torch.layers import moe
from repro_torch.models.lm import LM, init_lm, lm_loss
from repro_torch.optim.optimizers import global_norm
from repro_torch.sharding import AxisRules
from repro_torch.train.steps import build_train_step, train_batches

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
GOLDEN_TRAIN = os.path.join(DATA, "golden_train_stablelm.json")
GOLDEN_TRAIN_MESH = os.path.join(DATA, "golden_train_llama4_scout_mesh.json")
GOLDEN_TRAIN_VLM = os.path.join(DATA, "golden_train_qwen2_vl.json")
GOLDEN_TRAIN_FAMILIES = {arch: os.path.join(DATA, f"golden_train_{stem}.json") for arch, stem in (
    ("falcon-mamba-7b", "falcon_mamba"), ("recurrentgemma-2b", "recurrentgemma"), ("whisper-small", "whisper"))}
# the mesh file's run: llama4-scout at full width, depth cut to n_layers, one value_and_grad of lm_loss at
# batch x seq on each (data, model) mesh
MESH_RUN = dict(seed=0, n_layers=1, batch=2, seq=512, meshes=((1, 1), (1, 4), (2, 2)))
# the VLM file's run: qwen2-vl-72b at full width, depth cut to n_layers, one value_and_grad of lm_loss on batch x seq
# tokens holding an image grid (offset, (t, h, w)) of the reserved last id at Qwen2-VL's M-RoPE positions (the
# serving golden file's layout: 64 text tokens, a 1 x 32 x 32 grid, 960 text tokens)
VLM_RUN = dict(seed=0, n_layers=1, batch=1, seq=2048, image=(64, (1, 32, 32)))
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


def _host(a) -> np.ndarray:
    """A tensor (on any device) or an array, as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def frames_sha256(frames) -> str:
    """sha256 of a float32 frames tensor's (or array's) bytes, in C order."""
    return hashlib.sha256(np.ascontiguousarray(_host(frames), np.float32).tobytes()).hexdigest()


def batch_draws(batches: Sequence[Dict]) -> Dict[str, List]:
    """What a file keeps of each step's batch: its tokens (lists), and for
    an encoder-decoder the sha256 of its frames (``frames_sha256``)."""
    out = {"tokens": [_host(b["tokens"]).tolist() for b in batches]}
    if batches and "frames" in batches[0]:
        out["frames_sha256"] = [frames_sha256(b["frames"]) for b in batches]
    return out


def draw_mismatches(draws: Dict[str, List], golden: Dict) -> List[str]:
    """The steps at which a run's draws (``batch_draws``) differ from the
    file's, as ``"<key> at step <i>"``; empty when every draw is bitwise."""
    bad = []
    for key in ("tokens", "frames_sha256"):
        if key in golden:
            got = draws.get(key, [])
            bad += [f"{key} at step {i}" for i, want in enumerate(golden[key]) if i >= len(got) or got[i] != want]
    return bad


def file_config(golden: Dict, get=get_config):
    """A training file's config: its arch at full width, depth cut to its
    ``n_layers`` (an encoder-decoder's decoder; its encoder stays whole)."""
    return dataclasses.replace(get(golden["arch"])[0], n_layers=golden["n_layers"])


def port_run(golden: Dict, device="cuda", cfg=None) -> Tuple[Dict, Dict[str, List]]:
    """The golden file's run through the port on ``device``: its own
    ``init_lm``, the training launcher's batches (``train_batches``) and
    train step, at the file's config (or ``cfg``), batch and steps.
    Returns the run's record (over the file's leaves) and its draws
    (``batch_draws``)."""
    cfg = cfg or file_config(golden)
    params = init_lm(prng.prng_key(golden["seed"]), cfg, torch.float32, device=device)
    step_fn, opt = build_train_step(cfg, golden["optimizer"])
    state = opt.init(dict(params.named_parameters()))
    init, nxt = train_batches(cfg, golden["batch"], golden["seq"], seed=golden["seed"], device=device)
    ds, losses, gnorms, batches = init(), [], [], []
    for step in range(golden["steps"]):
        ds, b = nxt(ds)
        batches.append(b)
        params, state, m = step_fn(params, state, step, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    names = sorted({k.split("/", 1)[1] for k in golden["leaf_sums"]})
    record = train_record(losses, gnorms, convert.stack_named(params.state_dict(), cfg),
                          convert.opt_state_to_tree(state, cfg), names)
    return record, batch_draws(batches)


def mesh_tokens(golden: Dict, device) -> torch.Tensor:
    """The mesh file's tokens (and labels): ``randint(PRNGKey(seed + 1),
    (batch, seq), 0, vocab)``."""
    V = file_config(golden).vocab_size
    return prng.randint(prng.prng_key(golden["seed"] + 1, device), (golden["batch"], golden["seq"]), 0, V)


def vlm_batch(golden: Dict, device) -> Dict[str, torch.Tensor]:
    """The VLM file's batch: ``mesh_tokens`` with the image's tokens set to
    the last vocabulary id, as labels too, and the (batch, 3, seq) M-RoPE
    positions of ``launch.serve.vlm_layout`` for the file's image."""
    V = file_config(golden).vocab_size
    offset, grid = golden["image"]
    ids, mask, _ = vlm_layout(golden["seq"], (offset, tuple(grid)), device=device)
    tokens = mesh_tokens(golden, device).masked_fill(mask, V - 1)
    positions = ids.expand(golden["batch"], 3, golden["seq"]).contiguous()
    return {"tokens": tokens, "labels": tokens, "positions": positions}


def mesh_rules(golden: Dict, mesh: str, device) -> AxisRules:
    """The arch's rules on a ``"dxm"`` mesh whose every shard is on ``device``."""
    d, m = map(int, mesh.split("x"))
    return AxisRules(make_host_mesh(d, m, devices=(device,) * (d * m)), get_config(golden["arch"])[1])


def grad_record(params: LM, cfg, batch: Dict, shd: AxisRules = None) -> Tuple[Dict, List]:
    """The port's counterpart of a gradient file's record: ``lm_loss`` of
    ``batch`` and its gradient on ``shd``'s mesh (None: one device), the
    global norm (``optimizers.global_norm``), the float64 sum and |sum| of
    each of the reference's leaves (a layer's leaf summed over the layers),
    and, for an MoE config, per layer and data shard the MoE's
    ``route_stats``.  Also returns the recorded MoE calls (their router
    logits; none without experts).  The gradients are dropped before it
    returns."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    with (moe.Record() if cfg.is_moe else contextlib.nullcontext()) as rec, torch.enable_grad():
        loss = lm_loss(params, cfg, batch, shd=shd)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    record = {"loss": float(loss.detach()), "grad_norm": float(global_norm(grads)), "leaf_sums": {}}
    for name in list(grads):
        leaf = "/".join(p for p in name.split(".") if not p.isdigit())
        s, a = _sums(grads.pop(name))
        acc = record["leaf_sums"].setdefault(leaf, {"sum": 0.0, "abs_sum": 0.0})
        acc["sum"] += s
        acc["abs_sum"] += a
    if not cfg.is_moe:
        return record, []
    record["routing"] = [[moe.route_stats(cfg, c) for c in moe.split_call(call)] for call in rec.calls]
    return record, rec.calls


ROUTER_LEAF = "layers/moe/wr"


def grad_gaps(got: Dict, want: Dict, cfg) -> Dict[str, float]:
    """``rel_gaps`` of one ``grad_record`` against the file's.  At top-1 the
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
