"""Dev smoke of the PyTorch/CUDA port (port of ``scripts/dev_smoke.py``):
the protocol-engine matrix, then each reduced LM config's forward, AdamW
step, prefill and decode, with the prefill and decode held to the forward.

    PYTHONPATH=src python scripts/torch_dev_smoke.py --fast                 # on the card
    PYTHONPATH=src python scripts/torch_dev_smoke.py --fast --device cpu stablelm-1.6b
    PYTHONPATH=src python scripts/torch_dev_smoke.py --skip-lm --device cpu  # sequential matrix

``--fast`` runs each protocol's {RPC, one-sided} pair as one 2-config
``repro_torch.api`` bucket; without it each cell is a 1-config plan of its
own, the sequential reference, whose commit counts must equal the batched
run's.  The reference's fake-host-device flags have no counterpart: the
port's meshes take a device list (``launch/mesh.py``).
"""
from __future__ import annotations

import argparse
import copy
import math
import os
import sys

# runnable as `python scripts/torch_dev_smoke.py` from a checkout
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import torch  # noqa: E402

B, S = 2, 64
MATRIX_KW = dict(n_nodes=2, coroutines=6, records_per_node=256, ticks=48, warmup=8)
CONSISTENCY_TOL = 2e-2


def batch_for(cfg, device):
    """The reference's batch: tokens and labels ``randint(PRNGKey(0))``, an
    encoder-decoder's frames ``normal(PRNGKey(0))``, M-RoPE's text-only
    positions."""
    from repro_torch.core import prng

    key = prng.prng_key(0, device)
    tokens = prng.randint(key, (B, S), 0, cfg.vocab_size)
    b = {"tokens": tokens, "labels": tokens}
    if cfg.encoder_decoder:
        b["frames"] = prng.normal(key, (B, cfg.enc_seq_len, cfg.d_model))
    if cfg.mrope_sections is not None:
        b["positions"] = torch.arange(S, dtype=torch.int32, device=device)[None, None].expand(B, 3, S)
    return b


def protocol_matrix(fast: bool, device: str = "cuda"):
    """Every REGISTERED protocol x {rpc, one-sided} commits transactions.
    Returns {protocol: (rpc commits, one-sided commits)}."""
    from repro_torch.api import ExperimentSpec, run
    from repro_torch.core.costmodel import ONE_SIDED, RPC
    from repro_torch.core.registry import protocol_names

    planes = [{"hybrid": (RPC,) * 6}, {"hybrid": (ONE_SIDED,) * 6}]
    out = {}
    for proto in protocol_names():
        if fast:
            # one 2-config bucket per protocol
            rows = run(ExperimentSpec(protocol=proto, workload="smallbank", configs=planes, device=device,
                                      **MATRIX_KW)).rows
        else:
            # the sequential reference: one 1-config plan per cell
            rows = [run(ExperimentSpec(protocol=proto, workload="smallbank", configs=[p], device=device,
                                       **MATRIX_KW)).row for p in planes]
        for impl, m in zip(("rpc", "one_sided"), rows):
            if not (m["commits"] > 0 and m["abort_rate"] < 1.0):
                raise AssertionError((proto, impl, m))
        out[proto] = (rows[0]["commits"], rows[1]["commits"])
        print(f"    {proto}: ok (commits rpc={rows[0]['commits']} one_sided={rows[1]['commits']})", flush=True)
    print("protocol matrix ok", flush=True)
    return out


@torch.inference_mode()
def _consistency(params, cfg, batch):
    """prefill(4) logits against the forward's position 3, and decode of
    token 4 against its position 4: the largest absolute gaps."""
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import lm_apply

    tp = 4
    fb = {"tokens": batch["tokens"][:, : tp + 1]}
    if "frames" in batch:
        fb["frames"] = batch["frames"]
    if "positions" in batch:
        fb["positions"] = batch["positions"][:, :, : tp + 1]
    full = lm_apply(params, cfg, fb)
    pb = {"tokens": fb["tokens"][:, :tp]}
    if "frames" in fb:
        pb["frames"] = fb["frames"]
    if "positions" in fb:
        pb["positions"] = fb["positions"][:, :, :tp]
    lg_p, c = lm_prefill(params, cfg, pb, pad_to=tp + 4)
    err_p = float((lg_p - full[:, tp - 1]).abs().max())
    dbt = {"token": fb["tokens"][:, tp]}
    if cfg.mrope_sections is not None:
        dbt["positions"] = torch.full((B, 3), tp, dtype=torch.int32, device=full.device)
    lg_d, _ = lm_decode_step(params, cfg, c, dbt)
    err_d = float((lg_d - full[:, tp]).abs().max())
    return err_p, err_d


def lm_checks(arch_ids, device: str = "cuda"):
    """Each reduced arch: forward, one AdamW step, prefill and decode, then
    the prefill-vs-forward and decode-vs-forward gaps under 2e-2.  Returns
    {arch: {"loss", "err_prefill", "err_decode"}}."""
    from repro_torch.configs import reduced_config
    from repro_torch.core import prng
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import init_lm, lm_apply, resolve_device
    from repro_torch.train.steps import build_train_step

    dev = resolve_device(device)
    out = {}
    for aid in arch_ids:
        cfg = reduced_config(aid)
        print(f"--- {aid}: {cfg.family} params={cfg.param_count():,}", flush=True)
        params = init_lm(prng.prng_key(1), cfg, torch.float32, device=dev)
        batch = batch_for(cfg, dev)
        with torch.inference_mode():
            logits = lm_apply(params, cfg, batch)
        if tuple(logits.shape) != (B, S, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{aid}: logits {tuple(logits.shape)}, or not finite")
        print("    forward ok", flush=True)

        # the step updates its parameters in place: train a copy, so the checks below see the initial weights
        trained = copy.deepcopy(params)
        train_step, opt = build_train_step(cfg, "adamw")
        _, _, metrics = train_step(trained, opt.init(dict(trained.named_parameters())), 0, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"{aid}: loss {loss}")
        print(f"    train ok loss={loss:.3f}", flush=True)

        with torch.inference_mode():
            pre = {k: v for k, v in batch.items() if k != "labels"}
            logits1, cache = lm_prefill(params, cfg, pre)
            db = {"token": torch.zeros((B,), dtype=torch.int32, device=dev)}
            if cfg.mrope_sections is not None:
                db["positions"] = torch.full((B, 3), S, dtype=torch.int32, device=dev)
            logits2, cache2 = lm_decode_step(params, cfg, cache, db)
        if tuple(logits1.shape) != (B, cfg.vocab_size) or tuple(logits2.shape) != (B, cfg.vocab_size):
            raise AssertionError(f"{aid}: prefill/decode logits {tuple(logits1.shape)}, {tuple(logits2.shape)}")
        if not bool(torch.isfinite(logits2).all()) or int(cache2["len"]) != S + 1:
            raise AssertionError(f"{aid}: decode logits not finite, or cache length {int(cache2['len'])}")
        print("    prefill+decode ok", flush=True)

        err_p, err_d = _consistency(params, cfg, batch)
        print(f"    prefill-vs-forward={err_p:.2e} decode-vs-forward={err_d:.2e}", flush=True)
        if not (err_p < CONSISTENCY_TOL and err_d < CONSISTENCY_TOL):
            raise AssertionError(f"{aid}: prefill/decode against the forward: {err_p}, {err_d}")
        out[aid] = {"loss": loss, "err_prefill": err_p, "err_decode": err_d}
    print("ALL OK")
    return out


def main(argv=None):
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch_ids", nargs="*", help="LM arch ids (default: all)")
    ap.add_argument("--fast", action="store_true", help="batched sweep for the protocol matrix")
    ap.add_argument("--skip-lm", action="store_true", help="protocol matrix only")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    print(f"--- protocol matrix ({'batched' if args.fast else 'sequential'})", flush=True)
    out = {"matrix": protocol_matrix(args.fast, args.device)}
    if not args.skip_lm:
        out["lm"] = lm_checks(args.arch_ids or list(ARCH_IDS), args.device)
    return out


if __name__ == "__main__":
    main()
