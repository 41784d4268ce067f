"""Training launcher: end-to-end training on one device (port of
``repro.launch.train``).

    python -m repro_torch.launch.train --reduced --steps 100 --device cpu --ckpt build/ckpt
    python -m repro_torch.launch.train --batch 4 --seq 2048 --steps 5   # full stablelm-1.6b on the card

Weights come from ``init_lm`` at seed 0, batches from the synthetic
pipeline at seed 0, the step from ``build_train_step`` (the config's
optimizer, peak learning rate 3e-4 on the warmup-stable-decay schedule,
as the reference's ``make_optimizer`` sets it), all through the
fault-tolerant runner.  An encoder-decoder's batches also hold frames
(``train.steps.frames_batch``, the reference's draw), and an M-RoPE
model's (``--arch qwen2-vl-72b``) the reference's text-only positions,
0..seq-1 for each of the three ids.  The reference also
parses ``--lr`` and never uses it (ROADMAP.md C.7); the port leaves it out.  Runs on ``"cuda"`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core import prng
from repro_torch.data.pipeline import make_pipeline
from repro_torch.ft.runner import TrainRunner
from repro_torch.models.lm import default_positions, init_lm, resolve_device
from repro_torch.train.steps import build_train_step, frames_batch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=False,
                    help="the tiny same-family config (CPU scale); the full config by default")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None, help="inject a failure (ft demo)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)[0]
    print(f"[train] arch={cfg.name} params={cfg.param_count():,} reduced={args.reduced} device={dev}")

    train_step, optimizer = build_train_step(cfg)

    def init_state():
        params = init_lm(prng.prng_key(0), cfg, torch.float32, device=dev)
        return params, optimizer.init(dict(params.named_parameters()))

    init_data, next_batch = make_pipeline(cfg.vocab_size, args.batch, args.seq, device=dev)
    if cfg.encoder_decoder:
        def next_batch(ds, _tokens=next_batch):
            ds, b = _tokens(ds)
            b["frames"] = frames_batch(cfg, args.batch, ds.step, dev)
            return ds, b
    if cfg.mrope_sections is not None:
        def next_batch(ds, _tokens=next_batch):
            ds, b = _tokens(ds)
            b["positions"] = default_positions(cfg, b["tokens"])
            return ds, b

    runner = TrainRunner(train_step, init_state, next_batch, init_data,
                         ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every, fail_at=args.fail_at)
    out = runner.run(args.steps)
    losses = out["losses"]
    print(f"[train] done: step={out['final_step']} first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f}")
    if len(losses) > 20:
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not improve: {losses[0]} -> {losses[-1]}")
        print("[train] loss improved ✓")
    return out


if __name__ == "__main__":
    main()
