"""End-to-end LM training with fault tolerance on the PyTorch/CUDA port
(port of ``examples/train_lm.py``).

Default: a small same-family model for a quick run.  --full trains a
~100M-parameter stablelm-family model (8 layers, d 768) at 8 x 512 tokens
for a few hundred steps (sized for the card).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 120
    PYTHONPATH=src python examples/torch_train_lm.py --full --steps 300 --fail-at 170
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 30

Weights come from ``init_lm`` at seed 0 and batches from the synthetic
pipeline (copy runs in half the rows), both the reference's draws; the
runner checkpoints every 50 steps, and ``--fail-at N`` injects one failure
at step N, after which it resumes from the newest checkpoint.  Without
``--ckpt`` the checkpoints go to a temporary directory that is removed at
the end, so a second run starts from step 0 again; with ``--ckpt DIR`` a
run resumes from DIR's newest checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

# runnable as `python examples/torch_train_lm.py` from a checkout
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.ft.runner import TrainRunner  # noqa: E402
from repro_torch.models.lm import init_lm, resolve_device  # noqa: E402
from repro_torch.train.steps import build_train_step  # noqa: E402

CKPT_EVERY = 50
COPY_FRAC = 0.5


def config(full: bool = False):
    """(cfg, batch, seq): reduced stablelm at 8 x 128, or --full's 8-layer,
    d 768 stablelm-family model at 8 x 512."""
    if full:
        base, _ = get_config("stablelm-1.6b")
        cfg = dataclasses.replace(
            base, n_layers=8, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
            d_ff=2048, vocab_size=32000, microbatch=1, remat="none",
        )
        return cfg, 8, 512
    return reduced_config("stablelm-1.6b"), 8, 128


def train(steps: int = 120, *, full: bool = False, ckpt=None, fail_at=None, device: str = "cuda",
          ckpt_every: int = CKPT_EVERY, log_every: int = 10):
    """The example's run: the runner's output ({"final_step", "losses",
    "params", "opt"}) and the ``tokens`` of every batch drawn (one per
    loss, a replayed step's again)."""
    dev = resolve_device(device)
    cfg, batch, seq = config(full)
    print(f"[example] training {cfg.name}-family model: {cfg.param_count():,} params")
    train_step, optimizer = build_train_step(cfg)

    def init_state():
        params = init_lm(prng.prng_key(0), cfg, torch.float32, device=dev)
        return params, optimizer.init(dict(params.named_parameters()))

    init_data, draw = make_pipeline(cfg.vocab_size, batch, seq, copy_frac=COPY_FRAC, device=dev)
    tokens = []

    def next_batch(ds):
        ds, b = draw(ds)
        tokens.append(b["tokens"])
        return ds, b

    with tempfile.TemporaryDirectory(prefix="torch_train_lm_") as tmp:
        runner = TrainRunner(train_step, init_state, next_batch, init_data, ckpt_dir=ckpt or tmp,
                             ckpt_every=ckpt_every, fail_at=fail_at)
        out = runner.run(steps, log_every=log_every)
    out["tokens"] = tokens
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    out = train(args.steps, full=args.full, ckpt=args.ckpt, fail_at=args.fail_at, device=args.device)
    losses = out["losses"]
    print(f"[example] loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    print("[example] ok — model learned the synthetic copy/zipf structure")
    return out


if __name__ == "__main__":
    main()
