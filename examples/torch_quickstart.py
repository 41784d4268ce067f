"""Quickstart on the PyTorch/CUDA port: the RCC engine through the
``repro_torch.api`` front door, then the LM stack (port of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

One ExperimentSpec describes a whole sweep; plan() shows what will run on
which device and kernel plane; execute() returns one metrics row per
config.  Protocols come from the plugin registry
(``repro_torch.core.registry``): all six built-ins, plus anything you
register yourself.  On the card the RCC runs take the hand-written kernels
(``lock_arbiter`` and ``multi_read``; MVCC also ``mvcc_version_select``)
and the LM forward ``flash_attention``; on the CPU their plain versions.

Each section is a function whose defaults are the example's, so a caller
can run it at other knobs.
"""
from __future__ import annotations

import argparse
import os
import sys

# runnable as `python examples/torch_quickstart.py` from a checkout
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import torch  # noqa: E402

from repro_torch.api import ExperimentSpec, execute, plan  # noqa: E402
from repro_torch.core.costmodel import ONE_SIDED, RPC  # noqa: E402
from repro_torch.core.registry import protocol_names  # noqa: E402

KW = dict(n_nodes=4, coroutines=16, records_per_node=1024, ticks=300, warmup=60)
PLANES = (("rpc", (RPC,) * 6), ("one-sided", (ONE_SIDED,) * 6))
# the hybrid MVCC of section 2: fetch and validate via RPC, lock, log and commit one-sided
HYBRID_CODE = (RPC, ONE_SIDED, RPC, ONE_SIDED, ONE_SIDED, ONE_SIDED)
LM_ARCH = "qwen2.5-32b"
LM_BATCH, LM_SEQ = 2, 64


def protocol_pairs(device: str = "cuda", kw=KW):
    """Section 1: each protocol's all-RPC / all-one-sided pair as ONE
    2-config plan on SmallBank.  Returns [(protocol, impl, row), ...]."""
    print("=== SmallBank, 4 nodes x 16 co-routines, one-sided vs RPC ===")
    print(f"{'protocol':9s} {'impl':10s} {'Ktps':>8s} {'lat us':>8s} {'abort%':>7s} {'RTs':>5s}")
    out = []
    for proto in protocol_names():
        spec = ExperimentSpec(protocol=proto, workload="smallbank", configs=[{"hybrid": c} for _, c in PLANES],
                              device=device, **kw)
        for (impl, _), m in zip(PLANES, execute(plan(spec)).rows):
            print(f"{proto:9s} {impl:10s} {m['throughput_mtps'] * 1e3:8.1f} {m['avg_latency_us']:8.2f} "
                  f"{m['abort_rate'] * 100:6.2f}% {m['avg_round_trips']:5.2f}")
            out.append((proto, impl, m))
    return out


def hybrid_mvcc(device: str = "cuda", kw=KW):
    """Section 2: a hybrid protocol, the faster primitive per stage (paper
    §5), and the planner's summary of what runs.  Returns its row."""
    print("\n=== hybrid MVCC (fetch/validate via RPC, lock/log/commit one-sided) ===")
    pl = plan(ExperimentSpec(protocol="mvcc", workload="smallbank", configs=({"hybrid": HYBRID_CODE},),
                             device=device, **kw))
    print(pl.summary())
    m = execute(pl).row
    print(f"hybrid code={''.join(map(str, HYBRID_CODE))}  ->  {m['throughput_mtps'] * 1e3:.1f} Ktps, "
          f"{m['avg_latency_us']:.2f} us")
    return m


def lm_substrate(device: str = "cuda"):
    """Section 3: one forward and one AdamW step of reduced LM_ARCH, the
    reference's weights (``PRNGKey(0)``) and tokens (``PRNGKey(1)``).
    Returns {"cfg", "logits", "loss"}."""
    from repro_torch.configs import reduced_config
    from repro_torch.core import prng
    from repro_torch.models.lm import init_lm, lm_apply, resolve_device
    from repro_torch.train.steps import build_train_step

    print(f"\n=== LM substrate (reduced {LM_ARCH} family config) ===")
    dev = resolve_device(device)
    cfg = reduced_config(LM_ARCH)
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device=dev)
    tokens = prng.randint(prng.prng_key(1, dev), (LM_BATCH, LM_SEQ), 0, cfg.vocab_size)
    b = {"tokens": tokens, "labels": tokens}
    with torch.inference_mode():
        logits = lm_apply(params, cfg, b)
    step, opt = build_train_step(cfg)
    _, _, metrics = step(params, opt.init(dict(params.named_parameters())), 0, b)
    loss = float(metrics["loss"])
    print(f"params={cfg.param_count():,}  logits={tuple(logits.shape)}  loss={loss:.3f}")
    return {"cfg": cfg, "logits": logits, "loss": loss}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    out = {"pairs": protocol_pairs(args.device), "hybrid": hybrid_mvcc(args.device), "lm": lm_substrate(args.device)}
    print("quickstart ok")
    return out


if __name__ == "__main__":
    main()
