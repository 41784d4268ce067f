"""LM serving with RCC-transactional KV-page admission on the PyTorch/CUDA
port (port of ``examples/txn_serving.py``).

The paper's distributed KV store manages the serving engine's KV-cache
page table (DESIGN.md §Arch-applicability).  Concurrent admission requests
race for pages through the NOWAIT protocol: conflicting allocations abort
and retry; throughput and abort metrics come from the same engine that
runs the paper's benchmarks.  The admission workload is a user-written
``Workload``: its ``gen`` draws every slot's request at once, bit for bit
the reference's per-slot draws.  At the example's 24 co-routines a node
NOWAIT livelocks after its warm-up: every slot aborts every tick and
retries the same pages, as the reference's does (ROADMAP.md C.22); the
port keeps the reference's config.

    PYTHONPATH=src python examples/torch_txn_serving.py               # on the card
    PYTHONPATH=src python examples/torch_txn_serving.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

# runnable as `python examples/torch_txn_serving.py` from a checkout
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.costmodel import ONE_SIDED, CostModel  # noqa: E402
from repro_torch.core.engine import EngineConfig, Workload, run  # noqa: E402
from repro_torch.core.registry import get_protocol  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.lm import resolve_device  # noqa: E402

# page table: 4 nodes x 512 pages; an admission txn grabs 4 pages
N_NODES, PAGES_PER_NODE, PAGES_PER_REQ = 4, 512, 4
COROUTINES = 24  # admission requests in flight per node
DEDUP_ROUNDS = 4
SERVE_ARGS = ["--arch", "stablelm-1.6b", "--batch", "2", "--prompt-len", "16", "--gen-len", "8"]


def make_admission_workload(n_pages: int) -> Workload:
    def gen(keys, node, slot, per_row=None):
        """keys (N, 2) PRNG keys, node (N,) -> (pages (N, 4) int32, is_w,
        valid (N, 4) bool).  Preferred pages cluster near the requester's
        node (locality), which creates realistic allocation contention
        between co-located slots; a page that repeats an earlier one of its
        request moves on, in the reference's DEDUP_ROUNDS x 3 passes."""
        k1 = prng.split(keys, 2)[:, 0]
        local = prng.randint(k1, (PAGES_PER_REQ,), 0, PAGES_PER_NODE // 4)
        pages = (node[:, None] * PAGES_PER_NODE + local) % n_pages
        for r in range(DEDUP_ROUNDS):
            for i in range(1, PAGES_PER_REQ):
                clash = (pages[:, :i] == pages[:, i:i + 1]).any(1)
                moved = torch.where(clash, (pages[:, i] + i * 7 + r + 1) % n_pages, pages[:, i])
                pages = torch.cat([pages[:, :i], moved[:, None], pages[:, i + 1:]], 1)
        valid = torch.ones(pages.shape, dtype=torch.bool, device=pages.device)
        return pages.to(torch.int32), valid, valid  # all writes (allocations)

    def execute(keys, is_w, valid, rvals):
        """Bump each page's generation counter."""
        out = rvals.clone()
        out[:, :, 0] += 1
        return out

    return Workload(name="kv_admission", rw=1, max_ops=PAGES_PER_REQ, init_value=0, gen=gen, execute=execute,
                    exec_ticks=1)


def admission(device: str = "cuda", ticks: int = 300, warmup: int = 50):
    """NOWAIT admission at the example's EngineConfig, all one-sided, on
    ``device``'s default kernel plane.  Returns (state, store, metrics as
    Python values)."""
    device = str(resolve_device(device))
    ec = EngineConfig(
        protocol="nowait", n_nodes=N_NODES, coroutines=COROUTINES, records_per_node=PAGES_PER_NODE, rw=1,
        max_ops=PAGES_PER_REQ, hybrid=(ONE_SIDED,) * 6, kernel_plane=ops.resolve_plane(ops.AUTO, device),
        device=device,
    )
    wl = make_admission_workload(ec.n_records)
    st, store, m = run(get_protocol("nowait").tick, ec, CostModel(), wl, ticks, warmup=warmup)
    return st, store, {k: v[0].tolist() for k, v in m.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    _, store, m = admission(args.device)
    print(f"[admission] {m['commits']} admissions, abort_rate={m['abort_rate']:.3f}, "
          f"p50-ish latency={m['avg_latency_us']:.1f}us")
    print(f"[admission] page generations bumped: {int(store['data'].sum())}")

    # then serve a model against the admitted pages (reduced config decode)
    print("[serve] running batched prefill+decode with the admitted budget...")
    from repro_torch.launch import serve

    serve.main(SERVE_ARGS + ["--device", args.device])
    return m, store


if __name__ == "__main__":
    main()
