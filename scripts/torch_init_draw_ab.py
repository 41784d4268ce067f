#!/usr/bin/env python3
"""The weight draws on one NVIDIA card: ``prng._chunked_draw``'s table path
(counts hashed in int32, each element looked up in its map's table of the
top 23 random bits) against the plain path (int64 threefry, the map applied
to every element), in one process.

    python3 scripts/torch_init_draw_ab.py [--n-log2 28]

For the truncated normal on [-2, 2] (``dense_init``'s) and the normal: the
two paths' values bitwise over 2**n elements and over windows of a 2**33
element draw that cross 2**31 and 2**32 (the count words' edges), and each
path's time per element (the median of 3 draws after one warm-up).  Then
``init_lm`` of llama4-scout-17b-a16e at full width and 1 of its 48 layers on
the card (4.15 B parameters), timed, under each path in turn.  Prints one
JSON line and writes it to ``chiprun_out/init_draw_ab.json``.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_init_draw_ab: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models.lm import init_lm

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-log2", type=int, default=28)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    key = prng.fold_in(prng.prng_key(0, "cuda"), 11)
    n = 1 << args.n_log2
    out = {"card": card, "n": n, "maps": {}}
    for name, fn in (("truncated_normal", prng._truncated_normal_fn(-2.0, 2.0)), ("normal", prng._normal_fn())):
        row = {}
        for table in (False, True):
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v = prng._chunked_draw(key, (n,), fn, table=table)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row["table" if table else "plain"] = {"s": statistics.median(times[1:]),
                                                  "ns_per_element": statistics.median(times[1:]) / n * 1e9}
            if table:
                row["equal"] = bool(torch.equal(v.view(torch.int32), plain.view(torch.int32)))
            else:
                plain = v
            del v
        del plain
        for lo in (2**31 - 2**24, 2**32 - 2**24):
            a = prng._chunked_draw(key, (2**33,), fn, lo, lo + 2**25, table=False)
            b = prng._chunked_draw(key, (2**33,), fn, lo, lo + 2**25, table=True)
            row[f"window_{lo}_equal"] = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
            del a, b
        out["maps"][name] = row
        print(name, json.dumps(row), flush=True)
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e")[0], n_layers=1)
    plain_draw = prng._chunked_draw
    out["init_lm"] = {}
    for table in (True, False):
        prng._chunked_draw = (plain_draw if table else
                              lambda *a, **k: plain_draw(*a, **dict(k, table=False)))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        finally:
            prng._chunked_draw = plain_draw
        n_params = sum(p.numel() for p in params.parameters())
        sums = [float(p.double().sum()) for p in params.parameters()]
        out["init_lm"]["table" if table else "plain"] = {"s": s, "n_params": n_params}
        if table:
            table_sums = sums
        else:
            out["init_lm"]["sums_equal"] = sums == table_sums
        del params
        torch.cuda.empty_cache()
        print("init_lm", json.dumps(out["init_lm"]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "init_draw_ab.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
    ok = all(v for row in out["maps"].values() for k, v in row.items() if k.endswith("equal"))
    return 0 if ok and out["init_lm"]["sums_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
