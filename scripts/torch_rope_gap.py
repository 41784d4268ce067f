"""The port's CPU gap to the golden files written before its rotary table
became the reference's jitted one (ROADMAP.md C.20), measured again.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_rope_gap.py [NAME ...]

NAME is one of ``serve_stablelm``, ``serve_llama4_scout``,
``train_stablelm`` (all three by default).  Each file's writer (the
``__main__`` of its test file) runs on a copy of ``src/`` and ``tests/`` in
a temporary directory, so the reference and the port see the weights and
requests the file was written with, and the committed files stay as they
are.  Prints, for each file, the port's CPU gap recorded in the committed
file beside the one the copy measured, and whether the reference's own
outputs (tokens, top logits, losses) came out the same.  Takes about 15
minutes and, at its peak (the llama4-scout file), 25 GB of memory.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {  # name: (writer, golden file, the keys that hold the port's gap)
    "serve_stablelm": ("tests/test_torch_lm.py", "golden_serve_stablelm.json", ("port_cpu_max_abs_logit_gap",)),
    "serve_llama4_scout": ("tests/test_torch_moe.py", "golden_serve_llama4_scout.json",
                           ("port_cpu_gap", "port_cpu_logit_gap_per_step")),
    "train_stablelm": ("tests/test_torch_train.py", "golden_train_stablelm.json", ("port_cpu_gap",)),
}
# what the port's run writes into a file besides its gap: not the reference's
PORT_KEYS = ("port_cpu_gap_note", "port_cpu_routing", "tolerance")


def main(names):
    out = {}
    for name in names:
        writer, golden, gap_keys = FILES[name]
        with open(os.path.join(ROOT, "src", "repro_torch", "data", golden)) as f:
            old = json.load(f)
        with tempfile.TemporaryDirectory() as d:
            for sub in ("src", "tests"):
                shutil.copytree(os.path.join(ROOT, sub), os.path.join(d, sub),
                                ignore=shutil.ignore_patterns("__pycache__"))
            env = dict(os.environ, PYTHONPATH=os.path.join(d, "src"), JAX_PLATFORMS="cpu")
            t0 = time.time()
            subprocess.run([sys.executable, os.path.join(d, writer)], env=env, check=True, cwd=d)
            with open(os.path.join(d, "src", "repro_torch", "data", golden)) as f:
                new = json.load(f)
        ref_keys = sorted(k for k in old if k not in gap_keys + PORT_KEYS)
        same = [k for k in ref_keys if old[k] == new.get(k)]
        rec = {"writer": writer, "seconds": round(time.time() - t0, 1),
               "old": {k: old.get(k) for k in gap_keys}, "new": {k: new.get(k) for k in gap_keys},
               "old_tolerance": old.get("tolerance"), "reference_outputs_identical": same == ref_keys,
               "reference_keys_that_differ": [k for k in ref_keys if k not in same]}
        out[name] = rec
        print(f"{name}: " + json.dumps(rec), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:] or list(FILES))
