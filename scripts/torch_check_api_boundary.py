"""API-boundary gate of the PyTorch/CUDA port (port of
``scripts/check_api_boundary.py``): its examples, scripts and smoke go
through the front door.

    python scripts/torch_check_api_boundary.py

Gate (a): the port's files outside ``src/repro_torch`` and ``tests/``
(``examples/torch_*.py``, ``scripts/torch_*.py`` and ``chip_smoke.py``)
reach the engine through ``repro_torch.api`` or
``repro_torch.core.registry``, never through ``repro_torch.core.sweep``
(its deprecated ``run_grid``, ``run_grid_sharded`` and
``run_cell_sharded``, or ``plan_buckets``) or the legacy ``PROTOCOLS``
dict.  ``ALLOWED`` names the functions that cross it on purpose, each with
its reason.  The scan is AST-based (imports, names, attribute access), so
prose that merely mentions the banned names does not trip it.

Gate (b) keeps ``src/repro_torch/kernels/`` honest: every kernel module
must be imported somewhere outside the kernels package (``src/repro_torch``,
the port's examples and scripts, ``chip_smoke.py``; tests alone don't
count), directly or transitively through another live kernel module, and
every CUDA source ``kernels/csrc/*.cu`` must be one that ``_build.py``
names (a key of its ``SIGNATURES``).  ``__init__.py``, ``ref.py`` (the
plain versions) and ``_build.py`` (the build itself) are exempt.

Exit 0 = clean; exit 1 = prints one line per violation.
"""
from __future__ import annotations

import ast
import glob
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELF = os.path.join("scripts", "torch_check_api_boundary.py")
SCAN_GLOBS = (os.path.join("examples", "torch_*.py"), os.path.join("scripts", "torch_*.py"), "chip_smoke.py")

SWEEP_MODULE = "repro_torch.core.sweep"
BANNED_NAMES = {"PROTOCOLS"}
SWEEP_ENTRY_POINTS = {"run_grid", "run_grid_sharded", "run_cell_sharded", "plan_buckets"}
# (file, enclosing function) -> why it crosses gate (a) on purpose
ALLOWED = {
    ("chip_smoke.py", "phase_legacy"): "drives the deprecated sweep shims (run_grid, run_cell_sharded) in the "
                                       "legacy PRNG mode, held to the reference's pinned stage-graph counters",
    ("chip_smoke.py", "phase_profile"): "profiles bare ticks: builds a bucket's engine config with "
                                        "sweep.engine_config, below the planner",
    ("chip_smoke.py", "phase_calvin"): "profiles CALVIN's batched epochs: builds the engine config with "
                                       "sweep.engine_config, below the planner",
    ("chip_smoke.py", "phase_node"): "checks the node layout's final store against the dense run's: builds "
                                     "the engine config with sweep.engine_config, below the planner",
}

KERNELS_PKG = "repro_torch.kernels"
KERNEL_DIR = os.path.join("src", "repro_torch", "kernels")
KERNEL_LIVE = (os.path.join("src", "repro_torch"),) + SCAN_GLOBS
KERNEL_EXEMPT = {"__init__", "ref", "_build"}


def _scan_files(root: str):
    for pattern in SCAN_GLOBS:
        for path in sorted(glob.glob(os.path.join(root, pattern))):
            rel = os.path.relpath(path, root)
            if rel != SELF:
                yield path, rel


def _functions(tree):
    """node -> the name of the outermost function that holds it."""
    owner = {}
    for top in ast.walk(tree):
        if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)) and top not in owner:
            for node in ast.walk(top):
                owner.setdefault(node, top.name)
    return owner


def _file_violations(path: str, rel: str):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=rel)
    owner = _functions(tree)
    out = []

    def flag(node, what):
        if (rel, owner.get(node)) not in ALLOWED:
            out.append(f"{rel}:{node.lineno}: banned API use: {what}")

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == SWEEP_MODULE or mod.startswith(SWEEP_MODULE + "."):
                flag(node, f"from {mod} import ... (use repro_torch.api)")
            elif any(a.name in BANNED_NAMES for a in node.names):
                flag(node, f"from {mod} import PROTOCOLS (use repro_torch.core.registry)")
            elif mod == "repro_torch.core" and any(a.name == "sweep" for a in node.names):
                flag(node, "from repro_torch.core import sweep (use repro_torch.api)")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == SWEEP_MODULE or a.name.startswith(SWEEP_MODULE + "."):
                    flag(node, f"import {a.name} (use repro_torch.api)")
        elif isinstance(node, ast.Name) and node.id in BANNED_NAMES:
            flag(node, "PROTOCOLS (use repro_torch.core.registry.get_protocol)")
        elif (
            isinstance(node, ast.Attribute)
            and node.attr in SWEEP_ENTRY_POINTS
            and isinstance(node.value, ast.Name)
            and node.value.id == "sweep"
        ):
            flag(node, f"sweep.{node.attr} (use repro_torch.api.plan/execute)")
    return out


def violations(root: str = ROOT):
    out = []
    for path, rel in _scan_files(root):
        out.extend(_file_violations(path, rel))
    return out


def _kernel_imports(path: str) -> set:
    """Kernel submodule names a file imports (AST walk, so lazy function-level
    imports count too)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(KERNELS_PKG + "."):
                    out.add(a.name.split(".")[2])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == KERNELS_PKG:
                out.update(a.name for a in node.names)  # from repro_torch.kernels import ops
            elif mod.startswith(KERNELS_PKG + "."):
                out.add(mod.split(".")[2])
    return out


def _built_sources(kdir: str) -> set:
    """The kernel names ``_build.py`` builds: the string keys of its
    ``SIGNATURES`` dict (each is ``csrc/<name>.cu``)."""
    path = os.path.join(kdir, "_build.py")
    if not os.path.isfile(path):
        return set()
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target] if isinstance(
            node, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name) and t.id == "SIGNATURES" for t in targets) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return set()


def _live_files(root: str, kdir: str):
    for entry in KERNEL_LIVE:
        path = os.path.join(root, entry)
        if os.path.isdir(path):
            for dirpath, _, files in os.walk(path):
                if os.path.abspath(dirpath).startswith(os.path.abspath(kdir)):
                    continue
                yield from (os.path.join(dirpath, fn) for fn in sorted(files) if fn.endswith(".py"))
        else:
            yield from sorted(glob.glob(path))


def kernel_liveness(root: str = ROOT):
    """Dead-module gate: one violation line per kernel module that nothing
    outside the kernels package reaches, directly or transitively, and per
    CUDA source that ``_build.py`` does not name."""
    kdir = os.path.join(root, KERNEL_DIR)
    if not os.path.isdir(kdir):
        return []
    modules = {fn[:-3] for fn in os.listdir(kdir) if fn.endswith(".py")}
    internal = {m: _kernel_imports(os.path.join(kdir, m + ".py")) & modules for m in modules - {"__init__"}}
    live = set()
    for path in _live_files(root, kdir):
        live |= _kernel_imports(path) & modules
    frontier = set(live)
    while frontier:  # transitive: a module a live module imports is live
        frontier = set().union(*(internal.get(m, set()) for m in frontier)) - live
        live |= frontier
    out = [
        f"{KERNEL_DIR}/{m}.py: dead kernel module — imported nowhere in src/repro_torch, the port's examples "
        "and scripts or chip_smoke.py (tests don't count); wire it into repro_torch.kernels.ops or delete it"
        for m in sorted(modules - live - KERNEL_EXEMPT)
    ]
    built = _built_sources(kdir)
    for path in sorted(glob.glob(os.path.join(kdir, "csrc", "*.cu"))):
        name = os.path.basename(path)[:-3]
        if name not in built:
            out.append(f"{KERNEL_DIR}/csrc/{name}.cu: dead CUDA source — _build.py's SIGNATURES does not name "
                       f"{name!r}; build it or delete it")
    return out


def main() -> int:
    bad = violations()
    for v in bad:
        print(v)
    if bad:
        print(
            f"\n{len(bad)} API-boundary violation(s): use repro_torch.api "
            "(ExperimentSpec/plan/execute) or repro_torch.core.registry instead",
            file=sys.stderr,
        )
        return 1
    dead = kernel_liveness()
    for v in dead:
        print(v)
    if dead:
        print(f"\n{len(dead)} dead kernel module(s) or source(s)", file=sys.stderr)
        return 1
    print("api boundary ok: no direct repro_torch.core.sweep/PROTOCOLS use in the port's examples, scripts or smoke")
    print("kernel liveness ok: every src/repro_torch/kernels module and CUDA source is reachable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
