"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded through ``ctypes``.  Libraries go to
``<repo>/build/repro_torch/`` under a name keyed by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads at
once.  Nothing builds at import: the first launch of a kernel builds it,
and :func:`build` starts several ``nvcc`` processes at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
# kernel -> (C entry point, argtypes); every entry point returns cudaGetLastError()
SIGNATURES: Dict[str, Tuple[str, list]] = {
    # keys, prio_hi, prio_lo, active, won, scratch (NULL unless HELPERS asks for some), G, M, stream
    "lock_arbiter": ("rt_lock_arbiter", [_P] * 6 + [ctypes.c_int, ctypes.c_int, _P]),
    # srcs, dsts (host arrays of n device pointers), widths (host int32[n]), n, keys, R, M, stream
    "multi_read": ("rt_multi_read_many", [_P, _P, _P, ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_int, _P]),
    # wts_hi, wts_lo, row stride, keys, R, ctts_hi, ctts_lo, K, lock_hi, lock_lo, found, slot, ok,
    # rows_hi, rows_lo, M, S, stream (keys, the lock pair with ok, and the rows pair may be NULL)
    "mvcc_version_select": (
        "rt_mvcc_version_read",
        [_P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P, ctypes.c_int] + [_P] * 7
        + [ctypes.c_longlong, ctypes.c_int, _P],
    ),
    # q, k, v, o, B, H, Sq, Sk, Dh, strides (12 int64: b, h, s of q, k, v, o), scale, causal, bf16, stream
    "flash_attention": (
        "rt_flash_attention",
        [_P] * 4 + [ctypes.c_int] * 5 + [_P, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    ),
}

# helper functions of a kernel's library: C name -> (kernel, argtypes, restype)
HELPERS: Dict[str, Tuple[str, list, type]] = {
    # M -> int64 words of global scratch per group (0: shared-memory table, one launch; else two)
    "rt_lock_arbiter_scratch_words": ("lock_arbiter", [ctypes.c_int], ctypes.c_longlong),
}

_FNS: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("repro_torch kernels: nvcc not found (set CUDA_HOME); CUDA kernels cannot build")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes at once.  Returns each kernel's compiler output (ptxas
    register and shared-memory report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    try:
        for name in names:
            out = lib_path(name)
            if out.exists():
                logs[name] = "cached"
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for name, (p, tmp) in procs.items():
            text, _ = p.communicate()
            logs[name] = text
            if p.returncode:
                failed.append(f"{name}: nvcc exited {p.returncode}\n{text}")
                os.unlink(tmp)
            else:
                os.replace(tmp, lib_path(name))  # atomic: a concurrent loader sees old or new
        if failed:
            raise RuntimeError("repro_torch kernel build failed:\n" + "\n".join(failed))
    finally:
        for p, tmp in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _load(name: str, sym: str, argtypes: list, restype: type):
    fn = _FNS.get(sym)
    if fn is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[sym] = fn
    return fn


def kernel_fn(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    sym, argtypes = SIGNATURES[name]
    return _load(name, sym, argtypes, ctypes.c_int)


def helper_fn(sym: str):
    """The helper function ``sym`` of a kernel's library (:data:`HELPERS`)."""
    name, argtypes, restype = HELPERS[sym]
    return _load(name, sym, argtypes, restype)
