"""Build and load the port's CUDA kernels (``csrc/lloyd.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` (``wgmma`` and
``setmaxnreg`` exist only there) into a shared library with a plain C
interface the first time a kernel is launched, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
and loaded with :mod:`ctypes`.  The library's file name carries a hash of
the source and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "build", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lloyd.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: The fold core's arguments (``FoldScratch.args`` in cuda_lloyd.py): vec,
#: sort, hist, start, part, part_counts, sq_part.
_FOLD = [_I, _P, _P, _P, _P, _P, _P]
#: argtypes of each C entry point: every pointer and the stream as c_void_p.
_SIGNATURES = {
    # x, x_dtype, neg2c, cd, csq, w, n, d, k, with_update, raw, vec, core,
    # labels, mind, sums, counts, part_best, part_idx, then the fold's
    # (fold_vec, sort, hist, start, part, part_counts, sq_part), stream
    "kml_lloyd_pass": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, *_FOLD, _P],
    # x, x_dtype, neg2c, cd, csq, w, prev, n, d, k, with_mind, vec, core,
    # labels, mind, dsums, dcounts, n_changed, group_counts, part_best,
    # part_idx, stream
    "kml_lloyd_delta": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # x, x_dtype, cd, labels, scores, w, n, d, k, the fold's scratch, sums,
    # counts, mind, stream
    "kml_accumulate": [_P, _I, _I, _P, _P, _P, _I, _I, _I, *_FOLD,
                       _P, _P, _P, _P],
    # x, x_dtype, neg2c, cd, csq, w, prev, need, sb_in, slb_in, n, d, k,
    # vec, core, labels, sb, slb, dsums, dcounts, n_rec, group_counts,
    # part_best, part_idx, part_second, rows, group_start, stream
    "kml_lloyd_hamerly": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P],
    # x, x_dtype, neg2c, cd, csq, n, d, k, k_tile, raw, with_second, vec,
    # core, part_best, part_idx, part_second, labels, mind, second, stream
    "kml_tiled_argmin": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P, _P, _P, _P, _P, _P],
    # x, x_dtype, cd, w, lab, lab2, n, d, k, the fold's scratch, sums,
    # counts, stream
    "kml_tiled_fold": [_P, _I, _I, _P, _P, _P, _I, _I, _I, *_FOLD,
                       _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from csrc/lloyd.cu")


def build() -> dict:
    """Compile the kernels (unless this exact source is already built).

    Returns ``{"path", "seconds", "built", "ptxas"}``: the library path,
    the compile time, whether it compiled now, and the assembler's
    per-kernel register / shared-memory / spill report (empty when
    cached)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libkml_lloyd_{tag}.so"
    if out.exists():
        return {"path": out, "seconds": 0.0, "built": False, "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "built": True,
            "ptxas": proc.stderr}


_LOCK = threading.Lock()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use.  Threads that make
    the first call together (the engine's dispatchers) wait for one build
    and one load."""
    with _LOCK:
        return _load()
