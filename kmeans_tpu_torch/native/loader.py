"""ctypes binding of the native row gather (``rowgather.cpp``).

Counterpart of ``kmeans_tpu/native/loader.py``.  The shared library is
built with ``g++`` the first time it is needed, into ``build/native/`` at the
root of the checkout (listed in ``.gitignore``), under a hash of the source,
so an edited source is rebuilt and a stale library is never loaded.  ctypes
foreign calls release the GIL, which is the point: a producer thread running
the gather overlaps the device work of the previous batch.

The gather writes straight into a torch tensor through its ``data_ptr()``:
a pinned staging buffer on the card's path, so the rows cross to the card
with no second host copy.  The fused f32 → bf16 gather writes the bf16 bits
into a ``torch.bfloat16`` tensor; its rounding (to nearest, ties to even)
is that of ``torch.Tensor.to(torch.bfloat16)`` for every non-NaN value (a
NaN keeps its sign and high payload bits, where torch writes its canonical
NaN).  Nothing here needs ``ml_dtypes``.

``KMEANS_TPU_NO_NATIVE=1``, or a host without ``g++``, selects the numpy
version of each entry point, bit for bit the same result: the plain version
of the gather, which the tests hold the native one against.
:func:`gather_counts` counts the gathers each route made, so a caller can
show which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.utils import faults
from kmeans_tpu_torch.utils.retry import RetryError, RetryPolicy

__all__ = ["gather_rows", "native_available", "to_bfloat16", "gather_counts",
           "reset_gather_counts", "SOURCE", "BUILD_DIR"]

#: The g++ spawn can fail transiently (fork or memory pressure): retry the
#: spawn a couple of times before falling back to numpy.  A nonzero
#: compiler exit is a source problem and is never retried, nor is a blown
#: 120 s cap or a missing g++.
_COMPILE_RETRY = RetryPolicy(
    max_attempts=3, base_delay=0.1, max_delay=1.0,
    retryable=lambda e: (
        isinstance(e, (OSError, subprocess.SubprocessError))
        and not isinstance(e, (subprocess.TimeoutExpired,
                               FileNotFoundError))
    ),
)

SOURCE = Path(__file__).resolve().parent / "rowgather.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# Leave a core for the main thread.
_DEFAULT_THREADS = max(1, min(16, (os.cpu_count() or 2) - 1))

#: One worker per this many bytes of copy work: a std::thread create and
#: join costs about 100 µs, so small gathers run single-threaded.
_BYTES_PER_THREAD = 4 << 20

_COUNTS = {"native": 0, "numpy": 0}
_COUNTS_LOCK = threading.Lock()


def _count(route: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[route] += 1


def gather_counts() -> dict:
    """``{"native": n, "numpy": m}``: the gathers (and conversions) each
    route made since the last :func:`reset_gather_counts`."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_gather_counts() -> None:
    with _COUNTS_LOCK:
        for route in _COUNTS:
            _COUNTS[route] = 0


def _auto_threads(nbytes: int) -> int:
    return max(1, min(_DEFAULT_THREADS, int(nbytes // _BYTES_PER_THREAD)))


def _build() -> Optional[Path]:
    """Compile rowgather.cpp into ``BUILD_DIR``; the library's path, or
    None when it cannot be built here."""
    try:
        src = SOURCE.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"rowgather-{tag}.so"
    if so_path.exists():
        return so_path
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = ["g++", *_FLAGS, str(SOURCE), "-o", str(tmp)]

        def compile_once():
            faults.check("native.compile")
            return subprocess.run(cmd, capture_output=True, timeout=120)

        res = _COMPILE_RETRY.call(compile_once, site="native.compile")
        if res.returncode != 0:
            return None
        # Build under a private name, then rename into place: a concurrent
        # build of the same hash produces the same bits.
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError, RetryError):
        return None
    finally:
        try:
            tmp.unlink()
        except OSError:
            pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("KMEANS_TPU_NO_NATIVE"):
            return None
        so_path = _build()
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(str(so_path))
        except OSError:
            return None
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.kt_gather_rows.argtypes = [p, p, i64, i64, p, ctypes.c_int]
        lib.kt_gather_rows.restype = None
        lib.kt_gather_rows_f32_to_bf16.argtypes = [p, p, i64, i64, p,
                                                   ctypes.c_int]
        lib.kt_gather_rows_f32_to_bf16.restype = None
        lib.kt_f32_to_bf16.argtypes = [p, i64, p, ctypes.c_int]
        lib.kt_f32_to_bf16.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the compiled gather is (or can be) live on this host."""
    return _load() is not None


def _row_contiguous(a) -> bool:
    return (a.ndim == 2 and a.strides[1] == a.itemsize
            and a.strides[0] == a.shape[1] * a.itemsize)


def _out_tensor(out, m, d, dtype) -> torch.Tensor:
    """``out[:m]`` checked (a contiguous CPU tensor of ``dtype`` with at
    least m rows of width d), or a new (m, d) tensor."""
    if out is None:
        return torch.empty((m, d), dtype=dtype)
    if (out.device.type != "cpu" or out.dtype != dtype or out.dim() != 2
            or out.shape[1] != d or out.shape[0] < m
            or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous CPU {dtype} tensor of at least "
            f"({m}, {d}); got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out[:m]


def gather_rows(data, idx, *, to_bf16: bool = False,
                n_threads: Optional[int] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``data[idx]`` as a contiguous CPU tensor, gathered natively when
    ``data`` is an ndarray (or memmap) with contiguous rows, by numpy
    otherwise.  ``out`` (a contiguous CPU tensor, pinned on the card's
    path, with at least ``len(idx)`` rows) receives the rows in place of
    a new tensor; the returned tensor is then its first rows.

    With ``to_bf16`` (float32 input only) the gather fuses the f32 → bf16
    round to nearest even and returns a ``torch.bfloat16`` tensor, halving
    the bytes that cross to the card.
    """
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
    n = data.shape[0]
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"idx out of range [0, {n})")
    if to_bf16 and data.dtype != np.float32:
        raise ValueError(f"to_bf16 requires float32 input, got {data.dtype}")

    lib = _load()
    m = idx.shape[0]
    d = data.shape[1]
    dtype = (torch.bfloat16 if to_bf16
             else torch.from_numpy(np.empty(0, data.dtype)).dtype)
    usable = (lib is not None and isinstance(data, np.ndarray)
              and _row_contiguous(data) and m > 0)
    dst = _out_tensor(out, m, d, dtype)
    if usable:
        src = ctypes.c_void_p(data.ctypes.data)
        ip = ctypes.c_void_p(idx.ctypes.data)
        if to_bf16:
            nt = n_threads if n_threads is not None else _auto_threads(
                m * d * 4)
            lib.kt_gather_rows_f32_to_bf16(src, ip, m, d,
                                           ctypes.c_void_p(dst.data_ptr()),
                                           nt)
        else:
            row_bytes = d * data.itemsize
            nt = n_threads if n_threads is not None else _auto_threads(
                m * row_bytes)
            lib.kt_gather_rows(src, ip, m, row_bytes,
                               ctypes.c_void_p(dst.data_ptr()), nt)
        _count("native")
        return dst
    rows = torch.from_numpy(np.ascontiguousarray(np.asarray(data)[idx]))
    _count("numpy")
    if out is None:
        return rows.to(torch.bfloat16) if to_bf16 else rows
    dst.copy_(rows)
    return dst


def to_bfloat16(x, *, n_threads: Optional[int] = None) -> torch.Tensor:
    """f32 → bf16 (round to nearest even) as a ``torch.bfloat16`` tensor,
    threaded natively when possible."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    lib = _load()
    if lib is None or x.size == 0:
        _count("numpy")
        return torch.from_numpy(x).to(torch.bfloat16)
    out = torch.empty(x.shape, dtype=torch.bfloat16)
    nt = n_threads if n_threads is not None else _auto_threads(x.nbytes)
    lib.kt_f32_to_bf16(ctypes.c_void_p(x.ctypes.data), x.size,
                       ctypes.c_void_p(out.data_ptr()), nt)
    _count("native")
    return out
