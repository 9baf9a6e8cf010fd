"""The assignment engine: adaptive micro-batching over nearest-centroid
scoring on the engine's device.

Counterpart of ``kmeans_tpu/serve/assign.py``, up to its in-process entry
point :meth:`AssignEngine.submit`:

* **Adaptive micro-batcher.**  Concurrent requests coalesce into one
  batch.  The oldest queued request bounds the added delay
  (``ServeConfig.assign_max_delay_s``); an EWMA of the inter-arrival gap
  lets the batcher dispatch at once when traffic is sparse and coalesce
  when it is not.  A full queue refuses (``QueueFullError``).
* **Per-generation prepared models.**  Squared norms, the closure
  candidate tables (:func:`kmeans_tpu_torch.ops.hamerly.
  closure_candidates`) for k of ``assign_prune_min_k`` and more, and the
  device tensors of each route, built once per generation and kept for a
  few generations after a swap.
* **Three routes on the device.**  Dense: ``csq − 2·x·Cᵀ`` and a
  lowest-index argmin on K5 (:func:`kmeans_tpu_torch.ops.cuda_lloyd.
  tiled_argmin_cuda`, its plain version for a batch on the CPU), over the
  column ranges the planner gives f32 operands.  Pruned: each row scores
  only its group's candidates
  (:func:`kmeans_tpu_torch.ops.hamerly.closure_assign_device`), and a
  triangle-inequality certificate proves the result exact.  Quant: a
  k-tiled scan over an int8 or bf16 codebook whose error bounds make the
  prune provably complete (:mod:`kmeans_tpu_torch.quant`).  Rows that a
  certificate cannot prove are rescored densely (K5 on the rows already on
  the device; NumPy for a host route on the CPU), so every route gives
  the dense route's labels.  The pruned and quant stages also
  have the reference's host routes (grouped NumPy GEMMs), which
  ``assign_pruned_backend="auto"`` takes on the CPU.
* **Binary wire protocol.**  :func:`encode_points` / :func:`decode_points`
  / :func:`encode_labels` / :func:`decode_labels`, byte for byte the
  reference's frames.

Hot-swap contract: the registry's generation is read once per coalesced
batch; every request in it is answered from that immutable snapshot and
reports its number.  Nothing is dropped for a swap.

Known differences from the reference: nothing compiles per shape, so
batches are not padded to the bucket ladder (``batch_rows_pow2`` stays as
a summary of batch sizes) and ``stats()`` has no shape-cache counters; the
Prometheus metrics and tracing spans wait for the port's ``obs``.
"""

from __future__ import annotations

import collections
import queue
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.ops.cuda_lloyd import neg2c_pieces, tiled_argmin_cuda
from kmeans_tpu_torch.ops.hamerly import (closure_assign_device,
                                          closure_candidates)
from kmeans_tpu_torch.ops.plan import LANE, core_takes, kernel_plan
from kmeans_tpu_torch.quant import (QUANT_MARGIN_REL, QUANT_MODES,
                                    dequantize_matrix, quant_assign_device,
                                    quant_prune, quantize_codebook)

__all__ = [
    "AssignEngine",
    "PreparedModel",
    "assign_direct",
    "dense_k_tile",
    "quant_k_tile",
    "pruned_m_tile",
    "NoModelError",
    "QueueFullError",
    "AssignTimeoutError",
    "WireError",
    "encode_points",
    "decode_points",
    "encode_labels",
    "decode_labels",
    "WIRE_POINTS_CONTENT_TYPE",
    "WIRE_LABELS_CONTENT_TYPE",
    "WIRE_FLAG_DISTANCES",
    "WIRE_VERSION",
]

#: Relative certificate margin: the pruned scores' f32 error is ~1e-6·d
#: relative, and 1e-3 stays two orders of magnitude above it, as
#: ``ops.hamerly.HAMERLY_MARGIN_REL`` does.
_CERT_MARGIN_REL = 1e-3

#: The quant tier's auto policy (``assign_pruned_backend="auto"`` with
#: ``assign_quant="off"``): int8 engages when the f32 codebook (k·d·4
#: bytes) reaches this, half the codebook-scale slab (k = 65536 × d = 2048
#: = 512 MiB).
_QUANT_AUTO_SLAB_BYTES = 1 << 28

#: Default of ``ServeConfig.assign_quant_min_rows``: the host tier expands
#: each routed group's packed tile once a batch whatever its row count, so
#: smaller batches take the f32 pruned route (same labels).
_QUANT_MIN_ROWS = 512

#: Elements of the pruned device route's gathered (rows, m_tile, d) block
#: (f32: 64 MiB): the candidate gather streams in m_tile chunks so one
#: batch never holds rows·m·d at once.
_DEV_GATHER_ELEMS = 1 << 24

#: Elements of one of the quant scan's (rows, k_tile) f32 temporaries
#: (256 MiB; the scan holds about three at once): the scan streams the
#: compressed codebook in k_tile slices so one batch never holds rows·k.
_DEV_SCAN_ELEMS = 1 << 26


class NoModelError(RuntimeError):
    """No generation published, the engine is stopping, or a swap changed
    d mid-flight: retry."""


class QueueFullError(RuntimeError):
    """Backpressure: the pending-request queue is at
    ``assign_pending_limit``."""


class AssignTimeoutError(RuntimeError):
    """A request outlived ``assign_timeout_s`` waiting for its batch."""


# ---------------------------------------------------------------------------
# Binary wire protocol: versioned little-endian frames, the request payload
# read zero-copy with np.frombuffer (read-only; the engine only reads rows).
# ---------------------------------------------------------------------------

WIRE_POINTS_CONTENT_TYPE = "application/x-kmeans-points"
WIRE_LABELS_CONTENT_TYPE = "application/x-kmeans-labels"

#: Frame version both directions; a decoder seeing a higher version
#: rejects loudly instead of misparsing a future layout.
WIRE_VERSION = 1
#: Payload dtype code: 1 = little-endian float32 (the only code v1
#: speaks; the slot exists so f16/bf16 payloads can negotiate later).
_WIRE_DTYPE_F32 = 1
#: Request flag bit: client wants per-row distances to the assigned
#: centroid appended to the response (raw f32, after the labels).
WIRE_FLAG_DISTANCES = 0x1

_WIRE_POINTS_MAGIC = b"KMPT"
_WIRE_LABELS_MAGIC = b"KMLB"
#: magic(4) version(u8) dtype(u8) flags(u16) n(u32) d(u32) = 16 bytes,
#: then n*d f32 row-major points.
_POINTS_HEADER = struct.Struct("<4sBBHII")
#: magic(4) version(u8) dtype(u8) flags(u16) n(u32) k(u32)
#: generation(u64) = 24 bytes, then n i32 labels (+ n f32 distances
#: when the distances flag is set).
_LABELS_HEADER = struct.Struct("<4sBBHIIQ")


class WireError(ValueError):
    """A malformed binary assign frame — truncated/oversized header
    fields, wrong magic/version/dtype, payload length mismatch.  A
    ValueError subclass, so an HTTP layer can map it to a 400."""


def encode_points(points, *, want_distances: bool = False) -> bytes:
    """Client-side framing of an (n, d) float32 point matrix."""
    x = np.ascontiguousarray(points, np.float32)
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise WireError(
            f"points must be a non-empty (n, d) matrix; got shape "
            f"{tuple(x.shape)}")
    flags = WIRE_FLAG_DISTANCES if want_distances else 0
    return _POINTS_HEADER.pack(
        _WIRE_POINTS_MAGIC, WIRE_VERSION, _WIRE_DTYPE_F32, flags,
        x.shape[0], x.shape[1]) + x.tobytes()


def decode_points(body: bytes, *, max_points: int = 0):
    """Server-side parse of a points frame -> ``(x, flags)`` with ``x``
    an (n, d) float32 view INTO ``body`` (zero-copy; read-only, which
    the engine contract allows — it only reads request rows).  Raises
    :class:`WireError` on any malformation, including a
    header-declared ``n`` beyond ``max_points`` (a frame asking for an
    unbounded distance computation is malformed, not merely large)."""
    if len(body) < _POINTS_HEADER.size:
        raise WireError(
            f"truncated frame: {len(body)} bytes is shorter than the "
            f"{_POINTS_HEADER.size}-byte points header")
    magic, ver, dtype, flags, n, d = _POINTS_HEADER.unpack_from(body)
    if magic != _WIRE_POINTS_MAGIC:
        raise WireError(
            f"bad magic {magic!r}: not an {WIRE_POINTS_CONTENT_TYPE} "
            f"frame")
    if ver != WIRE_VERSION:
        raise WireError(
            f"unsupported wire version {ver} (this server speaks "
            f"version {WIRE_VERSION})")
    if dtype != _WIRE_DTYPE_F32:
        raise WireError(
            f"unsupported payload dtype code {dtype} (version "
            f"{WIRE_VERSION} speaks little-endian float32 = "
            f"{_WIRE_DTYPE_F32})")
    if n < 1 or d < 1:
        raise WireError(
            f"frame declares an empty point matrix (n={n}, d={d})")
    if max_points and n > max_points:
        raise WireError(
            f"frame declares n={n} points; this server accepts at most "
            f"{max_points} per request")
    want = _POINTS_HEADER.size + 4 * n * d
    if len(body) != want:
        raise WireError(
            f"payload length mismatch: header declares n={n} d={d} "
            f"({want} bytes total), frame is {len(body)} bytes")
    x = np.frombuffer(body, dtype="<f4", count=n * d,
                      offset=_POINTS_HEADER.size).reshape(n, d)
    return x, int(flags)


def encode_labels(labels, *, generation: int, k: int,
                  distances=None) -> bytes:
    """Server-side framing of the assign response: raw i32 labels plus
    optional raw f32 distances, with the generation the hot-swap
    contract requires every response to report."""
    lab = np.ascontiguousarray(labels, np.int32)
    flags = WIRE_FLAG_DISTANCES if distances is not None else 0
    out = _LABELS_HEADER.pack(
        _WIRE_LABELS_MAGIC, WIRE_VERSION, _WIRE_DTYPE_F32, flags,
        lab.shape[0], int(k), int(generation)) + lab.tobytes()
    if distances is not None:
        out += np.ascontiguousarray(distances, np.float32).tobytes()
    return out


def decode_labels(body: bytes):
    """Client-side parse -> ``(labels, distances_or_None, generation,
    k)``: the symmetric half of :func:`encode_labels`."""
    if len(body) < _LABELS_HEADER.size:
        raise WireError(
            f"truncated frame: {len(body)} bytes is shorter than the "
            f"{_LABELS_HEADER.size}-byte labels header")
    magic, ver, dtype, flags, n, k, generation = \
        _LABELS_HEADER.unpack_from(body)
    if magic != _WIRE_LABELS_MAGIC:
        raise WireError(
            f"bad magic {magic!r}: not an {WIRE_LABELS_CONTENT_TYPE} "
            f"frame")
    if ver != WIRE_VERSION or dtype != _WIRE_DTYPE_F32:
        raise WireError(
            f"unsupported labels frame (version {ver}, dtype {dtype})")
    with_dist = bool(flags & WIRE_FLAG_DISTANCES)
    want = _LABELS_HEADER.size + 4 * n * (2 if with_dist else 1)
    if len(body) != want:
        raise WireError(
            f"payload length mismatch: header declares n={n} "
            f"distances={with_dist} ({want} bytes), frame is "
            f"{len(body)} bytes")
    off = _LABELS_HEADER.size
    lab = np.frombuffer(body, dtype="<i4", count=n, offset=off)
    dist = (np.frombuffer(body, dtype="<f4", count=n, offset=off + 4 * n)
            if with_dist else None)
    return lab, dist, int(generation), int(k)


# ---------------------------------------------------------------------------
# Device routes
# ---------------------------------------------------------------------------

def dense_k_tile(k: int, d: int, budget=None) -> int:
    """K5's column range for the dense route: the planner's ``k_tile`` for
    f32 operands (``kernel_plan("classic", d, k, x_itemsize=4,
    cd_itemsize=4)``, which prices the core's f32 pieces) where it tiles,
    else 128 columns: a range is one block's work for 128 rows, and one
    range over all of k leaves most of the card idle at a serving batch.
    On the core's f32 route 256-column ranges measured as fast at a full
    imagenet-serve batch and slower at its mean batch (PERF.md §6), so 128
    stays.  K5's labels do not depend on the range.  A refused shape
    raises: the route has no other kernel."""
    plan = kernel_plan("classic", d, k, x_itemsize=4, cd_itemsize=4,
                       budget=budget)
    if plan.mode == "refuse":
        raise ValueError(f"dense assign route: the planner refuses d={d}, "
                         f"k={k} in f32: {plan.why}")
    return plan.k_tile if plan.mode == "tiled" else LANE


def quant_k_tile(rows: int, k: int) -> int:
    """The quant scan's slice: as many columns, a multiple of 128, as keep
    one (rows, k_tile) f32 temporary within ``_DEV_SCAN_ELEMS``, at least
    128 and at most k rounded up to 128 (the scan's labels do not depend
    on the slice)."""
    cols = _DEV_SCAN_ELEMS // max(1, rows) // LANE * LANE
    return max(LANE, min(cols, -(-k // LANE) * LANE))


def pruned_m_tile(rows: int, d: int, m: int) -> int:
    """The pruned device route's candidate chunk: as many of the ``m``
    candidates as keep the gathered (rows, m_tile, d) block within
    ``_DEV_GATHER_ELEMS``, at least one."""
    return max(1, min(m, _DEV_GATHER_ELEMS // max(1, rows * d)))


def _pair_to_host(labels: torch.Tensor, ok: torch.Tensor):
    """``(labels int32, ok bool)`` as writable host arrays, in one copy
    back (the batch's one synchronisation on the card)."""
    both = torch.stack((labels, ok.to(torch.int32))).cpu().numpy()
    return both[0].copy(), both[1].astype(bool)


# ---------------------------------------------------------------------------
# Host routes (grouped NumPy GEMMs), the reference's, copied
# ---------------------------------------------------------------------------

def _score_groups(xs, bounds, prep, s_out, g_lo, g_hi):
    """GEMM the rows routed to groups ``[g_lo, g_hi)`` — one contiguous
    ``(rows_g, d) @ (d, m)`` BLAS product per non-empty group, writing
    into disjoint slices of the shared score matrix.  Deliberately
    NOTHING but GEMMs: BLAS releases the GIL, so group ranges
    parallelize for real; every elementwise op happens once, vectorized
    over the whole batch, outside this loop."""
    for gg in range(g_lo, g_hi):
        lo, hi = bounds[gg], bounds[gg + 1]
        if lo == hi:
            continue
        np.matmul(xs[lo:hi], prep.cand_mats2[gg], out=s_out[lo:hi])


def _group_splits(bounds: np.ndarray, g_n: int, chunks: int):
    """Partition groups into ``chunks`` contiguous ranges of roughly
    equal ROW count (groups are unequal; splitting by group index alone
    would leave one worker with most of the rows)."""
    total = int(bounds[-1])
    splits, target = [0], total / chunks
    for i in range(1, chunks):
        splits.append(int(np.searchsorted(bounds, target * i)))
    splits.append(g_n)
    return [(lo, hi) for lo, hi in zip(splits, splits[1:]) if hi > lo]


def _pruned_host(x: np.ndarray, prep: "PreparedModel", pool=None,
                 chunks: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Closure-pruned labels + per-row exactness certificate, as a
    grouped BLAS GEMM on the host (the pruned route on the CPU).

    Route each row to its nearest of G group centers, argsort rows by
    group, then one contiguous ``(rows_g, d) @ (d, m)`` product per
    non-empty group against that group's prepacked candidate matrix —
    fanned out over ``pool`` in ``chunks`` row-balanced group ranges
    when given.  Returns ``(labels, ok)``; a row with ``ok`` False has
    a candidate list its certificate could not prove complete and must
    rescore densely."""
    n = x.shape[0]
    g_n = prep.gc.shape[0]
    sg = x @ prep.gc2                                          # (B, G)
    sg += prep.gsq[None, :]
    g = sg.argmin(axis=1)
    order = np.argsort(g, kind="stable")
    xs = x[order]
    gso = g[order]
    bounds = np.searchsorted(gso, np.arange(g_n + 1))
    s = np.empty((n, prep.m), np.float32)
    if pool is not None and chunks > 1 and n >= 256:
        ranges = _group_splits(bounds, g_n, chunks)
        futs = [pool.submit(_score_groups, xs, bounds, prep, s, lo, hi)
                for lo, hi in ranges[1:]]
        _score_groups(xs, bounds, prep, s, *ranges[0])
        for f in futs:
            f.result()
    else:
        _score_groups(xs, bounds, prep, s, 0, g_n)
    s += prep.csq_cand[gso]
    j = s.argmin(axis=1)
    labels_s = np.take_along_axis(prep.cand[gso], j[:, None],
                                  axis=1)[:, 0]
    s_best = np.take_along_axis(s, j[:, None], axis=1)[:, 0]
    xsq = np.einsum("bd,bd->b", xs, xs)
    dg = np.sqrt(np.maximum(
        xsq + np.take_along_axis(sg[order], gso[:, None], axis=1)[:, 0],
        0.0))
    b = np.sqrt(np.maximum(xsq + s_best, 0.0))
    # Exact iff the best candidate provably beats every excluded
    # centroid: ||x - c_excl|| >= thr[g] - dg (triangle inequality).
    ok_s = b + _CERT_MARGIN_REL * (b + dg + 1.0) <= prep.thr[gso] - dg
    labels = np.empty(n, np.int32)
    ok = np.empty(n, bool)
    labels[order] = labels_s
    ok[order] = ok_s
    return labels, ok


def _score_groups_quant(xs, bounds, tier, s_out, g_lo, g_hi):
    """The quantized twin of :func:`_score_groups`: per non-empty group,
    expand that group's packed ``(d, m)`` candidate payload into one
    reusable f32 scratch tile (a cast/shift — the per-centroid scale
    folds into the vectorized elementwise pass outside this loop), then
    the same contiguous BLAS product.  The slab this loop actually
    *reads* is 1/4 (int8) or 1/2 (bf16) the f32 candidate matrices —
    the compression win on a memory-bound host."""
    scratch = np.empty(tier.cand_q.shape[1:], np.float32)
    for gg in range(g_lo, g_hi):
        lo, hi = bounds[gg], bounds[gg + 1]
        if lo == hi:
            continue
        qf = dequantize_matrix(tier.cand_q[gg], tier.mode, out=scratch)
        np.matmul(xs[lo:hi], qf, out=s_out[lo:hi])


def _quant_host(x: np.ndarray, prep: "PreparedModel", tier, pool=None,
                chunks: int = 1):
    """Quantized closure-pruned labels on the host: the grouped-BLAS
    routing of :func:`_pruned_host`, but the candidate GEMM reads the
    compressed codebook and the argmin is resolved by the error-bounded
    prune + exact f32 rescore of :func:`kmeans_tpu_torch.quant.score.
    quant_prune` (provably exact — see that module's safety argument).

    Two nested guarantees: the quantization error bound proves the
    chosen label optimal *among the group's candidate list*, and the
    closure certificate (identical to the f32 pruned path) proves the
    candidate list complete among all k — rows failing it rescore
    densely in the engine, exactly like the f32 path.

    Returns ``(labels, ok, n_rescore)``: int32 labels, the closure
    certificate, and the rows that needed the exact rescore."""
    n = x.shape[0]
    g_n = prep.gc.shape[0]
    sg = x @ prep.gc2                                          # (B, G)
    sg += prep.gsq[None, :]
    g = sg.argmin(axis=1)
    order = np.argsort(g, kind="stable")
    xs = x[order]
    gso = g[order]
    bounds = np.searchsorted(gso, np.arange(g_n + 1))
    s = np.empty((n, prep.m), np.float32)
    if pool is not None and chunks > 1 and n >= 256:
        ranges = _group_splits(bounds, g_n, chunks)
        futs = [pool.submit(_score_groups_quant, xs, bounds, tier, s,
                            lo, hi)
                for lo, hi in ranges[1:]]
        _score_groups_quant(xs, bounds, tier, s, *ranges[0])
        for f in futs:
            f.result()
    else:
        _score_groups_quant(xs, bounds, tier, s, 0, g_n)
    s *= tier.scale2_cand[gso]
    s += tier.csqh_cand[gso]
    xsq = np.einsum("bd,bd->b", xs, xs)
    labels_s, se_best, _n_cand, n_rescore = quant_prune(
        xs, xsq, s, tier.err_cand[gso], prep.cand[gso],
        prep.gen.centroids, prep.csq)
    dg = np.sqrt(np.maximum(
        xsq + np.take_along_axis(sg[order], gso[:, None], axis=1)[:, 0],
        0.0))
    b = np.sqrt(np.maximum(xsq + se_best, 0.0))
    ok_s = b + _CERT_MARGIN_REL * (b + dg + 1.0) <= prep.thr[gso] - dg
    labels = np.empty(n, np.int32)
    ok = np.empty(n, bool)
    labels[order] = labels_s.astype(np.int32)
    ok[order] = ok_s
    return labels, ok, n_rescore


def assign_direct(gen, x: np.ndarray) -> np.ndarray:
    """The per-request NumPy path (``assign_batching=False``): one
    immutable generation, its squared norms cached on it
    (:meth:`Generation.sq_norms`)."""
    c = gen.centroids
    d2 = ((x * x).sum(1)[:, None] - 2.0 * (x @ c.T)
          + gen.sq_norms()[None, :])
    return d2.argmin(1)


class _QuantTier:
    """The compressed scoring tier of one prepared generation: the
    quantized codebook, its per-group candidate packs for the host
    route's grouped GEMM, and (lazily) its tensors on the engine's device
    for the quant scan.  Built on the first quant-routed batch after a
    publish, so a generation pays the quantization only if the tier is
    routed to."""

    __slots__ = ("mode", "qcb", "cand_q", "scale2_cand", "csqh_cand",
                 "err_cand", "_qdev")

    def __init__(self, prep: "PreparedModel", mode: str):
        self.mode = mode
        self.qcb = quantize_codebook(prep.gen.centroids, mode)
        self._qdev = None
        if prep.pruned:
            cand, q = prep.cand, self.qcb.q
            # Packed (G, d, m) payload tiles, the compressed twin of
            # PreparedModel.cand_mats2.  The -2x cannot fold into an
            # integer payload, so -2·scale folds into the per-candidate
            # elementwise pass instead (uniform -2 for bf16).
            self.cand_q = np.stack([
                np.ascontiguousarray(q[cand[g]].T)
                for g in range(prep.g_n)])
            self.scale2_cand = np.ascontiguousarray(
                (-2.0 * self.qcb.scale.astype(np.float64))
                .astype(np.float32)[cand])
            self.csqh_cand = self.qcb.csq_hat[cand]
            self.err_cand = self.qcb.err[cand]

    def device(self, device: torch.device):
        """``(q, scale, err, csq_hat)`` on ``device`` for the quant scan,
        moved once per generation."""
        if self._qdev is None:
            self._qdev = tuple(torch.from_numpy(a).to(device) for a in (
                self.qcb.q, self.qcb.scale, self.qcb.err, self.qcb.csq_hat))
        return self._qdev


class PreparedModel:
    """Everything serving needs about one generation, built once: the
    cached squared norms; the closure tables when k clears
    ``prune_min_k`` (group centers, candidate lists, the host route's
    prepacked ``(d, m)`` candidate matrices and the exactness thresholds);
    and, lazily, each device route's tensors on ``device``.  Immutable
    after construction, like the generation it wraps (a lazy tensor set
    is built once; two dispatchers racing it build it twice, and either
    copy is right).
    """

    __slots__ = ("gen", "k", "d", "csq", "pruned", "g_n", "m",
                 "gc", "gc2", "gsq", "cand", "csq_cand", "thr",
                 "cand_mats2", "device", "_dev", "_pieces", "_pdev", "_quant")

    def __init__(self, gen, *, prune_min_k: int = 256, device=None):
        self.gen = gen
        self.k, self.d = gen.k, gen.d
        self.device = resolve_device(device)
        self.csq = gen.sq_norms()
        self._dev = None
        self._pieces = None
        self._pdev = None
        self._quant = None
        self.pruned = bool(prune_min_k) and gen.k >= int(prune_min_k)
        if self.pruned:
            c = gen.centroids
            gc, cand, thr = closure_candidates(c)
            self.g_n, self.m = int(cand.shape[0]), int(cand.shape[1])
            self.gc = gc
            # The -2x folds into the prepacked operands so the batch
            # path's elementwise work is two adds and an argmin.
            self.gc2 = np.ascontiguousarray(-2.0 * gc.T)
            self.gsq = np.einsum("gd,gd->g", gc, gc).astype(np.float32)
            self.cand = cand
            self.csq_cand = self.csq[cand]
            self.thr = thr
            self.cand_mats2 = np.stack([
                np.ascontiguousarray(-2.0 * c[cand[g]].T)
                for g in range(self.g_n)])
        else:
            self.g_n = self.m = 0

    def _tensors(self, *arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in arrays)

    def dense_dev(self):
        """``(−2·C, csq, k_tile)`` for K5: the f32 operands on the device,
        moved once per generation (−2·C is exact, a power-of-two scale),
        and :func:`dense_k_tile`.  On a card where the core's f32 route
        takes d, −2·C's three bf16 pieces are split once beside them
        (:meth:`dense_pieces`)."""
        if self._dev is None:
            neg2c, csq = self._tensors(self.gen.centroids * np.float32(-2.0),
                                       self.csq)
            if self.device.type == "cuda" and core_takes("classic", self.d,
                                                         4, 4):
                self._pieces = neg2c_pieces(neg2c)
            self._dev = (neg2c, csq, dense_k_tile(self.k, self.d))
        return self._dev

    def dense_pieces(self):
        """−2·C's bf16 pieces for K5's ``neg2c_pieces=`` (None where K5
        scores without them: its plain version, or ``score_block``)."""
        self.dense_dev()
        return self._pieces

    def pruned_dev(self):
        """``(gc, gsq, cand, csq_cand, thr, centroids)`` on the device for
        the pruned device route, moved once per generation."""
        if self._pdev is None:
            self._pdev = self._tensors(self.gc, self.gsq, self.cand,
                                       self.csq_cand, self.thr,
                                       self.gen.centroids)
        return self._pdev

    def quant_tier(self, mode: str) -> _QuantTier:
        """The compressed scoring tier in ``mode``, built on first use and
        kept for the generation's serving life (one mode at a time; a
        config flip rebuilds once)."""
        tier = self._quant
        if tier is None or tier.mode != mode:
            tier = _QuantTier(self, mode)
            self._quant = tier
        return tier


class _Pending:
    """One enqueued request: rows in, labels + generation out."""

    __slots__ = ("points", "n", "event", "labels", "gen", "error", "t_enq")

    def __init__(self, points: np.ndarray):
        self.points = points
        self.n = int(points.shape[0])
        self.event = threading.Event()
        self.labels: Optional[np.ndarray] = None
        self.gen = None
        self.error: Optional[Exception] = None
        self.t_enq = time.perf_counter()


_SHUTDOWN = object()

#: Floor and ceiling of the adaptive inter-arrival estimate: the floor
#: stops one dense burst from convincing the batcher that requests arrive
#: every 0 s forever; the ceiling keeps one quiet night from making it
#: sluggish at the next burst's front edge.
_GAP_MIN_S, _GAP_MAX_S = 1e-5, 1.0


class AssignEngine:
    """The micro-batcher: a bounded queue drained by ``assign_workers``
    dispatcher threads, each coalescing its own batch (every batch reads
    its own generation snapshot, so batches are independent).

    ``current_model`` is a zero-argument callable returning the current
    :class:`~kmeans_tpu_torch.continuous.registry.Generation` (or None); a
    dispatcher calls it once per batch, which is the hot-swap contract.
    ``device`` is where the routes score: None is the card (raising
    without one), ``"cpu"`` runs the kernels' plain versions.  Worker
    threads start on the first :meth:`submit`.
    """

    #: Prepared generations kept after a swap: in-flight batches finish on
    #: the old model while the next batch warms the new one.
    _PREP_KEEP = 4

    def __init__(self, current_model: Callable[[], object], config, *,
                 device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self._current_model = current_model
        self._max_rows = max(int(config.assign_max_batch_rows),
                             int(config.assign_max_points))
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(config.assign_pending_limit)))
        self._n_workers = max(1, int(config.assign_workers))
        self._kernel_threads = max(1, int(config.assign_kernel_threads))
        self._pool = None               # lazy, with the worker threads
        self._closed = False            # stop() is permanent
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._thread_lock = threading.Lock()
        self._gap_lock = threading.Lock()
        self._gap_ewma = _GAP_MAX_S     # optimistic: sparse until proven
        self._last_enq = None
        #: Each dispatcher's pinned staging buffer on the card.
        self._local = threading.local()
        # Shared across dispatchers; batch-granularity updates under
        # _stats_lock (cheap next to a kernel call).
        self._stats_lock = threading.Lock()
        self._prep: "collections.OrderedDict[int, PreparedModel]" = \
            collections.OrderedDict()
        self._n_batches = 0
        self._n_rows = 0
        self._n_requests = 0
        self._n_fallback_rows = 0
        self._n_quant_batches = 0
        self._n_quant_rescore_rows = 0
        self._bucket_counts: collections.Counter = collections.Counter()

    # ------------------------------------------------------------ client
    def submit(self, points: np.ndarray):
        """Label ``points`` (n, d) float32 against one immutable
        generation; returns ``(labels, generation)``.  Raises
        :class:`NoModelError` / :class:`QueueFullError` /
        :class:`AssignTimeoutError`, or the error that failed the batch."""
        self._ensure_thread()
        if not (isinstance(points, np.ndarray)
                and points.dtype == np.float32
                and points.flags.c_contiguous):
            points = np.ascontiguousarray(points, np.float32)
        if points.ndim != 2:
            # Validated here: a malformed submit must fail alone, not
            # poison the coalesced batch it would have joined.
            raise ValueError(
                f"points must be (n, d); got shape {points.shape}")
        p = _Pending(points)
        now = p.t_enq
        with self._gap_lock:
            if self._last_enq is not None:
                gap = min(max(now - self._last_enq, _GAP_MIN_S),
                          _GAP_MAX_S)
                self._gap_ewma = 0.8 * self._gap_ewma + 0.2 * gap
            self._last_enq = now
        try:
            self._q.put_nowait(p)
        except queue.Full:
            raise QueueFullError(
                f"assign queue full ({self.cfg.assign_pending_limit} "
                "pending requests); retry shortly") from None
        if self._closed:
            # The enqueue-vs-stop() race: if stop()'s drain ran before
            # this put landed, nobody else will fail it.
            self._drain_pending()
        if not p.event.wait(float(self.cfg.assign_timeout_s)):
            raise AssignTimeoutError(
                f"assign batch did not complete within "
                f"{self.cfg.assign_timeout_s}s")
        if p.error is not None:
            raise p.error
        return p.labels, p.gen

    # ------------------------------------------------------------ control
    def _ensure_thread(self) -> None:
        if self._closed:
            raise NoModelError("assign engine stopped")
        if any(t.is_alive() for t in self._threads):
            return
        with self._thread_lock:
            if self._closed:
                raise NoModelError("assign engine stopped")
            if any(t.is_alive() for t in self._threads):
                return
            self._stop.clear()
            if self._pool is None and self._kernel_threads > 1:
                import concurrent.futures

                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._kernel_threads - 1,
                    thread_name_prefix="assign-kernel")
            self._threads = [
                threading.Thread(target=self._loop, daemon=True,
                                 name=f"assign-batcher-{i}")
                for i in range(self._n_workers)]
            for t in self._threads:
                t.start()

    def stop(self) -> None:
        """Stop the dispatchers, permanently, and fail anything still
        queued with :class:`NoModelError`."""
        with self._thread_lock:
            self._closed = True
        self._stop.set()
        live = [t for t in self._threads if t.is_alive()]
        for _ in live:
            try:
                self._q.put_nowait(_SHUTDOWN)
            except queue.Full:
                break   # loops notice _stop at their next poll timeout
        for t in live:
            t.join(timeout=10.0)
        with self._thread_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        self._drain_pending()

    def _drain_pending(self) -> None:
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is _SHUTDOWN:
                continue
            p.error = NoModelError("server stopping")
            p.event.set()

    @property
    def closed(self) -> bool:
        """True once :meth:`stop` has run (permanent)."""
        return self._closed

    def stats(self) -> Dict[str, object]:
        """Snapshot of the engine's counters."""
        with self._stats_lock:
            return {
                "batches": self._n_batches,
                "requests": self._n_requests,
                "rows": self._n_rows,
                "fallback_rows": self._n_fallback_rows,
                "quant_batches": self._n_quant_batches,
                "quant_rescore_rows": self._n_quant_rescore_rows,
                "batch_rows_pow2": dict(self._bucket_counts),
                "mean_batch_rows": (self._n_rows / self._n_batches
                                    if self._n_batches else 0.0),
            }

    # -------------------------------------------------------- dispatcher
    def _loop(self) -> None:
        carry = None
        while not self._stop.is_set():
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
            if first is _SHUTDOWN:
                continue
            batch = [first]
            rows = first.n
            # Phase 1, greedy drain: everything already queued (it piled
            # up while the previous batch was in the kernel) coalesces for
            # free.  Under sustained load the kernel time of batch N is
            # the coalescing window of batch N+1.
            while rows < self._max_rows:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    break
                if rows + nxt.n > self._max_rows:
                    carry = nxt          # opens the next batch instead
                    break
                batch.append(nxt)
                rows += nxt.n
            # Phase 2, bounded wait for more: only while the oldest
            # request's delay budget lasts and the observed arrival gap
            # says another request plausibly lands inside it.
            deadline = first.t_enq + float(self.cfg.assign_max_delay_s)
            while (carry is None and rows < self._max_rows
                   and not self._stop.is_set()):
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._gap_ewma > remaining:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    break
                if rows + nxt.n > self._max_rows:
                    carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.n
            try:
                self._dispatch(batch)
            except Exception as e:   # fail the batch, never the thread
                for p in batch:
                    p.error = e
                    p.event.set()
        if carry is not None:
            carry.error = NoModelError("server stopping")
            carry.event.set()

    def _prepared(self, gen) -> PreparedModel:
        with self._stats_lock:
            prep = self._prep.get(gen.generation)
            if prep is not None and prep.gen is gen:
                return prep
        # Built outside the lock; two workers racing a fresh generation
        # build it twice, and the last writer wins.
        prep = PreparedModel(
            gen, prune_min_k=int(self.cfg.assign_prune_min_k),
            device=self.device)
        with self._stats_lock:
            self._prep[gen.generation] = prep
            self._prep.move_to_end(gen.generation)
            while len(self._prep) > self._PREP_KEEP:
                self._prep.popitem(last=False)
        return prep

    def _bucket(self, rows: int) -> int:
        b = max(1, int(self.cfg.assign_min_bucket))
        while b < rows:
            b <<= 1
        return min(b, max(self._max_rows, rows))

    def _pruned_route(self) -> str:
        """``host`` | ``device``: ``assign_pruned_backend`` when it names
        one, else ``device`` on a CUDA card and ``host`` on the CPU (the
        reference's rule, "device when the backend is an accelerator")."""
        mode = str(self.cfg.assign_pruned_backend).lower()
        if mode in ("host", "device"):
            return mode
        return "device" if self.device.type == "cuda" else "host"

    def _quant_mode(self, prep: PreparedModel,
                    rows: Optional[int] = None) -> Optional[str]:
        """``int8`` | ``bf16`` | None: whether this batch scores through
        the compressed tier.  ``assign_quant`` forces a mode;
        ``assign_pruned_backend="quant"`` opts in at int8; otherwise int8
        engages when the f32 codebook reaches ``_QUANT_AUTO_SLAB_BYTES``.
        Only pruned-prepared models engage, and only batches of at least
        ``assign_quant_min_rows`` rows."""
        if not prep.pruned:
            return None
        if rows is not None and rows < int(self.cfg.assign_quant_min_rows):
            return None
        mode = str(self.cfg.assign_quant).lower()
        if mode in QUANT_MODES:
            return mode
        if mode not in ("off", ""):
            raise ValueError(
                f"assign_quant={mode!r}: expected int8 | bf16 | off")
        backend = str(self.cfg.assign_pruned_backend).lower()
        if backend == "quant":
            return "int8"
        if (backend == "auto"
                and prep.k * prep.d * 4 >= _QUANT_AUTO_SLAB_BYTES):
            return "int8"
        return None

    def _dispatch(self, batch: List[_Pending]) -> None:
        # ONE generation per coalesced batch: the hot-swap contract.
        gen = self._current_model()
        if gen is None:
            for p in batch:
                p.error = NoModelError(
                    "no model generation published yet; retry shortly")
                p.event.set()
            return
        good = [p for p in batch if p.points.shape[1] == gen.d]
        for p in batch:
            if p.points.shape[1] != gen.d:
                # A swap changed d after the request was sent: retryable.
                p.error = NoModelError(
                    f"model dimensionality changed mid-flight "
                    f"(generation {gen.generation} expects d={gen.d}, "
                    f"request has d={p.points.shape[1]}); retry")
                p.event.set()
        if not good:
            return
        rows = sum(p.n for p in good)
        prep = self._prepared(gen)
        qmode = self._quant_mode(prep, rows)
        kind = ("quant" if qmode
                else "pruned" if prep.pruned else "dense")
        x = (good[0].points if len(good) == 1
             else np.concatenate([p.points for p in good]))
        labels = self._run_kernel(kind, prep, x, rows, qmode=qmode)
        with self._stats_lock:
            self._n_batches += 1
            self._n_requests += len(good)
            self._n_rows += rows
            self._bucket_counts[self._bucket(rows)] += 1
        off = 0
        for p in good:
            p.labels = labels[off:off + p.n]
            p.gen = gen
            off += p.n
            p.event.set()

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        """The batch's rows as a tensor on the engine's device.  On the
        card they go through this dispatcher's pinned buffer (reused:
        each batch synchronises on its labels before the next one)."""
        if self.device.type != "cuda":
            return torch.from_numpy(x if x.flags.writeable else x.copy())
        buf = getattr(self._local, "pinned", None)
        if buf is None or buf.numel() < x.size:
            buf = torch.empty(max(x.size, self._max_rows * x.shape[1]),
                              dtype=torch.float32, pin_memory=True)
            self._local.pinned = buf
        host = buf[:x.size].view(x.shape)
        host.numpy()[...] = x
        return host.to(self.device, non_blocking=True)

    def _rescore(self, prep: PreparedModel, x: np.ndarray,
                 labels: np.ndarray, bad: np.ndarray,
                 x_dev: Optional[torch.Tensor] = None) -> None:
        """Dense scores for the rows a certificate could not prove: K5 on
        the rows already staged (``x_dev``, a device route's batch) or on
        a card, so they get the dense route's labels bit for bit; NumPy
        on the host for a host route on the CPU, as the reference does."""
        if x_dev is None and self.device.type != "cuda":
            sub = np.ascontiguousarray(x[bad])
            d2 = -2.0 * (sub @ prep.gen.centroids.T) + prep.csq[None, :]
            labels[bad] = d2.argmin(axis=1).astype(np.int32)
            return
        sub = (x_dev.index_select(0, torch.from_numpy(bad).to(x_dev.device))
               if x_dev is not None
               else self._stage(np.ascontiguousarray(x[bad])))
        labels[bad] = self._dense(prep, sub)

    def _dense(self, prep: PreparedModel, x_dev: torch.Tensor) -> np.ndarray:
        """K5's labels of staged rows (its plain version on the CPU)."""
        neg2c, csq, k_tile = prep.dense_dev()
        labels = tiled_argmin_cuda(x_dev, neg2c, csq, k_tile=k_tile,
                                   raw_scores=True,
                                   neg2c_pieces=prep.dense_pieces())[0]
        return labels.cpu().numpy()

    def _run_kernel(self, kind: str, prep: PreparedModel,
                    x: np.ndarray, rows: int,
                    qmode: Optional[str] = None) -> np.ndarray:
        if kind == "quant":
            return self._run_quant(prep, x, rows, qmode)
        if kind == "pruned":
            x_dev = None
            if self._pruned_route() == "device":
                x_dev = self._stage(x)
                labels, ok = _pair_to_host(*closure_assign_device(
                    x_dev, *prep.pruned_dev(),
                    m_tile=pruned_m_tile(rows, prep.d, prep.m),
                    margin_rel=_CERT_MARGIN_REL))
            else:
                labels, ok = _pruned_host(x, prep, pool=self._pool,
                                          chunks=self._kernel_threads)
            bad = np.flatnonzero(~ok)
            if bad.size:
                # Pruning is an optimization, never an approximation.
                with self._stats_lock:
                    self._n_fallback_rows += int(bad.size)
                self._rescore(prep, x, labels, bad, x_dev)
            return labels
        return self._dense(prep, self._stage(x))

    def _run_quant(self, prep: PreparedModel, x: np.ndarray, rows: int,
                   mode: str) -> np.ndarray:
        """The compressed-codebook route.  Host: grouped GEMM over the
        packed candidate tiles, error-bounded prune, exact rescore of the
        ambiguous survivors, then the closure certificate's dense
        fallback as on the f32 pruned route.  Device: the quant scan over
        the whole compressed codebook; rows it cannot certify are rescored
        densely (:meth:`_rescore`) and counted as quant rescores."""
        tier = prep.quant_tier(mode)
        if self._pruned_route() == "device":
            x_dev = self._stage(x)
            labels, ok = _pair_to_host(*quant_assign_device(
                x_dev, *tier.device(self.device), mode,
                k_tile=quant_k_tile(rows, prep.k),
                margin_rel=QUANT_MARGIN_REL))
            bad = np.flatnonzero(~ok)
            with self._stats_lock:
                self._n_quant_batches += 1
                self._n_quant_rescore_rows += int(bad.size)
            if bad.size:
                self._rescore(prep, x, labels, bad, x_dev)
            return labels
        labels, ok, n_rescore = _quant_host(
            x, prep, tier, pool=self._pool, chunks=self._kernel_threads)
        bad = np.flatnonzero(~ok)
        with self._stats_lock:
            self._n_quant_batches += 1
            self._n_quant_rescore_rows += n_rescore
            self._n_fallback_rows += int(bad.size)
        if bad.size:
            self._rescore(prep, x, labels, bad)
        return labels
