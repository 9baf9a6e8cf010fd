"""The four Lloyd sweep kernels: CUDA wrappers, plain versions and the plan.

Counterpart of ``kmeans_tpu/ops/pallas_lloyd.py``.  Each TPU kernel of the
full-batch delta and bound-pruned paths has a hand-written Hopper kernel in
``kmeans_tpu_torch/csrc/lloyd.cu`` (built by :mod:`kmeans_tpu_torch.ops._build`)
and, beside it here, a plain PyTorch version of the same function:

======================= ======================== ============================
wrapper                 replaces                 plain version
======================= ======================== ============================
``lloyd_pass_cuda``     ``lloyd_pass_pallas``    ``lloyd_pass_plain``
``lloyd_delta_cuda``    ``lloyd_delta_pallas``   ``lloyd_delta_plain``
``accumulate_cuda``     ``accumulate_pallas``    ``accumulate_plain``
``lloyd_hamerly_cuda``  ``lloyd_hamerly_pallas`` ``lloyd_hamerly_plain``
======================= ======================== ============================

A wrapper given a tensor on the CPU runs the plain version; given a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches`` (:func:`launch_counts`, :func:`reset_launch_counts`),
so a run can show which kernels its main path went through.

Numerics shared by the kernels and the plain versions: scores are
``||c||² + x_cd·(−2·C_cd)ᵀ`` with f32 accumulation (bf16 operands multiply
exactly; f32 products never use TF32), the argmin keeps the lowest index on
a tie, ``||x||²`` is taken from x in its stored dtype, and the fold adds
``w·float(cd(x))``.  The kernels fold with f32 atomics, so their sums differ
from the plain versions' (and from run to run) at the f32 rounding level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kmeans_tpu_torch.device import as_dtype
from kmeans_tpu_torch.ops.distance import full_f32, resolve_cd, sq_norms

__all__ = ["KernelPlan", "kernel_plan",
           "lloyd_pass_cuda", "lloyd_delta_cuda", "accumulate_cuda",
           "lloyd_hamerly_cuda", "lloyd_pass_plain", "lloyd_delta_plain",
           "accumulate_plain", "lloyd_hamerly_plain",
           "launch_counts", "reset_launch_counts",
           "DENSE_GROUP_ROWS", "DENSE_SLOTS", "HAMERLY_SLOTS"]

#: ``dense_tiles`` keeps the TPU kernels' meaning: the number of 1024-row
#: groups (their row tile) with more rows to compact than their slot budget
#: ``mc`` -- 128 changed rows for the delta kernel, 256 needed rows for the
#: Hamerly kernel.  Reported, never branched on: the CUDA kernels scatter
#: every changed row and score every needed one.
DENSE_GROUP_ROWS = 1024
DENSE_SLOTS = 128
HAMERLY_SLOTS = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelPlan(NamedTuple):
    """A dispatch decision for the kernels at one input: ``mode`` is
    ``"cuda"`` or ``"refuse"``; ``why`` says why, in one line."""

    mode: str
    why: str


def kernel_plan(x, k: int, *, weights=None, weights_are_binary: bool = False,
                compute_dtype=None, device=None) -> KernelPlan:
    """Whether the CUDA kernels take this input (counterpart of
    ``kernel_plan`` and the vetoes of ``ops/lloyd._pallas_plan``).

    ``x`` needs only ``shape`` and ``dtype`` (a numpy array will do);
    ``device`` overrides ``x.device``.  The kernels take any n, d and k
    (ragged edges are masked, so nothing is tiled or padded), x in float32
    or bfloat16, and a float32 or bfloat16 compute dtype.  They refuse off
    the card, and for fractional weights in a non-f32 compute dtype: the
    reference's exactness policy (:func:`kmeans_tpu_torch.ops.lloyd.
    weights_exact`) that every fit resolves its update flavour by."""
    from kmeans_tpu_torch.ops.lloyd import weights_exact

    x_dtype = as_dtype(x.dtype)
    if x_dtype == torch.float64:
        x_dtype = torch.float32
    cd = resolve_cd(compute_dtype, x_dtype)
    dev = torch.device(device) if device is not None else x.device
    if not weights_exact(cd, weights=weights,
                         weights_are_binary=weights_are_binary):
        return KernelPlan("refuse",
                          "fractional weights in a non-f32 compute dtype")
    if dev.type != "cuda":
        return KernelPlan("refuse", f"not running on a CUDA device ({dev})")
    if x_dtype not in _DTYPE_CODES or cd not in _DTYPE_CODES:
        return KernelPlan(
            "refuse", f"x dtype {x_dtype} / compute dtype {cd}: the kernels "
            "take float32 or bfloat16")
    n, d = x.shape
    if n < 1 or n * max(d, k) >= 2 ** 62 or max(n, d, k) >= 2 ** 31:
        return KernelPlan("refuse", f"shape n={n}, d={d}, k={k} out of range")
    return KernelPlan("cuda", "any n, d, k: ragged edges are masked")


def _counted(fn):
    fn.launches = 0
    return fn


def launch_counts() -> dict:
    """``{wrapper name: launches}`` since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _weights(weights, n: int, device) -> torch.Tensor:
    if weights is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return weights.to(device=device, dtype=torch.float32).contiguous()


def _score_operands(centroids: torch.Tensor, cd: torch.dtype):
    """``(−2·C in cd, ||C||² in f32)`` — the TPU's ``_neg2_ct`` convention.
    The ×(−2) is an exponent shift on the cast values, so every score is
    exactly ``csq − 2·x·c``."""
    return ((centroids.to(cd) * -2).contiguous(),
            sq_norms(centroids).contiguous())


def _check_cuda_inputs(name: str, x: torch.Tensor, k: int, cd: torch.dtype,
                       w: torch.Tensor, neg2c: Optional[torch.Tensor],
                       *vectors: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: ``w`` and each of
    ``vectors`` must be (n,), ``neg2c`` (k, d)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (n, d) tensor")
    if x.dtype not in _DTYPE_CODES or cd not in _DTYPE_CODES:
        raise ValueError(f"{name}: x dtype {x.dtype} / compute dtype {cd}; "
                         "the kernel takes float32 or bfloat16")
    n, d = x.shape
    if n < 1 or d < 1 or k < 1:
        raise ValueError(f"{name}: empty shape n={n}, d={d}, k={k}")
    if neg2c is not None and tuple(neg2c.shape) != (k, d):
        raise ValueError(f"{name}: centroids shape {tuple(neg2c.shape)} != "
                         f"{(k, d)}")
    for v in (w, *vectors):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name}: per-row operand shape "
                             f"{tuple(v.shape)} != ({n},)")
    for v in (w, *vectors, *([] if neg2c is None else [neg2c])):
        if v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous and on "
                             f"{x.device}")


def _vec_ok(d: int, cd: torch.dtype, *tensors: torch.Tensor) -> int:
    """1 when the kernel may use 16-byte row loads: d a multiple of the
    vector width and every base pointer 16-byte aligned."""
    width = 8 if cd == torch.bfloat16 else 4
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return int(d % width == 0 and aligned)


def _launch(wrapper, entry: str, x: torch.Tensor, *args) -> None:
    """Call one C entry point on PyTorch's current stream of x's device and
    raise if the launch was refused."""
    from kmeans_tpu_torch.ops._build import library

    fn = getattr(library(), entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed with "
                           f"CUDA error {err}")
    wrapper.launches += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (chunked matmul + argmin + index_add_)
# ---------------------------------------------------------------------------

def _chunks(n: int, chunk_size: int):
    for s in range(0, n, chunk_size):
        yield slice(s, min(n, s + chunk_size))


def _argmin_plain(x, centroids, cd, chunk_size, rows=None, with_second=False):
    """Per-row ``(lowest-index argmin, min score)`` of ``csq + x·(−2C)ᵀ`` over
    the rows of x, or over ``x[rows]`` (gathered chunk by chunk); with
    ``with_second`` also the least score over the other columns (the
    reference's ``_second_min_rows``: an exact duplicate of the winning
    centroid makes it equal the min)."""
    neg2c, csq = _score_operands(centroids, cd)
    neg2c_t = neg2c.float().T
    n = x.shape[0] if rows is None else rows.numel()
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    part_min = torch.empty(n, dtype=torch.float32, device=x.device)
    second = torch.empty_like(part_min) if with_second else None
    with full_f32():
        for s in _chunks(n, chunk_size):
            xr = x[s] if rows is None else x[rows[s]]
            part = csq + xr.to(cd).float() @ neg2c_t
            lab = part.argmin(dim=1)[:, None]
            labels[s] = lab[:, 0].int()
            part_min[s] = part.gather(1, lab)[:, 0]
            if with_second:
                second[s] = part.scatter_(1, lab, torch.inf).amin(dim=1)
    return (labels, part_min, second) if with_second else (labels, part_min)


def _row_sq_plain(x, chunk_size):
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for rows in _chunks(x.shape[0], chunk_size):
        out[rows] = sq_norms(x[rows])
    return out


def _fold_plain(sums, counts, x, labels, w, fold_dtype, chunk_size, sign=1.0,
                rows_mask=None):
    """``sums[label] += sign·w·float(fold_dtype(x))``, ``counts[label] +=
    sign·w`` over rows with ``0 <= label < k`` (and ``rows_mask``)."""
    k = sums.shape[0]
    for rows in _chunks(x.shape[0], chunk_size):
        lab = labels[rows].long()
        keep = (lab >= 0) & (lab < k)
        if rows_mask is not None:
            keep &= rows_mask[rows]
        idx = keep.nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        wr = sign * w[rows][idx]
        xr = x[rows][idx].to(fold_dtype).float() * wr[:, None]
        sums.index_add_(0, lab[idx], xr)
        counts.index_add_(0, lab[idx], wr)


def _signed_fold_plain(x, k, labels, prev, changed, w, cd, chunk_size):
    """``(dsums, dcounts)`` of the signed fold over ``changed`` rows: ``+w``
    at ``labels``, ``−w`` at ``prev`` where ``0 <= prev < k``."""
    dsums = torch.zeros(k, x.shape[1], dtype=torch.float32, device=x.device)
    dcounts = torch.zeros(k, dtype=torch.float32, device=x.device)
    _fold_plain(dsums, dcounts, x, labels, w, cd, chunk_size,
                rows_mask=changed)
    _fold_plain(dsums, dcounts, x, prev, w, cd, chunk_size, sign=-1.0,
                rows_mask=changed)
    return dsums, dcounts


def lloyd_pass_plain(x, centroids, *, weights=None, compute_dtype=None,
                     with_update=True, update="matmul", chunk_size=4096):
    """Plain version of :func:`lloyd_pass_cuda` (and of the reference's XLA
    route): ``update="segment"`` folds ``float(x)`` instead of the cd-cast
    row, as ``jax.ops.segment_sum`` over f32 rows does there."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    labels, part_min = _argmin_plain(x, centroids, cd, chunk_size)
    min_d2 = (part_min + _row_sq_plain(x, chunk_size)).clamp_min(0.0)
    sums = torch.zeros(k, d, dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    if with_update:
        fold = cd if update == "matmul" else torch.float32
        _fold_plain(sums, counts, x, labels, w, fold, chunk_size)
    return labels, min_d2, sums, counts, (min_d2 * w).sum()


def _dense_tiles(rows: torch.Tensor, slots: int = DENSE_SLOTS) -> torch.Tensor:
    """1024-row groups with more than ``slots`` rows flagged in ``rows``."""
    n = rows.shape[0]
    pad = (-n) % DENSE_GROUP_ROWS
    per_group = torch.nn.functional.pad(rows.int(), (0, pad)).view(
        -1, DENSE_GROUP_ROWS).sum(dim=1)
    return (per_group > slots).sum().int()


def lloyd_delta_plain(x, centroids, labels_prev, *, weights=None,
                      compute_dtype=None, with_mind=True, chunk_size=4096):
    """Plain version of :func:`lloyd_delta_cuda`."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n = x.shape[0]
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    prev = labels_prev.to(device=x.device, dtype=torch.int32)
    labels, part_min = _argmin_plain(x, centroids, cd, chunk_size)
    changed = (labels != prev) & (w > 0)
    dsums, dcounts = _signed_fold_plain(x, k, labels, prev, changed, w, cd,
                                        chunk_size)
    min_d2 = ((part_min + _row_sq_plain(x, chunk_size)).clamp_min(0.0)
              if with_mind else part_min)
    return (labels, min_d2, dsums, dcounts, (min_d2 * w).sum(),
            changed.sum().int(), _dense_tiles(changed))


def lloyd_hamerly_plain(x, centroids, labels_prev, need, sb_in, slb_in, *,
                        weights=None, compute_dtype=None, chunk_size=4096):
    """Plain version of :func:`lloyd_hamerly_cuda`: the rows flagged
    ``need`` are gathered and scored; every other row keeps ``labels_prev``,
    ``sb_in`` and ``slb_in``."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n = x.shape[0]
    k = centroids.shape[0]
    dev = x.device
    w = _weights(weights, n, dev)
    prev = labels_prev.to(device=dev, dtype=torch.int32)
    need = need.to(device=dev, dtype=torch.bool)
    rows = need.nonzero()[:, 0]
    lab_r, best_r, second_r = _argmin_plain(x, centroids, cd, chunk_size,
                                            rows=rows, with_second=True)
    labels = prev.clone()
    labels[rows] = lab_r
    sb = sb_in.to(device=dev, dtype=torch.float32).clone()
    sb[rows] = best_r
    slb = slb_in.to(device=dev, dtype=torch.float32).clone()
    slb[rows] = second_r
    changed = need & (labels != prev) & (w > 0)
    dsums, dcounts = _signed_fold_plain(x, k, labels, prev, changed, w, cd,
                                        chunk_size)
    return (labels, sb, slb, dsums, dcounts, need.sum().int(),
            _dense_tiles(need, HAMERLY_SLOTS))


def accumulate_plain(x, labels, k, *, scores=None, weights=None,
                     compute_dtype=None, chunk_size=4096):
    """Plain version of :func:`accumulate_cuda`."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    w = _weights(weights, n, x.device)
    sums = torch.zeros(k, d, dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    _fold_plain(sums, counts, x, labels.to(x.device), w, cd, chunk_size)
    g = 0.0 if scores is None else scores.to(x.device, torch.float32)
    min_d2 = (g + _row_sq_plain(x, chunk_size)).clamp_min(0.0)
    return sums, counts, min_d2


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@_counted
def lloyd_pass_cuda(x, centroids, *, weights=None, compute_dtype=None,
                    with_update=True):
    """K1: the classic fused sweep (replaces ``lloyd_pass_pallas``).

    Returns ``(labels int32 [n], min_d2 f32 [n], sums f32 [k, d], counts
    f32 [k], inertia f32 scalar)``; ``with_update=False`` leaves sums and
    counts zero."""
    if x.device.type == "cpu":
        return lloyd_pass_plain(x, centroids, weights=weights,
                                compute_dtype=compute_dtype,
                                with_update=with_update)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    neg2c, csq = _score_operands(centroids, cd)
    _check_cuda_inputs("lloyd_pass_cuda", x, k, cd, w, neg2c)
    dev = x.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    min_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    sums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    _launch(lloyd_pass_cuda, "kml_lloyd_pass", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], neg2c.data_ptr(),
            _DTYPE_CODES[cd], csq.data_ptr(), w.data_ptr(), n, d, k,
            int(with_update), _vec_ok(d, cd, x, neg2c), labels.data_ptr(),
            min_d2.data_ptr(), sums.data_ptr(), counts.data_ptr())
    return labels, min_d2, sums, counts, (min_d2 * w).sum()


@_counted
def lloyd_delta_cuda(x, centroids, labels_prev, *, weights=None,
                     compute_dtype=None, with_mind=True):
    """K2: the incremental sweep (replaces ``lloyd_delta_pallas``).

    Returns ``(labels, min_d2, delta_sums, delta_counts, inertia,
    n_changed, dense_tiles)``.  A row is changed when its label differs
    from ``labels_prev`` and its weight is positive; it adds ``+w`` at the
    new label and ``−w`` at the old one when ``0 <= prev < k`` (so a −1
    sentinel makes the delta the full reduction).  ``with_mind=False``
    returns the raw score ``min(||c||² − 2x·c)`` in the min_d2 slot."""
    if x.device.type == "cpu":
        return lloyd_delta_plain(x, centroids, labels_prev, weights=weights,
                                 compute_dtype=compute_dtype,
                                 with_mind=with_mind)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    prev = labels_prev.to(device=x.device, dtype=torch.int32).contiguous()
    neg2c, csq = _score_operands(centroids, cd)
    _check_cuda_inputs("lloyd_delta_cuda", x, k, cd, w, neg2c, prev)
    dev = x.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    min_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    dsums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    dcounts = torch.zeros(k, dtype=torch.float32, device=dev)
    n_changed = torch.zeros(1, dtype=torch.int32, device=dev)
    groups = torch.zeros(-(-n // DENSE_GROUP_ROWS), dtype=torch.int32,
                         device=dev)
    _launch(lloyd_delta_cuda, "kml_lloyd_delta", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], neg2c.data_ptr(),
            _DTYPE_CODES[cd], csq.data_ptr(), w.data_ptr(), prev.data_ptr(),
            n, d, k, int(with_mind), _vec_ok(d, cd, x, neg2c),
            labels.data_ptr(), min_d2.data_ptr(), dsums.data_ptr(),
            dcounts.data_ptr(), n_changed.data_ptr(), groups.data_ptr())
    dense_tiles = (groups > DENSE_SLOTS).sum().int()
    return (labels, min_d2, dsums, dcounts, (min_d2 * w).sum(),
            n_changed[0], dense_tiles)


@_counted
def accumulate_cuda(x, labels, k, *, scores=None, weights=None,
                    compute_dtype=None):
    """K3: the labeled fold (replaces ``accumulate_pallas``).

    Returns ``(sums f32 [k, d], counts f32 [k], min_d2 f32 [n])`` with
    ``min_d2 = max(scores + ||x||², 0)``; labels outside ``[0, k)``
    contribute nothing."""
    if x.device.type == "cpu":
        return accumulate_plain(x, labels, k, scores=scores, weights=weights,
                                compute_dtype=compute_dtype)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    w = _weights(weights, n, x.device)
    lab = labels.to(device=x.device, dtype=torch.int32).contiguous()
    g = (None if scores is None
         else scores.to(device=x.device, dtype=torch.float32).contiguous())
    _check_cuda_inputs("accumulate_cuda", x, k, cd, w, None, lab,
                       *([] if g is None else [g]))
    dev = x.device
    sums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    min_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    _launch(accumulate_cuda, "kml_accumulate", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[cd],
            lab.data_ptr(), _ptr(g), w.data_ptr(), n, d, k, sums.data_ptr(),
            counts.data_ptr(), min_d2.data_ptr())
    return sums, counts, min_d2


@_counted
def lloyd_hamerly_cuda(x, centroids, labels_prev, need, sb_in, slb_in, *,
                       weights=None, compute_dtype=None):
    """K4: the bound-pruned sweep (replaces ``lloyd_hamerly_pallas``).

    Returns ``(labels, sb, slb, delta_sums, delta_counts, n_recomputed,
    dense_tiles)``.  Only the rows flagged ``need`` are scored: each gets
    the lowest-index argmin, ``sb`` = its score and ``slb`` = the least
    score over the other columns; every other row passes ``labels_prev``,
    ``sb_in`` and ``slb_in`` through.  The delta is K2's signed fold over
    the scored rows whose label changed (a −1 sentinel, which the caller
    must flag ``need``, makes it the full reduction)."""
    if x.device.type == "cpu":
        return lloyd_hamerly_plain(x, centroids, labels_prev, need, sb_in,
                                   slb_in, weights=weights,
                                   compute_dtype=compute_dtype)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    w = _weights(weights, n, dev)
    prev = labels_prev.to(device=dev, dtype=torch.int32).contiguous()
    need = need.to(device=dev, dtype=torch.bool).contiguous()
    sb_in = sb_in.to(device=dev, dtype=torch.float32).contiguous()
    slb_in = slb_in.to(device=dev, dtype=torch.float32).contiguous()
    neg2c, csq = _score_operands(centroids, cd)
    _check_cuda_inputs("lloyd_hamerly_cuda", x, k, cd, w, neg2c, prev, need,
                       sb_in, slb_in)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    sb = torch.empty(n, dtype=torch.float32, device=dev)
    slb = torch.empty(n, dtype=torch.float32, device=dev)
    dsums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    dcounts = torch.zeros(k, dtype=torch.float32, device=dev)
    n_rec = torch.zeros(1, dtype=torch.int32, device=dev)
    groups = torch.empty(-(-n // DENSE_GROUP_ROWS), dtype=torch.int32,
                         device=dev)
    _launch(lloyd_hamerly_cuda, "kml_lloyd_hamerly", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], neg2c.data_ptr(),
            _DTYPE_CODES[cd], csq.data_ptr(), w.data_ptr(), prev.data_ptr(),
            need.data_ptr(), sb_in.data_ptr(), slb_in.data_ptr(), n, d, k,
            _vec_ok(d, cd, x, neg2c), labels.data_ptr(), sb.data_ptr(),
            slb.data_ptr(), dsums.data_ptr(), dcounts.data_ptr(),
            n_rec.data_ptr(), groups.data_ptr())
    dense_tiles = (groups > HAMERLY_SLOTS).sum().int()
    return labels, sb, slb, dsums, dcounts, n_rec[0], dense_tiles


_WRAPPERS = (lloyd_pass_cuda, lloyd_delta_cuda, accumulate_cuda,
             lloyd_hamerly_cuda)
