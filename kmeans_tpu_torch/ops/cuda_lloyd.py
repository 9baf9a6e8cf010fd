"""The Lloyd sweep kernels: CUDA wrappers and their plain versions.

Counterpart of ``kmeans_tpu/ops/pallas_lloyd.py``.  Each TPU kernel has a
hand-written Hopper kernel in ``kmeans_tpu_torch/csrc/lloyd.cu`` (built by
:mod:`kmeans_tpu_torch.ops._build`) and, beside it here, a plain PyTorch
version of the same function:

======================= ======================== ============================
wrapper                 replaces                 plain version
======================= ======================== ============================
``lloyd_pass_cuda``     ``lloyd_pass_pallas``    ``lloyd_pass_plain``
``lloyd_delta_cuda``    ``lloyd_delta_pallas``   ``lloyd_delta_plain``
``accumulate_cuda``     ``accumulate_pallas``    ``accumulate_plain``
``lloyd_hamerly_cuda``  ``lloyd_hamerly_pallas`` ``lloyd_hamerly_plain``
``tiled_argmin_cuda``   ``_tiled_argmin``        ``tiled_argmin_plain``
``tiled_fold_cuda``     ``_tiled_fold``          ``tiled_fold_plain``
======================= ======================== ============================

The four sweep wrappers take ``k_tile``: None runs their own kernel (K1–K4,
"untiled"); a multiple of 128 runs the k-tiled pair instead, K5 (the
streamed argmin over ``k_tile``-wide centroid slices) and K6 (the bucketed
fold), with the reference's tiled semantics.  The planner
(:mod:`kmeans_tpu_torch.ops.plan`) chooses.

A wrapper given a tensor on the CPU runs the plain version; given a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches`` (:func:`launch_counts`, :func:`reset_launch_counts`),
so a run can show which kernels its main path went through.

Numerics shared by the kernels and the plain versions: scores are
``||c||² + x_cd·(−2·C_cd)ᵀ`` with f32 accumulation (bf16 operands multiply
exactly; f32 products never use TF32), the argmin keeps the lowest index on
a tie, ``||x||²`` is taken from x in its stored dtype, and the fold adds
``w·float(cd(x))``.  K2 and K4 scatter their changed rows with f32 atomics,
so their sums differ from the plain versions' (and from run to run) at the
f32 rounding level; K1, K3 and K6 fold on one fold core, which sorts the
rows by label (a stable radix sort) and sums each bucket in row order, the
same bits every launch and the same sums from all three at the same labels
(:func:`fold_core_plain` is its order, op by op).

K1, K2, K4 and K5 score with one of two cores (:func:`scoring_core`): the
Hopper core (TMA loads into an mbarrier ring -- ``cp.async`` for K4's
gathered rows --, ``wgmma``, the argmin and second-min taken from registers,
over ``k_tile``-wide column ranges for K5) for bf16 x in bf16 compute and
f32 x in f32 compute with 16-byte rows, ``score_block`` (``mma.sync`` in
bf16, CUDA-core FMA in f32) for every other input.  In bf16 the two give
the same labels, scores and second-min bit for bit.  In f32 the core runs
the reference's ``Precision.HIGHEST`` algorithm (six bf16 passes): x and
−2·C are each split exactly into three bf16 pieces (:func:`split_bf16x3`,
:func:`neg2c_pieces`) and the six products that matter are summed in f32
on the tensor cores (:func:`six_pass_scores_plain` is its plain model), so
its scores agree with ``score_block``'s and the plain versions' IEEE f32
to the f32 tolerance, not bit for bit.  Whichever core scores a row, K1,
K2, K4 and K5 give it the same label, score and second-min bit for bit.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional

import torch

from kmeans_tpu_torch.ops.distance import full_f32, resolve_cd, sq_norms
from kmeans_tpu_torch.ops.plan import LANE, core_takes

__all__ = ["lloyd_pass_cuda", "lloyd_delta_cuda", "accumulate_cuda",
           "lloyd_hamerly_cuda", "tiled_argmin_cuda", "tiled_fold_cuda",
           "lloyd_pass_plain", "lloyd_delta_plain", "accumulate_plain",
           "lloyd_hamerly_plain", "tiled_argmin_plain", "tiled_fold_plain",
           "hamerly_compaction_plain", "fold_order_plain",
           "fold_core_plain", "fold_sort_passes", "launch_counts",
           "reset_launch_counts", "scoring_core", "split_bf16x3",
           "neg2c_pieces", "six_pass_scores_plain",
           "DENSE_GROUP_ROWS", "DENSE_SLOTS", "HAMERLY_SLOTS"]

#: ``dense_tiles`` keeps the TPU kernels' meaning: the number of 1024-row
#: groups (their row tile) with more rows to compact than their slot budget
#: ``mc`` -- 128 changed rows for the delta kernel, 256 needed rows for the
#: Hamerly kernel.  Reported, never branched on: the CUDA kernels scatter
#: every changed row and score every needed one.  The k-tiled route reports
#: 0, as the reference's does.
DENSE_GROUP_ROWS = 1024
DENSE_SLOTS = 128
HAMERLY_SLOTS = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: The fold core's sizes (``csrc/lloyd.cu``): the radix sort's digit bits
#: and tile, the sorted entries a fold block sums, the columns it sums.
_SORT_BITS = 8
_SORT_TILE = 4096
_FOLD_CHUNK = 256
_FOLD_SPAN = 2048
#: Centroids of one column range of K1, K2 and K4 on the Hopper core
#: (``CORE_BN``: one 256-column slice in bf16, two 128-column sub-slices
#: on the f32 route).
_CORE_SLICE = 256
#: The ``core`` code of the C entry points: ``score_block`` or the Hopper
#: core (bf16, or its f32 route).
_CORE_CODES = {"score_block": 0, "wgmma": 1}
#: Negative codes of the C entry points (CUDA's own errors are positive).
_ERRORS = {-1: "no kernel for this dtype pair",
           -2: "the Hopper core does not take this input",
           -3: "the driver offers no cuTensorMapEncodeTiled",
           -4: "cuTensorMapEncodeTiled refused an operand"}


#: Guards the launch counts: the engine's dispatcher threads launch
#: concurrently.
_COUNT_LOCK = threading.Lock()


def _counted(fn):
    fn.launches = 0
    return fn


def _count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def launch_counts() -> dict:
    """``{wrapper name: launches}`` since the last reset."""
    with _COUNT_LOCK:
        return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for f in _WRAPPERS:
            f.launches = 0


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _weights(weights, n: int, device) -> torch.Tensor:
    if weights is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return weights.to(device=device, dtype=torch.float32).contiguous()


def _score_operands(centroids: torch.Tensor, cd: torch.dtype,
                    valid_cols: Optional[torch.Tensor] = None):
    """``(−2·C in cd, ||C||² in f32)`` — the TPU's ``_neg2_ct`` convention.
    The ×(−2) is an exponent shift on the cast values, so every score is
    exactly ``csq − 2·x·c``.  ``valid_cols`` (k,) bool, the sharded callers'
    hook, gives the False columns a +inf ``csq``: they never win."""
    csq = sq_norms(centroids)
    if valid_cols is not None:
        csq = torch.where(valid_cols.to(csq.device), csq, torch.inf)
    return (centroids.to(cd) * -2).contiguous(), csq.contiguous()


def _check_k_tile(k_tile: int) -> None:
    if k_tile < LANE or k_tile % LANE:
        raise ValueError(f"k_tile must be a positive multiple of {LANE}; "
                         f"got {k_tile}")


def split_bf16x3(v: torch.Tensor) -> torch.Tensor:
    """The exact three-piece bf16 split of f32 ``v``, shape ``(3,
    *v.shape)``: each piece the bf16 nearest to what the pieces before it
    leave, so ``v == p0 + p1 + p2`` in f32 (every residual is exact in
    f32, and round-to-nearest leaves at most 8 significant bits for the
    third piece).  Exact wherever the third piece's bits stay at or above
    bf16's least subnormal, 2⁻¹³³: for |v| >= 2⁻¹¹⁰ and for 0 (−0 sums to
    +0); below that the split drops v's bits under 2⁻¹³³.  |v| within
    half a bf16 ulp of f32's largest finite value rounds its first piece to
    inf.  The core's f32 route splits x this way on chip (``cvt.rn.bf16x2``
    and ``sub.rn``), the same bits."""
    rest = v.float()
    out = torch.empty(3, *v.shape, dtype=torch.bfloat16, device=v.device)
    for i in range(3):
        out[i] = rest
        rest = rest - out[i].float()
    return out


def neg2c_pieces(neg2c: torch.Tensor) -> torch.Tensor:
    """The three bf16 pieces of an f32 −2·C that the core's f32 route reads
    by TMA: ``(3, k, d8)`` bf16, d8 = d rounded up to 8 (TMA's 16-byte row
    stride in bf16), columns past d zero, so that they add 0 to every
    product (:func:`split_bf16x3`; −2·C is an exponent shift of C, so its
    pieces are −2 times C's).  Three PyTorch passes over k·d, outside the
    product; K5 takes them precomputed (``neg2c_pieces=``) from a caller
    that scores many batches against one −2·C."""
    k, d = neg2c.shape
    out = torch.zeros(3, k, -(-d // 8) * 8, dtype=torch.bfloat16,
                      device=neg2c.device)
    out[:, :, :d] = split_bf16x3(neg2c)
    return out


def _check_cuda_inputs(name: str, x: torch.Tensor, k: int, cd: torch.dtype,
                       w: torch.Tensor, neg2c: Optional[torch.Tensor],
                       *vectors: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: ``w`` (unless None) and
    each of ``vectors`` must be (n,), ``neg2c`` (k, d)."""
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
    rows = [v for v in (w, *vectors) if v is not None]
    for v in rows:
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name}: per-row operand shape "
                             f"{tuple(v.shape)} != ({n},)")
    for v in (*rows, *([] if neg2c is None else [neg2c])):
        if v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous and on "
                             f"{x.device}")


def _vec_ok(d: int, cd: torch.dtype, *tensors: torch.Tensor) -> int:
    """1 when the kernel may use 16-byte row loads: d a multiple of the
    vector width and every base pointer 16-byte aligned."""
    width = 8 if cd == torch.bfloat16 else 4
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return int(d % width == 0 and aligned)


def scoring_core(x: torch.Tensor, cd: torch.dtype,
                 *operands: torch.Tensor) -> str:
    """The core K1, K2, K4 and K5 score ``x`` with: ``"wgmma"`` (the Hopper
    core, bf16 or its f32 route) where
    :func:`kmeans_tpu_torch.ops.plan.core_takes` says so and x and
    ``operands`` start on 16-byte boundaries, else ``"score_block"``.  A
    fixed rule on dtype, d and alignment: a failed build or launch never
    picks the other core."""
    d = x.shape[1]
    takes = (x.dtype in _DTYPE_CODES and cd in _DTYPE_CODES
             and core_takes("classic", d, x.dtype.itemsize, cd.itemsize)
             and _vec_ok(d, cd, x, *operands))
    return "wgmma" if takes else "score_block"


def _core_operand(neg2c: torch.Tensor, core: str,
                  pieces: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What the scoring core reads of −2·C: ``neg2c`` itself, or on the
    core's f32 route its three bf16 pieces (``pieces`` when the caller
    holds them, checked, else split now)."""
    if core == "score_block" or neg2c.dtype != torch.float32:
        return neg2c
    if pieces is None:
        return neg2c_pieces(neg2c)
    k, d = neg2c.shape
    if (tuple(pieces.shape) != (3, k, -(-d // 8) * 8)
            or pieces.dtype != torch.bfloat16 or pieces.device != neg2c.device
            or not pieces.is_contiguous() or pieces.data_ptr() % 16):
        raise ValueError("neg2c_pieces must be neg2c_pieces(neg2c): a "
                         "contiguous, 16-byte-aligned (3, k, d rounded up "
                         f"to 8) bfloat16 tensor on {neg2c.device}")
    return pieces


def _core_parts(x: torch.Tensor, slices: int, second: bool = False):
    """Per-slice ``[best, index]`` buffers (and ``second`` with
    ``second``), (slices, n) each: a score launch's partial argmins, which
    its finishing launch merges in slice order."""
    n = x.shape[0]
    if -(-n // 128) * slices >= 2 ** 31:
        raise ValueError(f"n={n} in {slices} slices: more than 2**31 tiles")
    parts = [torch.empty(slices, n, dtype=torch.float32, device=x.device),
             torch.empty(slices, n, dtype=torch.int32, device=x.device)]
    if second:
        parts.append(torch.empty(slices, n, dtype=torch.float32,
                                 device=x.device))
    return parts


def _core_slices(x: torch.Tensor, k: int, core: str):
    """K1's and K2's part buffers on the Hopper core, (⌈k/256⌉, n) each, or
    ``(None, None)`` for ``score_block``."""
    if core == "score_block":
        return None, None
    return _core_parts(x, -(-k // _CORE_SLICE))


class FoldScratch(NamedTuple):
    """The fold core's vector rule and scratch, as its C entry points take
    them (K1's fold, K3, K6): ``sort`` holds two key and two value buffers
    of ``entries``, ``hist`` the sort tiles' digit counts (then their
    offsets within the digit) and the 256 digit totals, ``start`` each
    bucket's first sorted position (and the folded count), ``part`` /
    ``part_counts`` two partial rows a fold chunk, ``sq_part`` the column
    spans' ||x||² when the norms run over more than one span (else
    empty)."""

    vec: int
    sort: torch.Tensor
    hist: torch.Tensor
    start: torch.Tensor
    part: torch.Tensor
    part_counts: torch.Tensor
    sq_part: torch.Tensor

    def args(self) -> tuple:
        return (self.vec, *(t.data_ptr() for t in self[1:]))


def _fold_scratch(x: torch.Tensor, k: int, dual: bool,
                  norms: bool = False) -> FoldScratch:
    """The fold core's scratch for a fold of x's rows into k labels: one
    entry a row, two in the dual fold; ``norms`` adds the per-span ||x||²
    buffer where d needs more than one span.  Nothing needs zeroing: every
    cell is written before it is read.  ``vec`` says whether the fold may
    load 8 columns at once (d % 8 == 0, x 16-byte aligned)."""
    n, d = x.shape
    entries = n * (2 if dual else 1)
    if entries >= 2 ** 31:
        raise ValueError(f"{entries} fold entries do not fit the kernel's "
                         "int32 entry index")
    tiles = -(-entries // _SORT_TILE)
    chunks = -(-entries // _FOLD_CHUNK)
    spans = -(-d // _FOLD_SPAN)
    ints = dict(dtype=torch.int32, device=x.device)
    floats = dict(dtype=torch.float32, device=x.device)
    return FoldScratch(
        int(d % 8 == 0 and x.data_ptr() % 16 == 0),
        torch.empty(4 * entries, **ints),
        torch.empty((1 << _SORT_BITS) * (tiles + 1), **ints),
        torch.empty(k + 1, **ints),
        torch.empty(2 * chunks, d, **floats),
        torch.empty(2 * chunks, **floats),
        torch.empty(spans * n if norms and spans > 1 else 0, **floats))


def fold_sort_passes(k: int) -> int:
    """The fold core's radix passes over keys in [0, k]: 8 bits each."""
    return -(-k.bit_length() // _SORT_BITS)


def _launch(wrapper, entry: str, x: torch.Tensor, *args) -> None:
    """Call one C entry point on PyTorch's current stream of x's device and
    raise if the launch was refused."""
    from kmeans_tpu_torch.ops._build import library

    fn = getattr(library(), entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    _count(wrapper)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (chunked matmul + argmin + index_add_)
# ---------------------------------------------------------------------------

def _chunks(n: int, chunk_size: int):
    for s in range(0, n, chunk_size):
        yield slice(s, min(n, s + chunk_size))


def _argmin_plain(x, centroids, cd, chunk_size, rows=None, with_second=False,
                  valid_cols=None):
    """Per-row ``(lowest-index argmin, min score)`` of ``csq + x·(−2C)ᵀ`` over
    the rows of x, or over ``x[rows]`` (gathered chunk by chunk); with
    ``with_second`` also the least score over the other columns (the
    reference's ``_second_min_rows``: an exact duplicate of the winning
    centroid makes it equal the min)."""
    neg2c, csq = _score_operands(centroids, cd, valid_cols)
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


def six_pass_scores_plain(x, neg2c_pieces, csq, chunk_size=4096):
    """A plain model of the core's f32 route: ``csq + x·(−2·C)ᵀ`` as the
    six bf16 products of x's and −2·C's exact three-piece splits
    (:func:`split_bf16x3`, :func:`neg2c_pieces`) that the reference's
    ``Precision.HIGHEST`` sums on its own chip, each product in f32 (bf16
    pieces multiply exactly): the five corrections x3c1 + x2c2 + x1c3 +
    x2c1 + x1c2, added once to the leading x1c1, as the kernel keeps the
    two in separate accumulators and adds them in its epilogue; the dropped
    terms are below one f32 ulp of |x·c|.  The kernel sums each product in
    another order, so its scores agree with this model to the f32
    tolerance, not bit for bit.  The CPU tests and ``chip_smoke.py`` phase
    3 hold the route to it; no sweep runs it.  Returns (n, k) f32."""
    d = x.shape[1]
    cp = neg2c_pieces[:, :, :d].float()
    csq = csq.to(device=x.device, dtype=torch.float32)
    out = torch.empty(x.shape[0], cp.shape[1], dtype=torch.float32,
                      device=x.device)
    pairs = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1))
    with full_f32():
        for s in _chunks(x.shape[0], chunk_size):
            xp = split_bf16x3(x[s]).float()
            corr = None
            for i, j in pairs:
                p = xp[i] @ cp[j].T
                corr = p if corr is None else corr + p
            out[s] = csq + (xp[0] @ cp[0].T + corr)
    return out


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


def tiled_argmin_plain(x, neg2c, csq, *, k_tile, raw_scores=False,
                       with_second=False, chunk_size=4096):
    """Plain version of :func:`tiled_argmin_cuda`: each chunk of rows is
    scored one ``k_tile``-wide slice at a time, and the slices are merged
    online in increasing order with strict ``<`` (the lowest global index
    wins a tie) and, with ``with_second``, the second-min lattice
    ``min(s_a, s_b, max(b_a, b_b))``."""
    _check_k_tile(k_tile)
    n, k = x.shape[0], neg2c.shape[0]
    cd = neg2c.dtype
    neg2c_f = neg2c.float()
    csq = csq.to(device=x.device, dtype=torch.float32)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    best = torch.empty(n, dtype=torch.float32, device=x.device)
    second = torch.empty_like(best) if with_second else None
    with full_f32():
        for s in _chunks(n, chunk_size):
            xr = x[s].to(cd).float()
            run = None
            for lo in range(0, k, k_tile):
                hi = min(k, lo + k_tile)
                part = csq[lo:hi] + xr @ neg2c_f[lo:hi].T
                idx = part.argmin(dim=1, keepdim=True)
                b, i = part.gather(1, idx)[:, 0], idx[:, 0] + lo
                sec = (part.scatter_(1, idx, torch.inf).amin(dim=1)
                       if with_second else None)
                if run is None:
                    run = [b, i, sec]
                    continue
                if with_second:
                    run[2] = torch.minimum(torch.minimum(run[2], sec),
                                           torch.maximum(run[0], b))
                take = b < run[0]
                run[0] = torch.where(take, b, run[0])
                run[1] = torch.where(take, i, run[1])
            best[s], labels[s] = run[0], run[1].int()
            if with_second:
                second[s] = run[2]
    if not raw_scores:
        best = (best + _row_sq_plain(x, chunk_size)).clamp_min(0.0)
    return (labels, best, second) if with_second else (labels, best)


def tiled_fold_plain(x, weights, labels, labels2, k, *, compute_dtype=None,
                     k_tile=None, chunk_size=4096):
    """Plain version of :func:`tiled_fold_cuda`, folding one ``k_tile``-wide
    slice of the sums at a time (all of k at once when None)."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    dev = x.device
    w = _weights(weights, n, dev)
    lab = labels.to(device=dev, dtype=torch.int32)
    lab2 = None if labels2 is None else labels2.to(device=dev,
                                                   dtype=torch.int32)
    keep = None if lab2 is None else lab != lab2
    sums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    step = k if k_tile is None else k_tile
    for lo in range(0, k, step):
        sl = slice(lo, min(k, lo + step))
        _fold_plain(sums[sl], counts[sl], x, lab - lo, w, cd, chunk_size,
                    rows_mask=keep)
        if lab2 is not None:
            _fold_plain(sums[sl], counts[sl], x, lab2 - lo, w, cd,
                        chunk_size, sign=-1.0, rows_mask=keep)
    return sums, counts


def fold_order_plain(weights, labels, labels2, k):
    """The fold core's sorted list: ``(keys, entries)``, each entry's
    bucket -- k for an entry that folds nothing (``w == 0``, a label
    outside ``[0, k)``, and in the dual fold equal labels) -- sorted
    stably, so each bucket lists its entries (row, or ``2·row + side`` in
    the dual fold) in increasing order and the excluded ones come last;
    the order the kernel's radix sort makes."""
    lab = labels.long()
    w = weights
    if labels2 is None:
        keys = torch.where((w != 0) & (lab >= 0) & (lab < k), lab, k)
    else:
        lab2 = labels2.long()
        both = torch.stack([lab, lab2], dim=1).reshape(-1)
        fold = ((w != 0) & (lab != lab2)).repeat_interleave(2)
        keys = torch.where(fold & (both >= 0) & (both < k), both, k)
    keys, entries = torch.sort(keys, stable=True)
    return keys, entries


def fold_core_plain(x, weights, labels, labels2, k, *, compute_dtype=None):
    """The fold core's ``(sums, counts)`` in its own order, one f32
    operation at a time, so the kernel must equal it bit for bit: the
    sorted list (:func:`fold_order_plain`) is cut into chunks of
    ``_FOLD_CHUNK`` entries; each run of one bucket inside a chunk sums
    ``w·float(cd(x))`` (and w) in entry order from 0; a bucket inside one
    chunk is its run's sum, a longer one the sum from 0 of its runs in
    chunk order (the kernel writes a lone run as it is: the same value, 0
    added); an empty bucket is 0."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    dev = x.device
    w = _weights(weights, n, dev)
    keys, entries = fold_order_plain(w, labels.to(dev),
                                     None if labels2 is None
                                     else labels2.to(dev), k)
    dual = labels2 is not None
    rows = entries >> 1 if dual else entries
    ws = w[rows]
    if dual:
        ws = torch.where(entries % 2 == 1, -ws, ws)
    pos = torch.arange(keys.numel(), device=dev)
    starts = torch.ones_like(keys, dtype=torch.bool)
    starts[1:] = (keys[1:] != keys[:-1]) | (pos[1:] % _FOLD_CHUNK == 0)
    run = torch.cumsum(starts.long(), 0) - 1
    rank = pos - pos[starts][run]
    run_key = keys[starts]
    acc = torch.zeros(run_key.numel(), d, dtype=torch.float32, device=dev)
    acc_w = torch.zeros(run_key.numel(), dtype=torch.float32, device=dev)
    for r in range(int(rank.max()) + 1 if keys.numel() else 0):
        at = (rank == r) & (keys < k)
        sel, rr = run[at], rows[at]
        acc[sel] = acc[sel] + ws[at][:, None] * x[rr].to(cd).float()
        acc_w[sel] = acc_w[sel] + ws[at]
    sums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    keep = run_key < k
    run_key, acc, acc_w = run_key[keep], acc[keep], acc_w[keep]
    runs = torch.bincount(run_key, minlength=k)
    first = torch.cumsum(runs, 0) - runs
    within = torch.arange(run_key.numel(), device=dev) - first[run_key]
    for r in range(int(runs.max()) if run_key.numel() else 0):
        at = within == r
        b = run_key[at]
        sums[b] = sums[b] + acc[at]
        counts[b] = counts[b] + acc_w[at]
    return sums, counts


def _no_dense_tiles(x):
    return torch.zeros((), dtype=torch.int32, device=x.device)


def _tiled_pair(on_card: bool, k_tile: int, chunk_size: int = 4096):
    """K5 and K6, or their plain versions, as the tiled sweeps call them."""
    if on_card:
        return tiled_argmin_cuda, tiled_fold_cuda
    return (functools.partial(tiled_argmin_plain, chunk_size=chunk_size),
            functools.partial(tiled_fold_plain, k_tile=k_tile,
                              chunk_size=chunk_size))


def _pass_tiled(on_card, x, centroids, w, cd, fold_dtype, with_update,
                valid_cols, raw_scores, k_tile, chunk_size=4096):
    """The classic sweep on the tiled route: K5, then K6's single fold."""
    argmin, fold = _tiled_pair(on_card, k_tile, chunk_size)
    k, d = centroids.shape
    neg2c, csq = _score_operands(centroids, cd, valid_cols)
    labels, min_d2 = argmin(x, neg2c, csq, k_tile=k_tile,
                            raw_scores=raw_scores)
    if with_update:
        sums, counts = fold(x, w, labels, None, k, compute_dtype=fold_dtype)
    else:
        sums = torch.zeros(k, d, dtype=torch.float32, device=x.device)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    return labels, min_d2, sums, counts, (min_d2 * w).sum()


def _delta_tiled(on_card, x, centroids, prev, w, cd, with_mind, k_tile,
                 chunk_size=4096):
    """The delta sweep on the tiled route: K5 scores every row, then K6's
    dual fold over ``w·changed``."""
    argmin, fold = _tiled_pair(on_card, k_tile, chunk_size)
    neg2c, csq = _score_operands(centroids, cd)
    labels, min_d2 = argmin(x, neg2c, csq, k_tile=k_tile,
                            raw_scores=not with_mind)
    changed = (labels != prev) & (w > 0)
    dsums, dcounts = fold(x, w * changed, labels, prev, centroids.shape[0],
                          compute_dtype=cd)
    return (labels, min_d2, dsums, dcounts, (min_d2 * w).sum(),
            changed.sum().int(), _no_dense_tiles(x))


def _hamerly_tiled(on_card, x, centroids, prev, need, sb_in, slb_in, w, cd,
                   k_tile, chunk_size=4096):
    """The Hamerly sweep on the tiled route, as the reference's: K5 scores
    every row (raw, with the second-min), ``need`` selects fresh or carried
    (label, sb, slb), then K6's dual fold over the changed rows."""
    argmin, fold = _tiled_pair(on_card, k_tile, chunk_size)
    neg2c, csq = _score_operands(centroids, cd)
    lab_f, m1, m2 = argmin(x, neg2c, csq, k_tile=k_tile, raw_scores=True,
                           with_second=True)
    labels = torch.where(need, lab_f, prev)
    sb = torch.where(need, m1, sb_in)
    slb = torch.where(need, m2, slb_in)
    changed = (labels != prev) & (w > 0)
    dsums, dcounts = fold(x, w * changed, labels, prev, centroids.shape[0],
                          compute_dtype=cd)
    return (labels, sb, slb, dsums, dcounts, need.sum().int(),
            _no_dense_tiles(x))


def lloyd_pass_plain(x, centroids, *, weights=None, compute_dtype=None,
                     with_update=True, update="matmul", chunk_size=4096,
                     valid_cols=None, raw_scores=False, k_tile=None):
    """Plain version of :func:`lloyd_pass_cuda` (and of the reference's XLA
    route): ``update="segment"`` folds ``float(x)`` instead of the cd-cast
    row, as ``jax.ops.segment_sum`` over f32 rows does there."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    fold = cd if update == "matmul" else torch.float32
    if k_tile is not None:
        return _pass_tiled(False, x, centroids, w, cd, fold, with_update,
                           valid_cols, raw_scores, k_tile, chunk_size)
    labels, part_min = _argmin_plain(x, centroids, cd, chunk_size,
                                     valid_cols=valid_cols)
    min_d2 = (part_min if raw_scores else
              (part_min + _row_sq_plain(x, chunk_size)).clamp_min(0.0))
    sums = torch.zeros(k, d, dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    if with_update:
        _fold_plain(sums, counts, x, labels, w, fold, chunk_size)
    return labels, min_d2, sums, counts, (min_d2 * w).sum()


def _group_counts(rows: torch.Tensor) -> torch.Tensor:
    """The number of rows flagged in ``rows`` in each 1024-row group."""
    pad = (-rows.shape[0]) % DENSE_GROUP_ROWS
    return torch.nn.functional.pad(rows.int(), (0, pad)).view(
        -1, DENSE_GROUP_ROWS).sum(dim=1, dtype=torch.int32)


def _dense_tiles(rows: torch.Tensor, slots: int = DENSE_SLOTS) -> torch.Tensor:
    """1024-row groups with more than ``slots`` rows flagged in ``rows``."""
    return (_group_counts(rows) > slots).sum().int()


def lloyd_delta_plain(x, centroids, labels_prev, *, weights=None,
                      compute_dtype=None, with_mind=True, chunk_size=4096,
                      k_tile=None):
    """Plain version of :func:`lloyd_delta_cuda`."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n = x.shape[0]
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    prev = labels_prev.to(device=x.device, dtype=torch.int32)
    if k_tile is not None:
        return _delta_tiled(False, x, centroids, prev, w, cd, with_mind,
                            k_tile, chunk_size)
    labels, part_min = _argmin_plain(x, centroids, cd, chunk_size)
    changed = (labels != prev) & (w > 0)
    dsums, dcounts = _signed_fold_plain(x, k, labels, prev, changed, w, cd,
                                        chunk_size)
    min_d2 = ((part_min + _row_sq_plain(x, chunk_size)).clamp_min(0.0)
              if with_mind else part_min)
    return (labels, min_d2, dsums, dcounts, (min_d2 * w).sum(),
            changed.sum().int(), _dense_tiles(changed))


def _hamerly_inputs(x, labels_prev, need, sb_in, slb_in):
    dev = x.device
    return (labels_prev.to(device=dev, dtype=torch.int32).contiguous(),
            need.to(device=dev, dtype=torch.bool).contiguous(),
            sb_in.to(device=dev, dtype=torch.float32).contiguous(),
            slb_in.to(device=dev, dtype=torch.float32).contiguous())


def hamerly_compaction_plain(need: torch.Tensor):
    """Plain version of K4's compaction on the Hopper core: ``(rows,
    count, group_counts)`` -- the rows flagged ``need`` in increasing
    order (int32), their count, and the count of each 1024-row group, from
    which ``dense_tiles`` counts the groups over ``HAMERLY_SLOTS``."""
    rows = need.nonzero()[:, 0].int()
    return (rows, torch.tensor(rows.numel(), dtype=torch.int32),
            _group_counts(need))


def lloyd_hamerly_plain(x, centroids, labels_prev, need, sb_in, slb_in, *,
                        weights=None, compute_dtype=None, chunk_size=4096,
                        k_tile=None):
    """Plain version of :func:`lloyd_hamerly_cuda`: the rows flagged
    ``need`` are listed (:func:`hamerly_compaction_plain`), gathered and
    scored; every other row keeps ``labels_prev``, ``sb_in`` and
    ``slb_in``."""
    cd = resolve_cd(compute_dtype, x.dtype)
    n = x.shape[0]
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    prev, need, sb_in, slb_in = _hamerly_inputs(x, labels_prev, need, sb_in,
                                                slb_in)
    if k_tile is not None:
        return _hamerly_tiled(False, x, centroids, prev, need, sb_in, slb_in,
                              w, cd, k_tile, chunk_size)
    rows, count, groups = hamerly_compaction_plain(need)
    lab_r, best_r, second_r = _argmin_plain(x, centroids, cd, chunk_size,
                                            rows=rows, with_second=True)
    labels = prev.clone()
    labels[rows] = lab_r
    sb = sb_in.clone()
    sb[rows] = best_r
    slb = slb_in.clone()
    slb[rows] = second_r
    changed = need & (labels != prev) & (w > 0)
    dsums, dcounts = _signed_fold_plain(x, k, labels, prev, changed, w, cd,
                                        chunk_size)
    return (labels, sb, slb, dsums, dcounts, count.to(x.device),
            (groups > HAMERLY_SLOTS).sum().int())


def accumulate_plain(x, labels, k, *, scores=None, weights=None,
                     compute_dtype=None, chunk_size=4096, k_tile=None):
    """Plain version of :func:`accumulate_cuda`."""
    w = _weights(weights, x.shape[0], x.device)
    sums, counts = tiled_fold_plain(x, w, labels, None, k,
                                    compute_dtype=compute_dtype,
                                    k_tile=k_tile, chunk_size=chunk_size)
    return sums, counts, _acc_min_d2(x, scores, chunk_size)


def _acc_min_d2(x, scores, chunk_size=4096):
    """``max(scores + ||x||², 0)``: the labeled fold's min_d2."""
    g = 0.0 if scores is None else scores.to(x.device, torch.float32)
    return (g + _row_sq_plain(x, chunk_size)).clamp_min(0.0)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@_counted
def lloyd_pass_cuda(x, centroids, *, weights=None, compute_dtype=None,
                    with_update=True, valid_cols=None, raw_scores=False,
                    k_tile=None):
    """K1: the classic fused sweep (replaces ``lloyd_pass_pallas``).

    Returns ``(labels int32 [n], min_d2 f32 [n], sums f32 [k, d], counts
    f32 [k], inertia f32 scalar)``; ``with_update=False`` leaves sums and
    counts zero.  The sharded callers' hooks: ``valid_cols`` (k,) bool
    masks the False columns out of the argmin, and ``raw_scores`` returns
    the raw min score ``min(||c||² − 2x·c)`` in the min_d2 slot (the
    inertia is then meaningless).  It scores with :func:`scoring_core`'s
    core and, with ``with_update``, folds on the fold core inside the same
    entry point (so ``tiled_fold_cuda.launches`` does not move): its merge
    then writes the raw score and the fold adds ``||x||²`` from its own
    read of each row (K3's min_d2), and its sums and counts are K6's single
    fold's at its labels, the same bits every launch.  Without the fold the
    merge adds ``||x||²`` itself, in another order, so min_d2 depends on
    ``with_update`` in its last bits (labels and raw scores do not).
    ``k_tile`` runs K5 and K6's single fold instead of K1."""
    if x.device.type == "cpu":
        return lloyd_pass_plain(x, centroids, weights=weights,
                                compute_dtype=compute_dtype,
                                with_update=with_update,
                                valid_cols=valid_cols, raw_scores=raw_scores,
                                k_tile=k_tile)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    if k_tile is not None:
        return _pass_tiled(True, x, centroids, w, cd, cd, with_update,
                           valid_cols, raw_scores, k_tile)
    neg2c, csq = _score_operands(centroids, cd, valid_cols)
    _check_cuda_inputs("lloyd_pass_cuda", x, k, cd, w, neg2c)
    dev = x.device
    core = scoring_core(x, cd, neg2c)
    c_op = _core_operand(neg2c, core)
    part_best, part_idx = _core_slices(x, k, core)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    min_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    if with_update:
        # The fold core writes every element of the sums and counts.
        sums = torch.empty(k, d, dtype=torch.float32, device=dev)
        counts = torch.empty(k, dtype=torch.float32, device=dev)
        scratch = _fold_scratch(x, k, dual=False,   # held through the launch
                                norms=not raw_scores)
        fold = scratch.args()
    else:
        sums = torch.zeros(k, d, dtype=torch.float32, device=dev)
        counts = torch.zeros(k, dtype=torch.float32, device=dev)
        fold = (0,) + (None,) * 6
    _launch(lloyd_pass_cuda, "kml_lloyd_pass", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], c_op.data_ptr(),
            _DTYPE_CODES[cd], csq.data_ptr(), w.data_ptr(), n, d, k,
            int(with_update), int(raw_scores), _vec_ok(d, cd, x, neg2c),
            _CORE_CODES[core], labels.data_ptr(), min_d2.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), _ptr(part_best),
            _ptr(part_idx), *fold)
    return labels, min_d2, sums, counts, (min_d2 * w).sum()


@_counted
def lloyd_delta_cuda(x, centroids, labels_prev, *, weights=None,
                     compute_dtype=None, with_mind=True, k_tile=None):
    """K2: the incremental sweep (replaces ``lloyd_delta_pallas``).

    Returns ``(labels, min_d2, delta_sums, delta_counts, inertia,
    n_changed, dense_tiles)``.  A row is changed when its label differs
    from ``labels_prev`` and its weight is positive; it adds ``+w`` at the
    new label and ``−w`` at the old one when ``0 <= prev < k`` (so a −1
    sentinel makes the delta the full reduction).  ``with_mind=False``
    returns the raw score ``min(||c||² − 2x·c)`` in the min_d2 slot.
    It scores with :func:`scoring_core`'s core and scatters the changed
    rows with f32 atomics.  ``k_tile`` runs K5 and K6's dual fold instead
    of K2 (``dense_tiles`` is then 0)."""
    if x.device.type == "cpu":
        return lloyd_delta_plain(x, centroids, labels_prev, weights=weights,
                                 compute_dtype=compute_dtype,
                                 with_mind=with_mind, k_tile=k_tile)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    w = _weights(weights, n, x.device)
    prev = labels_prev.to(device=x.device, dtype=torch.int32).contiguous()
    if k_tile is not None:
        return _delta_tiled(True, x, centroids, prev, w, cd, with_mind,
                            k_tile)
    neg2c, csq = _score_operands(centroids, cd)
    _check_cuda_inputs("lloyd_delta_cuda", x, k, cd, w, neg2c, prev)
    dev = x.device
    core = scoring_core(x, cd, neg2c)
    c_op = _core_operand(neg2c, core)
    part_best, part_idx = _core_slices(x, k, core)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    min_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    dsums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    dcounts = torch.zeros(k, dtype=torch.float32, device=dev)
    n_changed = torch.zeros(1, dtype=torch.int32, device=dev)
    groups = torch.zeros(-(-n // DENSE_GROUP_ROWS), dtype=torch.int32,
                         device=dev)
    _launch(lloyd_delta_cuda, "kml_lloyd_delta", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], c_op.data_ptr(),
            _DTYPE_CODES[cd], csq.data_ptr(), w.data_ptr(), prev.data_ptr(),
            n, d, k, int(with_mind), _vec_ok(d, cd, x, neg2c),
            _CORE_CODES[core], labels.data_ptr(), min_d2.data_ptr(),
            dsums.data_ptr(), dcounts.data_ptr(), n_changed.data_ptr(),
            groups.data_ptr(), _ptr(part_best), _ptr(part_idx))
    dense_tiles = (groups > DENSE_SLOTS).sum().int()
    return (labels, min_d2, dsums, dcounts, (min_d2 * w).sum(),
            n_changed[0], dense_tiles)


@_counted
def accumulate_cuda(x, labels, k, *, scores=None, weights=None,
                    compute_dtype=None, k_tile=None):
    """K3: the labeled fold (replaces ``accumulate_pallas``).

    Returns ``(sums f32 [k, d], counts f32 [k], min_d2 f32 [n])`` with
    ``min_d2 = max(scores + ||x||², 0)``; labels outside ``[0, k)`` and
    rows with ``w == 0`` contribute nothing.  It runs on the fold core, so
    its sums and counts are K6's single fold's bit for bit (no float
    atomics: the same bits every launch), and ``||x||²`` comes from the
    same read of each row.  ``k_tile`` runs K6's single fold instead of K3
    (its min_d2 then comes from a PyTorch epilogue, as the reference's
    tiled route finishes it in XLA)."""
    if x.device.type == "cpu":
        return accumulate_plain(x, labels, k, scores=scores, weights=weights,
                                compute_dtype=compute_dtype, k_tile=k_tile)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    w = _weights(weights, n, x.device)
    lab = labels.to(device=x.device, dtype=torch.int32).contiguous()
    if k_tile is not None:
        sums, counts = tiled_fold_cuda(x, w, lab, None, k, compute_dtype=cd)
        return sums, counts, _acc_min_d2(x, scores)
    g = (None if scores is None
         else scores.to(device=x.device, dtype=torch.float32).contiguous())
    _check_cuda_inputs("accumulate_cuda", x, k, cd, w, None, lab,
                       *([] if g is None else [g]))
    dev = x.device
    scratch = _fold_scratch(x, k, dual=False, norms=True)
    sums = torch.empty(k, d, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    min_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    _launch(accumulate_cuda, "kml_accumulate", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[cd],
            lab.data_ptr(), _ptr(g), w.data_ptr(), n, d, k, *scratch.args(),
            sums.data_ptr(), counts.data_ptr(), min_d2.data_ptr())
    return sums, counts, min_d2


@_counted
def lloyd_hamerly_cuda(x, centroids, labels_prev, need, sb_in, slb_in, *,
                       weights=None, compute_dtype=None, k_tile=None):
    """K4: the bound-pruned sweep (replaces ``lloyd_hamerly_pallas``).

    Returns ``(labels, sb, slb, delta_sums, delta_counts, n_recomputed,
    dense_tiles)``.  Only the rows flagged ``need`` are scored: each gets
    the lowest-index argmin, ``sb`` = its score and ``slb`` = the least
    score over the other columns; every other row passes ``labels_prev``,
    ``sb_in`` and ``slb_in`` through.  The delta is K2's signed fold over
    the scored rows whose label changed (a −1 sentinel, which the caller
    must flag ``need``, makes it the full reduction).  On
    :func:`scoring_core`'s Hopper core the needed rows are listed on the
    card in row order and scored 128 at a time, gathered with
    ``cp.async``; on ``score_block`` each 1024-row group scores its own.
    Neither synchronises with the host.  ``k_tile`` runs K5 over every row
    and K6's dual fold instead of K4, as the reference's tiled route does
    (``dense_tiles`` is then 0)."""
    if x.device.type == "cpu":
        return lloyd_hamerly_plain(x, centroids, labels_prev, need, sb_in,
                                   slb_in, weights=weights,
                                   compute_dtype=compute_dtype,
                                   k_tile=k_tile)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    w = _weights(weights, n, dev)
    prev, need, sb_in, slb_in = _hamerly_inputs(x, labels_prev, need, sb_in,
                                                slb_in)
    if k_tile is not None:
        return _hamerly_tiled(True, x, centroids, prev, need, sb_in, slb_in,
                              w, cd, k_tile)
    neg2c, csq = _score_operands(centroids, cd)
    _check_cuda_inputs("lloyd_hamerly_cuda", x, k, cd, w, neg2c, prev, need,
                       sb_in, slb_in)
    core = scoring_core(x, cd, neg2c)
    c_op = _core_operand(neg2c, core)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    sb = torch.empty(n, dtype=torch.float32, device=dev)
    slb = torch.empty(n, dtype=torch.float32, device=dev)
    dsums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    dcounts = torch.zeros(k, dtype=torch.float32, device=dev)
    n_rec = torch.zeros(1, dtype=torch.int32, device=dev)
    groups = torch.empty(-(-n // DENSE_GROUP_ROWS), dtype=torch.int32,
                         device=dev)
    # On the core: its slice buffers (indexed by a needed row's rank), the
    # list of needed rows, and each group's first rank in that list.
    scratch = []
    if core != "score_block":
        scratch = [*_core_parts(x, -(-k // _CORE_SLICE), second=True),
                   torch.empty(n, dtype=torch.int32, device=dev),
                   torch.empty_like(groups)]
    _launch(lloyd_hamerly_cuda, "kml_lloyd_hamerly", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], c_op.data_ptr(),
            _DTYPE_CODES[cd], csq.data_ptr(), w.data_ptr(), prev.data_ptr(),
            need.data_ptr(), sb_in.data_ptr(), slb_in.data_ptr(), n, d, k,
            _vec_ok(d, cd, x, neg2c), _CORE_CODES[core],
            labels.data_ptr(), sb.data_ptr(), slb.data_ptr(),
            dsums.data_ptr(), dcounts.data_ptr(), n_rec.data_ptr(),
            groups.data_ptr(),
            *(_ptr(t) for t in scratch or [None] * 5))
    dense_tiles = (groups > HAMERLY_SLOTS).sum().int()
    return labels, sb, slb, dsums, dcounts, n_rec[0], dense_tiles


@_counted
def tiled_argmin_cuda(x, neg2c, csq, *, k_tile, raw_scores=False,
                      with_second=False, neg2c_pieces=None):
    """K5: the streamed argmin (replaces ``_tiled_argmin``).

    ``neg2c`` is −2·C in the compute dtype (k, d) and ``csq`` its f32
    ``||c||²`` (+inf on masked columns).  Returns ``(labels int32 [n],
    min f32 [n])`` and with ``with_second`` the least score over the other
    columns; the min is ``max(min + ||x||², 0)``, or the raw score with
    ``raw_scores``.  Labels, raw scores and second-min are K2's and K4's
    bit for bit at the same operands.  It scores with
    :func:`scoring_core`'s core: the Hopper core walks ``k_tile``-wide
    column ranges, a row block's ranges on neighbouring blocks;
    ``score_block`` takes a block for each (slice, 128-row block),
    slice-major.  On the core's f32 route it reads −2·C's three bf16
    pieces: ``neg2c_pieces`` (``neg2c_pieces(neg2c)``, from a caller that
    holds them across calls) or split here; the plain version ignores
    them."""
    if x.device.type == "cpu":
        return tiled_argmin_plain(x, neg2c, csq, k_tile=k_tile,
                                  raw_scores=raw_scores,
                                  with_second=with_second)
    _check_k_tile(k_tile)
    cd = neg2c.dtype
    n, d = x.shape
    k = neg2c.shape[0]
    dev = x.device
    csq = csq.to(device=dev, dtype=torch.float32).contiguous()
    _check_cuda_inputs("tiled_argmin_cuda", x, k, cd, None, neg2c)
    if tuple(csq.shape) != (k,):
        raise ValueError(f"tiled_argmin_cuda: csq shape {tuple(csq.shape)} "
                         f"!= ({k},)")
    core = scoring_core(x, cd, neg2c)
    c_op = _core_operand(neg2c, core, neg2c_pieces)
    parts = _core_parts(x, -(-k // k_tile), second=with_second)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    best = torch.empty(n, dtype=torch.float32, device=dev)
    second = torch.empty_like(best) if with_second else None
    _launch(tiled_argmin_cuda, "kml_tiled_argmin", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], c_op.data_ptr(),
            _DTYPE_CODES[cd], csq.data_ptr(), n, d, k, k_tile,
            int(raw_scores), int(with_second), _vec_ok(d, cd, x, neg2c),
            _CORE_CODES[core], *(t.data_ptr() for t in parts),
            *([None] * (not with_second)),
            labels.data_ptr(), best.data_ptr(), _ptr(second))
    return (labels, best, second) if with_second else (labels, best)


@_counted
def tiled_fold_cuda(x, weights, labels, labels2, k, *, compute_dtype=None):
    """K6: the bucketed fold (replaces ``_tiled_fold``).

    Returns ``(sums f32 [k, d], counts f32 [k])``: ``+w·float(cd(x))`` at
    ``labels`` and, when ``labels2`` is given (the dual fold), ``−w·…`` at
    ``labels2``.  Labels outside ``[0, k)``, rows with ``w == 0`` and, in
    the dual fold, rows with equal labels fold nothing.  Each bucket is
    summed in row order without float atomics: two launches give the same
    bits."""
    if x.device.type == "cpu":
        return tiled_fold_plain(x, weights, labels, labels2, k,
                                compute_dtype=compute_dtype)
    cd = resolve_cd(compute_dtype, x.dtype)
    n, d = x.shape
    dev = x.device
    w = _weights(weights, n, dev)
    lab = labels.to(device=dev, dtype=torch.int32).contiguous()
    lab2 = (None if labels2 is None
            else labels2.to(device=dev, dtype=torch.int32).contiguous())
    _check_cuda_inputs("tiled_fold_cuda", x, k, cd, w, None, lab,
                       *([] if lab2 is None else [lab2]))
    scratch = _fold_scratch(x, k, dual=lab2 is not None)
    sums = torch.empty(k, d, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    _launch(tiled_fold_cuda, "kml_tiled_fold", x,
            x.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[cd],
            w.data_ptr(), lab.data_ptr(), _ptr(lab2), n, d, k,
            *scratch.args(), sums.data_ptr(), counts.data_ptr())
    return sums, counts


_WRAPPERS = (lloyd_pass_cuda, lloyd_delta_cuda, accumulate_cuda,
             lloyd_hamerly_cuda, tiled_argmin_cuda, tiled_fold_cuda)
