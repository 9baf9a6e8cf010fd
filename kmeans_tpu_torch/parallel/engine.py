"""Sharded Lloyd engine over a mesh of processes.

Counterpart of ``kmeans_tpu/parallel/engine.py``.  The reference runs one
``shard_map`` program over a ``jax.sharding.Mesh``; the port runs one
process per device (:mod:`kmeans_tpu_torch.parallel.mesh`), and each rank
drives the same sweep loop on its own block.  Data parallel:

* points are sharded by contiguous row blocks, padded to a multiple of the
  mesh size with weight-0 rows (:func:`_pad_rows`); centroids are
  replicated;
* each rank runs the single-device sweep on its block: the classic fused
  pass (:func:`~kmeans_tpu_torch.ops.lloyd.lloyd_pass`), the delta sweep
  (:func:`~kmeans_tpu_torch.ops.delta.delta_pass`) or the hamerly /
  yinyang pruned sweeps, each carrying its own row state; on the card each
  is the hand-written kernel the single-device fit runs;
* the per-sweep merge is ONE collective: an ``all_reduce`` of the packed
  ``(sums | counts | inertia)`` slab (``comm="allreduce"``), or a
  ``reduce_scatter`` of the packed slab, the update on this rank's k/dp
  slice, and an ``all_gather`` of the finished centroids
  (``comm="scatter"``), plus a scalar all-reduce of the shift;
* the convergence test reads one scalar a sweep, as the single-device loop
  does, and a final dense pass labels every row; every rank returns the
  global :class:`~kmeans_tpu_torch.models.lloyd.KMeansState` (labels
  all-gathered).

With a ``model`` axis the centroids shard over k, with a ``feature`` axis x
and the centroids over d, and both compose (:func:`_sharded_pass`: K1 in
raw-score mode on the k-slice, two MIN all-reduces, K3's labeled fold; each
rank places full rows of its share of the data block, the rows the
reference's feature exchange would hand it, and gathers only the
centroids' columns).  Beside the Lloyd fit the engine runs the reference's other DP
loops on the same rank bodies: :func:`fit_lloyd_accelerated_sharded` (β
and Anderson extrapolation, one merge a sweep, the decision replicated),
:func:`fit_trimmed_sharded` (each rank nominates its top rows, one
all-gather of their keys gives the global threshold, the correction is
subtracted before the merge), :func:`fit_fuzzy_sharded` and
:func:`fit_gmm_sharded` (local soft moments, one all-reduce a pass) and
:func:`fit_balanced_sharded` (the transport plan split by rows, the
column logsumexp a MAX and a SUM all-reduce a Sinkhorn sweep).  With ``ckpt_dir`` :func:`fit_lloyd_sharded`
runs elastic: sweep segments of ``ckpt_every`` sweeps, each ending in a
checkpoint of the global centroids that rank 0 writes in the reference's
format, so a run cut on one mesh resumes on another, in either package.
``center_update="sphere"`` is spherical k-means on every layout
(:func:`fit_spherical_sharded`): the renormalized direction sum, taken
from the full-width merged sums (the FP body holds full rows, so the norm
needs no collective of its own).  The pairwise families' ring passes
(:mod:`~kmeans_tpu_torch.parallel.medoids`, :mod:`~kmeans_tpu_torch.
parallel.kernel`) and the sharded spectral embedding
(:mod:`~kmeans_tpu_torch.parallel.spectral`) place their rows with
:func:`_place` and finish under :func:`_soft_fit`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch import obs
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor
from kmeans_tpu_torch.models.init import resolve_fit_config
from kmeans_tpu_torch.models.lloyd import KMeansState
from kmeans_tpu_torch.obs import tracing as _tracing
from kmeans_tpu_torch.ops.delta import DELTA_REFRESH, default_cap, delta_pass
from kmeans_tpu_torch.ops.distance import resolve_cd
from kmeans_tpu_torch.ops.hamerly import hamerly_pass, row_norms
from kmeans_tpu_torch.ops.lloyd import (lloyd_pass, resolve_backend,
                                        resolve_update, weights_exact)
from kmeans_tpu_torch.ops.select import order_keys, top_stable
from kmeans_tpu_torch.ops.update import apply_update
from kmeans_tpu_torch.ops.yinyang import centroid_groups, yinyang_pass
from kmeans_tpu_torch.parallel.init_sharded import init_on_mesh
from kmeans_tpu_torch.utils import faults

__all__ = ["fit_lloyd_sharded", "fit_lloyd_accelerated_sharded",
           "fit_trimmed_sharded", "fit_minibatch_sharded",
           "fit_balanced_sharded", "fit_fuzzy_sharded", "fit_gmm_sharded",
           "fit_spherical_sharded", "sharded_assign", "pad_and_place",
           "sweep_split", "ENGINE_CKPT_EVERY"]

#: Sharded-engine observability, the reference's families.  ``layout`` is
#: "dp<N>"; the sweep time is the fit's wall time over its sweeps.
_ENGINE_FIT_SECONDS = obs.histogram(
    "kmeans_tpu_engine_fit_seconds",
    "Wall time of one sharded fit (compile excluded on cache hits only)",
    labels=("kind", "backend", "layout"),
)
_ENGINE_SWEEP_SECONDS = obs.histogram(
    "kmeans_tpu_engine_sweep_seconds",
    "Mean per-sweep wall time of a sharded fit (fit wall time / sweeps; "
    "shards run each sweep in lockstep between psums)",
    labels=("kind", "backend", "layout"),
)
_ENGINE_FITS_TOTAL = obs.counter(
    "kmeans_tpu_engine_fits_total",
    "Sharded fits completed",
    labels=("kind", "backend", "layout"),
)
_ENGINE_SHARDS = obs.gauge(
    "kmeans_tpu_engine_shards",
    "Device count of the most recent sharded fit's mesh",
)
_ENGINE_COLLECTIVE_BYTES = obs.gauge(
    "kmeans_tpu_engine_collective_bytes",
    "Estimated per-device wire bytes one sweep's merge collectives move "
    "for the most recent sharded fit, by comm strategy (ring model: "
    "allreduce counts the packed sums|counts|inertia slab twice minus "
    "the resident share; scatter counts the reduce-scatter of the packed "
    "slab plus the centroid all-gather)",
    labels=("function", "comm"),
)

_ENGINE_CKPT_SECONDS = obs.histogram(
    "kmeans_tpu_engine_ckpt_seconds",
    "Wall time of one engine checkpoint cut at a sweep boundary (device "
    "pull of the finished global f32 centroids + verified atomic save)",
)
_ENGINE_RESUMES_TOTAL = obs.counter(
    "kmeans_tpu_engine_resumes_total",
    "Sharded-fit resume attempts by outcome (ok = restored and continued; "
    "finished = the checkpoint was already converged; refused = config "
    "fingerprint contradiction; error = missing or corrupt checkpoint)",
    labels=("outcome",),
)

#: Default sweep cadence of the elastic checkpoint loop (the reference's).
ENGINE_CKPT_EVERY = 10

def _mesh_layout(dp: int, mp: int, fp: int) -> str:
    parts = [f"dp{dp}"]
    if mp > 1:
        parts.append(f"tp{mp}")
    if fp > 1:
        parts.append(f"fp{fp}")
    return ".".join(parts)


def _observe_sharded_fit(kind: str, backend: str, layout: str,
                         shards: int, seconds: float, sweeps: int) -> None:
    """Record one finished sharded fit in the engine metric family."""
    labels = dict(kind=kind, backend=backend, layout=layout)
    _ENGINE_FIT_SECONDS.labels(**labels).observe(seconds)
    _ENGINE_SWEEP_SECONDS.labels(**labels).observe(
        seconds / max(1, sweeps))
    _ENGINE_FITS_TOTAL.labels(**labels).inc()
    _ENGINE_SHARDS.set(shards)


# ---------------------------------------------------------------------------
# Per-sweep split (instrumentation; off unless sweep_split is active)
# ---------------------------------------------------------------------------

class _Split:
    """Marks at the end of each part of a sweep: the host clock and, on a
    card, a CUDA event.  :meth:`summary` turns them into per-part
    milliseconds."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.sweeps = []
        self._cur = None

    def begin(self):
        self._cur = []
        self.mark("start")

    def mark(self, name: str):
        if self._cur is None:
            return
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self._cur.append((name, time.perf_counter(), ev))

    def end(self):
        if self._cur is not None:
            self.sweeps.append(self._cur)
        self._cur = None

    def summary(self):
        """One dict per sweep: part name → ``(host_ms, device_ms)``
        (device_ms None off the card)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for marks in self.sweeps:
            parts = {}
            for (_, t0, e0), (name, t1, e1) in zip(marks, marks[1:]):
                dev_ms = e0.elapsed_time(e1) if self.cuda else None
                host, devt = parts.get(name, (0.0, 0.0 if self.cuda
                                              else None))
                parts[name] = (host + (t1 - t0) * 1e3,
                               None if dev_ms is None else devt + dev_ms)
            out.append(parts)
        return out


def _mark(mesh, name: str) -> None:
    if mesh.split is not None:
        mesh.split.mark(name)


@contextlib.contextmanager
def sweep_split(mesh):
    """Record each sweep of a fit on ``mesh`` split into its local pass
    (``"pass"``), merge (``"merge"``; with ``comm="scatter"`` also the
    slice update, ``"update"``, and the gather, ``"gather"``) and update
    (``"update"``) while active; yields the recorder, whose ``summary()``
    gives per-sweep milliseconds by host clock and CUDA events."""
    prev, mesh.split = mesh.split, _Split(mesh.device)
    try:
        yield mesh.split
    finally:
        mesh.split = prev


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _pad_rows(x, multiple: int, weights=None):
    """Pad the rows of numpy ``x`` to ``multiple``; returns ``(x, w, n)``
    where ``w`` (numpy f32) carries the caller's sample weights (default
    1) with 0 on the padding rows."""
    n = x.shape[0]
    pad = (-n) % multiple
    w = np.ones(n + pad, np.float32)
    if weights is not None:
        w[:n] = np.asarray(
            weights.cpu() if isinstance(weights, torch.Tensor) else weights,
            np.float32)
    if pad:
        x = np.concatenate(
            [np.asarray(x), np.zeros((pad,) + x.shape[1:], x.dtype)])
        w[n:] = 0.0
    return x, w, n


def _row_block(x, n: int, n_loc: int, rank: int, device) -> torch.Tensor:
    """Rank ``rank``'s block of ``n_loc`` rows of the padded view of ``x``
    on ``device``, without padding all of ``x``: rows past n are 0."""
    lo = rank * n_loc
    hi = min(lo + n_loc, n)
    rows = x[lo:max(hi, lo)]
    if isinstance(rows, np.ndarray) and not rows.flags.writeable:
        rows = np.array(rows)     # a read-only memmap: this rank's rows
    block = as_tensor(rows, device)
    if block.shape[0] < n_loc:
        block = torch.cat([block, block.new_zeros(
            (n_loc - block.shape[0],) + tuple(block.shape[1:]))])
    # A view of a larger tensor on the same device would keep all of x
    # alive for the whole fit: the block owns its rows.
    if not block.is_contiguous() or block.untyped_storage().nbytes() != \
            block.numel() * block.element_size():
        block = block.clone(memory_format=torch.contiguous_format)
    return block


def _place(x, mesh, data_axis: str, weights=None, feature_axis=None):
    """``(x_loc, w_loc, w_host, n)``: this rank's row block and weights on
    its device, the global padded weights (numpy) and the real row count.
    ``x`` is the global data (numpy or a tensor), the same on every rank.
    With ``feature_axis`` the rows pad to a multiple of data × feature
    ranks and the block is this rank's share of full rows over both axes
    (block ``data · fp + feature``), its columns zero-padded to a multiple
    of the feature ranks: the rows the reference's feature exchange hands
    each device, read here from the global x, which every rank holds."""
    dp = mesh.axis_sizes[data_axis]
    fp = mesh.axis_sizes[feature_axis] if feature_axis else 1
    n, d = x.shape
    _, w_host, _ = _pad_rows(np.empty((n, 0), np.float32), dp * fp,
                             weights=weights)
    n_loc = w_host.shape[0] // (dp * fp)
    i = mesh.coord(data_axis) * fp + (mesh.coord(feature_axis) if fp > 1
                                      else 0)
    x_loc = _row_block(x, n, n_loc, i, mesh.device)
    if d % fp:
        x_loc = torch.cat([x_loc, x_loc.new_zeros(
            (n_loc, (-d) % fp))], dim=1)
    w_loc = torch.from_numpy(
        w_host[i * n_loc:(i + 1) * n_loc].copy()).to(mesh.device)
    return x_loc, w_loc, w_host, n


def pad_and_place(x, mesh, data_axis="data", weights=None):
    """Pad rows to the data-axis multiple and keep this rank's block: the
    one copy of the pad-and-place idiom for callers that place a dataset
    once and make many engine calls.  Returns ``(x_loc, w_loc, n_real)``;
    padding rows carry weight 0."""
    x_loc, w_loc, _, n = _place(x, mesh, data_axis, weights=weights)
    return x_loc, w_loc, n


def _gather_rows(mesh, t: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's per-row ``t`` concatenated in row order, cut to n."""
    return mesh.all_gather(t)[:n]


# ---------------------------------------------------------------------------
# Merges and updates
# ---------------------------------------------------------------------------

def _apply_center_update(c, sums, counts, *, center_update):
    """The one post-reduce centroid rule of every rank body: ``"mean"`` is
    Lloyd (sums/counts, empties keep), ``"sphere"`` spherical k-means (the
    renormalized direction sum; degenerate clusters keep).  ``sums`` always
    spans every column of its rows, so the norm is local."""
    if center_update == "mean":
        return apply_update(c, sums, counts)
    from kmeans_tpu_torch.models.spherical import _renormalize_update

    return _renormalize_update(c, sums, counts)


def _fused_psum_merge(mesh, sums, counts, inertia=None):
    """ONE collective for the per-sweep merge on the allreduce path: counts
    ride as an extra column of the sums, and the scalar inertia is
    broadcast into a second extra column (every row carries the local
    value, so every row of the reduced column holds the global total)."""
    k, d = sums.shape
    cols = [sums.float(), counts.float()[:, None]]
    if inertia is not None:
        cols.append(inertia.float().reshape(1, 1).expand(k, 1))
    packed = mesh.all_reduce(torch.cat(cols, dim=1))
    if inertia is None:
        return packed[:, :d], packed[:, d]
    return packed[:, :d], packed[:, d], packed[0, d + 1]


def _scatter_merge_update(mesh, c, sums, counts, x_loc, min_d2, *, empty,
                          center_update):
    """``comm="scatter"`` merge: the owner-computed centroid update on
    k-slices.

    ONE ``reduce_scatter`` of the packed per-rank ``(sums | counts)`` slab
    hands each rank a contiguous ``k/dp`` slice; the divide, the
    ``empty="farthest"`` healing and the shift run on that slice, and one
    ``all_gather`` of the finished f32 centroids replicates them.  k pads
    to a dp multiple inside (zero sums and counts, masked out of healing,
    cut after the gather).  Returns ``(new_c, counts_loc, shift_sq)``."""
    k, d = c.shape
    dp = mesh.size
    k_pad = (-k) % dp
    if k_pad:
        sums = torch.cat([sums, sums.new_zeros(k_pad, d)])
        counts = torch.cat([counts, counts.new_zeros(k_pad)])
        c_full = torch.cat([c, c.new_zeros(k_pad, d)])
    else:
        c_full = c
    k_loc = (k + k_pad) // dp
    packed = torch.cat([sums.float(), counts.float()[:, None]], dim=1)
    packed = mesh.reduce_scatter(packed)                   # (k_loc, d+1)
    _mark(mesh, "merge")
    sums_loc = packed[:, :d]
    counts_loc = packed[:, d]
    me = mesh.rank
    c_loc = c_full[me * k_loc:(me + 1) * k_loc]
    new_c_loc = _apply_center_update(c_loc, sums_loc, counts_loc,
                                     center_update=center_update)
    if empty == "farthest":
        valid = (me * k_loc + torch.arange(k_loc, device=c.device)) < k
        new_c_loc = _reseed_empty_farthest_tp(
            mesh, new_c_loc, counts_loc, valid, x_loc, min_d2, k)
    _mark(mesh, "update")
    shift_sq = mesh.all_reduce(
        ((new_c_loc - c_loc.float()) ** 2).sum().reshape(1))[0]
    new_c = mesh.all_gather(new_c_loc.float())[:k]
    _mark(mesh, "gather")
    return new_c, counts_loc, shift_sq


def _ranked_winners_dp(mesh, x_loc, min_d2, k):
    """The k globally worst-fit rows, ranked, replicated on every rank.

    Each rank nominates its k worst rows; only their values are
    all-gathered ((dp, k) floats), and the winning rows come back through
    one masked all-reduce: each winner's owner contributes the row, every
    other rank zeros.  Rows are sharded contiguously, so the flattened
    (rank, slot) order is global row order and the single-device
    lowest-index tie-break holds."""
    n_loc = min_d2.shape[0]
    # A rank may hold fewer than k rows: nominate what it has and pad the
    # remaining slots with −inf so they never win.
    k_nom = min(k, n_loc)
    vals_loc, idx_loc = top_stable(min_d2.float(), k_nom)
    pts_loc = x_loc[idx_loc].float()
    if k_nom < k:
        vals_loc = torch.cat([vals_loc,
                              vals_loc.new_full((k - k_nom,), -torch.inf)])
        pts_loc = torch.cat([pts_loc, pts_loc.new_zeros(k - k_nom,
                                                        pts_loc.shape[1])])
    vals_all = mesh.all_gather(vals_loc)                  # (dp·k,)
    _, win = top_stable(vals_all, k)
    win_shard = win // k
    win_slot = win % k
    contrib = torch.where((win_shard == mesh.rank)[:, None],
                          pts_loc[win_slot], 0.0)
    return mesh.all_reduce(contrib)                       # (k, d) ranked


def _reseed_empty_farthest_dp(mesh, new_c, counts, x_loc, min_d2):
    """Sharded ``reseed_empty_farthest``: the r-th empty slot (by index)
    takes the r-th ranked winner."""
    repl = _ranked_winners_dp(mesh, x_loc, min_d2, new_c.shape[0])
    empty = counts <= 0
    rank = torch.where(empty, torch.cumsum(empty.int(), 0) - 1, 0)
    return torch.where(empty[:, None], repl[rank], new_c)


def _reseed_empty_farthest_tp(mesh, new_c_loc, counts_loc, valid, x_loc,
                              min_d2, k_real, slice_mesh=None):
    """k-sliced farthest reseed: every slice owner computes the same ranked
    winner list (over ``mesh``, the rows) and claims the winners whose
    global rank matches its empty slots, rank = (empties on lower slices,
    an exclusive sum over ``slice_mesh``, default ``mesh``) + (local empty
    position).  Padded slots (``~valid``) are never empty."""
    slice_mesh = mesh if slice_mesh is None else slice_mesh
    repl = _ranked_winners_dp(mesh, x_loc, min_d2, k_real)
    empty_loc = (counts_loc <= 0) & valid
    n_empty_loc = empty_loc.int().sum().reshape(1)
    per_slice = slice_mesh.all_gather(n_empty_loc)        # (slices,)
    off = per_slice[:slice_mesh.rank].sum()
    rank = torch.where(empty_loc, torch.cumsum(empty_loc.int(), 0) - 1 + off,
                       0)
    return torch.where(empty_loc[:, None], repl[rank], new_c_loc)


# ---------------------------------------------------------------------------
# Local (per-rank) passes
# ---------------------------------------------------------------------------

def _dp_local_pass(mesh, x_loc, c, w_loc, *, chunk_size, compute_dtype,
                   update, backend="plain", empty="keep",
                   weights_binary=True, center_update="mean",
                   comm="allreduce"):
    """DP rank body: the rank's fused pass (K1 on the card, or K5 + K6
    where the planner tiles), then the merge; centroids replicated.
    Returns ``(new_c, inertia, counts)``, or with ``comm="scatter"``
    ``(new_c, shift_sq, counts_loc)``."""
    _, min_d2, sums, counts, inertia = lloyd_pass(
        x_loc, c, weights=w_loc, chunk_size=chunk_size,
        compute_dtype=compute_dtype, update=update,
        weights_are_binary=weights_binary, backend=backend,
        device=x_loc.device)
    _mark(mesh, "pass")
    if comm == "scatter":
        # Padding rows (weight 0) must never be nominated as reseed targets.
        masked = torch.where(w_loc > 0, min_d2, -torch.inf)
        new_c, counts_loc, shift_sq = _scatter_merge_update(
            mesh, c, sums, counts, x_loc, masked, empty=empty,
            center_update=center_update)
        return new_c, shift_sq, counts_loc
    sums, counts, inertia = _fused_psum_merge(mesh, sums, counts, inertia)
    _mark(mesh, "merge")
    new_c = _apply_center_update(c, sums, counts,
                                 center_update=center_update)
    if empty == "farthest":
        masked = torch.where(w_loc > 0, min_d2, -torch.inf)
        new_c = _reseed_empty_farthest_dp(mesh, new_c, counts, x_loc, masked)
    return new_c, inertia, counts


def _dp_delta_local_pass(mesh, x_loc, c, w_loc, lab_prev, sums_loc,
                         counts_loc, force_full, *, chunk_size,
                         compute_dtype, backend, empty, center_update,
                         comm="allreduce"):
    """DP rank body of the delta update: each rank runs
    :func:`~kmeans_tpu_torch.ops.delta.delta_pass` (K2 on the card) on its
    rows with ITS OWN carried (labels, sums, counts); one merge of the
    per-rank (sums, counts) gives the update.  Returns ``(new_c, labels,
    sums, counts[, shift_sq])``, the carried state un-reduced."""
    labels, min_d2, sums_new, counts_new, _, _ = delta_pass(
        x_loc, c, lab_prev, sums_loc, counts_loc, weights=w_loc,
        cap=default_cap(x_loc.shape[0]), chunk_size=chunk_size,
        compute_dtype=compute_dtype,
        # The engine resolved the classic route; the delta sweep re-gates
        # at its own plan.
        backend="auto" if backend == "cuda" else backend,
        weights_are_binary=True, force_full=force_full,
        with_mind=(empty == "farthest"), device=x_loc.device)
    _mark(mesh, "pass")
    if comm == "scatter":
        masked = (torch.where(w_loc > 0, min_d2, -torch.inf)
                  if empty == "farthest" else min_d2)
        new_c, _, shift_sq = _scatter_merge_update(
            mesh, c, sums_new, counts_new, x_loc, masked, empty=empty,
            center_update=center_update)
        return new_c, labels, sums_new, counts_new, shift_sq
    g_sums, g_counts = _fused_psum_merge(mesh, sums_new, counts_new)
    _mark(mesh, "merge")
    new_c = _apply_center_update(c, g_sums, g_counts,
                                 center_update=center_update)
    if empty == "farthest":
        masked = torch.where(w_loc > 0, min_d2, -torch.inf)
        new_c = _reseed_empty_farthest_dp(mesh, new_c, g_counts, x_loc,
                                          masked)
    return new_c, labels, sums_new, counts_new


def _dp_bound_local_pass(sweep, mesh, x_loc, c, w_loc, lab_prev, sums_loc,
                         counts_loc, sb, lower, c_cd, csq_prev, tail, *,
                         chunk_size, compute_dtype, backend,
                         comm="allreduce"):
    """DP rank body of the bound-pruned updates: ``sweep`` is
    :func:`~kmeans_tpu_torch.ops.hamerly.hamerly_pass` or
    :func:`~kmeans_tpu_torch.ops.yinyang.yinyang_pass` (K4 on the card),
    run on the rank's rows with ITS OWN carried (labels, sums, counts, sb,
    slb | glb); ``tail`` is the sweep's fit-static trailing arguments (the
    rank's row norms, and yinyang's group map).  The replicated centroid
    representations come back identical on every rank.  Returns
    ``(new_c, labels, sums, counts, sb, lower, c_cd, csq[, shift_sq])``."""
    out = sweep(x_loc, c, lab_prev, sums_loc, counts_loc, sb, lower, c_cd,
                csq_prev, *tail, weights=w_loc,
                cap=default_cap(x_loc.shape[0]), chunk_size=chunk_size,
                compute_dtype=compute_dtype,
                backend="auto" if backend == "cuda" else backend,
                weights_are_binary=True, device=x_loc.device)
    labels, sums_new, counts_new, sb2, lower2, c_cd2, csq2 = out[:7]
    _mark(mesh, "pass")
    if comm == "scatter":
        # The pruned updates run empty="keep" (checked at fit entry): the
        # slice update is the bare divide.
        new_c, _, shift_sq = _scatter_merge_update(
            mesh, c, sums_new, counts_new, x_loc, sb, empty="keep",
            center_update="mean")
        return (new_c, labels, sums_new, counts_new, sb2, lower2, c_cd2,
                csq2, shift_sq)
    g_sums, g_counts = _fused_psum_merge(mesh, sums_new, counts_new)
    _mark(mesh, "merge")
    new_c = apply_update(c, g_sums, g_counts)
    return (new_c, labels, sums_new, counts_new, sb2, lower2, c_cd2, csq2)


# ---------------------------------------------------------------------------
# The TP, FP and TP×FP bodies
# ---------------------------------------------------------------------------

class _Axes:
    """The views of a mesh with a model or feature axis that the sharded
    bodies reduce over: ``model``, ``feature``, ``rows`` (data × feature:
    the blocks of full rows, block ``data · fp + feature``, in global row
    order) and
    ``slice`` (model × feature: the ranks that hold the rest of the
    centroids)."""

    def __init__(self, mesh, data_axis, model_axis, feature_axis):
        self.model = mesh.sub((model_axis,))
        self.feature = mesh.sub((feature_axis,))
        self.rows = mesh.sub((data_axis, feature_axis))
        self.slice = mesh.sub((model_axis, feature_axis))
        self.mp, self.fp = self.model.size, self.feature.size


def _gather_cols(mesh, t):
    """Every rank's 2-D ``t`` side by side (dim 1), in rank order."""
    if mesh.size == 1:
        return t
    return mesh.all_gather(t.t().contiguous()).t().contiguous()


def _sharded_pass(ax, x_rows, w_rows, c_loc, *, k_real, route, k_tile, kw,
                  empty="keep", final=False, center_update="mean"):
    """One sweep of the DP×TP, DP×FP and DP×TP×FP bodies.

    The feature ranks' centroid columns are gathered into this model
    rank's full-width k-slice.  With a model axis the sweep is the
    reference's three phases: K1 scores the slice in raw-score mode with
    ``valid_cols`` masking the padded columns, two whole-shard MIN
    all-reduces over the model ranks resolve the value and then the lowest
    global index (``jnp.argmin``'s labels exactly), and K3 folds the rows
    this slice won (``scores=`` the global minimum; labels outside the
    slice drop).  Without one, K1 runs unchanged on the full centroids.  A
    k-slice the planner tiles goes through K5 / K6 the same way
    (``k_tile``); on the CPU every phase is the plain version.  One
    all-reduce over the row blocks (data × feature) merges (sums | counts
    | inertia); the update (``center_update``: the sphere's norm is taken
    over the full width here, where the reference's FP body all-reduces
    the per-slice norms) and the farthest reseed run on the full-width
    slice, and this rank keeps its feature columns.  Returns ``(new_c_loc,
    shift², inertia, counts, labels)``; with ``final`` the update is
    skipped (``new_c_loc`` and shift² None)."""
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    c_sl = _gather_cols(ax.feature, c_loc).float()
    valid = None
    if ax.mp > 1:
        k_loc = c_sl.shape[0]
        k_off = ax.model.rank * k_loc
        valid = (k_off + torch.arange(k_loc, device=c_sl.device)) < k_real
        on_card = route == "cuda"
        score = K.lloyd_pass_cuda if on_card else K.lloyd_pass_plain
        fold = K.accumulate_cuda if on_card else K.accumulate_plain
        lab_l, raw_l, _, _, _ = score(
            x_rows, c_sl, valid_cols=valid, with_update=False,
            raw_scores=True, compute_dtype=kw["compute_dtype"],
            k_tile=k_tile)
        _mark(ax.model, "pass")
        g = ax.model.all_reduce(raw_l.clone(), op="min")
        cand = torch.where(raw_l == g, lab_l + k_off,
                           k_loc * ax.mp).to(torch.int32)
        labels = ax.model.all_reduce(cand, op="min")
        _mark(ax.model, "resolve")
        sums, counts, mind = fold(
            x_rows, labels - k_off, k_loc, scores=g, weights=w_rows,
            compute_dtype=kw["compute_dtype"], k_tile=k_tile)
        inertia = (mind * w_rows).sum()
        _mark(ax.model, "fold")
    else:
        labels, mind, sums, counts, inertia = lloyd_pass(
            x_rows, c_sl, weights=w_rows, device=x_rows.device, **kw)
        _mark(ax.model, "pass")
    sums, counts, inertia = _fused_psum_merge(ax.rows, sums, counts, inertia)
    _mark(ax.model, "merge")
    if final:
        return None, None, inertia, counts, labels
    new_sl = _apply_center_update(c_sl, sums, counts,
                                  center_update=center_update)
    if empty == "farthest":
        masked = torch.where(w_rows > 0, mind, -torch.inf)
        if valid is None:
            new_sl = _reseed_empty_farthest_dp(ax.rows, new_sl, counts,
                                               x_rows, masked)
        else:
            new_sl = _reseed_empty_farthest_tp(
                ax.rows, new_sl, counts, valid, x_rows, masked, k_real,
                slice_mesh=ax.model)
    d_loc = c_loc.shape[1]
    j = ax.feature.rank
    new_c = new_sl[:, j * d_loc:(j + 1) * d_loc].contiguous()
    shift_sq = ax.slice.all_reduce(
        ((new_c - c_loc.float()) ** 2).sum().reshape(1))[0]
    return new_c, shift_sq, inertia, counts, labels


def _global_centroids(ax, c_loc, k: int, d: int):
    """The (k, d) centroids from every rank's slice: the feature ranks'
    columns, then the model ranks' rows, padding cut."""
    return ax.model.all_gather(_gather_cols(ax.feature, c_loc))[:k, :d]


# ---------------------------------------------------------------------------
# The sweep loops
# ---------------------------------------------------------------------------

def _sweep_loop(mesh, step, c0, tol_v, max_it):
    """The shared convergence loop: ``step(c, it)`` runs one sweep and
    returns ``(new_c, shift_sq | None)`` (None: the shift is taken here from
    the replicated centroids).  Returns ``(c, n_iter, converged)``."""
    c = c0
    it, converged = 0, False
    while it < max_it and not converged:
        if mesh.split is not None:
            mesh.split.begin()
        new_c, shift_sq = step(c, it)
        if shift_sq is None:
            shift_sq = ((new_c - c) ** 2).sum()
        _mark(mesh, "update")
        if mesh.split is not None:
            mesh.split.end()
        c = new_c
        it += 1
        converged = bool((shift_sq <= tol_v).item())
    return c, it, converged


def _dense_final(mesh, x_loc, w_loc, c, n, *, chunk_size, compute_dtype,
                 backend, weights_binary=True):
    """The final labeling pass of every loop: the classic dense pass, then
    one all-reduce of (counts | inertia) and an all-gather of the labels.
    Its centroid output would be dead, so the sums are not merged.
    Returns ``(labels[:n], inertia, counts)``."""
    labels, _, _, counts, inertia = lloyd_pass(
        x_loc, c, weights=w_loc, chunk_size=chunk_size,
        compute_dtype=compute_dtype, update="matmul",
        weights_are_binary=weights_binary, backend=backend,
        device=x_loc.device)
    packed = mesh.all_reduce(torch.cat([counts.float(),
                                        inertia.float().reshape(1)]))
    k = c.shape[0]
    return _gather_rows(mesh, labels, n), packed[k], packed[:k]


def _dense_steps(mesh, x_loc, w_loc, *, chunk_size, compute_dtype, update,
                 backend, empty, weights_binary, center_update, comm):
    """The classic (dense) DP sweep: one fused pass and one merge."""
    def step(c, it):
        out = _dp_local_pass(
            mesh, x_loc, c, w_loc, chunk_size=chunk_size,
            compute_dtype=compute_dtype, update=update, backend=backend,
            empty=empty, weights_binary=weights_binary,
            center_update=center_update, comm=comm)
        return out[0], (out[1] if comm == "scatter" else None)

    return step


def _delta_steps(mesh, x_loc, w_loc, c0, *, chunk_size, compute_dtype,
                 backend, empty, center_update, comm):
    """The DP delta sweep: each rank carries its own (labels, sums,
    counts); every ``DELTA_REFRESH``-th sweep (the first included) refolds
    them from scratch (``force_full``)."""
    k, d = c0.shape
    dev = x_loc.device
    carry = [torch.full((x_loc.shape[0],), -1, dtype=torch.int32,
                        device=dev),
             torch.zeros(k, d, dtype=torch.float32, device=dev),
             torch.zeros(k, dtype=torch.float32, device=dev)]

    def step(c, it):
        out = _dp_delta_local_pass(
            mesh, x_loc, c, w_loc, *carry, it % DELTA_REFRESH == 0,
            chunk_size=chunk_size, compute_dtype=compute_dtype,
            backend=backend, empty=empty, center_update=center_update,
            comm=comm)
        carry[:] = out[1:4]
        return out[0], (out[4] if comm == "scatter" else None)

    return step


def _bound_steps(mesh, x_loc, w_loc, c0, *, chunk_size, compute_dtype,
                 backend, comm, group_of=None, t=None):
    """The DP hamerly sweep, or with ``group_of`` (the centroid → group
    map, t groups) the yinyang sweep: per-rank carried (labels, sums,
    counts, sb, slb | glb); every ``DELTA_REFRESH``-th sweep passes the
    sentinel (labels −1, zero sums and counts), which scores every row and
    re-derives the bounds."""
    yinyang = group_of is not None
    k, d = c0.shape
    dev = x_loc.device
    f32 = torch.float32
    n_loc = x_loc.shape[0]
    rno = row_norms(x_loc, compute_dtype=compute_dtype)
    cd = resolve_cd(compute_dtype, x_loc.dtype)
    lower = torch.zeros((n_loc, t) if yinyang else (n_loc,), dtype=f32,
                        device=dev)
    carry = [torch.full((n_loc,), -1, dtype=torch.int32, device=dev),
             torch.zeros(k, d, dtype=f32, device=dev),
             torch.zeros(k, dtype=f32, device=dev),
             torch.zeros(n_loc, dtype=f32, device=dev), lower,
             c0.to(cd), torch.zeros(k, dtype=f32, device=dev)]
    sweep = yinyang_pass if yinyang else hamerly_pass
    # The sweep's fit-static trailing arguments: the rank's row norms and,
    # for yinyang, the replicated group map (its group drifts then come
    # from replicated inputs, so no extra collective).
    tail = (rno, group_of) if yinyang else (rno,)

    def step(c, it):
        if it % DELTA_REFRESH == 0:
            carry[0] = torch.full_like(carry[0], -1)
            carry[1] = torch.zeros_like(carry[1])
            carry[2] = torch.zeros_like(carry[2])
        out = _dp_bound_local_pass(
            sweep, mesh, x_loc, c, w_loc, *carry, tail,
            chunk_size=chunk_size, compute_dtype=compute_dtype,
            backend=backend, comm=comm)
        carry[:] = out[1:8]
        return out[0], (out[8] if comm == "scatter" else None)

    return step


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

#: ``comm="auto"`` switches to the reduce-scatter merge once the f32 (k, d)
#: centroid slab crosses this size (the reference's threshold).
_SCATTER_AUTO_MIN_BYTES = 4 << 20


def _resolve_comm(req, *, dp, sharded_axes, k, d):
    """The sweep-merge strategy policy: explicit "scatter" raises where it
    cannot hold (TP/FP meshes already own k- or d-slices); "auto" picks
    scatter when the slab is big enough to pay for the extra gather and
    dp > 1."""
    if req not in ("auto", "allreduce", "scatter"):
        raise ValueError(f"unknown comm {req!r}")
    if req == "scatter":
        if sharded_axes:
            raise ValueError(
                "comm='scatter' shards the centroid update over the data "
                "axis; it does not compose with model_axis/feature_axis "
                "(those bodies already compute slice-local updates)"
            )
        return "scatter"
    if req == "allreduce" or sharded_axes or dp <= 1:
        return "allreduce"
    return ("scatter" if 4 * k * d >= _SCATTER_AUTO_MIN_BYTES
            else "allreduce")


def _sweep_collective_bytes(comm, *, dp, k, d):
    """Ring-model estimate of the per-device wire bytes one DP sweep's
    merge moves (f32): allreduce, the packed (k, d+2) slab twice minus the
    resident share; scatter, the packed (k_pad, d+1) slab once plus the
    (k_pad, d) centroid all-gather."""
    if dp <= 1:
        return 0
    if comm == "scatter":
        k_pad = k + ((-k) % dp)
        rs = 4 * k_pad * (d + 1) * (dp - 1) // dp
        ag = 4 * k_pad * d * (dp - 1) // dp
        return rs + ag
    return 2 * 4 * k * (d + 2) * (dp - 1) // dp


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _check_weights(x, weights) -> None:
    if weights is not None:
        w_shape = tuple(weights.shape if isinstance(weights, torch.Tensor)
                        else np.shape(weights))
        if w_shape != (x.shape[0],):
            raise ValueError(f"weights shape {w_shape} != ({x.shape[0]},)")


def _given_init(init, cfg, k: int, d: int, device):
    """``(c0, method)``: an explicit (k, d) init on ``device`` (method
    None), or None and the seeding method to run."""
    if init is not None and not isinstance(init, str):
        c0 = as_tensor(init, device, torch.float32)
        if tuple(c0.shape) != (k, d):
            raise ValueError(
                f"init centroids shape {tuple(c0.shape)} != {(k, d)}")
        return c0, None
    method = init if isinstance(init, str) else cfg.init
    if method == "given":
        raise ValueError("init='given' needs an explicit (k, d) array")
    return None, method


def _placed(x, mesh, data_axis, weights, feature_axis=None):
    """Placement shared by the sharded fits: ``(x_loc, w_loc, w_host, n,
    weights_binary)``."""
    x_loc, w_loc, w_host, n = _place(x, mesh, data_axis, weights=weights,
                                     feature_axis=feature_axis)
    weights_binary = bool(np.all((w_host == 0.0) | (w_host == 1.0)))
    return x_loc, w_loc, w_host, n, weights_binary


def _seed_on_mesh(gen, x_loc, w_loc, k, *, mesh, n, method, weights, cfg):
    return init_on_mesh(gen, x_loc, k, mesh=mesh, n=n, method=method,
                        weights=w_loc, user_weights=weights is not None,
                        compute_dtype=cfg.compute_dtype,
                        chunk_size=cfg.chunk_size).float()


def _any_rank(mesh, flag: bool) -> bool:
    """Whether ``flag`` holds on any rank: one all-reduce of a scalar, so
    every rank takes the same branch."""
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    return bool(mesh.all_reduce(t)[0].item() > 0)


def _dtype_name(dt) -> Optional[str]:
    """A compute dtype as the reference's config spells it."""
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(dt)


def engine_fingerprint(cfg: KMeansConfig, *, k: int, d: int,
                       center_update: str = "mean",
                       tol: Optional[float] = None) -> dict:
    """The reference's ``kmeans_tpu.config.engine_fingerprint``, key for
    key: the mesh-agnostic identity of a sharded fit stored in an elastic
    checkpoint and checked on resume.  It leaves out everything a resume
    may change: mesh shape, device count, comm mode, backend, chunk_size
    and max_iter."""
    return {
        "k": int(k),
        "d": int(d),
        "update": cfg.update,
        "empty": cfg.empty,
        "init": cfg.init,
        "seed": int(cfg.seed),
        "tol": float(tol if tol is not None else cfg.tol),
        "compute_dtype": _dtype_name(cfg.compute_dtype),
        "center_update": center_update,
    }


def _resolve_elastic(ckpt_dir, resume):
    """The reference's argument checks of the elastic path; returns the
    checkpoint directory (None: not elastic)."""
    if isinstance(resume, str) and resume:
        if ckpt_dir is not None and (os.path.realpath(ckpt_dir)
                                     != os.path.realpath(resume)):
            raise ValueError(
                f"resume={resume!r} names a different directory than "
                f"ckpt_dir={ckpt_dir!r}; pass one of them")
        ckpt_dir = resume
    if resume and ckpt_dir is None:
        raise ValueError(
            "resume=True needs ckpt_dir (or pass the directory itself as "
            "resume=<path>)")
    return ckpt_dir


def _load_engine_resume(ckpt_dir, fp_want, *, k, d):
    """Restore an elastic checkpoint: verified load, fingerprint check,
    outcome accounting.  Returns ``(centroids (numpy), start_it, meta)``;
    the centroids then take the explicit-init path of a fresh fit."""
    from kmeans_tpu_torch.utils.checkpoint import (CorruptCheckpointError,
                                                   load_array_checkpoint)

    faults.check("engine.resume")
    try:
        arrays, meta = load_array_checkpoint(ckpt_dir)
    except (FileNotFoundError, CorruptCheckpointError):
        _ENGINE_RESUMES_TOTAL.labels(outcome="error").inc()
        raise
    extra = meta.get("extra") or {}
    fp_have = extra.get("fingerprint")
    if fp_have != fp_want:
        _ENGINE_RESUMES_TOTAL.labels(outcome="refused").inc()
        raise ValueError(
            f"refusing to resume from {ckpt_dir!r}: checkpoint fingerprint "
            f"{fp_have!r} contradicts this fit's {fp_want!r} (k, d, update, "
            "tol, dtype and seed must match; mesh shape, device count and "
            "comm mode may differ freely)")
    c_host = np.asarray(arrays["centroids"], np.float32)
    if c_host.shape != (k, d):
        _ENGINE_RESUMES_TOTAL.labels(outcome="refused").inc()
        raise ValueError(
            f"checkpoint centroids shape {c_host.shape} != {(k, d)}")
    _ENGINE_RESUMES_TOTAL.labels(
        outcome="finished" if extra.get("converged") else "ok").inc()
    return c_host, int(meta.get("step", 0)), meta


def fit_lloyd_sharded(
    x,
    k: int,
    *,
    mesh,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    model_axis: Optional[str] = None,
    feature_axis: Optional[str] = None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    center_update: str = "mean",
    ckpt_dir: Optional[str] = None,
    ckpt_every: Optional[int] = None,
    ckpt_keep: int = 0,
    resume: Union[bool, str] = False,
) -> KMeansState:
    """Full-batch Lloyd over ``mesh`` (:func:`~kmeans_tpu_torch.parallel.
    mesh.make_mesh`): data parallel, or with ``model_axis`` (centroids
    sharded over k, padded to a multiple of its ranks) and / or
    ``feature_axis`` (x and centroids sharded over d, padded likewise; rows
    pad to a multiple of data × feature ranks) the reference's DP×TP,
    DP×FP and DP×TP×FP bodies (:func:`_sharded_pass`).

    Every rank calls this with the same global ``x`` (host numpy, a host
    tensor or a card tensor) and places its own block on its device, a
    copy: host data stays on the host (a memory-mapped ``.npy`` is shared
    through the page cache) and no rank keeps all of ``x`` on its card.
    ``weights`` (optional (n,) nonnegative) ride the per-rank weight vector
    the engine already uses for row padding; fractional weights demote the
    dense update to the segment reduction and refuse explicit ``"delta"``,
    as on one device.  ``update`` (``config.update``): ``"auto"`` is the DP
    delta loop where weights are exact (the dense reduction on a model or
    feature axis, where the incremental flavours raise); ``"matmul"`` /
    ``"segment"``, ``"delta"``, ``"hamerly"`` and ``"yinyang"`` as on one
    device.  ``comm`` (``config.comm``) picks the DP merge
    (:func:`_resolve_comm`; ``"scatter"`` raises on a model or feature
    axis).  Every rank returns the global state on its device.
    ``generator`` drives the init draws (default: seeded with
    ``config.seed``); the sharded seeding draws what the single-device one
    draws.

    ``ckpt_dir`` turns on the elastic loop (:func:`_fit_lloyd_elastic`):
    every ``ckpt_every`` sweeps (default :data:`ENGINE_CKPT_EVERY`) and on
    SIGTERM / SIGINT on any rank, rank 0 saves the global f32 centroids,
    the sweep and :func:`engine_fingerprint` as the reference's bundle;
    ``ckpt_keep`` older bundles survive.  ``resume=True`` (or
    ``resume=<dir>``) continues such a bundle on whatever mesh shape and
    comm this call has, and refuses one whose fingerprint contradicts this
    call's.
    """
    ckpt_dir = _resolve_elastic(ckpt_dir, resume)
    cfg, gen = resolve_fit_config(k, generator, config, mesh.device)
    if center_update not in ("mean", "sphere"):
        raise ValueError(f"unknown center_update {center_update!r}")
    if center_update == "sphere" and cfg.empty == "farthest":
        raise ValueError(
            "spherical fits keep degenerate clusters (matching "
            "fit_spherical); empty='farthest' is a Lloyd policy"
        )
    if ckpt_dir is not None and ckpt_every is not None and ckpt_every <= 0:
        raise ValueError(f"ckpt_every must be positive, got {ckpt_every}")
    sharded = bool(model_axis or feature_axis)
    dp = mesh.axis_sizes[data_axis]
    mp = mesh.axis_sizes[model_axis] if model_axis else 1
    fp = mesh.axis_sizes[feature_axis] if feature_axis else 1
    d = x.shape[1]
    _check_weights(x, weights)
    fp_want = (engine_fingerprint(cfg, k=k, d=d, center_update=center_update,
                                  tol=tol) if ckpt_dir is not None else None)
    start_it, resume_meta = 0, None
    if resume:
        init, start_it, resume_meta = _load_engine_resume(ckpt_dir, fp_want,
                                                          k=k, d=d)
    c0, method = _given_init(init, cfg, k, d, mesh.device)
    # Every check runs before the first collective, the same on every rank.
    x_loc, w_loc, w_host, n, weights_binary = _placed(
        x, mesh, data_axis, weights, feature_axis)
    cd = resolve_cd(cfg.compute_dtype, x_loc.dtype)
    w_exact = weights_exact(cd, weights=w_host,
                            weights_are_binary=weights_binary)
    update = resolve_update(cfg.update, w_exact=w_exact,
                            sharded_axes=sharded)
    if update in ("hamerly", "yinyang") and (cfg.empty != "keep"
                                             or center_update != "mean"):
        raise ValueError(
            f"update={update!r} prunes rows from the distance pass (no "
            "per-sweep min_d2 for farthest-reseed, mean updates only); "
            "use empty='keep' with the default center update, or "
            "update='auto'/'delta'"
        )
    comm = _resolve_comm(cfg.comm, dp=dp, sharded_axes=sharded, k=k, d=d)
    k_pad, d_pad = k + (-k) % mp, d + (-d) % fp
    if sharded:
        from kmeans_tpu_torch.ops.lloyd import sweep_route

        # The route at the shapes the rank's kernels see: the k-slice over
        # full rows.
        backend, k_tile = sweep_route(
            "classic", cfg.backend, x_loc, k_pad // mp,
            weights=w_loc, weights_are_binary=weights_binary,
            compute_dtype=cfg.compute_dtype)
        ax = _Axes(mesh, data_axis, model_axis, feature_axis)
        seed_mesh = ax.rows
    else:
        backend = resolve_backend(cfg.backend, x_loc, k, weights=w_loc,
                                  weights_are_binary=weights_binary,
                                  compute_dtype=cfg.compute_dtype)
        seed_mesh = mesh

    if c0 is None:
        c0 = _seed_on_mesh(gen, x_loc, w_loc, k, mesh=seed_mesh, n=n,
                           method=method, weights=weights, cfg=cfg)[:, :d]
    tol_v = torch.tensor(tol if tol is not None else cfg.tol,
                         dtype=torch.float32, device=mesh.device)
    max_it = max_iter if max_iter is not None else cfg.max_iter
    c0 = c0.float()
    if center_update == "sphere" and resume_meta is None:
        # Every init route lands on the sphere (fit_spherical's c0); a
        # resumed cut is already there, and renormalizing it would move it
        # by an ulp off the uninterrupted run.
        from kmeans_tpu_torch.models.spherical import normalize_rows

        c0 = normalize_rows(c0)
    kw = dict(chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
              backend=backend, comm=comm)
    final_kw = dict(chunk_size=cfg.chunk_size,
                    compute_dtype=cfg.compute_dtype, backend=backend,
                    weights_binary=weights_binary)
    group_of = t_groups = None
    if update == "yinyang":
        # The centroid → group map, formed once on the host from the
        # centroids this run starts from (on a resume, the checkpoint's).
        g_np, t_groups = centroid_groups(
            c0.cpu().numpy(), cfg.yinyang_groups, seed=cfg.seed)
        group_of = torch.from_numpy(g_np).to(mesh.device)

    if sharded:
        # This rank's slice: model rank m's k rows, feature rank j's
        # columns, of the padded centroids.
        k_loc, d_loc = k_pad // mp, d_pad // fp
        m, j = ax.model.rank, ax.feature.rank
        c_full = torch.zeros(k_pad, d_pad, device=mesh.device)
        c_full[:k, :d] = c0
        c0 = c_full[m * k_loc:(m + 1) * k_loc,
                    j * d_loc:(j + 1) * d_loc].contiguous()
        skw = dict(k_real=k, route=backend, k_tile=k_tile, kw=dict(
            chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
            update=update, weights_are_binary=weights_binary,
            backend=backend))

        def make_step(c_start):
            def step(c, it):
                return _sharded_pass(ax, x_loc, w_loc, c, empty=cfg.empty,
                                     center_update=center_update, **skw)[:2]
            return step

        def to_global(c):
            return _global_centroids(ax, c, k, d)
    else:
        def make_step(c_start):
            """The sweep step of ``update`` with its carried state fresh
            from ``c_start`` (the elastic loop builds one a segment)."""
            if update == "delta":
                return _delta_steps(mesh, x_loc, w_loc, c_start,
                                    empty=cfg.empty,
                                    center_update=center_update, **kw)
            if update in ("hamerly", "yinyang"):
                return _bound_steps(mesh, x_loc, w_loc, c_start,
                                    group_of=group_of, t=t_groups, **kw)
            return _dense_steps(mesh, x_loc, w_loc, update=update,
                                empty=cfg.empty,
                                weights_binary=weights_binary,
                                center_update=center_update, **kw)

        def to_global(c):
            return c[:k]

    layout = _mesh_layout(dp, mp, fp)
    with _tracing.span("fit_lloyd_sharded", category="fit",
                       kind=f"lloyd.{update}", backend=backend,
                       layout=layout):
        t_run0 = time.perf_counter()
        if ckpt_dir is not None:
            c, n_iter, converged = _fit_lloyd_elastic(
                mesh, make_step, c0, tol_v, max_it=max_it, cfg=cfg,
                to_global=to_global, ckpt_dir=ckpt_dir,
                ckpt_every=ckpt_every, ckpt_keep=ckpt_keep,
                start_it=start_it, resume_meta=resume_meta,
                fingerprint=fp_want, extra={
                    "engine": "fit_lloyd_sharded", "layout": layout,
                    "comm": comm, "update": update})
            sweeps = max(n_iter - start_it, 1)
        else:
            c, n_iter, converged = _sweep_loop(mesh, make_step(c0), c0,
                                               tol_v, max_it)
            sweeps = n_iter
        if sharded:
            _, _, inertia, counts, labels = _sharded_pass(
                ax, x_loc, w_loc, c, final=True, **skw)
            labels = _gather_rows(ax.rows, labels, n)
            counts = ax.model.all_gather(counts)
        else:
            labels, inertia, counts = _dense_final(mesh, x_loc, w_loc, c,
                                                   n, **final_kw)
        c = to_global(c)
        if obs.enabled():
            _observe_sharded_fit(f"lloyd.{update}", backend, layout,
                                 dp * mp * fp, time.perf_counter() - t_run0,
                                 sweeps)
            if not sharded:
                _ENGINE_COLLECTIVE_BYTES.labels(
                    function=f"lloyd.{update}", comm=comm).set(float(
                        _sweep_collective_bytes(comm, dp=dp, k=k, d=d)))
    dev = mesh.device
    return KMeansState(
        c, labels, inertia,
        torch.tensor(n_iter, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev), counts[:k])


def fit_spherical_sharded(
    x,
    k: int,
    *,
    mesh,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    model_axis: Optional[str] = None,
    feature_axis: Optional[str] = None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    pre_normalized: bool = False,
) -> KMeansState:
    """Spherical k-means over ``mesh``: the layouts of
    :func:`fit_lloyd_sharded` with the renormalized-direction update of
    :func:`~kmeans_tpu_torch.models.spherical.fit_spherical`.

    Rows are unit-normalized (in f32) unless ``pre_normalized=True``: host
    numpy stays on the host (each rank then places its block), a tensor is
    normalized where it lies, a block of rows at a time.  Every init route
    is projected onto the sphere inside :func:`fit_lloyd_sharded`.
    Returned centroids are unit-norm; ``inertia`` is Σ w·2(1−cos)."""
    from kmeans_tpu_torch.models.spherical import normalize_rows

    if not pre_normalized:
        if isinstance(x, np.ndarray):
            xf = x.astype(np.float32, copy=False)
            norms = np.sqrt((xf * xf).sum(axis=1, keepdims=True))
            x = xf / np.maximum(norms, 1e-12)
        else:
            x = normalize_rows(x)
    return fit_lloyd_sharded(
        x, k, mesh=mesh, generator=generator, config=config, init=init,
        weights=weights, data_axis=data_axis, model_axis=model_axis,
        feature_axis=feature_axis, tol=tol, max_iter=max_iter,
        center_update="sphere")


def _fit_lloyd_elastic(mesh, make_step, c0, tol_v, *, max_it, cfg,
                       to_global, ckpt_dir, ckpt_every, ckpt_keep, start_it,
                       resume_meta, fingerprint, extra):
    """The elastic sweep loop: segments of ``ckpt_every`` sweeps.

    Each segment builds its step afresh from the centroids it starts from
    (``make_step``), so the delta, hamerly and yinyang flavours re-derive
    their carried state with a full refresh at every segment start, and the
    refresh cadence is segment-relative, as in the reference's segment
    programs: a resumed run replays an uninterrupted elastic run with the
    same cadence (the classic update's trajectory is the fused loop's).
    At each boundary every rank assembles the global centroids
    (``to_global``: a gather where the mesh shards them) and rank 0 saves
    them (the reference's ``save_array_checkpoint`` bundle: ``centroids``,
    the sweep as ``step``, the fingerprint and ``converged`` in
    ``extra``); then every rank joins one all-reduce of its
    :class:`PreemptionGuard` flag, which also keeps the others from going
    on before the bundle is whole.  A signal on any rank stops all of them
    there with :class:`Preempted`.  Returns ``(c, sweep index,
    converged)``."""
    from kmeans_tpu_torch.models.runner import seed_key_data
    from kmeans_tpu_torch.parallel.distributed import heartbeat
    from kmeans_tpu_torch.utils.checkpoint import save_array_checkpoint
    from kmeans_tpu_torch.utils.preempt import Preempted, PreemptionGuard

    every = int(ckpt_every) if ckpt_every else ENGINE_CKPT_EVERY

    def cut(c, it, done):
        faults.check("engine.ckpt")
        t0 = time.perf_counter()
        c_glob = to_global(c)
        if mesh.rank == 0:
            save_array_checkpoint(
                ckpt_dir, {"centroids": c_glob.cpu().numpy()}, step=it,
                config=cfg, key=seed_key_data(cfg.seed),
                extra=dict(extra, fingerprint=fingerprint,
                           converged=bool(done)),
                keep=ckpt_keep)
        _ENGINE_CKPT_SECONDS.observe(time.perf_counter() - t0)

    it = start_it
    done = bool(((resume_meta or {}).get("extra") or {}).get("converged"))
    c = c0
    with PreemptionGuard() as guard:
        while it < max_it and not done:
            stop = min(it + every, max_it)
            with _tracing.span("sweep_segment", category="assign"):
                c, n_seg, done = _sweep_loop(mesh, make_step(c), c, tol_v,
                                             stop - it)
            it += n_seg
            faults.check("engine.sweep_merge")
            cut(c, it, done)
            preempted = _any_rank(mesh, guard.triggered)
            heartbeat()
            if preempted and not done and it < max_it:
                raise Preempted.during(
                    "fit_lloyd_sharded", path=ckpt_dir, step=it,
                    resume_hint=f"--ckpt-dir {ckpt_dir} --resume {ckpt_dir}")
    return c, it, done


def fit_lloyd_accelerated_sharded(
    x,
    k: int,
    *,
    mesh,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    beta_max: float = 1.0,
    accel: Optional[str] = None,
    anderson_m: Optional[int] = None,
    anderson_reg: Optional[float] = None,
) -> KMeansState:
    """Safeguarded extrapolated Lloyd, data parallel over ``mesh``: the
    sharded counterpart of :func:`~kmeans_tpu_torch.models.accelerated.
    fit_lloyd_accelerated` (``accel`` ``"beta"`` or ``"anderson"``, default
    ``config.accel``).

    Each sweep is the DP rank body (:func:`_dp_local_pass`: K1 on the
    card) with one all-reduce of (sums | counts | inertia); the
    extrapolation runs replicated on every rank through the single-device
    loops' own iterations (:func:`~kmeans_tpu_torch.models.accelerated.
    beta_iterations`, :func:`~kmeans_tpu_torch.models.accelerated.
    anderson_iterations`), and its accept / reject test reads the merged
    objective, so every rank takes the same branch.  As in the reference,
    the sweeps are the dense reduction (``update`` "auto" and "delta" run
    "matmul", "segment" where weights are inexact), ``schedule`` must be
    ``"full"`` and ``empty="farthest"`` is refused.  The β loop keeps the
    port's one difference from the reference: a plain (β = 0) step is
    never rejected."""
    from kmeans_tpu_torch.models.accelerated import (anderson_iterations,
                                                     beta_iterations,
                                                     record_accel_steps)
    from kmeans_tpu_torch.ops.anderson import (OUTCOME_ACCEPTED,
                                               OUTCOME_FALLBACK,
                                               OUTCOME_REJECTED,
                                               anderson_reset)

    cfg, gen = resolve_fit_config(k, generator, config, mesh.device)
    accel = accel if accel is not None else cfg.accel
    if accel not in ("beta", "anderson"):
        raise ValueError(f"unknown accel {accel!r}")
    if cfg.schedule != "full":
        raise NotImplementedError(
            f"schedule={cfg.schedule!r} is not supported by the sharded "
            "accelerated loop (the nested subsample ladder is single-device "
            "today); use fit_lloyd_accelerated or schedule='full'")
    if cfg.empty == "farthest":
        raise NotImplementedError(
            "empty='farthest' is not supported by the accelerated loop "
            "(reseeding mid-extrapolation breaks the fixed-point "
            "safeguard); use fit_lloyd_sharded")
    m = anderson_m if anderson_m is not None else cfg.anderson_m
    if accel == "anderson" and not 2 <= m <= 64:
        raise ValueError(f"anderson_m must be in [2, 64], got {m}")
    d = x.shape[1]
    _check_weights(x, weights)
    c0, method = _given_init(init, cfg, k, d, mesh.device)
    x_loc, w_loc, w_host, n, weights_binary = _placed(x, mesh, data_axis,
                                                      weights)
    w_exact = weights_exact(resolve_cd(cfg.compute_dtype, x_loc.dtype),
                            weights=w_host, weights_are_binary=weights_binary)
    update = cfg.update
    if update in ("auto", "delta"):
        # The accelerated loop's sweeps are the dense reduction, as in
        # the reference (the incremental update is the Lloyd fit's).
        update = "matmul"
    if update == "matmul" and not w_exact:
        update = "segment"
    backend = resolve_backend(cfg.backend, x_loc, k, weights=w_loc,
                              weights_are_binary=weights_binary,
                              compute_dtype=cfg.compute_dtype)
    if c0 is None:
        c0 = _seed_on_mesh(gen, x_loc, w_loc, k, mesh=mesh, n=n,
                           method=method, weights=weights, cfg=cfg)
    tol_f = float(tol if tol is not None else cfg.tol)
    max_it = max_iter if max_iter is not None else cfg.max_iter
    kw = dict(chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
              backend=backend)

    def sweep(c, it=None):
        new_c, inertia, _ = _dp_local_pass(
            mesh, x_loc, c, w_loc, update=update, empty="keep",
            weights_binary=weights_binary, **kw)
        return new_c, inertia

    layout = _mesh_layout(mesh.axis_sizes[data_axis], 1, 1)
    with _tracing.span("fit_lloyd_accelerated_sharded", category="fit",
                       kind=f"accel.{accel}", backend=backend,
                       layout=layout):
        if accel == "beta":
            c, it, done, codes = beta_iterations(
                sweep, c0.float(), tol_f, max_iter=max_it,
                beta_max=beta_max)
        else:
            reg = anderson_reg if anderson_reg is not None \
                else cfg.anderson_reg
            xs0, rs0, _ = anderson_reset(m, k * d, device=mesh.device)
            c, it, done, codes = anderson_iterations(
                sweep, c0.float(), xs0, rs0, tol_f,
                torch.tensor(reg, dtype=torch.float32, device=mesh.device),
                max_iter=max_it)
        labels, inertia, counts = _dense_final(
            mesh, x_loc, w_loc, c, n, weights_binary=weights_binary, **kw)
    if accel == "anderson":
        codes = [int(v) for v in codes]
        record_accel_steps(codes.count(OUTCOME_ACCEPTED),
                           codes.count(OUTCOME_REJECTED),
                           codes.count(OUTCOME_FALLBACK))
    dev = mesh.device
    return KMeansState(c, labels, inertia,
                       torch.tensor(it, dtype=torch.int32, device=dev),
                       torch.tensor(done, device=dev), counts)


def _trim_select_dp(mesh, d2m, m_loc: int, m: int):
    """Global top-``m`` selection across the data axis with ``lax.top_k``'s
    semantics (largest first, the lowest GLOBAL index on a tie), without
    gathering the per-row distances:

    1. each rank nominates its local top ``m_loc = min(m, n_loc)`` (any
       global winner is a local winner);
    2. one all-gather of the candidates' order keys gives every rank the
       global m-th largest, τ;
    3. every row above τ is trimmed, and the rest of the budget goes to the
       rows equal to τ in global row order: one all-gather of each rank's
       (above, equal) counts says how many ties lower ranks take (rows are
       contiguous blocks, so lower rank, then lower local index, IS global
       order).

    The order is :func:`~kmeans_tpu_torch.models.trimmed.trim_select`'s
    (the floats' bits as ordered int32 keys).  Returns ``(idx_loc, sel,
    vals_loc)``: the candidates' local rows, a mask over them (True =
    trimmed) and their values."""
    key = order_keys(d2m)
    key_loc, idx_loc = torch.sort(key, descending=True, stable=True)
    key_loc, idx_loc = key_loc[:m_loc], idx_loc[:m_loc]
    keys_all = mesh.all_gather(key_loc)                  # (dp·m_loc,)
    tau = torch.sort(keys_all, descending=True).values[m - 1]
    counts = torch.stack([(key > tau).sum(), (key == tau).sum()])
    counts = mesh.all_gather(counts.reshape(1, 2))        # (dp, 2)
    total_gt = counts[:, 0].sum()
    ties_before = counts[:mesh.rank, 1].sum()
    take = torch.clamp(m - total_gt - ties_before, min=0)
    take = torch.minimum(take, counts[mesh.rank, 1])
    eq = key_loc == tau
    tie_rank = torch.cumsum(eq.to(torch.int64), 0) - 1
    sel = (key_loc > tau) | (eq & (tie_rank < take))
    return idx_loc, sel, d2m[idx_loc]


def _trimmed_local_pass(mesh, x_loc, c, w_loc, *, m, m_loc, final, kw,
                        empty="keep"):
    """DP rank body of trimmed k-means: the rank's fused pass (K1 on the
    card), the distributed top-m selection, the trimmed rows' contribution
    subtracted before the one merge (K6 folds it on the card).  Returns
    ``(new_c, inertia, counts)``, or with ``final`` ``(inertia, counts,
    labels, out_mask)`` with the rank's rows' labels (-1 = trimmed)."""
    from kmeans_tpu_torch.models.trimmed import trim_subtract

    labels, min_d2, sums, counts, inertia = lloyd_pass(
        x_loc, c, weights=w_loc, device=x_loc.device, **kw)
    _mark(mesh, "pass")
    d2m = torch.where(w_loc > 0, min_d2, -torch.inf)
    idx, sel, vals = _trim_select_dp(mesh, d2m, m_loc, m)
    _mark(mesh, "select")
    k = c.shape[0]
    wt = torch.where(sel, w_loc[idx].float(), 0.0)
    s_corr, c_corr, i_corr = trim_subtract(x_loc, labels, idx, wt, vals, k,
                                           backend=kw["backend"])
    _mark(mesh, "correction")
    sums, counts, inertia = _fused_psum_merge(
        mesh, sums - s_corr, counts - c_corr, inertia - i_corr)
    _mark(mesh, "merge")
    if final:
        out_mask = torch.zeros(w_loc.shape, dtype=torch.bool,
                               device=w_loc.device)
        out_mask[idx] = sel
        return inertia, counts, torch.where(out_mask, -1, labels), out_mask
    new_c = apply_update(c, sums, counts)
    if empty == "farthest":
        # Inliers only: a trimmed outlier must never seed an empty slot.
        mind = d2m.clone()
        mind[idx] = torch.where(sel, -torch.inf, vals)
        new_c = _reseed_empty_farthest_dp(mesh, new_c, counts, x_loc, mind)
    return new_c, inertia, counts


def fit_trimmed_sharded(
    x,
    k: int,
    *,
    mesh,
    trim_fraction: Optional[float] = None,
    n_trim: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
):
    """Trimmed k-means (k-means--), data parallel over ``mesh``: the
    sharded counterpart of :func:`~kmeans_tpu_torch.models.trimmed.
    fit_trimmed`, with its outlier set, tie order included, through the
    distributed selection :func:`_trim_select_dp`.  Returns a
    :class:`~kmeans_tpu_torch.models.trimmed.TrimmedState` (every rank the
    global one); ``n_trim=0`` is :func:`fit_lloyd_sharded` with an
    all-false mask."""
    from kmeans_tpu_torch.models.trimmed import TrimmedState, resolve_n_trim

    m = resolve_n_trim(x.shape[0], trim_fraction=trim_fraction,
                       n_trim=n_trim)
    cfg, gen = resolve_fit_config(k, generator, config, mesh.device)
    d = x.shape[1]
    _check_weights(x, weights)
    c0, method = _given_init(init, cfg, k, d, mesh.device)
    dev = mesh.device
    if m == 0:
        st = fit_lloyd_sharded(x, k, mesh=mesh, generator=gen,
                               config=config, init=init, weights=weights,
                               data_axis=data_axis, tol=tol,
                               max_iter=max_iter)
        return TrimmedState(*st, torch.zeros(x.shape[0], dtype=torch.bool,
                                             device=dev))
    x_loc, w_loc, w_host, n, weights_binary = _placed(x, mesh, data_axis,
                                                      weights)
    m_loc = min(m, x_loc.shape[0])
    backend = resolve_backend(cfg.backend, x_loc, k, weights=w_loc,
                              weights_are_binary=weights_binary,
                              compute_dtype=cfg.compute_dtype)
    if c0 is None:
        c0 = _seed_on_mesh(gen, x_loc, w_loc, k, mesh=mesh, n=n,
                           method=method, weights=weights, cfg=cfg)
    kw = dict(chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
              update=cfg.update, weights_are_binary=weights_binary,
              backend=backend)
    tol_v = torch.tensor(tol if tol is not None else cfg.tol,
                         dtype=torch.float32, device=dev)
    max_it = max_iter if max_iter is not None else cfg.max_iter

    def step(c, it):
        new_c, _, _ = _trimmed_local_pass(mesh, x_loc, c, w_loc, m=m,
                                          m_loc=m_loc, final=False, kw=kw,
                                          empty=cfg.empty)
        return new_c, None

    layout = _mesh_layout(mesh.axis_sizes[data_axis], 1, 1)
    with _tracing.span("fit_trimmed_sharded", category="fit",
                       kind="trimmed", backend=backend, layout=layout):
        c, n_iter, converged = _sweep_loop(mesh, step, c0.float(), tol_v,
                                           max_it)
        inertia, counts, labels, out_mask = _trimmed_local_pass(
            mesh, x_loc, c, w_loc, m=m, m_loc=m_loc, final=True, kw=kw)
    return TrimmedState(
        c, _gather_rows(mesh, labels, n), inertia,
        torch.tensor(n_iter, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev), counts,
        _gather_rows(mesh, out_mask.to(torch.uint8), n).bool())


def _sharded_start(x, k, mesh, data_axis, generator, config, init, weights):
    """What the soft and balanced sharded fits share: ``(cfg, x_loc,
    w_loc, w_host, n, c0)`` — the config, this rank's placed rows and
    weights (padding rows weight 0), the global padded weights, the real
    row count and the starting centroids (given, or seeded on the mesh)."""
    cfg, gen = resolve_fit_config(k, generator, config, mesh.device)
    _check_weights(x, weights)
    c0, method = _given_init(init, cfg, k, x.shape[1], mesh.device)
    x_loc, w_loc, w_host, n = _place(x, mesh, data_axis, weights=weights)
    if c0 is None:
        c0 = _seed_on_mesh(gen, x_loc, w_loc, k, mesh=mesh, n=n,
                           method=method, weights=weights, cfg=cfg)
    return cfg, x_loc, w_loc, w_host, n, c0.float()


def _soft_fit(mesh, kind: str, loop, n: int):
    """Run a soft or balanced family's loop (its model module's, given this
    rank's rows and the mesh) under the sharded fit's span; every rank
    returns the global state, its labels gathered."""
    layout = _mesh_layout(mesh.size, 1, 1)
    with _tracing.span(f"fit_{kind}_sharded", category="fit", kind=kind,
                       layout=layout):
        st = loop()
    return st._replace(labels=_gather_rows(mesh, st.labels, n))


def _mean_min_sq_dist(mesh, x_loc, c0, w_loc, *, compute_dtype) -> float:
    """The epsilon scale of :func:`fit_balanced`: the mean squared
    distance to the nearest seed over the real rows (padding excluded by
    the weight mask), with one all-reduce."""
    from kmeans_tpu_torch.ops.distance import pairwise_sq_dists

    mind = pairwise_sq_dists(x_loc, c0,
                             compute_dtype=compute_dtype).amin(dim=1)
    real = (w_loc > 0).float()
    t = mesh.all_reduce(torch.stack([(mind * real).sum(), real.sum()]))
    return float(t[0] / t[1])


def fit_balanced_sharded(
    x,
    k: int,
    *,
    mesh,
    capacities=None,
    epsilon: float = 0.5,
    sinkhorn_sweeps: int = 200,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    normalize_epsilon: bool = True,
):
    """Balanced (Sinkhorn-OT) k-means, data parallel over ``mesh``: the
    (n, k) transport plan split by rows, past the single-device fit's
    size gate.  Each rank runs :func:`~kmeans_tpu_torch.models.balanced.
    fit_balanced`'s loop on its rows; the column step's logsumexp is a MAX
    and a SUM all-reduce a sweep, the update one all-reduce a step.
    Centroids, inertia and column masses match the single-device fit to
    float tolerance; labels agree except on near-tie rows, where
    ``argmin(d² − g)`` can flip because the distributed logsumexp sums
    ``g`` in another order.  Returns a :class:`~kmeans_tpu_torch.models.
    balanced.BalancedState` (every rank the global one)."""
    from kmeans_tpu_torch.models.balanced import (_balanced_loop,
                                                  check_sinkhorn_args,
                                                  resolve_capacities)
    from kmeans_tpu_torch.models.gmm import to_f32

    check_sinkhorn_args(epsilon, sinkhorn_sweeps)
    cap = resolve_capacities(k, capacities, mesh.device)
    cfg, x_loc, w_loc, w_host, n, c0 = _sharded_start(
        x, k, mesh, data_axis, generator, config, init, weights)
    # Normalized log row masses on the host (padding rows -inf).
    wa = np.asarray(w_host, np.float64)
    with np.errstate(divide="ignore"):
        log_a = np.where(wa > 0, np.log(np.maximum(wa, 1e-300)), -np.inf)
    log_a = log_a - np.log(wa.sum())
    n_loc = x_loc.shape[0]
    lo = mesh.coord(data_axis) * n_loc
    log_a_loc = torch.from_numpy(
        log_a[lo:lo + n_loc].astype(np.float32)).to(mesh.device)
    eps_v = float(epsilon)
    if normalize_epsilon:
        eps_v = max(eps_v * _mean_min_sq_dist(
            mesh, x_loc, c0, w_loc, compute_dtype=cfg.compute_dtype), 1e-12)
    return _soft_fit(mesh, "balanced", lambda: _balanced_loop(
        x_loc, c0, w_loc, log_a_loc, torch.log(cap), cap,
        to_f32(tol if tol is not None else cfg.tol), eps_v,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        sweeps=sinkhorn_sweeps, compute_dtype=cfg.compute_dtype,
        mesh=mesh), n)


def fit_fuzzy_sharded(
    x,
    k: int,
    *,
    mesh,
    m: float = 2.0,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
):
    """Fuzzy c-means, data parallel over ``mesh``: each rank runs
    :func:`~kmeans_tpu_torch.models.fuzzy.fit_fuzzy`'s loop on its rows,
    the soft sums all-reduced once a pass.  Returns a
    :class:`~kmeans_tpu_torch.models.fuzzy.FuzzyState` equal to the
    single-device fit (labels exactly, floats to tolerance; bit for bit
    on a mesh of one)."""
    from kmeans_tpu_torch.models.fuzzy import _fcm_loop
    from kmeans_tpu_torch.models.gmm import to_f32

    if not m > 1.0:
        raise ValueError(f"fuzziness m must be > 1, got {m}")
    cfg, x_loc, w_loc, _, n, c0 = _sharded_start(
        x, k, mesh, data_axis, generator, config, init, weights)
    return _soft_fit(mesh, "fuzzy", lambda: _fcm_loop(
        x_loc, c0, w_loc, to_f32(tol if tol is not None else cfg.tol),
        m=float(m), max_iter=max_iter if max_iter is not None
        else cfg.max_iter, chunk_size=cfg.chunk_size,
        compute_dtype=cfg.compute_dtype, mesh=mesh), n)


def fit_gmm_sharded(
    x,
    k: int,
    *,
    mesh,
    covariance_type: str = "diag",
    reg_covar: float = 1e-6,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
):
    """Gaussian mixture EM, data parallel over ``mesh``: each rank runs
    :func:`~kmeans_tpu_torch.models.gmm.fit_gmm`'s loop on its rows, the
    soft moments all-reduced once a pass (the starting variances and the
    tied scatter once a fit).  Returns a :class:`~kmeans_tpu_torch.models.
    gmm.GMMState` equal to the single-device fit (labels exactly, floats
    to tolerance; bit for bit on a mesh of one)."""
    from kmeans_tpu_torch.models.gmm import _gmm_loop, to_f32

    if covariance_type not in ("diag", "spherical", "tied"):
        raise ValueError(
            f"covariance_type must be 'diag', 'spherical' or 'tied', "
            f"got {covariance_type!r}"
        )
    if not reg_covar >= 0.0:
        raise ValueError(f"reg_covar must be >= 0, got {reg_covar}")
    cfg, x_loc, w_loc, _, n, c0 = _sharded_start(
        x, k, mesh, data_axis, generator, config, init, weights)
    return _soft_fit(mesh, "gmm", lambda: _gmm_loop(
        x_loc, c0, w_loc, to_f32(tol if tol is not None else cfg.tol),
        to_f32(reg_covar), max_iter=max_iter if max_iter is not None
        else cfg.max_iter, chunk_size=cfg.chunk_size,
        compute_dtype=cfg.compute_dtype, covariance_type=covariance_type,
        mesh=mesh), n)


def _assign_local(mesh, x_loc, centroids, n, *, chunk_size, compute_dtype,
                  backend):
    """Labels and min-squared-distances of every row (gathered, cut to n):
    K1 with ``with_update=False`` on each rank."""
    labels, mind, _, _, _ = lloyd_pass(
        x_loc, centroids, chunk_size=chunk_size, compute_dtype=compute_dtype,
        with_update=False, backend=backend, device=x_loc.device)
    return _gather_rows(mesh, labels, n), _gather_rows(mesh, mind, n)


def sharded_assign(
    x,
    centroids,
    *,
    mesh,
    data_axis: str = "data",
    chunk_size: int = 4096,
    compute_dtype=None,
    backend: str = "auto",
):
    """Labels + min-squared-distances for row-sharded points and replicated
    centroids; every rank returns all n of each, on its device."""
    x_loc, _, _, n = _place(x, mesh, data_axis)
    c = as_tensor(centroids, mesh.device, torch.float32)
    backend = resolve_backend(backend, x_loc, c.shape[0],
                              compute_dtype=compute_dtype)
    return _assign_local(mesh, x_loc, c, n, chunk_size=chunk_size,
                         compute_dtype=compute_dtype, backend=backend)


def minibatch_rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s batch-draw generator for a loop seed: one
    ``torch.Generator`` per rank, seeded from ``(seed, rank)``."""
    s = np.random.SeedSequence([int(seed), int(rank)]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(s[0]) << 32 | int(s[1]))
    return g


def minibatch_loop_seed(generator: torch.Generator, device) -> int:
    """The minibatch loop's seed: one draw of the fit's generator after
    the seeding (each rank's batch generator derives from it)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=device).item())


def _minibatch_shard(n: int, n_loc: int, dp: int, rank: int):
    """``(n_valid, s_i)``: the rank's real rows and its importance weight
    ``n_valid·dp/n`` (≈1, smaller on the padding-carrying tail rank, 0 on
    an all-padding rank)."""
    n_valid = int(min(max(n - rank * n_loc, 0), n_loc))
    s_i = (np.float32(n_valid) * np.float32(dp) / np.float32(n)
           if n_valid > 0 else np.float32(0.0))
    return n_valid, float(s_i)


def fit_minibatch_sharded(
    x,
    k: int,
    *,
    mesh,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    data_axis: str = "data",
    batch_size: Optional[int] = None,
    steps: Optional[int] = None,
) -> KMeansState:
    """Sharded minibatch k-means (BASELINE config 5).

    Each step every rank draws ``b_loc = batch_size // dp`` of ITS OWN real
    rows (no row crosses the mesh), weights them by ``s_i = n_valid_i·dp/n``
    so the summed stats equal a global uniform draw's in expectation, and
    one all-reduce of the packed (counts | sums) batch stats feeds the
    Sculley update (:func:`~kmeans_tpu_torch.models.minibatch.batch_stats`,
    :func:`~kmeans_tpu_torch.models.minibatch.apply_batch_stats`).  The
    batch draws come from a generator per rank, seeded from ``(seed,
    rank)`` (:func:`minibatch_rank_generator`), the loop seed one draw of
    ``generator`` after the seeding.  Without an explicit ``init`` the
    seeding is :func:`~kmeans_tpu_torch.models.minibatch.fit_minibatch`'s:
    the configured method on a ``min(n, max(64·k, 65536))``-row subsample
    of the global ``x``, the same on every rank.  A final sharded
    assignment labels every row.
    """
    from kmeans_tpu_torch.models.init import init_centroids
    from kmeans_tpu_torch.models.minibatch import (apply_batch_stats,
                                                   batch_stats)

    dev = mesh.device
    cfg, gen = resolve_fit_config(k, generator, config, dev)
    d = x.shape[1]
    if init is not None and not isinstance(init, str):
        c0 = as_tensor(init, dev, torch.float32)
        if tuple(c0.shape) != (k, d):
            raise ValueError(
                f"init centroids shape {tuple(c0.shape)} != {(k, d)}")
    else:
        method = init if isinstance(init, str) else cfg.init
        if method == "given":
            raise ValueError("init='given' needs an explicit (k, d) array")
        n = x.shape[0]
        sub = min(n, max(4 * k * 16, 65536))
        if sub < n:
            idx = torch.randperm(n, generator=gen, device=dev)[:sub]
            xs = (x[idx] if isinstance(x, torch.Tensor)
                  else np.asarray(x)[idx.cpu().numpy()])
        else:
            xs = x
        c0 = init_centroids(gen, as_tensor(xs, dev), k, method=method,
                            compute_dtype=cfg.compute_dtype,
                            chunk_size=cfg.chunk_size)
        del xs
    x_loc, _, _, n = _place(x, mesh, data_axis)
    dp = mesh.axis_sizes[data_axis]
    bs_eff = batch_size if batch_size is not None else cfg.batch_size
    steps_eff = int(steps if steps is not None else cfg.steps)
    b_loc = max(1, int(bs_eff) // dp)
    n_loc = x_loc.shape[0]
    n_valid, s_i = _minibatch_shard(n, n_loc, dp, mesh.rank)
    g_rank = minibatch_rank_generator(minibatch_loop_seed(gen, dev),
                                      mesh.rank, dev)
    c = c0.float()
    n_seen = torch.zeros(k, dtype=torch.float32, device=dev)
    shift_sq = None
    for _ in range(steps_eff):
        idx = torch.randint(0, max(n_valid, 1), (b_loc,), generator=g_rank,
                            device=dev)
        bc, bsum, _ = batch_stats(c, x_loc[idx],
                                  compute_dtype=cfg.compute_dtype,
                                  row_weight=s_i)
        packed = mesh.all_reduce(torch.cat([bc[:, None], bsum], dim=1))
        c, n_seen, shift_sq = apply_batch_stats(c, n_seen, packed[:, 0],
                                                packed[:, 1:])
    converged = (shift_sq <= 0.0 if shift_sq is not None
                 else torch.tensor(False, device=dev))
    backend = resolve_backend(cfg.backend, x_loc, k,
                              compute_dtype=cfg.compute_dtype)
    labels, mind = _assign_local(mesh, x_loc, c, n,
                                 chunk_size=cfg.chunk_size,
                                 compute_dtype=cfg.compute_dtype,
                                 backend=backend)
    counts = torch.bincount(labels.long(), minlength=k).float()
    return KMeansState(c, labels, mind.sum(),
                       torch.tensor(steps_eff, dtype=torch.int32, device=dev),
                       converged, counts)
