"""Sharded Lloyd engine: data parallel over a mesh of processes.

Counterpart of the data-parallel half of ``kmeans_tpu/parallel/engine.py``.
The reference runs one ``shard_map`` program over a ``jax.sharding.Mesh``;
the port runs one process per device (:mod:`kmeans_tpu_torch.parallel.
mesh`), and each rank drives the same sweep loop on its own rows:

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

The reference's TP, FP and TP×FP bodies, its elastic checkpoint loop and
the sharded families other than Lloyd and minibatch are not ported yet
(ROADMAP A4b, A9); their arguments raise with one line naming the item.
"""

from __future__ import annotations

import contextlib
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
from kmeans_tpu_torch.ops.update import apply_update
from kmeans_tpu_torch.ops.yinyang import centroid_groups, yinyang_pass
from kmeans_tpu_torch.parallel.init_sharded import init_on_mesh

__all__ = ["fit_lloyd_sharded", "fit_minibatch_sharded", "sharded_assign",
           "pad_and_place", "sweep_split"]

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

#: The refusals of what this slice does not port.
_A4B = "is not ported yet (ROADMAP A4b); the port's sharded engine is DP-only"
_SPHERE_A9 = ("center_update='sphere' is fit_spherical_sharded's update, "
              "which is not ported yet (ROADMAP A9)")


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
    block = as_tensor(x[lo:max(hi, lo)], device)
    if block.shape[0] < n_loc:
        block = torch.cat([block, block.new_zeros(
            (n_loc - block.shape[0],) + tuple(block.shape[1:]))])
    return block.contiguous()


def _place(x, mesh, data_axis: str, weights=None):
    """``(x_loc, w_loc, w_host, n)``: this rank's row block and weights on
    its device, the global padded weights (numpy) and the real row count.
    ``x`` is the global data (numpy or a tensor), the same on every rank."""
    dp = mesh.axis_sizes[data_axis]
    n = x.shape[0]
    _, w_host, _ = _pad_rows(np.empty((n, 0), np.float32), dp,
                             weights=weights)
    n_loc = w_host.shape[0] // dp
    x_loc = _row_block(x, n, n_loc, mesh.rank, mesh.device)
    w_loc = torch.from_numpy(
        w_host[mesh.rank * n_loc:(mesh.rank + 1) * n_loc].copy()).to(
            mesh.device)
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
    """The post-reduce centroid rule: ``"mean"`` is Lloyd (sums/counts,
    empties keep).  ``"sphere"`` belongs to the spherical family (A9)."""
    if center_update != "mean":
        raise ValueError(_SPHERE_A9)
    return apply_update(c, sums, counts)


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


def _top_stable(v: torch.Tensor, m: int):
    """The m largest entries of ``v`` and their indices, descending, the
    lower index first on a tie (``lax.top_k``'s order; ``torch.topk``
    fixes none)."""
    vals, idx = torch.sort(v, descending=True, stable=True)
    return vals[:m], idx[:m]


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
    vals_loc, idx_loc = _top_stable(min_d2.float(), k_nom)
    pts_loc = x_loc[idx_loc].float()
    if k_nom < k:
        vals_loc = torch.cat([vals_loc,
                              vals_loc.new_full((k - k_nom,), -torch.inf)])
        pts_loc = torch.cat([pts_loc, pts_loc.new_zeros(k - k_nom,
                                                        pts_loc.shape[1])])
    vals_all = mesh.all_gather(vals_loc)                  # (dp·k,)
    _, win = _top_stable(vals_all, k)
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
                              min_d2, k_real):
    """k-sliced farthest reseed: every slice owner computes the same ranked
    winner list and claims the winners whose global rank matches its
    empty slots, rank = (empties on lower slices, an exclusive sum over
    the mesh) + (local empty position).  Padded slots (``~valid``) are
    never empty."""
    repl = _ranked_winners_dp(mesh, x_loc, min_d2, k_real)
    empty_loc = (counts_loc <= 0) & valid
    n_empty_loc = empty_loc.int().sum().reshape(1)
    per_slice = mesh.all_gather(n_empty_loc)              # (dp,)
    off = per_slice[:mesh.rank].sum()
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

def _refuse_unported(model_axis, feature_axis, ckpt_dir, resume):
    for name, on in (("model_axis", model_axis),
                     ("feature_axis", feature_axis),
                     ("ckpt_dir", ckpt_dir), ("resume", resume)):
        if on:
            raise ValueError(f"{name} {_A4B}")


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
    """Full-batch Lloyd, data parallel over ``mesh``
    (:func:`~kmeans_tpu_torch.parallel.mesh.make_mesh`).

    Every rank calls this with the same global ``x`` (host numpy or a
    tensor) and keeps its contiguous row block on its device.  ``weights``
    (optional (n,) nonnegative) ride the per-rank weight vector the engine
    already uses for row padding; fractional weights demote the dense
    update to the segment reduction and refuse explicit ``"delta"``, as on
    one device.  ``update`` (``config.update``): ``"auto"`` is the DP delta
    loop where weights are exact; ``"matmul"``/``"segment"``, ``"delta"``,
    ``"hamerly"`` and ``"yinyang"`` as on one device.  ``comm``
    (``config.comm``) picks the merge (:func:`_resolve_comm`).  Every rank
    returns the global state on its device.  ``generator`` drives the init
    draws (default: seeded with ``config.seed``); the sharded seeding draws
    what the single-device one draws.

    ``model_axis``, ``feature_axis``, ``ckpt_dir`` and ``resume`` are not
    ported yet (ROADMAP A4b) and raise first; ``ckpt_every`` and
    ``ckpt_keep`` are read only with ``ckpt_dir``.
    """
    _refuse_unported(model_axis, feature_axis, ckpt_dir, resume)
    cfg, gen = resolve_fit_config(k, generator, config, mesh.device)
    if center_update not in ("mean", "sphere"):
        raise ValueError(f"unknown center_update {center_update!r}")
    if center_update == "sphere":
        raise ValueError(_SPHERE_A9)
    dp = mesh.axis_sizes[data_axis]
    d = x.shape[1]
    if weights is not None:
        w_shape = tuple(weights.shape if isinstance(weights, torch.Tensor)
                        else np.shape(weights))
        if w_shape != (x.shape[0],):
            raise ValueError(f"weights shape {w_shape} != ({x.shape[0]},)")
    if init is not None and not isinstance(init, str):
        c0 = as_tensor(init, mesh.device, torch.float32)
        if tuple(c0.shape) != (k, d):
            raise ValueError(
                f"init centroids shape {tuple(c0.shape)} != {(k, d)}")
        method = None
    else:
        c0 = None
        method = init if isinstance(init, str) else cfg.init
        if method == "given":
            raise ValueError("init='given' needs an explicit (k, d) array")
    # Every check runs before the first collective, the same on every rank.
    x_loc, w_loc, w_host, n = _place(x, mesh, data_axis, weights=weights)
    weights_binary = bool(np.all((w_host == 0.0) | (w_host == 1.0)))
    cd = resolve_cd(cfg.compute_dtype, x_loc.dtype)
    w_exact = weights_exact(cd, weights=w_host,
                            weights_are_binary=weights_binary)
    update = resolve_update(cfg.update, w_exact=w_exact, sharded_axes=False)
    if update in ("hamerly", "yinyang") and cfg.empty != "keep":
        raise ValueError(
            f"update={update!r} prunes rows from the distance pass (no "
            "per-sweep min_d2 for farthest-reseed, mean updates only); "
            "use empty='keep' with the default center update, or "
            "update='auto'/'delta'"
        )
    backend = resolve_backend(cfg.backend, x_loc, k, weights=w_loc,
                              weights_are_binary=weights_binary,
                              compute_dtype=cfg.compute_dtype)
    comm = _resolve_comm(cfg.comm, dp=dp, sharded_axes=False, k=k, d=d)

    if c0 is None:
        c0 = init_on_mesh(gen, x_loc, k, mesh=mesh, n=n, method=method,
                          weights=w_loc, user_weights=weights is not None,
                          compute_dtype=cfg.compute_dtype,
                          chunk_size=cfg.chunk_size)
    tol_v = torch.tensor(tol if tol is not None else cfg.tol,
                         dtype=torch.float32, device=mesh.device)
    max_it = max_iter if max_iter is not None else cfg.max_iter
    c0 = c0.float()
    kw = dict(chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
              backend=backend, comm=comm)
    if update == "delta":
        step = _delta_steps(mesh, x_loc, w_loc, c0, empty=cfg.empty,
                            center_update=center_update, **kw)
    elif update in ("hamerly", "yinyang"):
        groups = {}
        if update == "yinyang":
            # The centroid → group map, formed once on the host from c0.
            g_np, t_groups = centroid_groups(
                c0.cpu().numpy(), cfg.yinyang_groups, seed=cfg.seed)
            groups = dict(group_of=torch.from_numpy(g_np).to(mesh.device),
                          t=t_groups)
        step = _bound_steps(mesh, x_loc, w_loc, c0, **groups, **kw)
    else:
        step = _dense_steps(mesh, x_loc, w_loc, update=update,
                            empty=cfg.empty, weights_binary=weights_binary,
                            center_update=center_update, **kw)
    layout = _mesh_layout(dp, 1, 1)
    with _tracing.span("fit_lloyd_sharded", category="fit",
                       kind=f"lloyd.{update}", backend=backend,
                       layout=layout):
        t_run0 = time.perf_counter()
        c, n_iter, converged = _sweep_loop(mesh, step, c0, tol_v, max_it)
        labels, inertia, counts = _dense_final(
            mesh, x_loc, w_loc, c, n, chunk_size=cfg.chunk_size,
            compute_dtype=cfg.compute_dtype, backend=backend,
            weights_binary=weights_binary)
        if obs.enabled():
            _observe_sharded_fit(f"lloyd.{update}", backend, layout, dp,
                                 time.perf_counter() - t_run0, n_iter)
            _ENGINE_COLLECTIVE_BYTES.labels(
                function=f"lloyd.{update}", comm=comm).set(float(
                    _sweep_collective_bytes(comm, dp=dp, k=k, d=d)))
    dev = mesh.device
    return KMeansState(
        c[:k], labels, inertia,
        torch.tensor(n_iter, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev), counts[:k])


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
