"""Trimmed k-means (k-means--): outlier-robust Lloyd.

Counterpart of ``kmeans_tpu/models/trimmed.py``.  Chawla & Gionis's
"k-means--" (SDM 2012): each iteration assigns every point, marks the ``m``
points FARTHEST from their nearest centroid as outliers, and updates the
centroids from the inliers only, solving k-means and outlier detection
jointly (the board's designated outliers, ``seed:t10`` / ``seed:t11``, are
the ones the teaching game expects humans to leave unassigned).

An iteration is ONE fused sweep plus O(m) work:

* the sweep (:func:`kmeans_tpu_torch.ops.lloyd.lloyd_pass`: the classic
  kernel K1 on the card, or K5 + K6 where the planner tiles) gives labels,
  min-distances and the FULL sums / counts / inertia in one read of ``x``;
* :func:`trim_select` picks the ``m`` largest min-distances, lowest index
  first among equal values (as ``lax.top_k`` does):
  :func:`~kmeans_tpu_torch.ops.select.top_stable` over the (n,)
  distances' ordered bit keys;
* the outliers' contributions are *subtracted*: :func:`trim_subtract`
  gathers the m rows and folds them per cluster with the bucketed-fold
  kernel K6 (:func:`~kmeans_tpu_torch.ops.cuda_lloyd.tiled_fold_cuda`: no
  float atomics, so two runs of one fit give the same bits; its plain
  version on the CPU and under ``backend="plain"``).  On an H100
  ``index_put_(accumulate=True)`` took 25 ms for this fold at the
  headline (64,000 rows of 2048), 2.4 times the sweep itself.

Zero-weight rows are never nominated as outliers: they rank at ``-inf``,
last, lowest index first among them, which only matters when ``m``
exceeds the positive-weight rows.

The loop is a Python loop over sweeps on the device that reads one scalar
(the shift) back per iteration, as :func:`~kmeans_tpu_torch.models.lloyd.
fit_lloyd` does; k-means++ draws from one :class:`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.models.lloyd import NearestCentroidMixin, best_of_n_init
from kmeans_tpu_torch.ops.cuda_lloyd import tiled_fold_cuda, tiled_fold_plain
from kmeans_tpu_torch.ops.lloyd import lloyd_pass, resolve_backend
from kmeans_tpu_torch.ops.select import order_keys, top_stable
from kmeans_tpu_torch.ops.update import apply_update, reseed_empty_farthest

__all__ = ["TrimmedState", "fit_trimmed", "TrimmedKMeans", "resolve_n_trim",
           "trim_select", "trim_subtract", "trim_correction", "order_keys"]


class TrimmedState(NamedTuple):
    """Result of a trimmed fit; tensors on the fit's device.

    ``labels`` is -1 for the points trimmed as outliers at the final
    centroids; ``outlier_mask`` is the same information as a boolean (n,)
    tensor.  ``inertia`` / ``counts`` cover inliers only.
    """

    centroids: torch.Tensor      # (k, d) float32
    labels: torch.Tensor         # (n,) int32, -1 = outlier
    inertia: torch.Tensor        # scalar float32, inliers only
    n_iter: torch.Tensor         # scalar int32
    converged: torch.Tensor      # scalar bool
    counts: torch.Tensor         # (k,) float32 inlier cluster sizes
    outlier_mask: torch.Tensor   # (n,) bool


def resolve_n_trim(n: int, *, trim_fraction: Optional[float],
                   n_trim: Optional[int]) -> int:
    """The reference's one copy of the trim-budget rule: exactly one of the
    two knobs, 0 <= m < n."""
    if (trim_fraction is None) == (n_trim is None):
        raise ValueError("pass exactly one of trim_fraction / n_trim")
    if n_trim is None:
        if not 0.0 <= trim_fraction < 1.0:
            raise ValueError(
                f"trim_fraction must be in [0, 1), got {trim_fraction}"
            )
        n_trim = int(round(trim_fraction * n))
    if not 0 <= n_trim < n:
        raise ValueError(f"n_trim must be in [0, {n}), got {n_trim}")
    return n_trim


def trim_select(min_d2: torch.Tensor, weights: Optional[torch.Tensor],
                m: int):
    """``(vals, idx)``: the ``m`` largest of ``min_d2`` (zero-weight rows
    ranked ``-inf``), in descending order, the lowest index first among
    equal values, as ``lax.top_k`` selects them.

    :func:`~kmeans_tpu_torch.ops.select.top_stable` ranks the floats in
    their one total order on every device (``lax.top_k``'s: -0.0 ranks
    below +0.0)."""
    d2m = min_d2 if weights is None else torch.where(
        weights > 0, min_d2, -torch.inf)
    return top_stable(d2m, m)


def trim_subtract(x, labels, idx, wt, vals, k: int, *, backend: str):
    """The ``(sums, counts, inertia)`` contribution of the rows ``idx``
    with effective weights ``wt`` (None: unit weights) and min-distances
    ``vals``: the reference's one copy of the correction.  The gathered
    rows fold in f32 of x's own dtype (the reference's ``astype(f32)``) on
    K6, or on its plain version where ``backend`` is ``"plain"`` or x lies
    on the CPU.  With no rows trimmed (``m == 0``) the correction is zero
    and nothing is launched: the kernel takes no empty input."""
    f32 = torch.float32
    if idx.shape[0] == 0:
        return (torch.zeros(k, x.shape[1], dtype=f32, device=x.device),
                torch.zeros(k, dtype=f32, device=x.device),
                torch.zeros((), dtype=f32, device=x.device))
    fold = tiled_fold_cuda if backend == "cuda" else tiled_fold_plain
    sums_corr, counts_corr = fold(x[idx], wt, labels[idx], None, k)
    if wt is None:
        inertia_corr = vals.sum()
    else:
        # vals can be -inf where every remaining candidate had weight 0;
        # those rows contribute nothing (wt == 0), so guard the product.
        inertia_corr = torch.where(wt > 0, wt * vals,
                                   torch.zeros((), dtype=f32,
                                               device=x.device)).sum()
    return sums_corr, counts_corr, inertia_corr


def trim_correction(x, labels, min_d2, weights, k: int, m: int, *,
                    backend: str):
    """Outlier selection and the reduction correction: returns ``(idx,
    sums_corr, counts_corr, inertia_corr)``, ``idx`` the m trimmed rows
    and the corrections what they contributed to the full sweep."""
    vals, idx = trim_select(min_d2, weights, m)
    wt = None if weights is None else weights[idx].float()
    return (idx, *trim_subtract(x, labels, idx, wt, vals, k,
                                backend=backend))


def _trimmed_loop(x, centroids0, weights, tol, *, m, max_iter, chunk_size,
                  compute_dtype, update, empty, backend):
    n = x.shape[0]
    k = centroids0.shape[0]
    dev = x.device
    kw = dict(weights=weights, chunk_size=chunk_size,
              compute_dtype=compute_dtype, update=update, backend=backend,
              device=dev)
    tol = torch.tensor(tol, dtype=torch.float32)
    c = centroids0.float()
    it, converged = 0, False
    while it < max_iter and not converged:
        labels, min_d2, sums, counts, _ = lloyd_pass(x, c, **kw)
        idx, s_corr, n_corr, _ = trim_correction(x, labels, min_d2,
                                                 weights, k, m,
                                                 backend=backend)
        sums = sums - s_corr
        counts = counts - n_corr
        new_c = apply_update(c, sums, counts)
        if empty == "farthest":
            # Reseed targets must be inliers: an empty cluster grabbing a
            # trimmed outlier would re-admit the point trimming excludes.
            mind = min_d2 if weights is None else torch.where(
                weights > 0, min_d2, -torch.inf)
            mind = mind.clone()
            mind[idx] = -torch.inf
            new_c = reseed_empty_farthest(new_c, counts, x, mind)
        shift_sq = ((new_c - c) ** 2).sum()
        c = new_c
        it += 1
        converged = bool((shift_sq <= tol).item())

    # Final consistent view at the final centroids: one more sweep + trim.
    labels, min_d2, _, counts, inertia = lloyd_pass(x, c, **kw)
    idx, _, n_corr, i_corr = trim_correction(x, labels, min_d2, weights, k,
                                             m, backend=backend)
    outlier_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    outlier_mask[idx] = True
    labels = torch.where(outlier_mask, -1, labels)
    return TrimmedState(
        c, labels, inertia - i_corr,
        torch.tensor(it, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev), counts - n_corr, outlier_mask)


def fit_trimmed(
    x,
    k: int,
    *,
    trim_fraction: Optional[float] = None,
    n_trim: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    device=None,
) -> TrimmedState:
    """Fit trimmed k-means (k-means--) on ``device`` (None is the card),
    excluding the ``m`` farthest points from every centroid update and
    from the final labeling.

    Exactly one of ``trim_fraction`` (fraction of n) / ``n_trim`` (count)
    selects the outlier budget; ``trim_fraction=0.0`` reproduces plain
    Lloyd with an all-false outlier mask.  ``generator`` drives the init
    draws (default: a generator seeded with ``config.seed``), as in
    :func:`~kmeans_tpu_torch.models.lloyd.fit_lloyd`."""
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    m = resolve_n_trim(x.shape[0], trim_fraction=trim_fraction,
                       n_trim=n_trim)
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    cfg, generator, c0 = resolve_fit_inputs(x, k, generator, config, init,
                                            weights)
    backend = resolve_backend(cfg.backend, x, k, weights=weights,
                              compute_dtype=cfg.compute_dtype)
    return _trimmed_loop(
        x, c0, weights, tol if tol is not None else cfg.tol, m=m,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        update=cfg.update, empty=cfg.empty, backend=backend)


@dataclasses.dataclass
class TrimmedKMeans(NearestCentroidMixin):
    """Estimator wrapper over :func:`fit_trimmed` (sklearn-like surface),
    on ``device`` (None is the card).

    ``predict`` / ``transform`` / ``score`` come from the nearest-centroid
    mixin: prediction never emits -1 (trimming is a fit-time concept; the
    mask for the training data is ``outlier_mask_``), and ``score`` sums
    min-distances over ALL given points, so on the training data
    ``-score(x) >= inertia_`` (which counts inliers only).

    >>> tk = TrimmedKMeans(n_clusters=3, trim_fraction=0.05, seed=0,
    ...                    device="cpu").fit(x)
    >>> tk.labels_          # -1 marks the trimmed outliers
    >>> tk.outlier_mask_
    """

    n_clusters: int = 3
    trim_fraction: float = 0.05
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    tol: float = 1e-4
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    empty: str = "keep"
    backend: str = "auto"
    device: Optional[str] = None

    state: Optional[TrimmedState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x, weights=None) -> "TrimmedKMeans":
        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        init = None if isinstance(self.init, str) else self.init
        cfg = KMeansConfig(
            k=self.n_clusters,
            init=self.init if isinstance(self.init, str) else "given",
            max_iter=self.max_iter, tol=self.tol, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
            empty=self.empty, backend=self.backend,
        )
        self.state = best_of_n_init(
            lambda gen: fit_trimmed(
                x, self.n_clusters, trim_fraction=self.trim_fraction,
                generator=gen, config=cfg, init=init, weights=weights,
                device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev)
        return self

    def fit_predict(self, x, weights=None):
        return self.fit(x, weights=weights).labels_

    @property
    def cluster_centers_(self):
        return self.state.centroids

    @property
    def labels_(self):
        return self.state.labels

    @property
    def outlier_mask_(self):
        return self.state.outlier_mask

    @property
    def inertia_(self):
        return float(self.state.inertia)

    @property
    def n_iter_(self):
        return int(self.state.n_iter)
