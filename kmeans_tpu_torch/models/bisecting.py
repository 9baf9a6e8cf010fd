"""Bisecting k-means: top-down hierarchical splitting.

Counterpart of ``kmeans_tpu/models/bisecting.py`` (the surface mirrors
``sklearn.cluster.BisectingKMeans``).  A split never gathers the member
rows: each of the k-1 splits is a *weighted* 2-means over the full (n, d)
array with the membership mask folded into the sample weights
(:func:`~kmeans_tpu_torch.models.lloyd.fit_lloyd` at k = 2, then one
``assign``: the sweep kernels K1 and K2 on the card), so every split runs
the same shapes.  The masks are 0/1 weights that the fit is not told are
binary, as in the reference: in bf16 compute its exactness policy sends the
single-device inner fits to the plain route (``ops.plan.WEIGHTS_VETO``);
on a mesh the engine admits them onto the kernels.

The split loop reads one (target, score) pair back per split; every inner
fit draws its seeding from the one generator of the fit, in split order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_config
from kmeans_tpu_torch.models.lloyd import (KMeans, KMeansState,
                                           best_of_n_init, fit_lloyd)
from kmeans_tpu_torch.ops.distance import assign, full_f32

__all__ = ["fit_bisecting", "BisectingKMeans"]

_STRATEGIES = ("biggest_inertia", "largest_cluster")

#: Rows a block reads at a time where x may be host data (the weighted
#: mean here, g-means' projection).
ROW_BLOCK = 65536


def host_rows(x, lo: int, hi: int, device) -> torch.Tensor:
    """Rows ``lo:hi`` of ``x`` (a tensor, or host numpy that may be a
    read-only memmap) on ``device``."""
    rows = x[lo:hi]
    if isinstance(rows, np.ndarray) and not rows.flags.writeable:
        rows = np.array(rows)
    return as_tensor(rows, device)


def weighted_mean(x, w: torch.Tensor) -> torch.Tensor:
    """Σ w·x / Σ w (0 where Σ w is 0) in f32 on ``w``'s device, a block of
    rows at a time: ``x`` may be host data that stays on the host."""
    total = torch.zeros(x.shape[1], dtype=torch.float32, device=w.device)
    for lo in range(0, x.shape[0], ROW_BLOCK):
        xb = host_rows(x, lo, lo + ROW_BLOCK, w.device).float()
        with full_f32():
            total += w[lo:lo + ROW_BLOCK] @ xb
    w_total = w.sum()
    return total / torch.where(w_total > 0, w_total, 1.0)


def inner_fits(cfg: KMeansConfig, mesh, data_axis: str, device):
    """``(fit, assign)`` of the splitting families: the single-device
    :func:`fit_lloyd` and ``assign`` on ``device``, or with ``mesh`` the
    data-parallel engine's ``fit_lloyd_sharded`` and ``sharded_assign``
    (every rank passes the global x).  The assigns take ``cfg.backend``
    too, so ``backend="plain"`` launches no kernel (the reference's
    assigns run its default route whatever the config's)."""
    if mesh is None:
        def _fit(x_, k_, **kw):
            return fit_lloyd(x_, k_, device=device, **kw)

        def _assign(x_, c_):
            return assign(x_, c_, chunk_size=cfg.chunk_size,
                          compute_dtype=cfg.compute_dtype,
                          backend=cfg.backend, device=device)
        return _fit, _assign
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded, sharded_assign

    def _fit(x_, k_, **kw):
        return fit_lloyd_sharded(x_, k_, mesh=mesh, data_axis=data_axis,
                                 **kw)

    def _assign(x_, c_):
        return sharded_assign(x_, c_, mesh=mesh, data_axis=data_axis,
                              chunk_size=cfg.chunk_size,
                              compute_dtype=cfg.compute_dtype,
                              backend=cfg.backend)
    return _fit, _assign


def fit_bisecting(
    x,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    strategy: str = "biggest_inertia",
    weights=None,
    mesh=None,
    data_axis: str = "data",
    device=None,
) -> KMeansState:
    """Fit bisecting k-means: start from one cluster, repeatedly
    2-means-split the worst cluster (by SSE or by size) until k clusters
    exist.

    Labels are hierarchical (the leaf a point's split path assigned it to),
    as in sklearn's BisectingKMeans; ``inertia`` / ``counts`` follow these
    labels.  On degenerate data with fewer than k splittable clusters, the
    remaining slots keep zero counts and duplicate the first centroid.

    Runs on ``device`` (None is the card), or with ``mesh`` every split's
    fit and assign on the data-parallel engine (every rank passes the same
    global ``x``; ``device`` is the mesh's)."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; have {_STRATEGIES}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg, gen = resolve_fit_config(k, generator, config, dev)
    if cfg.init == "given":
        raise ValueError(
            "bisecting derives every centroid from splits; init='given' "
            "(an init array) is not supported"
        )
    if mesh is None:
        x = as_tensor(x, dev)
    n, d = x.shape
    f32 = torch.float32
    # k = 2 sub-problem config, honouring the caller's init method; "keep"
    # for empties (a split that finds no two clusters leaves the second
    # child empty, which the splittable mask handles).
    cfg2 = dataclasses.replace(cfg, k=2, empty="keep")
    _fit, _assign = inner_fits(cfg, mesh, data_axis, dev)
    w = (torch.ones(n, dtype=f32, device=dev) if weights is None
         else as_tensor(weights, dev, f32))

    labels = torch.zeros(n, dtype=torch.int32, device=dev)
    mean0 = weighted_mean(x, w)
    _, mind0 = _assign(x, mean0[None])
    centroids = torch.zeros(k, d, dtype=f32, device=dev)
    centroids[0] = mean0
    sse = torch.zeros(k, dtype=f32, device=dev)
    sse[0] = (w * mind0).sum()
    counts = torch.zeros(k, dtype=f32, device=dev)
    counts[0] = w.sum()
    # Splittable = at least two members carrying weight (count alone can't
    # tell 2 unit-weight points from 1 double-weight point).
    members = torch.zeros(k, dtype=f32, device=dev)
    members[0] = (w > 0).sum()

    n_splits = 0
    for i in range(1, k):
        score = sse if strategy == "biggest_inertia" else counts
        score = torch.where(members >= 2, score, -torch.inf)
        best = score.argmax()
        target, top = torch.stack([best.to(f32), score[best]]).tolist()
        target = int(target)
        if not top > 0:
            break  # nothing splittable (or all remaining SSE exactly 0)
        mask_w = torch.where(labels == target, w, 0.0)

        st2 = _fit(x, 2, generator=gen, config=cfg2, weights=mask_w)
        lab2, mind2 = _assign(x, st2.centroids)
        in_b = (labels == target) & (lab2 == 1)
        labels = torch.where(in_b, i, labels).to(torch.int32)

        wa = torch.where(lab2 == 0, mask_w, 0.0)
        wb = torch.where(lab2 == 1, mask_w, 0.0)
        centroids[target] = st2.centroids[0]
        centroids[i] = st2.centroids[1]
        sse[target], sse[i] = (wa * mind2).sum(), (wb * mind2).sum()
        counts[target], counts[i] = wa.sum(), wb.sum()
        members[target], members[i] = (wa > 0).sum(), (wb > 0).sum()
        n_splits += 1

    # Zero-count slots (never used, or consumed by a split whose second
    # child came out empty) take centroid 0: ties resolve to the lower
    # index, so the duplicates are unreachable by predict().
    stale = (counts <= 0) & (torch.arange(k, device=dev) > 0)
    centroids = torch.where(stale[:, None], centroids[0], centroids)

    return KMeansState(
        centroids=centroids,
        labels=labels,
        inertia=sse.sum(),
        n_iter=torch.tensor(n_splits, dtype=torch.int32, device=dev),
        converged=torch.tensor(n_splits == k - 1, device=dev),
        counts=counts,
    )


@dataclasses.dataclass
class BisectingKMeans(KMeans):
    """Estimator wrapper over :func:`fit_bisecting`.

    ``labels_`` are the hierarchical (split-path) labels; ``predict`` is
    nearest-final-centroid, which can differ on points near leaf
    boundaries."""

    strategy: str = "biggest_inertia"

    def fit(self, x, weights=None) -> "BisectingKMeans":
        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        if not isinstance(self.init, str):
            raise ValueError(
                "BisectingKMeans derives every centroid from splits; "
                "an init array is not accepted"
            )
        self.state = best_of_n_init(
            lambda gen: fit_bisecting(
                x, self.n_clusters, generator=gen, config=self._config(),
                strategy=self.strategy, weights=weights, device=dev),
            self.seed, self.n_init, device=dev)
        return self
