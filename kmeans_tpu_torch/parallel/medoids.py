"""Sharded k-medoids: the O(n²) pairwise cost sweep as a ring pass.

Counterpart of ``kmeans_tpu/parallel/medoids.py``.  The medoid update needs
every row's summed distance to its cluster's co-members; on a mesh the row
blocks rotate instead of every rank holding all of x: each of the dp ring
steps, every rank sums its rows' partial costs against the visiting block
((chunk, n/dp) tiles), then passes the block on
(:meth:`~kmeans_tpu_torch.parallel.mesh.Mesh.ring_shift`, the reference's
``ppermute``).  Medoid selection keeps the single-device lowest-index rule
with two MIN all-reduces a step (the least cost per cluster, then the
lowest global row among the rows that reach it); the medoid rows come
from their owners in one all-reduce.  The loop is
:func:`kmeans_tpu_torch.models.medoids._kmedoids_loop` itself (one device
is a ring of one), and the D-sampling init is its sharded form: every
rank draws the full Gumbel stream, so the picks are one device's.

Parity caveat (the reference's own): costs add up over the ring steps in
another f32 order than one device's, so a sub-ulp cost tie can select a
different, equally good medoid; on a mesh of one the sums are one
device's, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.models.init import resolve_fit_config
from kmeans_tpu_torch.models.medoids import (KMedoidsState, _kmedoids_loop,
                                             resolve_medoid_init)

__all__ = ["fit_kmedoids_sharded"]


def fit_kmedoids_sharded(
    x,
    k: int,
    *,
    mesh,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    metric: str = "euclidean",
    max_iter: Optional[int] = None,
) -> KMedoidsState:
    """k-medoids (alternate iteration) over ``mesh``.

    The contract of :func:`~kmeans_tpu_torch.models.medoids.fit_kmedoids`
    (real rows as centers, euclidean / sqeuclidean, lowest-index ties);
    every rank calls it with the same global ``x`` and places only its own
    rows.  ``init`` may be a (k,) array of global row indices or an init
    method name.  Every rank returns the global state."""
    from kmeans_tpu_torch.parallel.engine import (_check_weights, _place,
                                                  _soft_fit)

    if metric not in ("euclidean", "sqeuclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    cfg, gen = resolve_fit_config(k, generator, config, mesh.device)
    _check_weights(x, weights)
    ring = mesh.sub((data_axis,))
    x_loc, w_loc, _, n = _place(x, mesh, data_axis, weights=weights)
    idx0 = resolve_medoid_init(gen, x_loc, k, init=init, cfg=cfg,
                               weights=w_loc, metric=metric, mesh=ring, n=n)
    return _soft_fit(ring, "kmedoids", lambda: _kmedoids_loop(
        x_loc, idx0, w_loc,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        metric=metric, mesh=ring, n=n), n)
