"""Centroid update (the Lloyd "update" step) and empty-cluster policies.

Counterpart of ``kmeans_tpu/ops/update.py``: the update is the mean of the
assigned points, from the ``(sums, counts)`` reduction of the same sweep.
Empty clusters either keep their previous centroid (``"keep"``) or are
reseeded to the worst-fit points (``"farthest"``).
"""

from __future__ import annotations

import torch

from kmeans_tpu_torch.ops.select import top_stable

__all__ = ["apply_update", "reseed_empty_farthest"]


def apply_update(centroids: torch.Tensor, sums: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """New centroids = sums/counts where count > 0, else the old centroid."""
    keep = counts > 0
    means = sums / torch.where(keep, counts, 1.0)[:, None]
    return torch.where(keep[:, None], means, centroids.float())


def reseed_empty_farthest(centroids: torch.Tensor, counts: torch.Tensor,
                          x: torch.Tensor,
                          min_d2: torch.Tensor) -> torch.Tensor:
    """Replace empty clusters with the globally worst-fit points: the j-th
    empty cluster (in index order) takes the point with the j-th largest
    ``min_d2``, the lower index first among equal values (``lax.top_k``'s
    order, :func:`~kmeans_tpu_torch.ops.select.top_stable`)."""
    k = centroids.shape[0]
    empty = counts <= 0
    rank = torch.where(empty, torch.cumsum(empty.int(), 0) - 1, 0)
    _, cand = top_stable(min_d2, k)
    repl = x[cand[rank]].float()
    return torch.where(empty[:, None], repl, centroids.float())
