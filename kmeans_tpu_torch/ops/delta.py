"""Incremental (delta) Lloyd update: distance pass + changed-rows-only fold.

Counterpart of ``kmeans_tpu/ops/delta.py``.  The per-cluster sums are an
additive function of the assignment,

    sums_t = sums_{t-1} + Σ_{i: changed} w_i·x_i·(e_{new_i} − e_{old_i}),

so a sweep needs the distance product plus a fold over the rows whose label
changed.  On the card that is one kernel launch
(:func:`kmeans_tpu_torch.ops.cuda_lloyd.lloyd_delta_cuda`): argmin, then a
scatter of each changed row, ``+w`` at the new label and ``−w`` at the old;
where the planner tiles the shape, the k-tiled pair (K5's streamed argmin,
K6's dual fold) instead.
Like the reference's fused kernel route, the delta is valid at any churn,
so the only full recompute is the caller's periodic refresh
(``force_full``, the labeled fold
:func:`kmeans_tpu_torch.ops.cuda_lloyd.accumulate_cuda`), which bounds the
f32 drift of repeated ± accumulation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.ops.cuda_lloyd import (accumulate_cuda,
                                             accumulate_plain,
                                             lloyd_delta_cuda,
                                             lloyd_delta_plain)
from kmeans_tpu_torch.ops.lloyd import resolve_backend, sweep_route
from kmeans_tpu_torch.ops.plan import KernelPlan, device_plan

__all__ = ["delta_pass", "delta_kernel_plan", "resolve_delta_backend",
           "default_cap", "DELTA_REFRESH"]

#: Full-reduction refresh period of delta-update loops: one sweep in every
#: DELTA_REFRESH recomputes sums/counts from scratch, bounding the f32
#: drift of repeated +/- accumulation.  The reference's value: the two
#: packages must share the cadence or their trajectories fork.
DELTA_REFRESH = 16


def delta_kernel_plan(x, k: int, *, weights=None, weights_are_binary=False,
                      compute_dtype=None, device=None) -> KernelPlan:
    """Dispatch decision for the delta sweep: the vetoes, then the shape's
    price as the ``"delta"`` kind (:func:`kmeans_tpu_torch.ops.plan.
    device_plan`)."""
    return device_plan("delta", x, k, weights=weights,
                       weights_are_binary=weights_are_binary,
                       compute_dtype=compute_dtype, device=device)


def resolve_delta_backend(backend, x, k: int, *, weights=None,
                          weights_are_binary=False, compute_dtype=None,
                          device=None) -> Tuple[str, str]:
    """``(request to pass to delta_pass, route its sweeps run)``, the
    reference's reporting pair; the route is ``"cuda"`` or ``"plain"``."""
    return backend, resolve_backend(
        backend, x, k, weights=weights,
        weights_are_binary=weights_are_binary, compute_dtype=compute_dtype,
        device=device, kind="delta")


def default_cap(n: int) -> int:
    """The reference's changed-rows buffer capacity (n/8) for its XLA
    gather route.  Every route of the port folds at any churn, so
    :func:`delta_pass` takes ``cap`` for call compatibility only."""
    return max(1, n // 8)


def delta_pass(
    x,
    centroids,
    labels_prev,
    sums_prev,
    counts_prev,
    *,
    weights=None,
    cap: Optional[int] = None,
    chunk_size: int = 4096,
    compute_dtype=None,
    backend: str = "auto",
    weights_are_binary: bool = False,
    force_full: bool = False,
    with_mind: bool = True,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """One Lloyd sweep with an incremental update.

    Args:
      x: (n, d) points.
      centroids: (k, d) current centroids.
      labels_prev: (n,) int32 labels of the previous sweep, and
        ``sums_prev``/``counts_prev`` the matching reduction (the invariant
        is ``sums_prev == Σ_i w_i·x_i·onehot(labels_prev_i)``).  Pass −1
        everywhere with zero sums for a first sweep.
      cap: unused (see :func:`default_cap`).
      force_full: True recomputes sums/counts from scratch from the new
        labels (the fit loop's drift-bounding refresh).
      with_mind: when False, ``min_d2`` and ``inertia`` come back NaN on
        every backend, as in the reference (the kernel skips the row
        norms).
      backend: "auto" | "cuda" | "plain"; device: where to run (None is
        the card).

    Returns:
      ``(labels, min_d2, sums, counts, inertia, n_changed)``; ``sums`` and
      ``counts`` satisfy the invariant for ``labels`` whichever branch ran.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    centroids = as_tensor(centroids, dev)
    labels_prev = as_tensor(labels_prev, dev, torch.int32)
    w = None if weights is None else as_tensor(weights, dev, torch.float32)
    k = centroids.shape[0]
    route, k_tile = sweep_route("delta", backend, x, k, weights=w,
                                weights_are_binary=weights_are_binary,
                                compute_dtype=compute_dtype)
    if route == "cuda":
        labels, min_d2, dsums, dcounts, inertia, n_changed, _ = \
            lloyd_delta_cuda(x, centroids, labels_prev, weights=w,
                             compute_dtype=compute_dtype, with_mind=with_mind,
                             k_tile=k_tile)
    else:
        labels, min_d2, dsums, dcounts, inertia, n_changed, _ = \
            lloyd_delta_plain(x, centroids, labels_prev, weights=w,
                              compute_dtype=compute_dtype,
                              with_mind=with_mind, chunk_size=chunk_size,
                              k_tile=k_tile)
    if force_full:
        # The delta plan's tile serves the labeled fold too, as in the
        # reference (K6 ignores it; the plain version folds per slice).
        accumulate = accumulate_cuda if route == "cuda" else accumulate_plain
        sums, counts, _ = accumulate(x, labels, k, weights=w,
                                     compute_dtype=compute_dtype,
                                     k_tile=k_tile)
    else:
        sums = as_tensor(sums_prev, dev, torch.float32) + dsums
        counts = as_tensor(counts_prev, dev, torch.float32) + dcounts
    if not with_mind:
        min_d2 = torch.full_like(min_d2, float("nan"))
        inertia = torch.full_like(inertia, float("nan"))
    return labels, min_d2, sums, counts, inertia, n_changed
