"""The fused Lloyd pass: assign + reduce in one sweep over the data.

Counterpart of ``kmeans_tpu/ops/lloyd.py``.  One call returns ``labels``,
``min_d2``, per-cluster ``sums`` and ``counts`` and the ``inertia``.  On the
card the sweep is the hand-written classic kernel
(:func:`kmeans_tpu_torch.ops.cuda_lloyd.lloyd_pass_cuda`), or the k-tiled
pair where the planner (:mod:`kmeans_tpu_torch.ops.plan`) tiles the shape;
on the CPU it is their plain PyTorch version, which also serves the
reference XLA route's ``update="segment"`` flavour.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kmeans_tpu_torch.device import as_dtype, as_tensor, resolve_device
from kmeans_tpu_torch.ops.cuda_lloyd import lloyd_pass_cuda, lloyd_pass_plain
from kmeans_tpu_torch.ops.distance import resolve_cd
from kmeans_tpu_torch.ops.plan import WEIGHTS_VETO, device_plan, shape_plan

__all__ = ["lloyd_pass", "resolve_backend", "sweep_route", "resolve_update",
           "weights_exact", "BACKENDS"]

#: The port's sweep backends.  The reference's ``"xla"``, ``"pallas"`` and
#: ``"pallas_interpret"`` have no counterpart here.
BACKENDS = ("auto", "cuda", "plain")


def weights_exact(compute_dtype, *, weights=None,
                  weights_are_binary=False) -> bool:
    """Whether sample weights survive the fold exactly in ``compute_dtype``
    (binary weights, or f32 compute) — the reference's one copy of the
    policy, by which fits resolve their update flavour and the kernel plan
    vetoes fractional weights in bf16."""
    if weights is None or weights_are_binary:
        return True
    return as_dtype(compute_dtype) == torch.float32


def resolve_backend(backend: str, x, k: int, *, weights=None,
                    weights_are_binary: bool = False, compute_dtype=None,
                    device=None, kind: str = "classic",
                    groups=None) -> str:
    """Resolve a backend request to the route a sweep runs: ``"cuda"`` or
    ``"plain"``.

    ``"auto"`` is the kernels for data on the card and the plain versions
    for data on the CPU.  Where the kernel plan of ``kind``
    (:func:`kmeans_tpu_torch.ops.plan.device_plan`) vetoes the weights
    (fractional weights in bf16 compute: the reference's exactness policy,
    by which its ``"auto"`` takes the XLA route), ``"auto"`` is the plain
    versions on the card; every other refusal (a dtype, a shape, a block or
    slice the card cannot hold) raises, as ``"cuda"`` does wherever the plan
    refuses (the CPU included).  ``device`` overrides ``x.device`` (``x``
    needs only ``shape`` and ``dtype``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{BACKENDS} (the reference's xla/pallas routes "
                         "have no counterpart)")
    if backend == "plain":
        return "plain"
    dev = torch.device(device) if device is not None else x.device
    if backend == "auto" and dev.type == "cpu":
        return "plain"
    plan = device_plan(kind, x, k, weights=weights,
                       weights_are_binary=weights_are_binary,
                       compute_dtype=compute_dtype, device=dev, groups=groups)
    if plan.mode == "refuse":
        if backend == "auto" and plan.why == WEIGHTS_VETO:
            return "plain"
        raise ValueError(f"the CUDA kernels do not take this input: "
                         f"{plan.why}; use backend='plain' to run the plain "
                         "PyTorch versions")
    return "cuda"


def sweep_route(kind: str, backend: str, x, k: int, *, weights=None,
                weights_are_binary: bool = False, compute_dtype=None,
                groups=None) -> Tuple[str, Optional[int]]:
    """``(route, k_tile)`` of one sweep of ``kind``: the route of
    :func:`resolve_backend` and the planner's slice width
    (:func:`kmeans_tpu_torch.ops.plan.shape_plan`; None: untiled), which
    either route runs at."""
    route = resolve_backend(backend, x, k, weights=weights,
                            weights_are_binary=weights_are_binary,
                            compute_dtype=compute_dtype, kind=kind,
                            groups=groups)
    return route, shape_plan(kind, x, k, compute_dtype=compute_dtype,
                             groups=groups).k_tile


def resolve_update(update: str, *, w_exact: bool,
                   sharded_axes: bool = False) -> str:
    """Resolve a config ``update`` flavour — the reference's one copy of
    the policy.  ``"auto"`` picks the incremental ``"delta"`` sweep where
    weights are exact (and nothing is sharded over k or d), else the dense
    reduction; explicit ``"delta"``/``"hamerly"``/``"yinyang"`` raise where
    unsupported; ``"matmul"`` with inexact weights demotes to the
    equal-value ``"segment"`` reduction."""
    if update == "auto":
        if w_exact and not sharded_axes:
            return "delta"
        return "matmul" if w_exact else "segment"
    if update in ("delta", "hamerly", "yinyang"):
        if sharded_axes:
            raise ValueError(
                f"update={update!r} carries per-shard row state; it does "
                "not compose with model_axis/feature_axis sharding — use "
                "update='auto' to fall back to the dense reduction"
            )
        if not w_exact:
            raise ValueError(
                f"update={update!r} folds changed rows with signed ±w "
                "weights, exact only for binary weights or float32 "
                "compute (ops.lloyd.weights_exact); use update='auto' to "
                "fall back or compute_dtype='float32' to keep it"
            )
        return update
    if update == "matmul" and not w_exact:
        return "segment"
    return update


def lloyd_pass(
    x,
    centroids,
    *,
    weights=None,
    chunk_size: int = 4096,
    compute_dtype=None,
    update: str = "matmul",
    with_update: bool = True,
    weights_are_binary: bool = False,
    backend: str = "auto",
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """One fused assign(+reduce) sweep.

    Args:
      x: (n, d) points (tensor or array; float64 computes in f32).
      centroids: (k, d) current centroids.
      weights: optional (n,) float weights.
      chunk_size: rows per tile of the plain route.
      compute_dtype: product input dtype (None = x.dtype); accumulation f32.
      update: "matmul" | "segment" fold flavour of the plain route (the
        loop-level flavours "auto"/"delta"/"hamerly"/"yinyang" mean the
        dense fold for a single sweep, as in the reference).
      with_update: when False, sums/counts come back zero.
      backend: "auto" | "cuda" | "plain" (see :func:`resolve_backend`).
        Either route takes the planner's ``k_tile`` for this shape.
      device: where to run; None is the card.

    Returns:
      (labels int32 [n], min_d2 f32 [n], sums f32 [k, d], counts f32 [k],
       inertia f32 scalar).
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    centroids = as_tensor(centroids, dev)
    w = None if weights is None else as_tensor(weights, dev, torch.float32)
    if update in ("auto", "delta", "hamerly", "yinyang", "adaptive"):
        update = "matmul"
    if update not in ("matmul", "segment"):
        raise ValueError(f"unknown update {update!r}")
    if update == "matmul" and not weights_exact(
            resolve_cd(compute_dtype, x.dtype), weights=w,
            weights_are_binary=weights_are_binary):
        # Fractional weights would not survive the cd fold: the reference's
        # XLA route demotes to the f32 segment reduction, and so does this.
        update = "segment"
    route, k_tile = sweep_route("classic", backend, x, centroids.shape[0],
                                weights=w,
                                weights_are_binary=weights_are_binary,
                                compute_dtype=compute_dtype)
    if route == "cuda":
        return lloyd_pass_cuda(x, centroids, weights=w,
                               compute_dtype=compute_dtype,
                               with_update=with_update, k_tile=k_tile)
    return lloyd_pass_plain(x, centroids, weights=w,
                            compute_dtype=compute_dtype,
                            with_update=with_update, update=update,
                            chunk_size=chunk_size, k_tile=k_tile)
