"""Hamerly-pruned exact Lloyd sweep: skip the distance product for rows
whose score bounds prove the argmin unchanged.

Counterpart of ``kmeans_tpu/ops/hamerly.py``, whose docstring derives the
bounds.  The kernels rank rows by the computed score

    s(r, c) = ||c||²_f32 + x_cd(r)·(−2·c_cd)   (f32 accumulation)

and a sweep carries per row ``sb`` ≥ s(r, a_r) (an upper bound on the
assigned centroid's score), ``slb`` ≤ min_{c≠a_r} s(r, c) (a lower bound on
the runner-up) and the static row norms R_r = ||x_cd(r)||.  When centroids
move c → c', with Δ_c the change of ||c||² and δ_c = ||c'_cd − c_cd|| (on
the cd-rounded values the product uses):

    sb'  = sb  + Δ_{a_r} + 2·R_r·δ_{a_r}
    slb' = slb + min_c Δ_c − 2·R_r·max_c δ_c

and a row is scored again when ``sb' + margin ≥ slb'`` (``margin =
HAMERLY_MARGIN_REL·(R_r·max_c||c|| + 1)``, above the f32 accumulation
error) or when its previous label is the −1 sentinel.  Rows that pass keep
their argmin, so the labels are those of the dense sweep.

The scoring of the needed rows is the Hamerly kernel on the card
(:func:`kmeans_tpu_torch.ops.cuda_lloyd.lloyd_hamerly_cuda`, which compacts
them per 1024-row group) and its plain version on the CPU (which gathers
them).  Both give the values of the reference's XLA route at any ``cap``,
so ``cap`` is taken for call compatibility only.  Where the planner tiles
the shape, the sweep is the k-tiled pair instead, which like the reference's
tiled route scores every row and forgoes the pruning.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.ops.cuda_lloyd import (_argmin_plain,
                                             lloyd_hamerly_cuda,
                                             lloyd_hamerly_plain)
from kmeans_tpu_torch.ops.distance import resolve_cd, sq_norms
from kmeans_tpu_torch.ops.lloyd import resolve_backend, sweep_route
from kmeans_tpu_torch.ops.plan import KernelPlan, device_plan

__all__ = ["hamerly_pass", "hamerly_bounds", "hamerly_kernel_plan",
           "resolve_hamerly_backend", "row_norms", "centroid_mini_kmeans",
           "HAMERLY_MARGIN_REL"]

#: Relative soundness margin over the f32 dot-accumulation error bound
#: (γ_d ≈ d·2⁻²⁴ ≈ 1.2e-4 at d=2048, entering twice per dot and twice per
#: comparison).  The reference's value, unchanged.
HAMERLY_MARGIN_REL = 1e-3

#: Multiplicative inflation of the norms entering the Cauchy-Schwarz drift
#: bound: covers the f32 rounding of the norm computations themselves.
_NORM_INFLATE = 1.0 + 1e-3


def _sqrt(t):
    """The f32 square root rounded as IEEE rounds it (and the reference
    computes it): torch's CPU f32 ``sqrt`` can be one ulp off, so take it in
    f64 and round once."""
    return torch.sqrt(t.double()).float()


def row_norms(x, *, compute_dtype=None, chunk_size: int = 65536):
    """(n,) float32 upper bounds on ``||x_r||`` as the kernels see the rows:
    norms of x cast to the compute dtype, then inflated by the f32 slack.
    Chunked, so no (n, d) f32 copy of x is made (10 GB at the headline
    shape)."""
    cd = resolve_cd(compute_dtype, x.dtype)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk_size):
        xf = x[s:s + chunk_size].to(cd).float()
        out[s:s + chunk_size] = _sqrt((xf * xf).sum(dim=1))
    return out * _NORM_INFLATE


def centroid_mini_kmeans(centroids, n_groups: int, *, seed: int = 0,
                         iters: int = 8):
    """Farthest-point-seeded NumPy k-means over the centroid set (the
    reference's, copied: its module imports JAX).  Groups land on the
    centroid set's natural clusters; groups emptied mid-iteration reseed
    from a single-take order so two never become duplicates.

    Returns ``(mu (G, d) f32 group centers, lab (k,) int32 assignment of
    each centroid to its nearest final group center)``."""
    c = np.asarray(centroids, np.float32)
    if c.ndim != 2:
        raise ValueError(f"centroids must be (k, d); got {c.shape}")
    k, _d = c.shape
    g_n = max(1, min(int(n_groups), k))
    rng = np.random.RandomState(seed)
    csq = np.einsum("kd,kd->k", c, c)
    first = int(rng.randint(k))
    picks = [first]
    mind = np.maximum(csq + csq[first] - 2.0 * (c @ c[first]), 0.0)
    for _ in range(g_n - 1):
        nxt = int(mind.argmax())
        picks.append(nxt)
        mind = np.minimum(
            mind, np.maximum(csq + csq[nxt] - 2.0 * (c @ c[nxt]), 0.0))
    mu = c[picks].copy()
    for _ in range(max(1, int(iters))):
        musq = np.einsum("gd,gd->g", mu, mu)
        d2 = csq[:, None] - 2.0 * (c @ mu.T) + musq[None, :]
        lab = d2.argmin(axis=1)
        # Reseed order for groups emptied this iteration: centroids by
        # decreasing distance to their assigned center, each taken once.
        far_order = np.argsort(-np.take_along_axis(
            d2, lab[:, None], axis=1)[:, 0])
        reseed_at = 0
        for g in range(g_n):
            members = c[lab == g]
            if members.shape[0]:
                mu[g] = members.mean(axis=0)
            else:
                mu[g] = c[int(far_order[min(reseed_at, k - 1)])]
                reseed_at += 1
    musq = np.einsum("gd,gd->g", mu, mu)
    lab = (csq[:, None] - 2.0 * (c @ mu.T) + musq[None, :]).argmin(axis=1)
    return mu.astype(np.float32), lab.astype(np.int32)


def hamerly_kernel_plan(x, k: int, *, weights=None, weights_are_binary=False,
                        compute_dtype=None, device=None) -> KernelPlan:
    """Dispatch decision for the Hamerly sweep: the vetoes, then the
    shape's price as the ``"hamerly"`` kind (:func:`kmeans_tpu_torch.ops.
    plan.device_plan`)."""
    return device_plan("hamerly", x, k, weights=weights,
                       weights_are_binary=weights_are_binary,
                       compute_dtype=compute_dtype, device=device)


def resolve_hamerly_backend(backend, x, k: int, *, weights=None,
                            weights_are_binary=False, compute_dtype=None,
                            device=None) -> Tuple[str, str]:
    """``(request to pass to hamerly_pass, route its sweeps run)``; the
    route is ``"cuda"`` or ``"plain"``."""
    return backend, resolve_backend(
        backend, x, k, weights=weights,
        weights_are_binary=weights_are_binary, compute_dtype=compute_dtype,
        device=device, kind="hamerly")


def _scores_chunked(x, centroids, *, chunk_size, compute_dtype):
    """Per-row ``(labels, best, second)`` scores of every row of x: the
    plain scorer of the reference's XLA route (and the plain version's)."""
    return _argmin_plain(x, centroids, resolve_cd(compute_dtype, x.dtype),
                         chunk_size, with_second=True)


def _centroid_drift(centroids, c_prev_cd, csq_prev, cd):
    """``(c_cd, csq, δ, Δ, max_c ||c||)`` of one sweep: this sweep's
    centroids in cd and their f32 squared norms (carried to the next
    sweep), the inflated drift norms δ_c measured on the cd-rounded values,
    the change Δ_c of ||c||², and the largest centroid norm."""
    c_cd = centroids.to(cd)
    csq = sq_norms(centroids)
    delta_c = _sqrt(((c_cd.float() - c_prev_cd.float()) ** 2).sum(
        dim=1).clamp_min(0.0)) * _NORM_INFLATE
    big_d = csq - csq_prev
    cmax = _sqrt(csq.max().clamp_min(0.0))
    return c_cd, csq, delta_c, big_d, cmax


def _inputs(x, centroids, labels_prev, c_prev_cd, vectors, weights, device):
    """The pass inputs as tensors on the pass's device."""
    dev = resolve_device(device)
    f32 = torch.float32
    return (dev, as_tensor(x, dev).contiguous(),
            as_tensor(centroids, dev, f32),
            as_tensor(labels_prev, dev, torch.int32),
            as_tensor(c_prev_cd, dev),
            [as_tensor(v, dev, f32) for v in vectors],
            None if weights is None else as_tensor(weights, dev, f32))


def hamerly_bounds(centroids, labels_prev, sb, slb, c_prev_cd, csq_prev,
                   rno, cd):
    """The drifted bounds and the recompute mask of one sweep:
    ``(sb', slb', need, c_cd, csq)`` (see the module docstring)."""
    k = centroids.shape[0]
    c_cd, csq, delta_c, big_d, cmax = _centroid_drift(centroids, c_prev_cd,
                                                      csq_prev, cd)
    lab_safe = labels_prev.clamp(0, k - 1).long()
    sb2 = sb + big_d[lab_safe] + 2.0 * rno * delta_c[lab_safe]
    slb2 = slb + big_d.min() - 2.0 * rno * delta_c.max()
    margin = HAMERLY_MARGIN_REL * (rno * cmax + 1.0)
    need = (sb2 + margin >= slb2) | (labels_prev < 0)
    return sb2, slb2, need, c_cd, csq


def hamerly_pass(
    x,
    centroids,
    labels_prev,
    sums_prev,
    counts_prev,
    sb,
    slb,
    c_prev_cd,
    csq_prev,
    rno,
    *,
    weights=None,
    cap: Optional[int] = None,
    chunk_size: int = 4096,
    compute_dtype=None,
    backend: str = "auto",
    weights_are_binary: bool = False,
    device=None,
) -> Tuple[torch.Tensor, ...]:
    """One Hamerly-pruned Lloyd sweep.

    Args mirror :func:`kmeans_tpu_torch.ops.delta.delta_pass` plus the
    pruning state: ``sb``/``slb`` the carried score bounds, ``c_prev_cd``
    the previous sweep's centroids in the compute dtype, ``csq_prev`` their
    f32 squared norms, ``rno`` the static row norms (:func:`row_norms`).  A
    refresh sweep passes ``labels_prev = −1`` with zero ``sums_prev``: the
    sentinels force every row to be scored, and the signed fold over them is
    the full reduction.  ``cap`` is unused (see the module docstring).

    Returns ``(labels, sums, counts, sb', slb', c_cd, csq, n_recomputed)``;
    ``c_cd``/``csq`` are this sweep's centroid representations, to carry as
    the next sweep's ``c_prev_cd``/``csq_prev``.
    """
    dev, x, centroids, labels_prev, c_prev_cd, vecs, w = _inputs(
        x, centroids, labels_prev, c_prev_cd,
        (sums_prev, counts_prev, sb, slb, csq_prev, rno), weights, device)
    sums_prev, counts_prev, sb, slb, csq_prev, rno = vecs
    route, k_tile = sweep_route("hamerly", backend, x, centroids.shape[0],
                                weights=w,
                                weights_are_binary=weights_are_binary,
                                compute_dtype=compute_dtype)
    sb2, slb2, need, c_cd, csq = hamerly_bounds(
        centroids, labels_prev, sb, slb, c_prev_cd, csq_prev, rno,
        resolve_cd(compute_dtype, x.dtype))
    sweep = (lloyd_hamerly_cuda if route == "cuda" else
             functools.partial(lloyd_hamerly_plain, chunk_size=chunk_size))
    labels, sb3, slb3, dsums, dcounts, n_rec, _ = sweep(
        x, centroids, labels_prev, need, sb2, slb2, weights=w,
        compute_dtype=compute_dtype, k_tile=k_tile)
    return (labels, sums_prev + dsums, counts_prev + dcounts, sb3, slb3,
            c_cd, csq, n_rec)
