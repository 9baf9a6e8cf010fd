"""Yinyang group-drift pruned exact Lloyd sweep: per-group lower bounds
where hamerly carries one global one.

Counterpart of ``kmeans_tpu/ops/yinyang.py`` (Ding et al., "Yinyang
K-Means").  ``group_of (k,)`` maps each centroid to one of t groups, formed
once per fit on the host from the initial centroids
(:func:`centroid_groups`).  Carried per row: ``sb`` (hamerly's) and
``glb (n, t)``, ``glb[r, g]`` ≤ the least score of a competitor of row r in
group g.  Drift tightens per group, with hamerly's margin:

    glb'[r, g] = glb[r, g] + min_{c∈g} Δ_c − 2·R_r·max_{c∈g} δ_c

A group fails for a row when ``sb' + margin ≥ glb'[r, g]`` (and always for
the row's own group); a row is scored when any group fails.  Only failing
groups' bounds are refreshed from the scores, so they compound across
sweeps.  With t = 1 this is hamerly.

Two routes, as in the reference:

* on the card, the Hamerly kernel with the yinyang ``need`` mask and
  ``slb_in = min_g glb'`` gives labels, ``sb`` and the fold (the masked
  argmin provably equals the full one), then :func:`_glb_refresh` scores
  the needed rows again with a library product to refresh ``glb`` -- the
  double scoring the reference's Pallas route does too;
* on the CPU, the needed rows are gathered and scored once with the
  passing groups' columns masked to +inf (:func:`_scores_grouped_chunked`),
  the reference's XLA route.

Both give the reference's values at any ``cap``, which is taken for call
compatibility only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.ops.cuda_lloyd import (KernelPlan, _chunks,
                                             _score_operands,
                                             _signed_fold_plain, _weights,
                                             lloyd_hamerly_cuda)
from kmeans_tpu_torch.ops.distance import full_f32, resolve_cd
from kmeans_tpu_torch.ops.hamerly import (HAMERLY_MARGIN_REL,
                                          _centroid_drift, _inputs,
                                          centroid_mini_kmeans,
                                          hamerly_kernel_plan)
from kmeans_tpu_torch.ops.lloyd import resolve_backend

__all__ = ["yinyang_pass", "yinyang_kernel_plan", "resolve_yinyang_backend",
           "centroid_groups", "default_groups", "AUTO_SWITCH_HIGH",
           "AUTO_REPROBE_PERIODS", "AUTO_MIN_ROWS"]

#: ``update="auto"`` runtime policy: switch yinyang → delta when the
#: trailing refresh period's measured recompute fraction exceeds this.
#: Read by the fit at call time (tests monkeypatch it).
AUTO_SWITCH_HIGH = 0.5

#: How many refresh periods a demoted (delta) phase runs before the policy
#: probes yinyang again.
AUTO_REPROBE_PERIODS = 8

#: Rows below which ``update="auto"`` never engages the adaptive loop.
AUTO_MIN_ROWS = 16384


def default_groups(k: int) -> int:
    """The default group count, t ≈ k/10 (Ding et al.'s recommendation)."""
    return max(1, -(-int(k) // 10))


def centroid_groups(centroids, n_groups: Optional[int] = None, *,
                    seed: int = 0, iters: int = 8):
    """``(group_of (k,) int32 numpy, t)``: the once-per-fit centroid →
    group map, made on the host in numpy (deterministic given the
    centroids and seed), as in the reference.  ``n_groups=None`` is
    :func:`default_groups`; t ≥ k is the identity map, t = 1 all zeros."""
    c = np.asarray(centroids, np.float32)
    if c.ndim != 2:
        raise ValueError(f"centroids must be (k, d); got {c.shape}")
    k = c.shape[0]
    t = default_groups(k) if n_groups is None else int(n_groups)
    t = max(1, min(t, k))
    if t == k:
        return np.arange(k, dtype=np.int32), k
    if t == 1:
        return np.zeros((k,), np.int32), 1
    _, lab = centroid_mini_kmeans(c, t, seed=seed, iters=iters)
    return lab, t


def yinyang_kernel_plan(x, k: int, *, groups: Optional[int] = None,
                        weights=None, weights_are_binary=False,
                        compute_dtype=None, device=None) -> KernelPlan:
    """Dispatch decision for the yinyang route: the Hamerly kernel's
    (``groups`` prices nothing on this card: the bounds live outside the
    kernel)."""
    return hamerly_kernel_plan(x, k, weights=weights,
                               weights_are_binary=weights_are_binary,
                               compute_dtype=compute_dtype, device=device)


def resolve_yinyang_backend(backend, x, k: int, *,
                            groups: Optional[int] = None, weights=None,
                            weights_are_binary=False, compute_dtype=None,
                            device=None) -> Tuple[str, str]:
    """``(request to pass to yinyang_pass, route its sweeps run)``; the
    route is ``"cuda"`` or ``"plain"``."""
    return backend, resolve_backend(
        backend, x, k, weights=weights,
        weights_are_binary=weights_are_binary, compute_dtype=compute_dtype,
        device=device)


def _group_drift(big_d, delta_c, group_of, t: int):
    """Per-group ``(min_g Δ, max_g δ)``.  An empty group gets (+inf, 0), as
    ``segment_min``/``segment_max`` (clamped at 0) give it in the
    reference: its bound drifts to +inf and never fails, which is sound
    (no centroid lives there to be missed)."""
    idx = group_of.long()
    gmin = big_d.new_full((t,), torch.inf).scatter_reduce(
        0, idx, big_d, "amin", include_self=False)
    gmax = delta_c.new_full((t,), -torch.inf).scatter_reduce(
        0, idx, delta_c, "amax", include_self=False).clamp_min(0.0)
    return gmin, gmax


def _group_min(part, group_of, t: int):
    """(m, t) per-group column mins of an (m, k) score block; +inf for a
    group with no column."""
    idx = group_of.long()[None, :].expand_as(part)
    return part.new_full((part.shape[0], t), torch.inf).scatter_reduce(
        1, idx, part, "amin", include_self=False)


def _score_rows(xr, neg2c, csq, cd):
    """``csq + cd(xr)·(−2·C_cd)ᵀ`` in f32: on the card a bf16 product with
    f32 output (exact products, f32 accumulation: the reference's
    ``preferred_element_type=f32`` product), else an f32 product of the
    cd-rounded operands with TF32 off."""
    if xr.is_cuda and cd == torch.bfloat16:
        return csq + torch.mm(xr.to(cd), neg2c.T, out_dtype=torch.float32)
    with full_f32():
        return csq + xr.to(cd).float() @ neg2c.float().T


def _scores_grouped_chunked(x, rows, fail, centroids, group_of, *,
                            chunk_size, compute_dtype):
    """``(labels, m1, glb_new (m, t))`` of the rows ``x[rows]`` with the
    passing groups' columns (``fail`` False, one row of ``fail`` per row)
    masked to +inf before the argmin: the XLA route's scorer.  ``glb_new``
    is each group's least score over the unmasked columns, the label's
    excluded; callers keep it only where ``fail`` holds."""
    cd = resolve_cd(compute_dtype, x.dtype)
    neg2c, csq = _score_operands(centroids, cd)
    gidx = group_of.long()
    m, t = rows.numel(), fail.shape[1]
    labels = torch.empty(m, dtype=torch.int32, device=x.device)
    m1 = torch.empty(m, dtype=torch.float32, device=x.device)
    glb = torch.empty(m, t, dtype=torch.float32, device=x.device)
    for s in _chunks(m, chunk_size):
        part = _score_rows(x[rows[s]], neg2c, csq, cd)
        lab = torch.where(fail[s][:, gidx], part, torch.inf).argmin(dim=1)
        labels[s] = lab.int()
        m1[s] = part.gather(1, lab[:, None])[:, 0]
        glb[s] = _group_min(part.scatter_(1, lab[:, None], torch.inf),
                            group_of, t)
    return labels, m1, glb


def _group_mins_chunked(x, rows, labels, centroids, group_of, t: int, *,
                        chunk_size, compute_dtype):
    """(m, t) per-group competitor mins of the rows ``x[rows]`` at known
    ``labels`` (the label's column excluded): the card route's glb
    refresh, over the same scores :func:`_scores_grouped_chunked` takes."""
    cd = resolve_cd(compute_dtype, x.dtype)
    neg2c, csq = _score_operands(centroids, cd)
    out = torch.empty(rows.numel(), t, dtype=torch.float32, device=x.device)
    for s in _chunks(rows.numel(), chunk_size):
        part = _score_rows(x[rows[s]], neg2c, csq, cd)
        part.scatter_(1, labels[s].long()[:, None], torch.inf)
        out[s] = _group_min(part, group_of, t)
    return out


def _glb_refresh(x, centroids, labels_new, need, fail, glb2, group_of, *,
                 chunk_size, compute_dtype):
    """The failing groups' bounds of the scored rows, refreshed in place in
    ``glb2`` (which the caller owns): the card route scores the needed rows
    a second time for it, as the reference's Pallas route does."""
    rows = need.nonzero()[:, 0]
    glb_new = _group_mins_chunked(x, rows, labels_new[rows], centroids,
                                  group_of, glb2.shape[1],
                                  chunk_size=chunk_size,
                                  compute_dtype=compute_dtype)
    glb2[rows] = torch.where(fail[rows], glb_new, glb2[rows])
    return glb2


def yinyang_pass(
    x,
    centroids,
    labels_prev,
    sums_prev,
    counts_prev,
    sb,
    glb,
    c_prev_cd,
    csq_prev,
    rno,
    group_of,
    *,
    weights=None,
    cap: Optional[int] = None,
    chunk_size: int = 4096,
    compute_dtype=None,
    backend: str = "auto",
    weights_are_binary: bool = False,
    device=None,
) -> Tuple[torch.Tensor, ...]:
    """One yinyang-pruned Lloyd sweep.

    Args mirror :func:`kmeans_tpu_torch.ops.hamerly.hamerly_pass` with the
    global ``slb`` replaced by the per-group bounds ``glb (n, t)`` and the
    centroid → group map ``group_of (k,)`` (:func:`centroid_groups`; t is
    ``glb.shape[1]``).  The sentinel refresh contract is hamerly's.

    Returns ``(labels, sums, counts, sb', glb', c_cd, csq, n_recomputed,
    n_group_pruned)``, the last the count of (scored row, passing group)
    pairs whose distances the group filter proved unnecessary.  ``glb'`` is
    a new tensor (the caller's ``glb`` is not written); the pass builds it
    in place from ``glb + min Δ`` and so holds at most the input, ``glb'``
    and one (n, t) temporary at a time.
    """
    dev, x, centroids, labels_prev, c_prev_cd, vecs, w = _inputs(
        x, centroids, labels_prev, c_prev_cd,
        (sums_prev, counts_prev, sb, glb, csq_prev, rno), weights, device)
    sums_prev, counts_prev, sb, glb, csq_prev, rno = vecs
    group_of = torch.as_tensor(group_of, device=dev)
    n = x.shape[0]
    k = centroids.shape[0]
    t = glb.shape[1]
    cd = resolve_cd(compute_dtype, x.dtype)
    route = resolve_backend(backend, x, k, weights=w,
                            weights_are_binary=weights_are_binary,
                            compute_dtype=compute_dtype)
    c_cd, csq, delta_c, big_d, cmax = _centroid_drift(centroids, c_prev_cd,
                                                      csq_prev, cd)
    gmin_d, gmax_dc = _group_drift(big_d, delta_c, group_of, t)
    sentinel = labels_prev < 0
    lab_safe = labels_prev.clamp(0, k - 1).long()
    sb2 = sb + big_d[lab_safe] + 2.0 * rno * delta_c[lab_safe]
    glb2 = glb + gmin_d[None, :]
    glb2 -= 2.0 * rno[:, None] * gmax_dc[None, :]
    margin = HAMERLY_MARGIN_REL * (rno * cmax + 1.0)
    # Two-level filter.  GROUP: a row whose sb' clears every group's bound
    # keeps its argmin.  LOCAL: among scored rows a passing group needs no
    # distances; the row's own group always fails (with t = 1 this makes
    # fail == need: hamerly).
    fail = (sb2 + margin)[:, None] >= glb2
    fail |= sentinel[:, None]
    need = fail.any(dim=1)
    fail[torch.arange(n, device=dev), group_of.long()[lab_safe]] = True
    n_group_pruned = ((t - fail.sum(dim=1)) * need).sum().int()

    if route == "cuda":
        labels, sb3, _, dsums, dcounts, n_rec, _ = lloyd_hamerly_cuda(
            x, centroids, labels_prev, need, sb2, glb2.amin(dim=1),
            weights=w, compute_dtype=compute_dtype)
        glb3 = _glb_refresh(x, centroids, labels, need, fail, glb2, group_of,
                            chunk_size=max(chunk_size, 32768),
                            compute_dtype=compute_dtype)
    else:
        rows = need.nonzero()[:, 0]
        fail_r = fail[rows]
        lab_r, m1_r, glb_r = _scores_grouped_chunked(
            x, rows, fail_r, centroids, group_of, chunk_size=chunk_size,
            compute_dtype=compute_dtype)
        labels = labels_prev.clone()
        labels[rows] = lab_r
        sb3 = sb2
        sb3[rows] = m1_r
        glb3 = glb2
        glb3[rows] = torch.where(fail_r, glb_r, glb2[rows])
        w_all = _weights(w, n, dev)
        changed = need & (labels != labels_prev) & (w_all > 0)
        dsums, dcounts = _signed_fold_plain(x, k, labels, labels_prev,
                                            changed, w_all, cd, chunk_size)
        n_rec = need.sum().int()
    return (labels, sums_prev + dsums, counts_prev + dcounts, sb3, glb3,
            c_cd, csq, n_rec, n_group_pruned)
