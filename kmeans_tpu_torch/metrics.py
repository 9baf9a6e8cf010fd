"""Numeric cluster-quality metrics (silhouette, DB, CH, ARI, NMI, Dunn).

Counterpart of ``kmeans_tpu/metrics.py``:

* internal (geometry) metrics — silhouette, Davies–Bouldin,
  Calinski–Harabasz, Dunn — run over row chunks, so no n×n (or n×k beyond a
  chunk) matrix is ever made.  Silhouette's pairwise products are
  ``torch.matmul`` in the compute dtype (bf16 operands multiply exactly and
  accumulate in f32; f32 is IEEE f32, never TF32: the reference's
  ``matmul_precision``), as the reference computes them outside any Pallas
  kernel.  DB / CH need only own-centroid distances (a gather and an f32
  reduction);
* external (label-agreement) metrics — adjusted Rand index, normalized
  mutual information, homogeneity / completeness / V, Fowlkes–Mallows —
  count a contingency table in O(n).

Silhouette's per-cluster distance sums multiply each (m, chunk) distance
tile by the chunk's (chunk, k) one-hot matrix in IEEE f32, as the
reference does (2·m·n·k flops): the same bits on every run, on either
device.  Every other sum by label (the counts, Davies–Bouldin's distance
sums) is :func:`kmeans_tpu_torch.ops.segment.segment_sum`, which sums in a
fixed order on the card too.

All distances here are Euclidean (not squared), as in the conventional
definitions of silhouette and Davies–Bouldin.  Every function runs on
``device`` (None is the card); float results are 0-d f32 tensors there
(``dunn_index`` returns a float, as the reference's does).
"""

from __future__ import annotations

from typing import Optional

import torch

from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.ops.distance import (cd_product, full_f32,
                                           pairwise_sq_dists, resolve_cd,
                                           sq_norms)
from kmeans_tpu_torch.ops.segment import segment_sum

__all__ = [
    "silhouette_score",
    "dispersion_scores",
    "davies_bouldin_score",
    "calinski_harabasz_score",
    "adjusted_rand_index",
    "normalized_mutual_info",
    "homogeneity_completeness_v",
    "fowlkes_mallows_index",
    "dunn_index",
]

_F32 = torch.float32


def _silhouette_samples(x_eval, labels_eval, x_all, labels_all, valid_all,
                        *, k, chunk_size, compute_dtype):
    """Per-row silhouette of ``x_eval`` against the full population
    ``x_all``.

    For each evaluated point: mean Euclidean distance to every cluster
    (excluding itself from its own cluster's mean), a = own-cluster mean,
    b = min over other clusters; s = (b − a) / max(a, b).  Chunked over
    ``x_all`` so only (m × chunk) distance tiles live.  Rows with a
    negative label (or ``valid_all`` false) count in no cluster."""
    cd = resolve_cd(compute_dtype, x_all.dtype)
    m = x_eval.shape[0]
    dev = x_all.device
    la = labels_all.long()
    va = valid_all.to(_F32) * (la >= 0)
    la = la.clamp_min(0)
    counts = segment_sum(va, la, k)
    xe_sq = sq_norms(x_eval)
    dist_sums = torch.zeros(m, k, dtype=_F32, device=dev)
    for lo in range(0, x_all.shape[0], chunk_size):
        xb = x_all[lo:lo + chunk_size]
        prod = cd_product(x_eval, xb, cd)                    # (m, chunk)
        d2 = (xe_sq[:, None] - 2.0 * prod
              + sq_norms(xb)[None, :]).clamp_min_(0.0)
        dist = d2.sqrt_().mul_(va[lo:lo + chunk_size][None, :])
        hot = torch.nn.functional.one_hot(la[lo:lo + chunk_size], k)
        with full_f32():
            dist_sums += dist @ hot.to(_F32)                 # (m, k)

    own = labels_eval.long()
    rows = torch.arange(m, device=dev)
    # Own-cluster mean excludes self (distance 0 contributes to the sum);
    # a is defined 0 for singleton clusters.
    denom_own = (counts[own] - 1.0).clamp_min(1.0)
    a = dist_sums[rows, own] / denom_own
    # Other clusters: mean over their full membership; empty clusters inf.
    mean_other = torch.where(counts[None, :] > 0,
                             dist_sums / counts.clamp_min(1.0)[None, :],
                             torch.inf)
    own_onehot = own[:, None] == torch.arange(k, device=dev)[None, :]
    b = torch.where(own_onehot, torch.inf, mean_other).amin(dim=1)
    s = (b - a) / torch.maximum(a, b).clamp_min(1e-30)
    # Singleton own cluster => s = 0 by convention.
    return torch.where(counts[own] <= 1.0, 0.0, s)


def sample_rows(generator: torch.Generator, n: int, size: int,
                device) -> torch.Tensor:
    """``size`` distinct row indices of ``n``, uniformly: the draw
    :func:`silhouette_score` evaluates (the reference's
    ``jax.random.choice(..., replace=False)``)."""
    return torch.randperm(n, generator=generator, device=device)[:size]


def silhouette_score(
    x,
    labels,
    *,
    k: Optional[int] = None,
    sample_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    chunk_size: int = 2048,
    compute_dtype=None,
    device=None,
) -> torch.Tensor:
    """Mean silhouette coefficient (Euclidean).

    Exact silhouette is O(n²·d); pass ``sample_size`` to evaluate a uniform
    row sample *against the full population* in O(s·n·d).  The sample is
    drawn from ``generator`` (default: one seeded with 0)."""
    from kmeans_tpu_torch.data.synthetic import generator_for

    dev = resolve_device(device)
    x = as_tensor(x, dev)
    labels = as_tensor(labels, dev, torch.int32)
    if k is None:
        k = int(labels.max()) + 1
    n = x.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if sample_size is not None and sample_size < n:
        gen = generator_for(0 if generator is None else generator, dev)
        idx = sample_rows(gen, n, sample_size, dev)
        x_eval, labels_eval = x[idx], labels[idx]
    else:
        x_eval, labels_eval = x, labels
    s = _silhouette_samples(x_eval, labels_eval, x, labels, valid, k=k,
                            chunk_size=chunk_size,
                            compute_dtype=compute_dtype)
    return s.mean()


def _db_ch(x, labels, centroids, *, k, chunk_size):
    """Shared pass for Davies–Bouldin and Calinski–Harabasz: distances to
    each point's own centroid only, chunked over rows, accumulated in f32
    whatever the input dtype."""
    n, d = x.shape
    dev = x.device
    cf = centroids.to(_F32)
    dist_sum = torch.zeros(k, dtype=_F32, device=dev)
    counts = torch.zeros(k, dtype=_F32, device=dev)
    x_sum = torch.zeros(d, dtype=_F32, device=dev)
    wss = torch.zeros((), dtype=_F32, device=dev)
    for lo in range(0, n, chunk_size):
        xb = x[lo:lo + chunk_size].to(_F32)
        lb = labels[lo:lo + chunk_size].long()
        diff = xb - cf[lb]
        d2 = (diff * diff).sum(dim=1)
        segment_sum(d2.sqrt(), lb, k, out=dist_sum)
        wss = wss + d2.sum()
        segment_sum(torch.ones_like(d2), lb, k, out=counts)
        x_sum = x_sum + xb.sum(dim=0)
    nz = counts > 0

    # Davies–Bouldin: S_i = mean ||x - c_i|| within cluster i.
    s = torch.where(nz, dist_sum / counts.clamp_min(1.0), 0.0)
    csq = sq_norms(cf)
    with full_f32():
        gram = cf @ cf.T
    cdist = (csq[:, None] - 2.0 * gram + csq[None, :]).clamp_min(0.0).sqrt()
    ratio = (s[:, None] + s[None, :]) / torch.where(cdist > 0, cdist,
                                                     torch.inf)
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    both = nz[:, None] & nz[None, :] & ~eye
    worst = torch.where(both, ratio, -torch.inf).amax(dim=1).clamp_min(0.0)
    db = (worst * nz).sum() / nz.sum().clamp_min(1)

    # Calinski–Harabasz: between/within dispersion, dof-corrected.
    mean_all = x_sum / n
    bss = (counts * ((cf - mean_all[None, :]) ** 2).sum(dim=1)).sum()
    k_eff = nz.sum().clamp_min(2)
    ch = (bss / (k_eff - 1).clamp_min(1)) / (
        wss / (n - k_eff).clamp_min(1)).clamp_min(1e-30)
    return db, ch


def dispersion_scores(x, labels, centroids, *, chunk_size: int = 65536,
                      device=None):
    """(Davies–Bouldin, Calinski–Harabasz) from ONE pass over the data."""
    dev = resolve_device(device)
    centroids = as_tensor(centroids, dev, _F32)
    return _db_ch(as_tensor(x, dev), as_tensor(labels, dev, torch.int32),
                  centroids, k=int(centroids.shape[0]),
                  chunk_size=chunk_size)


def davies_bouldin_score(x, labels, centroids, *, chunk_size: int = 65536,
                         device=None):
    """Davies–Bouldin index (lower is better).  Empty clusters are
    skipped."""
    return dispersion_scores(x, labels, centroids, chunk_size=chunk_size,
                             device=device)[0]


def calinski_harabasz_score(x, labels, centroids, *,
                            chunk_size: int = 65536, device=None):
    """Calinski–Harabasz variance-ratio criterion (higher is better)."""
    return dispersion_scores(x, labels, centroids, chunk_size=chunk_size,
                             device=device)[1]


def _masked_pair(labels_a, labels_b, device):
    """Two int64 label vectors with rows excluded where EITHER side is
    negative (the trimmed family's outlier convention) set to -1 on both
    sides, plus the surviving row count."""
    dev = resolve_device(device)
    la = as_tensor(labels_a, dev, torch.int64)
    lb = as_tensor(labels_b, dev, torch.int64)
    valid = (la >= 0) & (lb >= 0)
    return (torch.where(valid, la, -1), torch.where(valid, lb, -1),
            valid.sum())


def _contingency(labels_a, labels_b, *, ka, kb):
    """(ka, kb) f32 table of the pairs; rows with a negative id drop."""
    flat = labels_a * kb + labels_b
    keep = (labels_a >= 0) & (labels_b >= 0)
    counts = torch.bincount(flat[keep], minlength=ka * kb)
    return counts.reshape(ka, kb).to(_F32)


def _masked_contingency(labels_a, labels_b, device):
    """``(contingency, n_valid)`` over the rows surviving
    :func:`_masked_pair`."""
    la, lb, n = _masked_pair(labels_a, labels_b, device)
    ka = max(int(la.max()) + 1, 1)
    kb = max(int(lb.max()) + 1, 1)
    return _contingency(la, lb, ka=ka, kb=kb), n


def adjusted_rand_index(labels_a, labels_b, *, device=None) -> torch.Tensor:
    """Adjusted Rand index between two labelings (1 = identical
    partitions).  Rows with a negative label on either side are
    excluded."""
    c, n = _masked_contingency(labels_a, labels_b, device)
    n = n.to(_F32)

    def comb2(v):
        return v * (v - 1.0) / 2.0

    sum_ij = comb2(c).sum()
    sum_a = comb2(c.sum(dim=1)).sum()
    sum_b = comb2(c.sum(dim=0)).sum()
    total = comb2(n)
    expected = sum_a * sum_b / total.clamp_min(1.0)
    max_index = 0.5 * (sum_a + sum_b)
    denom = max_index - expected
    # Both partitions trivial (single cluster / all singletons) -> ARI = 1.
    return torch.where(denom.abs() < 1e-12, 1.0,
                       (sum_ij - expected) / denom)


def _mi_terms(labels_a, labels_b, device):
    """``(mi, H(a), H(b))`` from the contingency table: the one copy of the
    mutual-information math."""
    c, _ = _masked_contingency(labels_a, labels_b, device)
    p = c / c.sum().clamp_min(1.0)
    pa = p.sum(dim=1)
    pb = p.sum(dim=0)

    def ent(q):
        return -torch.where(q > 0, q * torch.log(q), 0.0).sum()

    outer = pa[:, None] * pb[None, :]
    mi = torch.where(p > 0, p * torch.log(p / outer.clamp_min(1e-300)),
                     0.0).sum()
    return mi, ent(pa), ent(pb)


def normalized_mutual_info(labels_a, labels_b, *,
                           device=None) -> torch.Tensor:
    """NMI with arithmetic-mean normalization (sklearn's default)."""
    mi, ha, hb = _mi_terms(labels_a, labels_b, device)
    denom = 0.5 * (ha + hb)
    return torch.where(denom <= 0, 1.0, mi / denom)


def homogeneity_completeness_v(labels_true, labels_pred, *, device=None):
    """Entropy-based external metrics (Rosenberg & Hirschberg 2007):
    ``{homogeneity, completeness, v_measure}``; a zero entropy scores 1 by
    convention, as in sklearn."""
    mi, h_a, h_b = _mi_terms(labels_true, labels_pred, device)
    hom = torch.where(h_a <= 0, 1.0, mi / h_a)
    com = torch.where(h_b <= 0, 1.0, mi / h_b)
    v = torch.where(hom + com <= 0, 0.0, 2.0 * hom * com / (hom + com))
    return {"homogeneity": hom, "completeness": com, "v_measure": v}


def fowlkes_mallows_index(labels_a, labels_b, *,
                          device=None) -> torch.Tensor:
    """Fowlkes–Mallows index: geometric mean of pairwise precision and
    recall between two labelings."""
    c, n = _masked_contingency(labels_a, labels_b, device)
    n = n.to(c.dtype)
    tk = (c * c).sum() - n
    pk = (c.sum(dim=1) ** 2).sum() - n
    qk = (c.sum(dim=0) ** 2).sum() - n
    return torch.where((pk <= 0) | (qk <= 0), 0.0, tk / (pk * qk).sqrt())


def dunn_index(x, labels, centroids, *, chunk_size: int = 65536,
               device=None) -> float:
    """Dunn index (higher = better) in the centroid-linkage approximation:
    min pairwise centroid distance over live clusters, over 2 × the max
    point-to-own-centroid distance.  Rows with a negative label are
    skipped."""
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    labels = as_tensor(labels, dev, torch.int64)
    c = as_tensor(centroids, dev, _F32)
    k = c.shape[0]
    max_r2 = torch.full((), -torch.inf, dtype=_F32, device=dev)
    counts = torch.zeros(k, dtype=_F32, device=dev)
    for lo in range(0, x.shape[0], chunk_size):
        lt = labels[lo:lo + chunk_size]
        vt = lt >= 0
        own = c[lt.clamp_min(0)]
        d2 = ((x[lo:lo + chunk_size].to(_F32) - own) ** 2).sum(dim=-1)
        d2 = torch.where(vt, d2, -torch.inf)
        segment_sum(torch.ones_like(d2), lt, k, out=counts)
        max_r2 = torch.maximum(max_r2, d2.max())
    diameter = 2.0 * max_r2.clamp_min(0.0).sqrt()
    # Separation over LIVE clusters only: a drained cluster keeps a stale
    # centroid that can sit arbitrarily close to a live one.
    live = counts > 0
    dc = pairwise_sq_dists(c, c)
    off = torch.eye(k, dtype=torch.bool, device=dev) | ~(
        live[:, None] & live[None, :])
    separation = torch.where(off, torch.inf, dc).min().sqrt()
    return float(torch.where(diameter <= 0, torch.inf,
                             separation / diameter))
