"""Hierarchical merging of fitted centroids: dendrogram + drill-down.

A copy of ``kmeans_tpu/models/hierarchy.py``: numpy only, but importing it
would run ``kmeans_tpu/__init__.py``, which imports JAX.  The one change:
:func:`merge_to_k` reads a state's tensors through :func:`_host`, so a port
state on the card merges as a reference state does.

The board caps itself at 3 clusters (app.mjs:127), while the numeric
engine's fits use k = 1000: this module builds an agglomerative dendrogram
OVER THE FITTED CENTROIDS (size-weighted, so merging respects how much data
each center represents) and cuts it at any coarser k', relabeling the
original points without touching the data again.

Agglomeration is a sequential O(k²)-state loop over at most a few thousand
centers, so it runs in NumPy on the host via the Lance–Williams recurrence
(one vectorized O(k) update per merge).  The linkage matrix uses SciPy's
(k−1, 4) convention, so ``scipy.cluster.hierarchy.dendrogram`` can plot it
directly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["centroid_linkage", "cut_linkage", "merge_to_k"]


def _host(a):
    """``a`` as a host array: a tensor (on any device) through numpy."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return a


#: Lance–Williams coefficients (α_i, α_j, β, γ) as functions of the
#: cluster sizes (n_i, n_j, n_h): D(m, h) for the merge m = i∪j is
#: α_i·D(i,h) + α_j·D(j,h) + β·D(i,j) + γ·|D(i,h) − D(j,h)| — where D is
#: SQUARED distance for ward (whose recurrence is exact in d²) and plain
#: distance for average/single/complete (the mean does not commute with
#: squaring; min/max would, but plain d keeps one convention).
def _lw_coeffs(method: str, ni, nj, nh):
    if method == "ward":
        t = ni + nj + nh
        return ((ni + nh) / t, (nj + nh) / t, -nh / t, 0.0)
    if method == "average":
        t = ni + nj
        return (ni / t, nj / t, 0.0, 0.0)
    if method == "single":
        return (0.5, 0.5, 0.0, -0.5)
    if method == "complete":
        return (0.5, 0.5, 0.0, 0.5)
    raise ValueError(f"unknown linkage method {method!r}")


def centroid_linkage(
    centroids,
    counts=None,
    *,
    method: str = "ward",
) -> np.ndarray:
    """SciPy-format linkage matrix over ``centroids``.

    ``counts`` (cluster sizes from the fit) weight the merges: for
    ``method="ward"`` the height is the weighted Ward cost
    ``sqrt(2·n_i·n_j/(n_i+n_j))·‖c_i − c_j‖`` (SciPy's convention), so a
    center representing 10⁶ points resists merging into one representing
    10².  ``None`` means unit weights — on raw points that reproduces
    ``scipy.cluster.hierarchy.linkage`` exactly (tested).

    Returns a float64 ``(k−1, 4)`` array: merged ids, height, leaf count
    — directly consumable by ``scipy.cluster.hierarchy`` tooling.
    """
    c = np.asarray(centroids, np.float64)
    if c.ndim != 2 or c.shape[0] < 2:
        raise ValueError(f"need (k>=2, d) centroids, got shape {c.shape}")
    k = c.shape[0]
    n = (np.ones(k) if counts is None
         else np.asarray(counts, np.float64).copy())
    if n.shape != (k,) or (n < 0).any():
        raise ValueError(
            "counts must be non-negative with one entry per center"
        )
    # Zero-count centers (the default empty="keep" policy leaves them in
    # fitted states) get a vanishing weight: they merge almost for free,
    # wherever they sit — exactly how much data they represent.
    pos = n[n > 0]
    n = np.maximum(n, (pos.min() if pos.size else 1.0) * 1e-9)

    # Pairwise dissimilarity matrix in the method's exact-recurrence
    # space: squared distance (Ward-scaled) for ward, plain distance for
    # the rest.  Gram form — O(k² + kd) memory, never a (k, k, d) cube.
    sq = np.einsum("ij,ij->i", c, c)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (c @ c.T), 0.0)
    if method == "ward":
        w = (n[:, None] * n[None, :]) / (n[:, None] + n[None, :])
        d2 = 2.0 * w * d2
    else:
        _lw_coeffs(method, 1.0, 1.0, np.ones(1))   # validate the name
        d2 = np.sqrt(np.maximum(d2, 0.0))
    np.fill_diagonal(d2, np.inf)

    active = np.ones(k, bool)
    ids = np.arange(k)                 # scipy node id of each active row
    sizes = n.copy()                   # weighted sizes (for Lance–Williams)
    leaves = np.ones(k)                # leaf counts (column 3 of Z)
    Z = np.zeros((k - 1, 4))
    for m in range(k - 1):
        # Global nearest pair among active rows.
        flat = np.argmin(d2)
        i, j = np.unravel_index(flat, d2.shape)
        if i > j:
            i, j = j, i
        h2 = d2[i, j]
        height = np.sqrt(max(h2, 0.0)) if method == "ward" else h2
        Z[m] = (min(ids[i], ids[j]), max(ids[i], ids[j]),
                height, leaves[i] + leaves[j])
        # Lance–Williams update of row i (the merged cluster); retire j.
        mask = active.copy()
        mask[i] = mask[j] = False
        ai, aj, beta, gamma = _lw_coeffs(method, sizes[i], sizes[j],
                                         sizes[mask])
        dih, djh = d2[i, mask], d2[j, mask]
        new = ai * dih + aj * djh + beta * h2 + gamma * np.abs(dih - djh)
        d2[i, mask] = new
        d2[mask, i] = new
        d2[j, :] = np.inf
        d2[:, j] = np.inf
        d2[i, i] = np.inf
        active[j] = False
        ids[i] = k + m
        sizes[i] = sizes[i] + sizes[j]
        leaves[i] = leaves[i] + leaves[j]
    return Z


def cut_linkage(Z: np.ndarray, k: int) -> np.ndarray:
    """Flat clustering with ``k`` clusters from a linkage matrix: apply
    the first ``n_leaves − k`` merges, then relabel components 0..k−1 in
    order of first leaf appearance (deterministic).  Returns int32
    ``(n_leaves,)`` labels for the ORIGINAL leaves (= fitted centers)."""
    Z = np.asarray(Z)
    n_leaves = Z.shape[0] + 1
    if not 1 <= k <= n_leaves:
        raise ValueError(f"k must be in [1, {n_leaves}], got {k}")
    parent = np.arange(n_leaves + Z.shape[0])

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for m in range(n_leaves - k):
        a, b = int(Z[m, 0]), int(Z[m, 1])
        node = n_leaves + m
        parent[find(a)] = node
        parent[find(b)] = node
    roots = np.asarray([find(i) for i in range(n_leaves)])
    order: Dict[int, int] = {}
    labels = np.empty(n_leaves, np.int32)
    for i, r in enumerate(roots):
        labels[i] = order.setdefault(int(r), len(order))
    return labels


def merge_to_k(
    state,
    k: int,
    *,
    method: str = "ward",
    linkage: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Coarsen a fitted state to ``k`` clusters without re-fitting.

    Returns ``(labels, centers)``: per-point int32 labels in the merged
    clustering (negative labels — the trimmed family's outliers — pass
    through unchanged), and the (k, d) size-weighted merged centers.
    Pass a precomputed ``linkage`` to cut the same tree at many levels.
    """
    from kmeans_tpu_torch.models import state_centers, state_counts

    cents = state_centers(state)
    if cents is None:
        raise ValueError(
            "state has no center array to merge (center-free family)"
        )
    counts = state_counts(state)
    if counts is None:
        raise ValueError("state has no per-cluster counts to weight by")
    counts = np.asarray(_host(counts), np.float64)
    cents = np.asarray(_host(cents), np.float64)
    if linkage is None:
        linkage = centroid_linkage(cents, counts, method=method)
    leaf_to_merged = cut_linkage(linkage, k)

    w = np.maximum(counts, 0.0)
    merged = np.zeros((k, cents.shape[1]))
    mass = np.zeros(k)
    np.add.at(merged, leaf_to_merged, cents * w[:, None])
    np.add.at(mass, leaf_to_merged, w)
    # A merged group whose members are all empty keeps the plain mean of
    # its member centers rather than 0/0.
    empty = mass <= 0
    if empty.any():
        cnt = np.zeros(k)
        np.add.at(cnt, leaf_to_merged, 1.0)
        plain = np.zeros_like(merged)
        np.add.at(plain, leaf_to_merged, cents)
        merged[empty] = plain[empty] / cnt[empty, None]
        mass[empty] = 1.0
    merged = merged / mass[:, None]

    labels = np.asarray(_host(state.labels))
    lut = leaf_to_merged.astype(np.int32)
    out = np.where(labels >= 0, lut[np.maximum(labels, 0)], labels)
    return out.astype(np.int32), merged.astype(np.float32)
