"""Fuzzy c-means (soft k-means), Bezdek's FCM.

Counterpart of ``kmeans_tpu/models/fuzzy.py``.  Memberships are a
row-normalized elementwise power of the (chunk, k) distance tile made
right after the distance product, and the centroid update is the same
transposed product as hard Lloyd's with ``u^m`` in place of the one-hot:
both products are ``torch.matmul`` in the compute dtype with f32
accumulation, the membership pass plain PyTorch (the reference's is XLA
code, no Pallas kernel).

Update rules (fuzziness m > 1):

  u_ij = d_ij^(-2/(m-1)) / sum_l d_il^(-2/(m-1))     (memberships, rows sum 1)
  c_j  = sum_i w_i u_ij^m x_i / sum_i w_i u_ij^m      (centroids)
  J    = sum_ij w_i u_ij^m d_ij^2                     (objective)

Points coincident with a centroid get a one-hot membership on the first
such centroid (the standard singularity rule).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.ops.distance import cd_matmul, resolve_cd, sq_norms

__all__ = ["FuzzyState", "fit_fuzzy", "fuzzy_memberships", "FuzzyCMeans"]


class FuzzyState(NamedTuple):
    centroids: torch.Tensor   # (k, d) float32
    labels: torch.Tensor      # (n,) int32 — argmax membership (= nearest)
    objective: torch.Tensor   # scalar float32, J at final centroids
    n_iter: torch.Tensor      # scalar int32
    converged: torch.Tensor   # scalar bool
    counts: torch.Tensor      # (k,) float32 — soft counts sum_i w_i u_ij^m


def _memberships_tile(d2, inv_exp):
    """(chunk, k) memberships from squared distances; singularity-safe.

    The ratio form of ``u_ij = 1 / Σ_l (d_ij/d_il)^(2/(m-1))``: dividing by
    the row minimum first keeps every powered term in (0, 1], so nothing
    overflows however small a distance gets.  A row at distance 0 from a
    centroid takes a one-hot on the first such centroid (``argmax`` of the
    mask cast to uint8: torch's takes no bool, and returns the first
    maximum, as the reference's)."""
    zero = d2 <= 0.0
    any_zero = zero.any(dim=1, keepdim=True)
    d2_safe = torch.where(zero, torch.inf, d2)
    row_min = d2_safe.amin(dim=1, keepdim=True)
    t = (d2_safe / row_min) ** (-inv_exp)
    u_reg = t / t.sum(dim=1, keepdim=True)
    first_zero = torch.argmax(zero.to(torch.uint8), dim=1)
    u_sing = torch.nn.functional.one_hot(first_zero, d2.shape[1]).float()
    return torch.where(any_zero, u_sing, u_reg)


def _d2_tile(xb, xb_sq, c_t, c_sq, cd):
    return (xb_sq[:, None] - 2.0 * cd_matmul(xb, c_t, cd)
            + c_sq[None, :]).clamp_min(0.0)


def fcm_scan_tiles(x, w, c, *, m, chunk_size, compute_dtype, with_labels):
    """The FCM pass — distance tile, memberships, ``u^m``-weighted soft
    reductions — without the normalization: returns this block's
    ``(sums, counts, objective, labels (n,) | None)``.  The one copy of the
    pass body, which :func:`_fcm_loop` finishes (on a mesh, after one
    all-reduce of the three sums).  ``w`` None is all-ones."""
    cd = resolve_cd(compute_dtype, x.dtype)
    k, d = c.shape
    dev = x.device
    inv_exp = 1.0 / (m - 1.0)
    c_t = c.to(cd).T
    c_sq = sq_norms(c)
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    obj = torch.zeros((), dtype=torch.float32, device=dev)
    labels = (torch.empty((x.shape[0],), dtype=torch.int32, device=dev)
              if with_labels else None)
    for lo in range(0, x.shape[0], chunk_size):
        xb = x[lo:lo + chunk_size]
        d2 = _d2_tile(xb, sq_norms(xb), c_t, c_sq, cd)
        u = _memberships_tile(d2, inv_exp)
        um = u ** m
        if w is not None:
            um = um * w[lo:lo + chunk_size, None].float()
        obj += (um * d2).sum()
        sums += cd_matmul(um.T, xb, cd)
        counts += um.sum(dim=0)
        if with_labels:
            labels[lo:lo + xb.shape[0]] = torch.argmax(u, dim=1)
    return sums, counts, obj, labels


def fcm_center_update(c, sums, counts):
    """Soft-count mean; empty (zero-soft-mass) clusters keep their center."""
    denom = torch.where(counts > 0, counts, torch.ones_like(counts))
    return torch.where((counts > 0)[:, None], sums / denom[:, None],
                       c.float())


def _fcm_loop(x, centroids0, weights, tol, *, m, max_iter, chunk_size,
              compute_dtype, mesh=None):
    """FCM passes until the squared centroid shift is <= tol (one scalar
    read a pass), then a final pass for labels, objective and counts.

    With ``mesh`` (the sharded fit) ``x`` and ``weights`` are this rank's
    rows and the soft sums are all-reduced once a pass; the returned
    labels are this rank's rows'."""
    from kmeans_tpu_torch.models.gmm import _reduce

    kw = dict(m=m, chunk_size=chunk_size, compute_dtype=compute_dtype)
    tol_v = torch.tensor(tol, dtype=torch.float32)
    c = centroids0.float()
    it, converged = 0, False
    while it < max_iter and not converged:
        sums, counts, obj, _ = fcm_scan_tiles(x, weights, c,
                                              with_labels=False, **kw)
        sums, counts, _ = _reduce(mesh, sums, counts, obj)
        new_c = fcm_center_update(c, sums, counts)
        shift_sq = ((new_c - c) ** 2).sum()
        c = new_c
        it += 1
        converged = bool((shift_sq.cpu() <= tol_v).item())
    sums, counts, obj, labels = fcm_scan_tiles(x, weights, c,
                                               with_labels=True, **kw)
    _, counts, obj = _reduce(mesh, sums, counts, obj)
    dev = x.device
    return FuzzyState(c, labels, obj,
                      torch.tensor(it, dtype=torch.int32, device=dev),
                      torch.tensor(converged, device=dev), counts)


def fit_fuzzy(
    x,
    k: int,
    *,
    m: float = 2.0,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    device=None,
) -> FuzzyState:
    """Fit fuzzy c-means with fuzziness exponent ``m`` (> 1; 2.0 standard)
    on ``device`` (None is the card).

    As m → 1⁺ memberships sharpen toward hard Lloyd; large m flattens them
    toward uniform.  ``generator`` drives the init draws (default: seeded
    with ``config.seed``).
    """
    if not m > 1.0:
        raise ValueError(f"fuzziness m must be > 1, got {m}")
    from kmeans_tpu_torch.models.gmm import to_f32

    dev = resolve_device(device)
    x = as_tensor(x, dev)
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    cfg, generator, c0 = resolve_fit_inputs(x, k, generator, config, init,
                                            weights)
    return _fcm_loop(
        x, c0, weights, to_f32(tol if tol is not None else cfg.tol),
        m=float(m),
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype)


def fuzzy_memberships(x, centroids, *, m: float = 2.0,
                      chunk_size: int = 4096, compute_dtype=None,
                      device=None):
    """(n, k) membership matrix for given centroids (rows sum to 1), on
    ``device`` (None: the centroids' device when they are a tensor, else
    the card)."""
    if device is None and isinstance(centroids, torch.Tensor):
        device = centroids.device
    c = as_tensor(centroids, resolve_device(device), torch.float32)
    x = as_tensor(x, c.device)
    cd = resolve_cd(compute_dtype, x.dtype)
    inv_exp = 1.0 / (float(m) - 1.0)
    c_t = c.to(cd).T
    c_sq = sq_norms(c)
    u = torch.empty((x.shape[0], c.shape[0]), dtype=torch.float32,
                    device=c.device)
    for lo in range(0, x.shape[0], chunk_size):
        xb = x[lo:lo + chunk_size]
        u[lo:lo + xb.shape[0]] = _memberships_tile(
            _d2_tile(xb, sq_norms(xb), c_t, c_sq, cd), inv_exp)
    return u


@dataclasses.dataclass
class FuzzyCMeans:
    """Estimator wrapper over :func:`fit_fuzzy` (sklearn-like surface), on
    ``device`` (None is the card)."""

    n_clusters: int = 3
    m: float = 2.0
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    tol: float = 1e-4
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    device: Optional[str] = None

    state: Optional[FuzzyState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x, weights=None) -> "FuzzyCMeans":
        from kmeans_tpu_torch.models.lloyd import best_of_n_init

        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        init = None if isinstance(self.init, str) else self.init
        cfg = KMeansConfig(
            k=self.n_clusters,
            init=self.init if isinstance(self.init, str) else "given",
            max_iter=self.max_iter, tol=self.tol, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
        )
        self.state = best_of_n_init(
            lambda gen: fit_fuzzy(
                x, self.n_clusters, m=self.m, generator=gen, config=cfg,
                init=init, weights=weights, device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev,
            score=lambda s: float(s.objective))
        return self

    @property
    def cluster_centers_(self):
        return self.state.centroids

    @property
    def labels_(self):
        return self.state.labels

    @property
    def objective_(self):
        return float(self.state.objective)

    @property
    def n_iter_(self):
        return int(self.state.n_iter)

    def soft_predict(self, x):
        return fuzzy_memberships(
            x, self.state.centroids, m=self.m, chunk_size=self.chunk_size,
            compute_dtype=self.compute_dtype)

    def predict(self, x):
        return torch.argmax(self.soft_predict(x), dim=1).to(torch.int32)
