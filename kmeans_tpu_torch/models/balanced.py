"""Balanced k-means via entropic optimal transport (Sinkhorn).

Counterpart of ``kmeans_tpu/models/balanced.py``.  The assign step solves
an entropic optimal-transport problem between points (mass = sample
weight) and clusters (mass = a capacity vector, uniform by default), so
every cluster receives exactly its share of the data mass.  Sinkhorn's
alternating row / column scalings run in the log domain over one (n, k)
f32 matrix of squared distances; the column update runs last, so the
plan's column sums equal the capacities at every outer iteration.  Hard
labels are the plan's row argmax, ``argmin_j (d²_ij − g_j)``: the OT
potentials act as per-cluster price offsets on nearest-centroid
assignment.  Prediction is unconstrained nearest-centroid assignment (K1
on the card).

Each sweep is two logsumexps over the whole (n, k) matrix, plain PyTorch
(the reference's are XLA code, no Pallas kernel) over one preallocated
(n, k) buffer, in place: ``x − max``, ``exp`` and the row or column sum
write nothing else of that size.  A row of zero weight has ``log a =
−inf``: its potential is −inf and its plan row 0, with no NaN.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.models.lloyd import NearestCentroidMixin
from kmeans_tpu_torch.ops.distance import full_f32, pairwise_sq_dists
from kmeans_tpu_torch.ops.segment import segment_sum

__all__ = ["BalancedState", "fit_balanced", "BalancedKMeans",
           "sinkhorn_potentials", "resolve_capacities"]

#: Size gate of the (n, k) f32 plan: 1.5e8 elements = 600 MB.  Beyond it
#: the DP-sharded fit splits the rows.
_MAX_PLAN_ELEMENTS = 150_000_000


class BalancedState(NamedTuple):
    """Result of a balanced fit.

    ``counts`` are HARD label counts (argmax of the plan) — approximately
    the capacities, tighter as ``epsilon`` shrinks.  ``col_masses`` are
    the SOFT plan column sums, equal to the capacities.
    """

    centroids: torch.Tensor     # (k, d) float32
    labels: torch.Tensor        # (n,) int32
    inertia: torch.Tensor       # scalar float32 (hard, at final centroids)
    n_iter: torch.Tensor        # scalar int32
    converged: torch.Tensor     # scalar bool
    counts: torch.Tensor        # (k,) float32 hard cluster sizes
    col_masses: torch.Tensor    # (k,) float32 soft masses (== capacities)


def resolve_capacities(k: int, capacities, device=None) -> torch.Tensor:
    """Normalized per-cluster mass vector on ``device`` (None is the CPU):
    ``None`` means uniform (same-size clusters); an explicit vector is
    validated positive and normalized to sum 1 (in f64, then rounded)."""
    if capacities is None:
        return torch.full((k,), 1.0 / k, dtype=torch.float32, device=device)
    cap = np.asarray(capacities.cpu() if isinstance(capacities, torch.Tensor)
                     else capacities, np.float64)
    if cap.shape != (k,):
        raise ValueError(f"capacities shape {cap.shape} != ({k},)")
    if not (cap > 0).all():
        raise ValueError("capacities must be strictly positive")
    return torch.as_tensor((cap / cap.sum()).astype(np.float32),
                           device=device)


def lse_inplace(buf: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """``logsumexp(buf, dim)``, overwriting ``buf`` with ``exp(buf − max)``
    (the reference's formula: a max that is not finite counts as 0, so a
    line of −inf gives −inf).  With ``mesh`` the lines run across the
    ranks' rows: a MAX all-reduce of the maxima and a SUM all-reduce of the
    shifted exps, the distributed logsumexp."""
    m = buf.amax(dim=dim, keepdim=True)
    if mesh is not None:
        mesh.all_reduce(m, op="max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = buf.sub_(m).exp_().sum(dim=dim)
    if mesh is not None:
        mesh.all_reduce(s)
    return torch.log(s) + m.squeeze(dim)


def _eps_pair(epsilon):
    """``(epsilon, 1/epsilon)`` as the f32 values the reference computes
    with."""
    eps = np.float32(epsilon)
    return float(eps), float(np.float32(1.0) / eps)


def sinkhorn_potentials(d2, log_a, log_b, *, epsilon: float, sweeps: int,
                        buf: Optional[torch.Tensor] = None, mesh=None):
    """Dual potentials (f, g) after ``sweeps`` row → column scaling sweeps
    in the log domain.  Ending on the column update makes the plan's
    column sums ``exp(log_b)`` — the balance guarantee.  ``buf`` is an
    (n, k) f32 scratch (made when None).  With ``mesh`` the rows are this
    rank's and each column step's logsumexp runs across the ranks (two
    all-reduces a sweep)."""
    n, k = d2.shape
    eps, inv_eps = _eps_pair(epsilon)
    buf = torch.empty_like(d2) if buf is None else buf
    f = torch.zeros((n,), dtype=torch.float32, device=d2.device)
    g = torch.zeros((k,), dtype=torch.float32, device=d2.device)
    for _ in range(sweeps):
        torch.sub(g[None, :], d2, out=buf).mul_(inv_eps)
        f = eps * (log_a - lse_inplace(buf, 1))
        torch.sub(f[:, None], d2, out=buf).mul_(inv_eps)
        g = eps * (log_b - lse_inplace(buf, 0, mesh))
    return f, g


def plan_into(buf, d2, f, g, epsilon):
    """``buf ← exp((f + g − d2) / ε)``, the transport plan."""
    eps, _ = _eps_pair(epsilon)
    torch.add(f[:, None], g[None, :], out=buf)
    return buf.sub_(d2).div_(eps).exp_()


def log_row_masses(weights, n: int, device) -> torch.Tensor:
    """Normalized log row masses: ``−log n`` each, or ``log w − lse(log
    w)`` with −inf on zero-weight rows."""
    if weights is None:
        return torch.full((n,), -float(np.log(np.float32(n))),
                          dtype=torch.float32, device=device)
    w = weights.float()
    log_a = torch.where(w > 0, torch.log(w.clamp_min(1e-38)),
                        torch.full_like(w, -torch.inf))
    return log_a - torch.logsumexp(log_a, dim=0)


def _balanced_loop(x, centroids0, weights, log_a, log_b, capacities, tol,
                   epsilon, *, max_iter, sweeps, compute_dtype, mesh=None):
    """Sinkhorn-assigned Lloyd steps until the squared centroid shift is
    <= tol (one scalar read a step), then the final plan's labels, hard
    counts and column masses.  With ``mesh`` (the sharded fit) ``x``,
    ``weights`` and ``log_a`` are this rank's rows: the column steps, the
    update's ``πᵀx`` and the final sums are all-reduced, and the returned
    labels are this rank's rows'."""
    from kmeans_tpu_torch.models.gmm import _reduce

    n = x.shape[0]
    k = centroids0.shape[0]
    dev = x.device
    buf = torch.empty((n, k), dtype=torch.float32, device=dev)

    def d2_of(c):
        return pairwise_sq_dists(x, c, compute_dtype=compute_dtype).float()

    def potentials(d2):
        return sinkhorn_potentials(d2, log_a, log_b, epsilon=epsilon,
                                   sweeps=sweeps, buf=buf, mesh=mesh)

    tol_v = torch.tensor(tol, dtype=torch.float32)
    c = centroids0.float()
    it, converged = 0, False
    while it < max_iter and not converged:
        d2 = d2_of(c)
        f, g = potentials(d2)
        pi = plan_into(buf, d2, f, g, epsilon)               # (n, k)
        del d2
        # Column sums are the capacities by construction, so the update
        # divides by them, not by recomputed masses.
        with full_f32():
            (num,) = _reduce(mesh, pi.T @ x.float())
        new_c = num / capacities[:, None].clamp_min(1e-38)
        shift_sq = ((new_c - c) ** 2).sum()
        c = new_c
        it += 1
        converged = bool((shift_sq.cpu() <= tol_v).item())

    # Final view: labels = plan argmax = argmin(d2 − g).
    d2 = d2_of(c)
    f, g = potentials(d2)
    labels = torch.argmin(torch.sub(d2, g[None, :], out=buf), dim=1)
    mind = d2.gather(1, labels[:, None])[:, 0]
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else weights.float())
    inertia = mind.sum() if weights is None else (w * mind).sum()
    counts = segment_sum(w, labels, k)
    col_masses = plan_into(buf, d2, f, g, epsilon).sum(dim=0)
    inertia, counts, col_masses = _reduce(mesh, inertia, counts, col_masses)
    return BalancedState(c, labels.to(torch.int32), inertia,
                         torch.tensor(it, dtype=torch.int32, device=dev),
                         torch.tensor(converged, device=dev), counts,
                         col_masses)


def check_sinkhorn_args(epsilon, sinkhorn_sweeps) -> None:
    if epsilon <= 0:
        raise ValueError(f"epsilon must be positive, got {epsilon}")
    if sinkhorn_sweeps < 1:
        raise ValueError(
            f"sinkhorn_sweeps must be >= 1, got {sinkhorn_sweeps}")


def fit_balanced(
    x,
    k: int,
    *,
    capacities=None,
    epsilon: float = 0.5,
    sinkhorn_sweeps: int = 200,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    normalize_epsilon: bool = True,
    device=None,
) -> BalancedState:
    """Fit balanced k-means on ``device`` (None is the card): every
    cluster receives its capacity share of the data mass (uniform
    capacities = same-size clusters).

    ``epsilon`` is the entropic regularization: smaller is closer to hard
    nearest-centroid assignment (needs more ``sinkhorn_sweeps`` for the
    balance to bite), larger trades geometry for balance.  With
    ``normalize_epsilon`` (default) it multiplies the mean squared
    NEAREST-seed distance (zero-weight rows excluded), the within-cluster
    scale.
    """
    n = x.shape[0]
    if n * k > _MAX_PLAN_ELEMENTS:
        raise ValueError(
            f"balanced k-means materializes the (n, k) transport plan; "
            f"n*k = {n * k:.2e} exceeds {_MAX_PLAN_ELEMENTS:.0e}. "
            "Use fit_balanced_sharded to split rows across devices."
        )
    check_sinkhorn_args(epsilon, sinkhorn_sweeps)
    from kmeans_tpu_torch.models.gmm import to_f32

    dev = resolve_device(device)
    x = as_tensor(x, dev)
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    cap = resolve_capacities(k, capacities, dev)
    cfg, generator, c0 = resolve_fit_inputs(x, k, generator, config, init,
                                            weights)
    eps_v = float(epsilon)
    if normalize_epsilon:
        mind = pairwise_sq_dists(x, c0,
                                 compute_dtype=cfg.compute_dtype).amin(dim=1)
        if weights is not None:
            real = (weights > 0).float()
            scale = float((mind * real).sum() / real.sum())
        else:
            scale = float(mind.mean())
        eps_v = max(eps_v * scale, 1e-12)
    return _balanced_loop(
        x, c0, weights, log_row_masses(weights, n, dev), torch.log(cap), cap,
        to_f32(tol if tol is not None else cfg.tol), eps_v,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        sweeps=sinkhorn_sweeps, compute_dtype=cfg.compute_dtype)


@dataclasses.dataclass
class BalancedKMeans(NearestCentroidMixin):
    """Estimator wrapper over :func:`fit_balanced` (sklearn-like surface),
    on ``device`` (None is the card).

    ``predict``/``transform``/``score`` come from the nearest-centroid
    mixin — prediction is unconstrained (capacities bind the training
    mass, not future points) and runs K1 on the card.
    """

    n_clusters: int = 3
    capacities: Optional[object] = None
    epsilon: float = 0.5
    sinkhorn_sweeps: int = 200
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    tol: float = 1e-4
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    device: Optional[str] = None

    state: Optional[BalancedState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x, weights=None) -> "BalancedKMeans":
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
            lambda gen: fit_balanced(
                x, self.n_clusters, capacities=self.capacities,
                epsilon=self.epsilon, sinkhorn_sweeps=self.sinkhorn_sweeps,
                generator=gen, config=cfg, init=init, weights=weights,
                device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev)
        return self

    def fit_predict(self, x, weights=None):
        return self.fit(x, weights=weights).labels_

    @property
    def cluster_centers_(self):
        return self.state.centroids

    @property
    def labels_(self):
        return self.state.labels

    @property
    def inertia_(self):
        return float(self.state.inertia)

    @property
    def n_iter_(self):
        return int(self.state.n_iter)
