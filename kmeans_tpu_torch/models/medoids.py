"""k-medoids (alternate / Voronoi iteration), exemplar-based clustering.

Counterpart of ``kmeans_tpu/models/medoids.py``.  Centers are actual data
rows (medoids), robust to outliers; the surface mirrors
``sklearn_extra.cluster.KMedoids`` with ``method="alternate"``.

The assignment step is a tiled argmin over the medoids' distance tile.
The medoid update needs, for every row, its summed distance to the
co-members of its cluster: an O(n²) pass, a (chunk, n) distance tile a
step (``torch.matmul`` in the compute dtype, finished in place on the
product's buffer, as the reference's is XLA code), a same-label mask and a
row sum.  Medoid selection is two ``scatter_reduce(..., "amin")``s (the
minimum cost, then the lowest row index among the rows that reach it);
an empty cluster keeps its medoid, and a zero-weight row costs +inf and
is never a medoid.  The fit stops when the medoid set is fixed.

One loop serves one device and a mesh (:func:`_kmedoids_loop`): on a mesh
each rank's rows sum their costs against every row block in turn, the
visiting block moving one rank a step round the ring, and the two minima
are MIN all-reduces; one device is a ring of one.  The D-sampling init
(k-means++ on the metric's distances, returning row indices) draws from a
:class:`torch.Generator`, each pick one assignment against one row: K1 at
k = 1 on the card, as :meth:`KMedoids.predict` is K1.

O(n²·d) an iteration bounds this to moderate n (about 10⁵ on one card).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_config
from kmeans_tpu_torch.ops.distance import cd_product, resolve_cd, sq_norms

__all__ = ["KMedoidsState", "fit_kmedoids", "resolve_medoid_init",
           "KMedoids"]


class KMedoidsState(NamedTuple):
    medoids: torch.Tensor         # (k, d) float32 — actual data rows
    medoid_indices: torch.Tensor  # (k,) int32 — row indices into x
    labels: torch.Tensor          # (n,) int32
    inertia: torch.Tensor         # scalar float32 — sum of metric distances
    n_iter: torch.Tensor          # scalar int32
    converged: torch.Tensor       # scalar bool (medoid set fixed)


def _dist_tile(xb, y, xb_sq, y_sq, *, metric, cd):
    """(chunk, m) distances from the rows ``xb`` to the rows ``y``, finished
    in place on the product's buffer (exact rewrites of the reference's
    expression)."""
    d2 = cd_product(xb, y, cd).mul_(-2.0).add_(xb_sq[:, None])
    d2 = d2.add_(y_sq[None, :]).clamp_min_(0.0)
    return d2.sqrt_() if metric == "euclidean" else d2


def _assign_rows(x, x_sq, w, med, *, metric, chunk_size, cd):
    """Each row's nearest medoid (the lowest index on a tie) and
    Σ w·distance, summed tile by tile as the reference's scan does."""
    med = med.float()
    m_sq = sq_norms(med)
    labels = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], chunk_size):
        hi = lo + chunk_size
        dist = _dist_tile(x[lo:hi], med, x_sq[lo:hi], m_sq, metric=metric,
                          cd=cd)
        labels[lo:hi] = torch.argmin(dist, dim=1)
        inertia = inertia + (dist.amin(dim=1) * w[lo:hi]).sum()
    return labels, inertia


def _cost_rows(x, x_sq, lab, bx, bsq, blab, bw, *, metric, chunk_size, cd):
    """Each row's weighted summed distance to the rows of the block
    ``(bx, bsq, blab, bw)`` that share its label: the cost of making it
    its cluster's medoid, over that block."""
    cost = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], chunk_size):
        hi = lo + chunk_size
        dist = _dist_tile(x[lo:hi], bx, x_sq[lo:hi], bsq, metric=metric,
                          cd=cd)
        other = lab[lo:hi, None] != blab[None, :]
        cost[lo:hi] = dist.mul_(bw[None, :]).masked_fill_(other, 0.0).sum(1)
    return cost


def _medoid_rows(x, med_idx, mesh, lo):
    """The (k, d) f32 medoid rows: indexed on one device; on a mesh each
    owner sends its rows and one all-reduce assembles them."""
    if mesh is None:
        return x[med_idx].float()
    n_loc = x.shape[0]
    mine = (med_idx >= lo) & (med_idx < lo + n_loc)
    rows = x[(med_idx - lo).clamp(0, n_loc - 1)].float()
    return mesh.all_reduce(torch.where(mine[:, None], rows, 0.0))


def _select_medoids(cost, w, labels, med_idx, row_ids, sentinel, k, mesh):
    """Each cluster's new medoid: its least cost, the lowest row index on a
    tie; a zero-weight row costs +inf; an empty cluster keeps its medoid."""
    cost = torch.where(w > 0, cost, torch.inf)
    lab = labels.long()
    seg = torch.full((k,), torch.inf, dtype=torch.float32, device=cost.device)
    seg.scatter_reduce_(0, lab, cost, "amin", include_self=False)
    if mesh is not None:
        mesh.all_reduce(seg, "min")
    is_min = (cost <= seg[lab]) & torch.isfinite(cost)
    cand = torch.where(is_min, row_ids, sentinel)
    new = torch.full((k,), sentinel, dtype=torch.int64, device=cost.device)
    new.scatter_reduce_(0, lab, cand, "amin", include_self=False)
    if mesh is not None:
        mesh.all_reduce(new, "min")
    return torch.where(new >= sentinel, med_idx, new)


def _kmedoids_loop(x, idx0, w, *, max_iter, chunk_size, compute_dtype,
                   metric, mesh=None, n=None):
    """Assign, sweep the costs, select, until the medoid set is fixed (one
    scalar read an iteration); then the final assignment.  With ``mesh``
    the rows are this rank's block of the padded rows (``n`` real rows in
    all; padding rows weigh 0) and the returned labels are its rows'."""
    cd = resolve_cd(compute_dtype, x.dtype)
    dev = x.device
    n_loc = x.shape[0]
    steps = 1 if mesh is None else mesh.size
    lo = 0 if mesh is None else mesh.rank * n_loc
    sentinel = n_loc * steps
    row_ids = lo + torch.arange(n_loc, device=dev)
    k = idx0.shape[0]
    kw = dict(metric=metric, chunk_size=chunk_size, cd=cd)
    x_sq = sq_norms(x)
    med_idx = idx0.to(dev, torch.int64)
    it, converged = 0, False
    while it < max_iter and not converged:
        labels, _ = _assign_rows(x, x_sq, w, _medoid_rows(x, med_idx, mesh,
                                                          lo), **kw)
        blk = (x, x_sq, labels, w)
        cost = None
        for i in range(steps):
            part = _cost_rows(x, x_sq, labels, *blk, **kw)
            cost = part if cost is None else cost.add_(part)
            if i + 1 < steps:
                blk = mesh.ring_shift(*blk)
        new = _select_medoids(cost, w, labels, med_idx, row_ids, sentinel,
                              k, mesh)
        converged = bool(torch.equal(new, med_idx))
        med_idx = new
        it += 1
    med = _medoid_rows(x, med_idx, mesh, lo)
    labels, inertia = _assign_rows(x, x_sq, w, med, **kw)
    if mesh is not None:
        mesh.all_reduce(inertia)
    return KMedoidsState(
        medoids=med, medoid_indices=med_idx.to(torch.int32), labels=labels,
        inertia=inertia,
        n_iter=torch.tensor(it, dtype=torch.int32, device=dev),
        converged=torch.tensor(converged, device=dev))


def _pick(score, x, mesh, lo):
    """``(global row index, its row f32)`` of the score's argmax (the lowest
    index on a tie); on a mesh one all-gather of each rank's (score, index,
    row) in f64, which holds all three exactly."""
    li = torch.argmax(score)
    if mesh is None:
        return li, x[li].float()
    packed = torch.cat([score[li].view(1).double(),
                        (li + lo).view(1).double(), x[li].double()])
    allp = mesh.all_gather(packed[None])
    win = allp[torch.argmax(allp[:, 0])]             # first max: lowest rank
    return win[1].long(), win[2:].float()


def _init_medoid_indices(generator, x, k, *, weights, metric, chunk_size,
                         compute_dtype, mesh=None, n=None):
    """k-means++-style D-sampling that returns ROW INDICES: Gumbel-max
    draws with the metric's distances as the mass, each pick one
    assignment against one row (K1 at k = 1 on the card).  On a mesh
    ``x`` / ``weights`` are this rank's rows (padding weighs 0) and every
    rank draws the full n-row Gumbel stream, so the picks are one
    device's."""
    from kmeans_tpu_torch.models.init import _gumbel
    from kmeans_tpu_torch.ops.distance import assign
    from kmeans_tpu_torch.parallel.init_sharded import _local_stream

    dev = x.device
    n_loc = x.shape[0]
    n = n_loc if n is None else n
    lo = 0 if mesh is None else mesh.rank * n_loc
    w = (torch.ones(n_loc, dtype=torch.float32, device=dev)
         if weights is None else weights.float())
    logw = torch.log(w)
    idx = torch.zeros(k, dtype=torch.int64, device=dev)

    def mass_to(row):
        _, d2 = assign(x, row[None], chunk_size=chunk_size,
                       compute_dtype=compute_dtype, device=dev)
        return torch.sqrt(d2) if metric == "euclidean" else d2

    first, row = _pick(
        logw + _local_stream(_gumbel(n, generator, dev), lo, n_loc), x,
        mesh, lo)
    idx[0] = first
    mass = mass_to(row)
    for i in range(1, k):
        g = _local_stream(_gumbel(n, generator, dev), lo, n_loc)
        nxt, row = _pick(logw + torch.log(mass) + g, x, mesh, lo)
        idx[i] = nxt
        mass = torch.minimum(mass, mass_to(row))
    return idx


def resolve_medoid_init(generator, x, k, *, init, cfg, weights, metric,
                        mesh=None, n=None):
    """Starting medoid indices for any ``init`` route: an explicit (k,)
    index array (validated), "random" (uniform, weight-agnostic), or
    ++-family D-sampling.  THE one copy, shared by the single-device fit
    and the ring fit (``mesh``: ``x`` / ``weights`` are this rank's rows
    of ``n`` in all), so seeded runs of the two pick identical rows."""
    n = x.shape[0] if n is None else n
    if init is not None and not isinstance(init, str):
        idx0 = torch.as_tensor(init.cpu() if isinstance(init, torch.Tensor)
                               else np.asarray(init)).to(torch.int32)
        if tuple(idx0.shape) != (k,):
            raise ValueError(
                f"init medoid indices shape {tuple(idx0.shape)} != ({k},)")
        if bool(((idx0 < 0) | (idx0 >= n)).any()):
            raise ValueError(
                f"init medoid indices must lie in [0, {n}); got "
                f"min={int(idx0.min())}, max={int(idx0.max())}")
        return idx0.to(x.device)
    method = init if isinstance(init, str) else cfg.init
    if method == "given":
        raise ValueError(
            "init='given' requires an explicit medoid index array"
        )
    if method == "random":
        return torch.randperm(n, generator=generator,
                              device=x.device)[:k].to(torch.int32)
    return _init_medoid_indices(
        generator, x, k, weights=weights, metric=metric,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        mesh=mesh, n=n).to(torch.int32)


def fit_kmedoids(
    x,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    metric: str = "euclidean",
    max_iter: Optional[int] = None,
    device=None,
) -> KMedoidsState:
    """Fit alternate k-medoids on ``device`` (None is the card).  ``init``
    may be a (k,) int array of row indices or an init method name (drawn
    from ``generator``, default seeded with ``config.seed``); ``metric``
    is "euclidean" or "sqeuclidean"."""
    if metric not in ("euclidean", "sqeuclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = resolve_device(device)
    cfg, gen = resolve_fit_config(k, generator, config, dev)
    x = as_tensor(x, dev)
    w = (torch.ones(x.shape[0], dtype=torch.float32, device=dev)
         if weights is None else as_tensor(weights, dev, torch.float32))
    idx0 = resolve_medoid_init(gen, x, k, init=init, cfg=cfg, weights=w,
                               metric=metric)
    return _kmedoids_loop(
        x, idx0, w, max_iter=max_iter if max_iter is not None
        else cfg.max_iter, chunk_size=cfg.chunk_size,
        compute_dtype=cfg.compute_dtype, metric=metric)


@dataclasses.dataclass
class KMedoids:
    """Estimator wrapper over :func:`fit_kmedoids` (the sklearn-extra
    surface), on ``device`` (None is the card)."""

    n_clusters: int = 3
    metric: str = "euclidean"
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    device: Optional[str] = None

    state: Optional[KMedoidsState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x, weights=None) -> "KMedoids":
        from kmeans_tpu_torch.models.lloyd import best_of_n_init

        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        init = None if isinstance(self.init, str) else self.init
        cfg = KMeansConfig(
            k=self.n_clusters,
            init=self.init if isinstance(self.init, str) else "given",
            max_iter=self.max_iter, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
        )
        self.state = best_of_n_init(
            lambda gen: fit_kmedoids(
                x, self.n_clusters, generator=gen, config=cfg, init=init,
                weights=weights, metric=self.metric, device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev)
        return self

    @property
    def cluster_centers_(self):
        return self.state.medoids

    @property
    def medoid_indices_(self):
        return self.state.medoid_indices

    @property
    def labels_(self):
        return self.state.labels

    @property
    def inertia_(self):
        return float(self.state.inertia)

    @property
    def n_iter_(self):
        return int(self.state.n_iter)

    def predict(self, x):
        """Each row's nearest medoid: K1 on the card."""
        from kmeans_tpu_torch.ops.distance import assign

        labels, _ = assign(x, self.state.medoids, chunk_size=self.chunk_size,
                           compute_dtype=self.compute_dtype,
                           device=self.state.medoids.device)
        return labels
