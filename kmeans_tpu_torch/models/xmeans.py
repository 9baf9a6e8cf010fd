"""X-means: automatic k via BIC-scored splitting (Pelleg & Moore 2000).

Counterpart of ``kmeans_tpu/models/xmeans.py``.  Improve-params /
improve-structure alternation:

1. Fit k-means at the current k.
2. For every cluster, fit a local 2-means and compare the BIC of the
   1-cluster parent against the 2-cluster split on that cluster's points
   alone (spherical-Gaussian MLE likelihood, ``p = K(d+1)`` free
   parameters).
3. Accept all BIC-improving splits (until ``k_max``), re-fit globally from
   the survivors and children, repeat until no split is accepted.

As in :mod:`kmeans_tpu_torch.models.bisecting`, a split never gathers
member rows: each local 2-means is a weighted fit over the full (n, d)
array with the membership mask as the weights (the sweep kernels on the
card).  Which splits to take is host-side Python over scalars: one read
back of each split's (n_a, n_b, sse2).  Every inner fit draws its seeding
from the fit's one generator, in the order the reference splits its key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.bisecting import inner_fits
from kmeans_tpu_torch.models.init import resolve_fit_config
from kmeans_tpu_torch.models.lloyd import KMeansState, NearestCentroidMixin
from kmeans_tpu_torch.ops.segment import segment_sum

__all__ = ["fit_xmeans", "bic_score", "XMeans"]


def bic_score(n: float, d: int, k: int, sse: float, counts) -> float:
    """BIC of a spherical-Gaussian k-means model on ``n`` points.

    ``ll - (p/2)·log n`` with the Pelleg-Moore MLE log-likelihood: shared
    spherical variance ``σ² = sse / (d·(n-k))`` and ``p = k·(d+1)`` free
    parameters.  Higher is better.  Degenerate inputs (n ≤ k, an empty
    cluster) score ``-inf``; a zero-variance model with every cluster
    populated scores ``+inf``, so two point masses split and a single point
    mass never does."""
    counts = [float(c) for c in counts]
    if n <= k or any(c <= 0 for c in counts):
        return -math.inf
    var = sse / (d * (n - k))
    if var <= 0.0:
        return math.inf
    ll = sum(c * math.log(c / n) for c in counts)
    ll -= (n * d / 2.0) * math.log(2.0 * math.pi * var)
    ll -= (d * (n - k)) / 2.0
    p = k * (d + 1)
    return ll - (p / 2.0) * math.log(n)


def _grow_k(
    x,
    k_max: int,
    *,
    k_min: int,
    generator: Optional[torch.Generator],
    config: Optional[KMeansConfig],
    max_rounds: int,
    accept,
    family: str,
    min_split_size: int = 4,
    mesh=None,
    data_axis: str = "data",
    device=None,
) -> KMeansState:
    """The shared improve-params / improve-structure loop of the auto-k
    families (x-means, g-means): fit at the current k, offer every
    cluster's local 2-means split to ``accept(...)``, rebuild from the
    survivors and accepted children, repeat.  ``accept`` receives host
    floats (n_j, sse_j, n_a, n_b, sse2, d) and device tensors (mask, st2,
    lab2, mind2, x) and returns whether to take the split.

    With ``mesh`` every fit and assign runs on the data-parallel engine
    (every rank passes the same global ``x``; the split masks are binary
    weights, which the engine admits onto the kernels)."""
    if not 1 <= k_min <= k_max:
        raise ValueError(f"need 1 <= k_min <= k_max, got {k_min}..{k_max}")
    if config is not None:
        config = dataclasses.replace(config, k=k_min)
    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg, gen = resolve_fit_config(k_min, generator, config, dev)
    if cfg.init == "given":
        raise ValueError(
            f"{family} derives k; init='given' is not supported"
        )
    if mesh is None:
        x = as_tensor(x, dev)
    d = x.shape[1]
    cfg2 = dataclasses.replace(cfg, k=2, empty="keep")
    _fit, _assign = inner_fits(cfg, mesh, data_axis, dev)

    state = _fit(x, k_min, generator=gen,
                 config=dataclasses.replace(cfg, k=k_min))
    k = k_min
    converged = False
    rounds = 0

    def drop_empty_slots(state, k):
        """A refinement fit (empty='keep') can strand a child centroid with
        zero members when adjacent splits compete; k is this model's
        output, so dead slots are removed and the survivors re-fit once."""
        cnts = state.counts.cpu().numpy()
        if not (cnts <= 0).any():
            return state, k
        keep = np.flatnonzero(cnts > 0)
        k2 = max(1, len(keep))
        init2 = state.centroids.cpu().numpy()[keep[:k2]].astype(np.float32)
        state = _fit(x, k2, config=dataclasses.replace(cfg, k=k2),
                     init=init2)
        return state, k2

    for _ in range(max_rounds):
        if k >= k_max:
            break
        rounds += 1
        labels = state.labels.long()
        _, mind = _assign(x, state.centroids)
        # Every per-cluster stat in one reduction and one read back.
        n_js = state.counts.cpu().numpy()
        sse_js = segment_sum(mind, labels, k).cpu().numpy()
        splits: dict = {}                    # j -> (2, d) children
        for j in range(k):
            if k + len(splits) >= k_max:
                break
            n_j = float(n_js[j])
            # Don't pay a 2-means fit for a cluster the accept criterion
            # statically cannot split.
            if n_j < min_split_size:
                continue
            mask = labels == j
            sse_j = float(sse_js[j])
            st2 = _fit(x, 2, generator=gen, config=cfg2,
                       weights=mask.float())
            lab2, mind2 = _assign(x, st2.centroids)
            n_a, n_b, sse2 = torch.stack([
                (mask & (lab2 == 0)).sum().float(),
                (mask & (lab2 == 1)).sum().float(),
                torch.where(mask, mind2, 0.0).sum()]).tolist()
            if n_a < 1 or n_b < 1:
                continue          # the 2-means formed no two children
            if accept(n_j=n_j, sse_j=sse_j, n_a=n_a, n_b=n_b, sse2=sse2,
                      d=d, mask=mask, st2=st2, lab2=lab2, mind2=mind2,
                      x=x):
                splits[j] = st2.centroids.cpu().numpy()
        if not splits:
            converged = True
            break
        # Survivors keep their center; accepted splits contribute both
        # children.  One global refinement fit from these centers.
        cents = state.centroids.cpu().numpy()
        new_centers = []
        for j in range(k):
            if j in splits:
                new_centers.extend(splits[j])
            else:
                new_centers.append(cents[j])
        init = np.stack(new_centers).astype(np.float32)
        k = init.shape[0]
        state = _fit(x, k, config=dataclasses.replace(cfg, k=k), init=init)
        state, k = drop_empty_slots(state, k)

    state, k = drop_empty_slots(state, k)
    return KMeansState(
        centroids=state.centroids,
        labels=state.labels,
        inertia=state.inertia,
        n_iter=torch.tensor(rounds, dtype=torch.int32, device=dev),
        converged=torch.tensor(converged, device=dev),
        counts=state.counts,
    )


def fit_xmeans(
    x,
    k_max: int,
    *,
    k_min: int = 1,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    max_rounds: int = 16,
    mesh=None,
    data_axis: str = "data",
    device=None,
) -> KMeansState:
    """Fit X-means on ``device`` (None is the card): grow k from ``k_min``
    toward ``k_max`` by accepting BIC-improving cluster splits.

    Returns a :class:`KMeansState` whose centroids have exactly the
    discovered k rows; ``n_iter`` counts improve-structure rounds and
    ``converged`` means no split improved BIC (rather than hitting
    ``k_max`` or ``max_rounds``).  ``config.k`` is ignored; every other
    knob applies to the inner fits.  With ``mesh`` every inner fit and
    assign runs on the data-parallel engine."""
    def accept(*, n_j, sse_j, n_a, n_b, sse2, d, **_):
        parent = bic_score(n_j, d, 1, sse_j, [n_j])
        child = bic_score(n_j, d, 2, sse2, [n_a, n_b])
        return child > parent

    return _grow_k(x, k_max, k_min=k_min, generator=generator,
                   config=config, max_rounds=max_rounds, accept=accept,
                   family="x-means", min_split_size=4, mesh=mesh,
                   data_axis=data_axis, device=device)


@dataclasses.dataclass
class XMeans(NearestCentroidMixin):
    """Estimator wrapper over :func:`fit_xmeans`, on ``device`` (None is
    the card).  ``n_clusters_`` is the discovered k; ``k_max`` bounds
    it."""

    k_max: int = 16
    k_min: int = 1
    seed: int = 0
    max_rounds: int = 16
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    init: Union[str, object] = "k-means++"
    device: Optional[str] = None

    state: Optional[KMeansState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x) -> "XMeans":
        if not isinstance(self.init, str):
            raise ValueError("x-means derives k; an init array is not "
                             "accepted")
        cfg = KMeansConfig(
            k=self.k_min, init=self.init, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
        )
        self.state = fit_xmeans(x, self.k_max, k_min=self.k_min, config=cfg,
                                max_rounds=self.max_rounds,
                                device=self.device)
        return self

    @property
    def n_clusters_(self):
        return int(self.state.centroids.shape[0])

    @property
    def cluster_centers_(self):
        return self.state.centroids

    @property
    def labels_(self):
        return self.state.labels

    @property
    def inertia_(self):
        return float(self.state.inertia)
