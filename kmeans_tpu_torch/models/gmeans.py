"""G-means: automatic k via Gaussianity testing (Hamerly & Elkan, NIPS 2003).

Counterpart of ``kmeans_tpu/models/gmeans.py``, the statistical sibling of
:mod:`kmeans_tpu_torch.models.xmeans`: each cluster's 2-means split is kept
only if the cluster's points, projected onto the axis joining the two child
centers, fail an Anderson-Darling test of normality.  Shares the
improve-params / improve-structure loop with x-means (``_grow_k``); only
the accept criterion differs.  The projection z = x·v/|v| is one f32
matrix–vector product on the device (IEEE f32, no TF32); the statistic runs
on the host over the member values, with ``torch.special.ndtr`` in f64 for
the normal CDF (the reference's ``jax.scipy.special.ndtr``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.models.bisecting import ROW_BLOCK, host_rows
from kmeans_tpu_torch.models.lloyd import KMeansState, NearestCentroidMixin
from kmeans_tpu_torch.models.xmeans import _grow_k
from kmeans_tpu_torch.ops.distance import full_f32

__all__ = ["fit_gmeans", "anderson_darling_normal", "GMeans", "AD_CRITICAL"]

#: Critical values of the A² statistic with estimated mean/variance
#: (Stephens 1974, case 3).  Reject normality (=> accept the split) when
#: the corrected statistic exceeds the value at the chosen significance.
AD_CRITICAL = {0.10: 0.631, 0.05: 0.752, 0.025: 0.873, 0.01: 1.035}


def anderson_darling_normal(z) -> float:
    """Corrected Anderson-Darling A²* statistic of ``z`` against a normal
    with estimated mean/variance (Stephens' small-sample correction
    ``A²·(1 + 4/n − 25/n²)``).  Larger = less normal.  Degenerate samples
    (n < 8 or zero variance) return 0.0, so callers never split on them."""
    z = np.sort(np.asarray(z, np.float64))
    n = z.size
    if n < 8:
        return 0.0
    sd = z.std(ddof=1)
    if sd <= 0:
        return 0.0
    u = (z - z.mean()) / sd
    # Clipped away from {0, 1} so the logs stay finite.
    cdf = torch.special.ndtr(torch.from_numpy(u)).numpy()
    cdf = np.clip(cdf, 1e-12, 1.0 - 1e-12)
    i = np.arange(1, n + 1)
    a2 = -n - np.mean((2 * i - 1) * (np.log(cdf) + np.log(1 - cdf[::-1])))
    return float(a2 * (1.0 + 4.0 / n - 25.0 / (n * n)))


def fit_gmeans(
    x,
    k_max: int,
    *,
    k_min: int = 1,
    alpha: float = 0.01,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    max_rounds: int = 16,
    mesh=None,
    data_axis: str = "data",
    device=None,
) -> KMeansState:
    """Fit G-means on ``device`` (None is the card): grow k while any
    cluster's split-axis projection fails the Anderson-Darling normality
    test at significance ``alpha`` (one of ``AD_CRITICAL``'s keys).  Same
    contract as :func:`~kmeans_tpu_torch.models.xmeans.fit_xmeans`
    otherwise."""
    if alpha not in AD_CRITICAL:
        raise ValueError(
            f"alpha must be one of {sorted(AD_CRITICAL)}, got {alpha}"
        )
    crit = AD_CRITICAL[alpha]

    def accept(*, mask, st2, x, **_):
        v = st2.centroids[1] - st2.centroids[0]
        vnorm = float((v * v).sum().sqrt())
        if vnorm <= 1e-12:
            return False                # children coincide: nothing to split
        # The projection of the member rows only, a block at a time: x may
        # be host data on a mesh.
        parts = []
        for lo in range(0, x.shape[0], ROW_BLOCK):
            xb = host_rows(x, lo, lo + ROW_BLOCK, v.device).float()
            with full_f32():
                z = (xb @ v) / vnorm
            parts.append(z[mask[lo:lo + ROW_BLOCK]])
        members = torch.cat(parts).cpu().numpy()
        return anderson_darling_normal(members) > crit

    # min_split_size=8: anderson_darling_normal returns 0.0 below 8
    # samples, so smaller clusters can never be split.
    return _grow_k(x, k_max, k_min=k_min, generator=generator,
                   config=config, max_rounds=max_rounds, accept=accept,
                   family="g-means", mesh=mesh, data_axis=data_axis,
                   min_split_size=8, device=device)


@dataclasses.dataclass
class GMeans(NearestCentroidMixin):
    """Estimator wrapper over :func:`fit_gmeans` (``n_clusters_`` is the
    discovered k), on ``device`` (None is the card)."""

    k_max: int = 16
    k_min: int = 1
    alpha: float = 0.01
    seed: int = 0
    max_rounds: int = 16
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    init: str = "k-means++"
    device: Optional[str] = None

    state: Optional[KMeansState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x) -> "GMeans":
        cfg = KMeansConfig(
            k=self.k_min, init=self.init, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
        )
        self.state = fit_gmeans(x, self.k_max, k_min=self.k_min,
                                alpha=self.alpha, config=cfg,
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
