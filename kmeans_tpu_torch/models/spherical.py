"""Spherical k-means: cosine-similarity clustering on the unit sphere.

Counterpart of ``kmeans_tpu/models/spherical.py``, the model for embedding
datasets (the GloVe-300d config of ``BASELINE.json``), where direction
matters and magnitude does not.

For unit-norm ``x`` and ``c``, ``‖x−c‖² = 2·(1−cos(x,c))``, so the
Euclidean fused sweep (:func:`kmeans_tpu_torch.ops.lloyd.lloyd_pass`: the
classic kernel K1 on the card, unchanged) already gives the cosine argmax
assignment and the per-cluster sums.  Spherical k-means differs from Lloyd
only in the update: the new centroid is the renormalized mean direction,
not the mean.  Clusters whose summed direction is ~zero keep their previous
centroid.

The reported ``inertia`` is Σ w·‖x−c‖² = Σ w·2(1−cos).

The rows are normalized a chunk at a time (:func:`normalize_rows`): each
row in f32, then rounded to the dtype the fit computes in, so no f32 copy
of all of ``x`` is made beside it (10.49 GB at the headline in bf16) and
the bits are those of a whole-array f32 normalization rounded afterwards,
as the reference makes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_dtype, as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.models.lloyd import KMeansState, best_of_n_init
from kmeans_tpu_torch.ops.distance import full_f32
from kmeans_tpu_torch.ops.lloyd import lloyd_pass, resolve_backend

__all__ = ["normalize_rows", "fit_spherical", "SphericalKMeans"]

#: Rows normalized at a time: a (65536, d) f32 block beside x and the
#: result.
NORMALIZE_CHUNK = 65536


def normalize_rows(x, *, eps: float = 1e-12,
                   dtype=torch.float32) -> torch.Tensor:
    """Unit-normalize rows in float32, then round to ``dtype`` (f32 by
    default, the reference's output); zero rows stay zero.  Works
    NORMALIZE_CHUNK rows at a time, so the only f32 temporary is one
    block."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    out = torch.empty(x.shape, dtype=as_dtype(dtype), device=x.device)
    for lo in range(0, max(x.shape[0], 1), NORMALIZE_CHUNK):
        xf = x[lo:lo + NORMALIZE_CHUNK].float()
        norms = (xf * xf).sum(dim=-1, keepdim=True).sqrt()
        out[lo:lo + NORMALIZE_CHUNK] = xf / norms.clamp_min(eps)
    return out


def _renormalize_update(centroids, sums, counts, *, eps: float = 1e-8,
                        norm_sq=None):
    """New centroid = unit-normalized sum of member directions.

    Degenerate clusters — empty, or members cancelling to ~zero sum — keep
    the old centroid (already unit-norm).  The one copy of the spherical
    update rule: the sharded engine calls it too (``norm_sq`` precomputed
    by a caller that holds only some of the columns)."""
    if norm_sq is None:
        norm_sq = (sums * sums).sum(dim=-1, keepdim=True)
    norms = norm_sq.sqrt()
    ok = (counts > 0)[:, None] & (norms > eps)
    return torch.where(ok, sums / norms.clamp_min(eps), centroids.float())


def _spherical_loop(x, centroids0, weights, tol, *, max_iter, chunk_size,
                    compute_dtype, update, backend):
    """A classic sweep (K1 on the card) and the renormalized update each
    iteration, one shift read back per iteration, then a final labelling
    sweep."""
    kw = dict(weights=weights, chunk_size=chunk_size,
              compute_dtype=compute_dtype, update=update, backend=backend,
              device=x.device)
    tol = torch.tensor(tol, dtype=torch.float32)
    c = centroids0.float()
    it, converged = 0, False
    while it < max_iter and not converged:
        _, _, sums, counts, _ = lloyd_pass(x, c, **kw)
        new_c = _renormalize_update(c, sums, counts)
        shift_sq = ((new_c - c) ** 2).sum()
        c = new_c
        it += 1
        converged = bool((shift_sq <= tol).item())
    labels, _, _, counts, inertia = lloyd_pass(x, c, **kw)
    dev = x.device
    return KMeansState(c, labels, inertia,
                       torch.tensor(it, dtype=torch.int32, device=dev),
                       torch.tensor(converged, device=dev), counts)


def fit_spherical(
    x,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    pre_normalized: bool = False,
    device=None,
) -> KMeansState:
    """Fit spherical k-means (cosine similarity) on ``device`` (None is the
    card).

    ``x`` is unit-normalized internally unless ``pre_normalized=True``.
    Returned centroids are unit-norm; ``inertia`` is Σ w·2(1−cos(x, c)).
    ``generator`` drives the init draws (default: seeded with
    ``config.seed``)."""
    dev = resolve_device(device)
    cfg = (config or KMeansConfig(k=k)).validate()
    x = as_tensor(x, dev)
    cd = torch.float32 if cfg.compute_dtype is None else as_dtype(
        cfg.compute_dtype)
    xn = x.to(cd) if pre_normalized else normalize_rows(x, dtype=cd)
    del x
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    # Seeding runs on the normalized data: k-means++ D² sampling on the
    # sphere is 2(1-cos) sampling.  Centroids (given or seeded) are
    # re-normalized onto the sphere.
    cfg, generator, c0 = resolve_fit_inputs(xn, k, generator, config, init,
                                            weights)
    c0 = normalize_rows(c0)
    backend = resolve_backend(cfg.backend, xn, k, weights=weights,
                              compute_dtype=cfg.compute_dtype)
    return _spherical_loop(
        xn, c0, weights, tol if tol is not None else cfg.tol,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        update=cfg.update, backend=backend)


@dataclasses.dataclass
class SphericalKMeans:
    """Estimator wrapper over :func:`fit_spherical` (sklearn-like surface),
    on ``device`` (None is the card)."""

    n_clusters: int = 3
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    tol: float = 1e-6
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    backend: str = "auto"
    device: Optional[str] = None

    state: Optional[KMeansState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x, weights=None) -> "SphericalKMeans":
        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        init = None if isinstance(self.init, str) else self.init
        cfg = KMeansConfig(
            k=self.n_clusters,
            init=self.init if isinstance(self.init, str) else "given",
            max_iter=self.max_iter, tol=self.tol, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
            backend=self.backend,
        )
        self.state = best_of_n_init(
            lambda gen: fit_spherical(
                x, self.n_clusters, generator=gen, config=cfg, init=init,
                weights=weights, device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev)
        return self

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

    def predict(self, x):
        from kmeans_tpu_torch.ops.distance import assign

        c = self.state.centroids
        labels, _ = assign(normalize_rows(as_tensor(x, c.device)), c,
                           chunk_size=self.chunk_size,
                           compute_dtype=self.compute_dtype,
                           device=c.device)
        return labels

    def similarity(self, x):
        """Cosine similarity of each row to every centroid: (n, k)."""
        c = self.state.centroids
        with full_f32():
            return normalize_rows(as_tensor(x, c.device)) @ c.float().T
