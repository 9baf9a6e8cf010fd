"""Full-batch Lloyd k-means: the flagship model.

Counterpart of ``kmeans_tpu/models/lloyd.py``.  The reference's jitted
``lax.while_loop`` becomes a Python loop over sweeps on the device:

  sweep (assign + fold) → centroid update → shift-based convergence test

With ``update="delta"`` every ``DELTA_REFRESH``-th sweep (the first
included) is the classic fused sweep and the others are incremental delta
sweeps; after the loop one classic sweep gives the final labels, counts
and inertia.  The convergence test reads one scalar back per sweep.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.synthetic import generator_for
from kmeans_tpu_torch.device import as_dtype, as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.ops.delta import (DELTA_REFRESH, delta_pass,
                                        resolve_delta_backend)
from kmeans_tpu_torch.ops.distance import resolve_cd
from kmeans_tpu_torch.ops.lloyd import (lloyd_pass, resolve_backend,
                                        resolve_update, weights_exact)
from kmeans_tpu_torch.ops.update import apply_update, reseed_empty_farthest

__all__ = ["KMeansState", "fit_lloyd", "fit_plan", "KMeans",
           "best_of_n_init", "AUTO_MIN_ROWS"]

#: The reference's ``ops/yinyang.AUTO_MIN_ROWS``: from this many rows up,
#: ``update="auto"`` with ``empty="keep"`` runs the adaptive delta↔yinyang
#: loop, which needs the Hamerly kernel this port does not have yet.
AUTO_MIN_ROWS = 16384

_LATER_SLICE = ("ROADMAP.md, queue B item 1: the Hamerly kernel with "
                "ops/hamerly.py, ops/yinyang.py and the adaptive 'auto' loop")


class KMeansState(NamedTuple):
    """Result of a fit; tensors on the fit's device."""

    centroids: torch.Tensor   # (k, d) float32
    labels: torch.Tensor      # (n,) int32
    inertia: torch.Tensor     # scalar float32 (objective at final centroids)
    n_iter: torch.Tensor      # scalar int32 (Lloyd iterations applied)
    converged: torch.Tensor   # scalar bool (shift <= tol before max_iter)
    counts: torch.Tensor      # (k,) float32 cluster sizes at final labels


def _lloyd_loop(x, centroids0, weights, tol, *, max_iter, chunk_size,
                compute_dtype, update, empty, backend) -> KMeansState:
    kw = dict(weights=weights, chunk_size=chunk_size,
              compute_dtype=compute_dtype, backend=backend, device=x.device)
    tol = torch.tensor(tol, dtype=torch.float32)

    def reseed(new_c, counts, min_d2):
        if empty != "farthest":
            return new_c
        mind = min_d2 if weights is None else torch.where(
            weights > 0, min_d2, -torch.inf)
        return reseed_empty_farthest(new_c, counts, x, mind)

    c = centroids0.float()
    n = x.shape[0]
    k, d = c.shape
    # Delta state: labels −1 (the sentinel) and zero sums until the first
    # sweep, which is a refresh.
    lab = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    sums = torch.zeros(k, d, dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    it, converged = 0, False
    while it < max_iter and not converged:
        if update == "delta" and it % DELTA_REFRESH != 0:
            # The raw-score shortcut is safe only when min_d2 is never read;
            # the farthest-reseed policy reads it every sweep.
            lab, min_d2, sums, counts, _, _ = delta_pass(
                x, c, lab, sums, counts,
                with_mind=(empty == "farthest"), **kw)
        else:
            # The dense loop's every sweep, and the delta loop's refresh:
            # the classic fused sweep gives labels and full sums in one read.
            lab, min_d2, sums, counts, _ = lloyd_pass(
                x, c, update=update, **kw)
        new_c = reseed(apply_update(c, sums, counts), counts, min_d2)
        shift_sq = ((new_c - c) ** 2).sum()
        c = new_c
        it += 1
        converged = bool((shift_sq <= tol).item())
    # Final consistent view: labels/inertia/counts at the final centroids.
    labels, _, _, counts, inertia = lloyd_pass(x, c, update=update, **kw)
    return KMeansState(
        c, labels, inertia,
        torch.tensor(it, dtype=torch.int32, device=x.device),
        torch.tensor(converged, device=x.device), counts)


def _resolve_update(cfg: KMeansConfig, n: int, cd, weights) -> str:
    """The update flavour a fit runs, raising where this slice has none."""
    update = resolve_update(cfg.update, w_exact=weights_exact(
        cd, weights=weights))
    if update in ("hamerly", "yinyang"):
        raise NotImplementedError(
            f"update={update!r} is not ported yet ({_LATER_SLICE})")
    if (cfg.update == "auto" and update == "delta" and cfg.empty == "keep"
            and n >= AUTO_MIN_ROWS):
        raise NotImplementedError(
            f"update='auto' at n >= {AUTO_MIN_ROWS} runs the adaptive "
            f"delta/yinyang loop, which is not ported yet ({_LATER_SLICE}); "
            "pass update='delta' for the incremental loop")
    return update


def fit_lloyd(
    x,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    device=None,
) -> KMeansState:
    """Fit full-batch Lloyd k-means on ``device`` (None is the card).

    ``init`` may be a (k, d) array of starting centroids (overrides
    ``config.init``) or a method name; ``generator`` drives the init draws
    (default: a generator seeded with ``config.seed``).  float64 input
    computes in f32.  ``update`` values this slice does not have
    (``"hamerly"``, ``"yinyang"``, and ``"auto"`` where the reference would
    run its adaptive loop) raise :class:`NotImplementedError`."""
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    cfg, generator, centroids0 = resolve_fit_inputs(x, k, generator, config,
                                                    init, weights)
    backend = resolve_backend(cfg.backend, x, k, weights=weights,
                              compute_dtype=cfg.compute_dtype)
    update = _resolve_update(cfg, x.shape[0],
                             resolve_cd(cfg.compute_dtype, x.dtype), weights)
    return _lloyd_loop(
        x, centroids0, weights, tol if tol is not None else cfg.tol,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        update=update, empty=cfg.empty, backend=backend)


def fit_plan(x, k: int, *, config: Optional[KMeansConfig] = None,
             weights=None, device=None) -> dict:
    """The execution plan a :func:`fit_lloyd` call with these arguments
    runs: ``{"update", "backend", "delta_backend", "adaptive"}``, the
    resolved flavour, the classic sweep's route, the delta sweeps' route
    (``"cuda"``/``"plain"``, or None for a dense fit) and whether the
    adaptive loop engages (never: that raises here, as :func:`fit_lloyd`
    does).  ``x`` needs only ``shape`` and ``dtype``; nothing is moved to
    the device."""
    cfg = (config or KMeansConfig(k=k)).validate()
    dev = resolve_device(device)
    x_dtype = as_dtype(x.dtype)
    if x_dtype == torch.float64:
        x_dtype = torch.float32
    cd = resolve_cd(cfg.compute_dtype, x_dtype)
    update = _resolve_update(cfg, x.shape[0], cd, weights)
    backend = resolve_backend(cfg.backend, x, k, weights=weights,
                              compute_dtype=cfg.compute_dtype, device=dev)
    delta_backend = None
    if update == "delta":
        _, delta_backend = resolve_delta_backend(
            cfg.backend, x, k, weights=weights,
            compute_dtype=cfg.compute_dtype, device=dev)
    return {"update": update, "backend": backend,
            "delta_backend": delta_backend, "adaptive": False}


def restart_generator(seed: int, i: int, device) -> torch.Generator:
    """Restart ``i``'s generator: ``seed`` itself for restart 0 (so one
    restart reproduces a plain fit seeded with ``seed``), else a seed
    derived from ``(seed, i)``."""
    if i:
        seed = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
    return generator_for(seed, device)


def best_of_n_init(fit_one, seed: int, n_init: int, *, device,
                   score=lambda s: float(s.inertia)):
    """Run ``fit_one(generator_i)`` for ``n_init`` independently seeded
    generators and keep the lowest-``score`` state (sklearn's n_init)."""
    if n_init < 1:
        raise ValueError(f"n_init must be >= 1, got {n_init}")
    best = best_score = None
    for i in range(n_init):
        state = fit_one(restart_generator(seed, i, device))
        s = score(state)
        # A NaN score (e.g. bf16 overflow) must never shadow a finite one.
        if best is None or math.isnan(best_score) or s < best_score:
            best, best_score = state, s
    return best


class NearestCentroidMixin:
    """``predict``/``transform``/``score`` for an estimator carrying
    ``state.centroids``, ``chunk_size``, ``compute_dtype`` and ``device``."""

    def predict(self, x):
        from kmeans_tpu_torch.ops.distance import assign

        labels, _ = assign(x, self.state.centroids,
                           chunk_size=self.chunk_size,
                           compute_dtype=self.compute_dtype,
                           device=self.state.centroids.device)
        return labels

    def transform(self, x):
        from kmeans_tpu_torch.ops.distance import pairwise_sq_dists

        c = self.state.centroids
        return torch.sqrt(pairwise_sq_dists(
            as_tensor(x, c.device), c, compute_dtype=self.compute_dtype))

    def score(self, x):
        from kmeans_tpu_torch.ops.distance import assign

        _, mind = assign(x, self.state.centroids, chunk_size=self.chunk_size,
                         compute_dtype=self.compute_dtype,
                         device=self.state.centroids.device)
        return -float(mind.sum())


@dataclasses.dataclass
class KMeans(NearestCentroidMixin):
    """Estimator-style wrapper (sklearn-like surface) over :func:`fit_lloyd`,
    on ``device`` (None is the card).

    >>> km = KMeans(n_clusters=3, seed=0, device="cpu").fit(x)
    >>> km.labels_, km.cluster_centers_, km.inertia_
    """

    n_clusters: int = 3
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    tol: float = 1e-4
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    update: str = "auto"
    yinyang_groups: Optional[int] = None
    empty: str = "keep"
    backend: str = "auto"
    device: Optional[str] = None

    state: Optional[KMeansState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _config(self) -> KMeansConfig:
        return KMeansConfig(
            k=self.n_clusters,
            init=self.init if isinstance(self.init, str) else "given",
            max_iter=self.max_iter,
            tol=self.tol,
            seed=self.seed,
            chunk_size=self.chunk_size,
            compute_dtype=self.compute_dtype,
            update=self.update,
            yinyang_groups=self.yinyang_groups,
            empty=self.empty,
            backend=self.backend,
        )

    def fit(self, x, weights=None) -> "KMeans":
        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        init = None if isinstance(self.init, str) else self.init
        # An explicit centroid array makes restarts identical — run once.
        n_init = 1 if init is not None else self.n_init
        self.state = best_of_n_init(
            lambda gen: fit_lloyd(x, self.n_clusters, generator=gen,
                                  config=self._config(), init=init,
                                  weights=weights, device=dev),
            self.seed, n_init, device=dev)
        return self

    def fit_predict(self, x, weights=None):
        return self.fit(x, weights=weights).labels_

    def fit_transform(self, x, weights=None):
        return self.fit(x, weights=weights).transform(x)

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
