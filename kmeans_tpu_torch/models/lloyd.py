"""Full-batch Lloyd k-means: the flagship model.

Counterpart of ``kmeans_tpu/models/lloyd.py``.  The reference's jitted
``lax.while_loop`` becomes a Python loop over sweeps on the device:

  sweep (assign + fold) → centroid update → shift-based convergence test

The sweep is one of five flavours:

* ``"matmul"``/``"segment"``: the classic fused sweep every time;
* ``"delta"``: every ``DELTA_REFRESH``-th sweep (the first included) is the
  classic sweep and the others are incremental delta sweeps;
* ``"hamerly"``/``"yinyang"``: bound-pruned sweeps, which score only rows
  whose carried bounds cannot prove their label; every ``DELTA_REFRESH``-th
  sweep passes −1 labels and zero sums, so it scores every row and re-derives
  the bounds;
* ``"adaptive"`` (what ``"auto"`` runs from ``AUTO_MIN_ROWS`` rows up with
  ``empty="keep"``): the delta loop, which at each refresh boundary after
  the first probes or judges the yinyang flavour by the trailing period's
  measured recompute fraction.

After the loop one classic sweep gives the final labels, counts and
inertia.  The convergence test reads one scalar back per sweep.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch import obs
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.synthetic import generator_for
from kmeans_tpu_torch.device import as_dtype, as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.ops import yinyang as _yy
from kmeans_tpu_torch.ops.delta import (DELTA_REFRESH, delta_pass,
                                        resolve_delta_backend)
from kmeans_tpu_torch.ops.distance import resolve_cd
from kmeans_tpu_torch.ops.hamerly import (hamerly_pass,
                                          resolve_hamerly_backend, row_norms)
from kmeans_tpu_torch.ops.lloyd import (lloyd_pass, resolve_backend,
                                        resolve_update, weights_exact)
from kmeans_tpu_torch.ops.plan import device_plan, shape_plan
from kmeans_tpu_torch.ops.update import apply_update, reseed_empty_farthest

__all__ = ["KMeansState", "fit_lloyd", "fit_plan", "KMeans",
           "best_of_n_init"]

#: ``diag["final_flavor"]`` codes, the reference's.
_DENSE, _DELTA, _YINYANG, _HAMERLY = -1, 0, 1, 2

#: Pruned-sweep observability, the reference's families: the exact row and
#: group counters the hamerly / yinyang sweeps already count on the device,
#: stamped once per fit from the counters ``diag`` reads back at fit exit
#: (dense and delta fits stamp nothing and stay free of host syncs).
_SWEEP_RECOMPUTE_ROWS = obs.counter(
    "kmeans_tpu_sweep_recompute_rows_total",
    "Rows whose distances a pruned-exact Lloyd fit actually recomputed, "
    "summed over its sweeps (exact on-device counters; backend-"
    "independent)",
    labels=("update",),
)
_SWEEP_GROUP_FILTER_FRACTION = obs.gauge(
    "kmeans_tpu_sweep_group_filter_fraction",
    "Fraction of (recomputed row, centroid group) pairs the most recent "
    "yinyang fit's local group filter proved need no distances",
)


class KMeansState(NamedTuple):
    """Result of a fit; tensors on the fit's device."""

    centroids: torch.Tensor   # (k, d) float32
    labels: torch.Tensor      # (n,) int32
    inertia: torch.Tensor     # scalar float32 (objective at final centroids)
    n_iter: torch.Tensor      # scalar int32 (Lloyd iterations applied)
    converged: torch.Tensor   # scalar bool (shift <= tol before max_iter)
    counts: torch.Tensor      # (k,) float32 cluster sizes at final labels


def _lloyd_loop(x, centroids0, weights, tol, *, max_iter, chunk_size,
                compute_dtype, update, empty, backend, group_of=None,
                groups=None, switch_high=None, reprobe=None):
    """Returns ``(KMeansState, diag)``.  ``diag`` holds the reference's
    counters as floats: ``recompute_rows``/``rows_seen`` summed over the
    sweeps, ``group_pairs_pruned``/``group_pairs_seen`` of the yinyang group
    filter, and ``final_flavor`` (−1 dense, 0 delta, 1 yinyang, 2 hamerly:
    for ``"adaptive"`` the flavour the fit ended on); −1 where the flavour
    measures nothing.  ``"yinyang"`` and ``"adaptive"`` need ``group_of``
    and ``groups``; ``"adaptive"`` also the policy's ``switch_high`` and
    ``reprobe``."""
    kw = dict(weights=weights, chunk_size=chunk_size,
              compute_dtype=compute_dtype, backend=backend, device=x.device)
    tol = torch.tensor(tol, dtype=torch.float32)
    c = centroids0.float()
    n = x.shape[0]
    k, d = c.shape
    dev = x.device
    # Delta state: labels −1 (the sentinel) and zero sums until the first
    # sweep, which is a refresh.
    lab = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    pruned = update in ("hamerly", "yinyang", "adaptive")
    if pruned:
        # Bound state; the first sweep is a sentinel sweep, which overwrites
        # sb and the lower bounds and ignores c_cd / csq.
        rno = row_norms(x, compute_dtype=compute_dtype)
        sb = torch.zeros(n, dtype=torch.float32, device=dev)
        lower = torch.zeros((n,) if update == "hamerly" else (n, groups),
                            dtype=torch.float32, device=dev)
        c_cd = c.to(resolve_cd(compute_dtype, x.dtype))
        csq = torch.zeros(k, dtype=torch.float32, device=dev)
    flavor = {"hamerly": _HAMERLY, "yinyang": _YINYANG}.get(update, _DELTA)
    since_probe = reprobe - 1 if update == "adaptive" else 0
    # Counters stay on the device until the policy or the end of the fit
    # reads them.
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    per_rec, per_sweeps = zero, 0
    rec_t, seen_t, gp_p, gp_s = zero, 0, zero, zero
    it, converged = 0, False
    while it < max_iter and not converged:
        refresh = it % DELTA_REFRESH == 0
        if update == "adaptive":
            # The policy, judged only at refresh boundaries after period 0:
            # demote yinyang when its period recomputed more than
            # switch_high of the rows it saw; probe it again after reprobe
            # delta periods (the first judgment promotes).
            if refresh and it > 0:
                frac = (np.float32(float(per_rec))
                        / np.float32(max(per_sweeps * n, 1)))
                if flavor == _YINYANG and frac > np.float32(switch_high):
                    flavor, since_probe = _DELTA, 0
                elif flavor == _DELTA:
                    since_probe += 1
                    if since_probe >= reprobe:
                        flavor, since_probe = _YINYANG, 0
            if refresh:
                per_rec, per_sweeps = zero, 0
        if pruned and refresh:
            lab = torch.full_like(lab, -1)
            sums = torch.zeros_like(sums)
            counts = torch.zeros_like(counts)
        n_rec, n_gp = n, 0
        if flavor == _YINYANG:
            (lab, sums, counts, sb, lower, c_cd, csq, n_rec,
             n_gp) = _yy.yinyang_pass(x, c, lab, sums, counts, sb, lower,
                                      c_cd, csq, rno, group_of, **kw)
        elif flavor == _HAMERLY:
            (lab, sums, counts, sb, lower, c_cd, csq,
             n_rec) = hamerly_pass(x, c, lab, sums, counts, sb, lower, c_cd,
                                   csq, rno, **kw)
        elif update in ("delta", "adaptive") and not refresh:
            # The raw-score shortcut is safe only when min_d2 is never read;
            # the farthest-reseed policy reads it every sweep (the adaptive
            # loop runs only with empty="keep").
            lab, min_d2, sums, counts, _, _ = delta_pass(
                x, c, lab, sums, counts,
                with_mind=(empty == "farthest"), **kw)
        else:
            # The dense loop's every sweep, and the delta loop's refresh:
            # the classic fused sweep gives labels and full sums in one read.
            lab, min_d2, sums, counts, _ = lloyd_pass(
                x, c, update=update, **kw)
        new_c = apply_update(c, sums, counts)
        if empty == "farthest":
            mind = min_d2 if weights is None else torch.where(
                weights > 0, min_d2, -torch.inf)
            new_c = reseed_empty_farthest(new_c, counts, x, mind)
        shift_sq = ((new_c - c) ** 2).sum()
        c = new_c
        it += 1
        if pruned:
            per_rec = per_rec + n_rec
            per_sweeps += 1
            rec_t = rec_t + n_rec
            seen_t += n
            if flavor == _YINYANG:
                gp_p = gp_p + n_gp
                gp_s = gp_s + n_rec * groups
        converged = bool((shift_sq <= tol).item())
    # Final consistent view: labels/inertia/counts at the final centroids.
    labels, _, _, counts, inertia = lloyd_pass(x, c, update=update, **kw)
    diag = {"recompute_rows": -1.0, "rows_seen": -1.0,
            "group_pairs_pruned": -1.0, "group_pairs_seen": -1.0,
            "final_flavor": float(_DENSE)}
    if update == "delta":
        diag["final_flavor"] = float(_DELTA)
    elif pruned:
        diag.update(recompute_rows=float(rec_t), rows_seen=float(seen_t),
                    final_flavor=float(flavor))
        if update != "hamerly":
            diag.update(group_pairs_pruned=float(gp_p),
                        group_pairs_seen=float(gp_s))
    return KMeansState(
        c, labels, inertia,
        torch.tensor(it, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev), counts), diag


def _resolve_update(cfg: KMeansConfig, n: int, cd, weights):
    """``(update flavour, whether the adaptive loop engages)``: the
    reference's policy in ``fit_lloyd``/``fit_plan``.  The resolved flavour
    stays ``"delta"`` under the adaptive loop (its starting flavour)."""
    update = resolve_update(cfg.update, w_exact=weights_exact(
        cd, weights=weights))
    if update in ("hamerly", "yinyang") and cfg.empty == "farthest":
        raise ValueError(
            f"update={update!r} prunes rows from the distance pass, so no "
            "per-sweep min_d2 exists for the farthest-reseed policy; use "
            "empty='keep' or update='auto'/'delta'")
    adaptive = (cfg.update == "auto" and update == "delta"
                and cfg.empty == "keep" and n >= _yy.AUTO_MIN_ROWS)
    return update, adaptive


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
    diag: bool = False,
):
    """Fit full-batch Lloyd k-means on ``device`` (None is the card).

    ``init`` may be a (k, d) array of starting centroids (overrides
    ``config.init``) or a method name; ``generator`` drives the init draws
    (default: a generator seeded with ``config.seed``).  float64 input
    computes in f32.  ``diag=True`` returns ``(state, diag)``, ``diag`` the
    pruned-sweep counters as floats (``{"recompute_rows", "rows_seen",
    "group_pairs_pruned", "group_pairs_seen", "final_flavor"}``, −1 where
    the flavour measures nothing).  The adaptive policy's constants are read
    from :mod:`kmeans_tpu_torch.ops.yinyang` at call time."""
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    cfg, generator, centroids0 = resolve_fit_inputs(x, k, generator, config,
                                                    init, weights)
    backend = resolve_backend(cfg.backend, x, k, weights=weights,
                              compute_dtype=cfg.compute_dtype)
    update, adaptive = _resolve_update(
        cfg, x.shape[0], resolve_cd(cfg.compute_dtype, x.dtype), weights)
    loop = {}
    if update == "yinyang" or adaptive:
        if adaptive:
            update = "adaptive"
            loop.update(switch_high=_yy.AUTO_SWITCH_HIGH,
                        reprobe=_yy.AUTO_REPROBE_PERIODS)
        # Group formation is host-side numpy, once per fit, from the
        # initial centroids (deterministic given init and seed).
        group_np, groups = _yy.centroid_groups(
            centroids0.float().cpu().numpy(), cfg.yinyang_groups,
            seed=cfg.seed)
        loop.update(group_of=torch.from_numpy(group_np).to(dev),
                    groups=groups)
    state, dg = _lloyd_loop(
        x, centroids0, weights, tol if tol is not None else cfg.tol,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        update=update, empty=cfg.empty, backend=backend, **loop)
    if update in ("hamerly", "yinyang", "adaptive"):
        _SWEEP_RECOMPUTE_ROWS.labels(update=update).inc(
            max(dg["recompute_rows"], 0.0))
        if dg["group_pairs_seen"] > 0:
            _SWEEP_GROUP_FILTER_FRACTION.set(
                dg["group_pairs_pruned"] / dg["group_pairs_seen"])
    return (state, dg) if diag else state


def fit_plan(x, k: int, *, config: Optional[KMeansConfig] = None,
             weights=None, device=None) -> dict:
    """The execution plan a :func:`fit_lloyd` call with these arguments
    runs: ``{"update", "backend", "why", "delta_backend", "adaptive",
    "mode", "k_tile"}``, the resolved flavour, the classic sweep's route,
    why ``"auto"`` made that route the plain one (the kernel plan's reason:
    the CPU, or the weights veto on the card; None where the route is the
    kernels or ``"plain"`` was asked for), the incremental sweeps' route
    (``"cuda"``/``"plain"``, or None for a dense fit), whether the
    ``"auto"`` policy's runtime delta ↔ yinyang loop engages (``update``
    then stays ``"delta"``, its starting flavour), and the planner's mode
    and slice width for the flavour's sweeps
    (:func:`kmeans_tpu_torch.ops.plan.shape_plan`; both routes run them).
    Raises where :func:`fit_lloyd` would.  ``x`` needs only ``shape`` and
    ``dtype``; nothing is moved to the device."""
    cfg = (config or KMeansConfig(k=k)).validate()
    dev = resolve_device(device)
    x_dtype = as_dtype(x.dtype)
    if x_dtype == torch.float64:
        x_dtype = torch.float32
    cd = resolve_cd(cfg.compute_dtype, x_dtype)
    update, adaptive = _resolve_update(cfg, x.shape[0], cd, weights)
    backend = resolve_backend(cfg.backend, x, k, weights=weights,
                              compute_dtype=cfg.compute_dtype, device=dev)
    why = None
    if backend == "plain" and cfg.backend == "auto":
        why = device_plan("classic", x, k, weights=weights,
                          compute_dtype=cfg.compute_dtype, device=dev).why
    delta_backend = None
    resolver = {"delta": resolve_delta_backend,
                "hamerly": resolve_hamerly_backend,
                "yinyang": _yy.resolve_yinyang_backend}.get(update)
    if resolver is not None:
        _, delta_backend = resolver(cfg.backend, x, k, weights=weights,
                                    compute_dtype=cfg.compute_dtype,
                                    device=dev)
    kind = update if update in ("delta", "hamerly", "yinyang") else "classic"
    groups = None
    if kind == "yinyang":
        groups = (cfg.yinyang_groups if cfg.yinyang_groups is not None
                  else _yy.default_groups(k))
    shape = shape_plan(kind, x, k, compute_dtype=cfg.compute_dtype,
                       groups=groups, device=dev)
    return {"update": update, "backend": backend, "why": why,
            "delta_backend": delta_backend, "adaptive": adaptive,
            "mode": shape.mode, "k_tile": shape.k_tile}


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
    on ``device`` (None is the card).  ``diag_`` holds the kept fit's
    pruned-sweep counters.

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
    #: The kept fit's ``fit_lloyd(..., diag=True)`` counters.
    diag_: Optional[dict] = dataclasses.field(
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
        self.state, self.diag_ = best_of_n_init(
            lambda gen: fit_lloyd(x, self.n_clusters, generator=gen,
                                  config=self._config(), init=init,
                                  weights=weights, device=dev, diag=True),
            self.seed, n_init, device=dev,
            score=lambda fit: float(fit[0].inertia))
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
