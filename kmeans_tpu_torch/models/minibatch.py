"""Minibatch k-means (Sculley 2010) and the nested-prefix ladder.

Counterpart of ``kmeans_tpu/models/minibatch.py``.  Per step, one sampled
batch is assigned against the current centroids and each touched centroid
moves toward the batch mean with the per-centre rate 1/n_seen: the
streaming average.  :func:`batch_stats` is plain PyTorch on either route,
as the reference's runs outside its kernels: the product in the compute
dtype with f32 accumulation (:func:`~kmeans_tpu_torch.ops.distance.
cd_product`), the lowest-index argmin, and the per-cluster folds.  A final
full-data sweep (:func:`~kmeans_tpu_torch.ops.lloyd.lloyd_pass`: K1 on the
card) gives consistent labels and inertia.

The draws come from one :class:`torch.Generator` on the data's device, in
this order (the reference folds JAX keys; tests replay this order):

1. seeding, when ``init`` is a method: ``randperm(n)[:sub]`` picks the
   subsample (only if ``sub = min(n, max(4·k·16, 65536)) < n``), then the
   init method's own draws on it;
2. one ``randint(0, n, (batch_size,))`` per step, in step order.

Without early stopping the loop enqueues its steps with no host sync; with
``tol`` or ``max_no_improvement`` it reads one flag per step.

``schedule="nested"`` runs :func:`nested_ladder` and finishes with
``fit_lloyd`` (Nested Mini-Batch K-Means): exact Lloyd sweeps on doubling
row prefixes ``x[:b]`` (views, no copy), each promoted once its centroid
shift falls under the prefix's sampling noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.synthetic import generator_for
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import init_centroids, resolve_fit_config
from kmeans_tpu_torch.models.lloyd import (KMeansState, NearestCentroidMixin,
                                           best_of_n_init, fit_lloyd)
from kmeans_tpu_torch.ops.distance import (assign, cd_product, resolve_cd,
                                           sq_norms)
from kmeans_tpu_torch.ops.lloyd import lloyd_pass, resolve_backend
from kmeans_tpu_torch.ops.update import apply_update

__all__ = ["fit_minibatch", "MiniBatchKMeans", "batch_update",
           "batch_stats", "apply_batch_stats", "nested_ladder"]


def batch_stats(centroids, xb, *, compute_dtype, row_weight=None):
    """Per-cluster ``(counts, sums, inertia)`` of one batch against fixed
    centroids, the additive half of :func:`batch_update`.  ``row_weight``
    (scalar or (b,)) scales every contribution.

    The folds are ``index_put_(accumulate=True)``, which on the card sums
    each cluster's rows in row order (``index_add_`` there scatters with
    float atomics, whose order, and so whose last bits, vary from run to
    run)."""
    f32 = torch.float32
    cd = resolve_cd(compute_dtype, xb.dtype)
    k, d = centroids.shape
    part = sq_norms(centroids)[None, :] - 2.0 * cd_product(xb, centroids, cd)
    labels = torch.argmin(part, dim=1)
    mind = torch.clamp_min(part.min(dim=1).values + sq_norms(xb), 0.0)
    b = xb.shape[0]
    w = (torch.ones(b, dtype=f32, device=xb.device) if row_weight is None
         else torch.as_tensor(row_weight, dtype=f32,
                              device=xb.device).expand(b))
    b_inertia = (mind * w).sum()
    bc = torch.zeros(k, dtype=f32, device=xb.device).index_put_(
        (labels,), w, accumulate=True)
    bs = torch.zeros(k, d, dtype=f32, device=xb.device).index_put_(
        (labels,), xb.float() * w[:, None], accumulate=True)
    return bc, bs, b_inertia


def apply_batch_stats(centroids, n_seen, bc, bs):
    """The streaming-average update from reduced batch stats:
    ``c += (batch_sum − batch_count·c) / n_seen_total`` per touched centre.
    Returns ``(new_centroids, n_seen_after, shift_sq)``."""
    n_after = n_seen + bc
    delta = (bs - bc[:, None] * centroids) / torch.clamp_min(
        n_after, 1.0)[:, None]
    step = torch.where((bc > 0)[:, None], delta, 0.0)
    return centroids + step, n_after, (step ** 2).sum()


def batch_update(centroids, n_seen, xb, *, compute_dtype):
    """One Sculley streaming-average update: assign the batch, then move
    each touched centroid toward the batch mean at rate 1/n_seen_total.
    Returns ``(new_centroids, n_seen_after, shift_sq, batch_inertia)``, the
    batch inertia measured at the centroids before the update."""
    bc, bs, b_inertia = batch_stats(centroids, xb,
                                    compute_dtype=compute_dtype)
    new_c, n_after, shift_sq = apply_batch_stats(centroids, n_seen, bc, bs)
    return new_c, n_after, shift_sq, b_inertia


# ---------------------------------------------------------------------------
# Nested mini-batch scheduling
# ---------------------------------------------------------------------------

def _nested_rung_loop(xb, c0, tol, *, max_iter, chunk_size, compute_dtype,
                      backend):
    """One ladder rung: exact Lloyd sweeps over the prefix ``xb`` until the
    squared centroid shift falls under the rung's sampling noise floor,
    ``k·inertia/b²`` (or ``tol`` / ``max_iter``).  Each sweep recomputes
    the means over the whole prefix, every row counted once: the paper's
    reuse-bias-corrected update.  Returns ``(c, iterations)``; reads one
    flag per sweep."""
    b = xb.shape[0]
    k = c0.shape[0]
    kw = dict(chunk_size=chunk_size, compute_dtype=compute_dtype,
              update="matmul", backend=backend, device=xb.device)
    # The reference's static float coefficient (b² overflows int32 at 64k).
    coef = float(k) / (float(b) * float(b))
    c = c0.float()
    it, done = 0, False
    while it < max_iter and not done:
        _, _, sums, counts, f_c = lloyd_pass(xb, c, **kw)
        tc = apply_update(c, sums, counts)
        shift_sq = ((tc - c) ** 2).sum()
        floor = f_c * coef
        c = tc
        it += 1
        done = bool((shift_sq <= torch.maximum(tol, floor)).item())
    return c, it


def nested_ladder(x, c0, *, tol, start=8192, chunk_size=4096,
                  compute_dtype=None, backend="auto", max_iter=100,
                  device=None):
    """The doubling nested-prefix ladder on ``device`` (None is the card);
    returns ``(c, ladder_iters, rungs)``: the warmed centroids, the total
    rung iterations and the per-rung ``[(rows, iterations), …]`` record.

    Rungs run on ``x[:b]`` for b = start, 2·start, … while b < n; the first
    is floored at 64·k rows, and when 64·k ≥ n the ladder is empty.  Rows
    should be in random order, as a prefix is the sample.  A ``"cuda"``
    request, resolved at the full shape, is handed down as ``"auto"`` so
    each prefix resolves at its own shape (the reference's idiom)."""
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    n = x.shape[0]
    k = c0.shape[0]
    b = int(min(max(1, int(start), 64 * k), n))
    rung_backend = "auto" if backend == "cuda" else backend
    c = as_tensor(c0, dev, torch.float32)
    tol_v = torch.tensor(tol, dtype=torch.float32, device=dev)
    total = 0
    rungs = []
    while b < n:
        c, it = _nested_rung_loop(
            x[:b], c, tol_v, max_iter=max_iter, chunk_size=chunk_size,
            compute_dtype=compute_dtype, backend=rung_backend)
        rungs.append((b, it))
        total += it
        b = min(2 * b, n)
    return c, total, rungs


def _minibatch_loop(x, centroids0, generator, *, batch_size, steps,
                    chunk_size, compute_dtype, backend, tol=None,
                    max_no_improvement=None):
    """The Sculley loop and the final full-data sweep.  Early stopping
    (sklearn's semantics) stops when the centroid shift reaches ``tol`` or
    when the EWA of batch inertia fails to improve ``max_no_improvement``
    steps running; ``steps`` stays the cap."""
    n = x.shape[0]
    k = centroids0.shape[0]
    dev = x.device
    f32 = torch.float32
    c = centroids0.float()
    n_seen = torch.zeros(k, dtype=f32, device=dev)

    def one_batch(c, n_seen):
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=dev)
        return batch_update(c, n_seen, x[idx], compute_dtype=compute_dtype)

    if tol is None and max_no_improvement is None:
        shift_sq = None
        for _ in range(steps):
            c, n_seen, shift_sq, _ = one_batch(c, n_seen)
        # "converged" only in the degenerate no-movement case.
        converged = (shift_sq <= 0.0 if shift_sq is not None
                     else torch.tensor(False, device=dev))
        n_steps = steps
    else:
        tol_v = torch.tensor(-1.0 if tol is None else tol, dtype=f32,
                             device=dev)
        mni = 0 if max_no_improvement is None else int(max_no_improvement)
        alpha = torch.tensor(min(1.0, batch_size * 2.0 / (n + 1)),
                             dtype=f32, device=dev)
        best = torch.full((), float("inf"), dtype=f32, device=dev)
        stale = torch.zeros((), dtype=torch.int32, device=dev)
        ewa = None
        n_steps, done = 0, False
        while n_steps < steps and not done:
            c, n_seen, shift_sq, b_inertia = one_batch(c, n_seen)
            ewa = (b_inertia if ewa is None
                   else ewa * (1.0 - alpha) + b_inertia * alpha)
            improved = ewa < best
            best = torch.minimum(best, ewa)
            stale = torch.where(improved, 0, stale + 1).to(torch.int32)
            flag = shift_sq <= tol_v
            if mni > 0:
                flag = flag | (stale >= mni)
            n_steps += 1
            done = bool(flag.item())
        converged = torch.tensor(done, device=dev)
    labels, _, _, counts, inertia = lloyd_pass(
        x, c, chunk_size=chunk_size, compute_dtype=compute_dtype,
        backend=backend, device=dev)
    return KMeansState(c, labels, inertia,
                       torch.tensor(n_steps, dtype=torch.int32, device=dev),
                       converged, counts)


def fit_minibatch(
    x,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    batch_size: Optional[int] = None,
    steps: Optional[int] = None,
    tol: Optional[float] = None,
    max_no_improvement: Optional[int] = None,
    schedule: Optional[str] = None,
    return_ladder: bool = False,
    device=None,
):
    """Fit minibatch k-means on ``device`` (None is the card); see the
    module docstring for the update rule and the order of the draws.

    ``generator`` (default: one seeded with ``config.seed``) drives every
    draw.  ``tol`` and ``max_no_improvement`` turn on early stopping; both
    default to off, so ``steps`` is exact.  ``schedule`` (default
    ``config.schedule``): ``"full"`` is the Sculley loop; ``"nested"`` runs
    :func:`nested_ladder` and finishes with ``fit_lloyd`` to ``tol``, and
    refuses the Sculley knobs (``steps``, ``batch_size``,
    ``max_no_improvement``).  ``return_ladder=True`` returns
    ``(state, rungs)``, the ladder's ``[(rows, iterations), …]`` (empty
    under ``"full"``)."""
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    cfg, gen = resolve_fit_config(k, generator, config, dev)
    schedule = schedule if schedule is not None else cfg.schedule
    if schedule not in ("full", "nested"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "nested" and (steps is not None or batch_size is not None
                                 or max_no_improvement is not None):
        raise ValueError(
            "steps/batch_size/max_no_improvement drive the Sculley "
            "streaming loop; schedule='nested' is ladder-paced (it "
            "promotes on the sampling noise floor and finishes full-batch "
            "to tol) — drop them or use schedule='full'")
    if init is not None and not isinstance(init, str):
        centroids0 = as_tensor(init, dev, torch.float32)
        if tuple(centroids0.shape) != (k, x.shape[1]):
            raise ValueError(f"init centroids shape "
                             f"{tuple(centroids0.shape)} != {(k, x.shape[1])}")
    else:
        method = init if isinstance(init, str) else cfg.init
        if method == "given":
            raise ValueError("init='given' needs an explicit (k, d) array")
        # Seed on a subsample for speed at large n.
        n = x.shape[0]
        sub = min(n, max(4 * k * 16, 65536))
        xs = x
        if sub < n:
            xs = x[torch.randperm(n, generator=gen, device=dev)[:sub]]
        centroids0 = init_centroids(gen, xs, k, method=method,
                                    compute_dtype=cfg.compute_dtype,
                                    chunk_size=cfg.chunk_size)
        del xs
    backend = resolve_backend(cfg.backend, x, k,
                              compute_dtype=cfg.compute_dtype)
    if schedule == "nested":
        tol_f = float(tol if tol is not None else cfg.tol)
        c_warm, ladder_iters, rungs = nested_ladder(
            x, centroids0, tol=tol_f, start=cfg.nested_start,
            chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
            backend=backend, max_iter=cfg.max_iter, device=dev)
        # The full-batch finish through fit_lloyd (the delta or adaptive
        # loop under the default update="auto"), from the ladder's output.
        state = fit_lloyd(x, k, generator=gen, config=cfg, init=c_warm,
                          tol=tol_f, device=dev)
        state = state._replace(n_iter=state.n_iter + ladder_iters)
        return (state, rungs) if return_ladder else state
    state = _minibatch_loop(
        x, centroids0, gen,
        batch_size=batch_size if batch_size is not None else cfg.batch_size,
        steps=steps if steps is not None else cfg.steps,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        backend=backend, tol=tol, max_no_improvement=max_no_improvement)
    return (state, []) if return_ladder else state


@dataclasses.dataclass
class MiniBatchKMeans(NearestCentroidMixin):
    """Estimator over :func:`fit_minibatch` on ``device`` (None is the
    card); ``backend`` selects the final sweep's route."""

    n_clusters: int = 8
    init: Union[str, object] = "k-means++"
    batch_size: int = 8192
    steps: int = 200
    seed: int = 0
    n_init: int = 1
    tol: Optional[float] = None
    max_no_improvement: Optional[int] = None
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    backend: str = "auto"
    device: Optional[str] = None

    state: Optional[KMeansState] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: Lifetime per-centre sample counts driving partial_fit's 1/n rates
    #: (sklearn's ``_counts``); distinct from ``state.counts``.
    _n_seen: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x) -> "MiniBatchKMeans":
        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        cfg = KMeansConfig(
            k=self.n_clusters,
            init=self.init if isinstance(self.init, str) else "given",
            seed=self.seed,
            chunk_size=self.chunk_size,
            compute_dtype=self.compute_dtype,
            batch_size=self.batch_size,
            steps=self.steps,
            backend=self.backend,
        )
        init = None if isinstance(self.init, str) else self.init
        self.state = best_of_n_init(
            lambda gen: fit_minibatch(
                x, self.n_clusters, generator=gen, config=cfg, init=init,
                tol=self.tol, max_no_improvement=self.max_no_improvement,
                device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev)
        # A later partial_fit rescales from this fit's counts.
        self._n_seen = None
        return self

    def partial_fit(self, x) -> "MiniBatchKMeans":
        """One streaming-average update on one batch (sklearn's
        ``partial_fit``).  The first call seeds the centroids from this
        batch (the init method with a generator seeded by ``seed``, or the
        given array); every later call applies one :func:`batch_update`.
        ``labels_`` / ``inertia_`` then describe this batch at the updated
        centroids.  After ``fit``, the lifetime rates resume from the
        samples the fit processed (``steps × batch_size``, apportioned by
        cluster mass), not the full-data cluster sizes."""
        dev = resolve_device(self.device)
        xb = as_tensor(x, dev)
        k = self.n_clusters
        if self.state is None:
            if isinstance(self.init, str):
                c = init_centroids(generator_for(self.seed, dev), xb, k,
                                   method=self.init,
                                   compute_dtype=self.compute_dtype,
                                   chunk_size=self.chunk_size)
            else:
                c = as_tensor(self.init, dev, torch.float32)
                if tuple(c.shape) != (k, xb.shape[1]):
                    raise ValueError(f"init centroids shape "
                                     f"{tuple(c.shape)} != {(k, xb.shape[1])}")
            n_seen = torch.zeros(k, dtype=torch.float32, device=dev)
            n_steps = 0
        else:
            c = self.state.centroids
            n_steps = int(self.state.n_iter)
            if self._n_seen is not None:
                n_seen = self._n_seen
            else:
                total = torch.clamp_min(self.state.counts.sum(), 1.0)
                processed = float(n_steps) * float(self.batch_size)
                n_seen = self.state.counts * (processed / total)
        new_c, n_after, _, _ = batch_update(c, n_seen, xb,
                                            compute_dtype=self.compute_dtype)
        labels, mind = assign(xb, new_c, chunk_size=self.chunk_size,
                              compute_dtype=self.compute_dtype,
                              backend=self.backend, device=dev)
        self._n_seen = n_after
        self.state = KMeansState(
            centroids=new_c, labels=labels, inertia=mind.sum(),
            n_iter=torch.tensor(n_steps + 1, dtype=torch.int32, device=dev),
            converged=torch.tensor(False, device=dev), counts=n_after)
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
