"""The drift-aware continuous clustering loop.

Counterpart of ``kmeans_tpu/continuous/pipeline.py``.  Per batch: (1) score
the incoming batch against the served model (per-point inertia, the drift
signal: K1 on the card), (2) push it into the sliding window (which
coreset-compacts itself, ``continuous.compact``), (3) let the
:class:`~kmeans_tpu_torch.continuous.drift.DriftMonitor` vote, and (4) when
drift fires, the schedule comes due or no model exists yet, run a partial
refit (warm-start weighted Lloyd on the window, ``continuous.refit``: K1
and K2 on the card) and publish it to the
:class:`~kmeans_tpu_torch.continuous.registry.ModelRegistry`
(persist-then-swap, ``registry.swap``), which ``cli serve --model-dir``
hot-swaps into ``/api/assign``.

Partial refits warm-start from the current centroids with
``empty="farthest"`` reseeding, so centres stranded by a drifted cluster
are replanted in the worst-fit mass.  The initial (and any from-scratch)
refit seeds with k-means++ from a :class:`torch.Generator` seeded with
``(seed << 8) ^ (batch index or 1)``, the integer the reference feeds
``jax.random.key``.

Recovery: every publish checkpoints the model and the pipeline's resume
state (window snapshot, drift-detector state, stream position, compaction
sequence) in the reference's format, so ``resume=True`` restores the last
verified generation (of either package) and replays the stream from its
recorded position.  SIGTERM / SIGINT latch a
:class:`~kmeans_tpu_torch.utils.preempt.PreemptionGuard`; the loop notices
at the batch boundary, publishes a final ``preempt`` generation with the
exact stream position and raises
:class:`~kmeans_tpu_torch.utils.preempt.Preempted`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional, Union

import numpy as np

from kmeans_tpu_torch.continuous.drift import DriftMonitor
from kmeans_tpu_torch.continuous.registry import Generation, ModelRegistry
from kmeans_tpu_torch.continuous.window import SlidingWindow
from kmeans_tpu_torch.obs import counter as _obs_counter
from kmeans_tpu_torch.obs import histogram as _obs_histogram
from kmeans_tpu_torch.utils import faults
from kmeans_tpu_torch.utils.retry import RetryPolicy

__all__ = ["BatchInfo", "ContinuousConfig", "ContinuousPipeline"]

_BATCHES_TOTAL = _obs_counter(
    "kmeans_tpu_continuous_batches_total",
    "Stream batches consumed by the continuous pipeline",
)
_REFITS_TOTAL = _obs_counter(
    "kmeans_tpu_continuous_refits_total",
    "Partial refits run by the continuous pipeline",
    labels=("trigger",),
)
_REFIT_SECONDS = _obs_histogram(
    "kmeans_tpu_continuous_refit_seconds",
    "Wall time of one continuous-pipeline refit (fit + publish)",
)

#: Transient-failure policy for refits: a refit is fit + atomic publish,
#: both safe to rerun (the publish either fully landed — the rerun
#: re-persists the same step and the swap advances — or never happened),
#: so a flaky checkpoint write or an injected ``continuous.refit``/
#: ``registry.swap`` fault is absorbed instead of killing a pipeline
#: that may have been running for days.  Exhaustion raises: a permanent
#: fault stays loud.
REFIT_RETRY = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=1.0)


@dataclasses.dataclass(frozen=True)
class ContinuousConfig:
    """Knobs of the continuous loop (see the module docstring)."""

    k: int = 4
    #: Sliding window: raw batches kept, compaction trigger/size, decay.
    window_batches: int = 8
    compact_above: int = 32768
    coreset_size: int = 4096
    decay: float = 1.0
    #: Partial-refit Lloyd iteration budget (warm starts converge fast;
    #: this bounds the tail when drift moved everything).
    refit_iters: int = 25
    #: Drift detection (drift.py): threshold ratio + EWMA band.
    drift_ratio: float = 0.25
    ewma_alpha: float = 0.3
    ewma_k_sigma: float = 6.0
    ewma_warmup: int = 5
    #: Batches that must pass after a refit before drift may fire again
    #: (the detectors rebase at the refit; this bounds refit churn when
    #: drift is continuous).
    min_refit_batches: int = 2
    #: Scheduled refit cadence (batches since the last refit; 0 = off).
    #: Drift triggers catch the model getting WORSE; the cadence catches
    #: it staying mediocre — a drift-time refit lands on a mixed old/new
    #: window, and once the window has slid fully onto the new regime
    #: only a scheduled refit re-fits the now-clean data (the detectors
    #: rebased at the mixed level and see nothing wrong).
    refit_every: int = 10
    #: Batches accumulated before the initial fit.
    warmup_batches: int = 2
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    seed: int = 0

    def validate(self) -> "ContinuousConfig":
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.refit_iters < 1:
            raise ValueError(
                f"refit_iters must be >= 1, got {self.refit_iters}"
            )
        if self.warmup_batches < 1:
            raise ValueError(
                f"warmup_batches must be >= 1, got {self.warmup_batches}"
            )
        if self.min_refit_batches < 0:
            raise ValueError(
                f"min_refit_batches must be >= 0, got "
                f"{self.min_refit_batches}"
            )
        if self.refit_every < 0:
            raise ValueError(
                f"refit_every must be >= 0, got {self.refit_every}"
            )
        return self


class BatchInfo:
    """Per-batch callback payload (the continuous analog of
    :class:`~kmeans_tpu_torch.models.runner.IterInfo`)."""

    __slots__ = ("batch", "inertia_pp", "drifted", "refit", "generation",
                 "seconds")

    def __init__(self, batch, inertia_pp, drifted, refit, generation,
                 seconds):
        self.batch = batch            #: stream index of this batch
        self.inertia_pp = inertia_pp  #: per-point inertia vs served model
        self.drifted = drifted        #: detector names that fired
        self.refit = refit            #: refit trigger, or None
        self.generation = generation  #: served generation after the batch
        self.seconds = seconds

    def as_dict(self) -> dict:
        return {
            "batch": self.batch,
            "inertia_pp": self.inertia_pp,
            "drifted": list(self.drifted),
            "refit": self.refit,
            "generation": self.generation,
            "seconds": self.seconds,
        }


class ContinuousPipeline:
    """One stream, one registry, one long-running loop.

    ``source`` is either a callable ``t -> (n, d) array`` (the resumable
    form — batch t must be a pure function of t) or a plain iterable
    (non-resumable: after a crash the caller owns re-positioning it).
    Scoring, compactions and refits run on ``device`` (None is the card).
    """

    def __init__(
        self,
        source: Union[Callable[[int], np.ndarray], Iterable[np.ndarray]],
        config: Optional[ContinuousConfig] = None,
        *,
        registry: Optional[ModelRegistry] = None,
        resume: bool = False,
        device=None,
    ):
        from kmeans_tpu_torch.device import resolve_device

        self.cfg = (config or ContinuousConfig()).validate()
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else ModelRegistry()
        self._source_fn = source if callable(source) else None
        self._source_it = None if callable(source) else iter(source)
        self.window = SlidingWindow(
            max_batches=self.cfg.window_batches,
            compact_above=self.cfg.compact_above,
            coreset_size=self.cfg.coreset_size,
            decay=self.cfg.decay,
            chunk_size=self.cfg.chunk_size,
            device=self.device,
        )
        self.monitor = DriftMonitor(
            ratio=self.cfg.drift_ratio, alpha=self.cfg.ewma_alpha,
            k_sigma=self.cfg.ewma_k_sigma, warmup=self.cfg.ewma_warmup,
        )
        self.batch_idx = 0            #: next stream index to consume
        self._since_refit = 0
        self._served = (0, None)      #: (generation, its centroids on device)
        if resume:
            self._resume()

    # -------------------------------------------------------------- resume
    def _resume(self) -> None:
        loaded = self.registry.load_latest()
        if loaded is None:
            return                     # nothing published yet: fresh start
        gen, arrays, meta = loaded
        if gen.k != self.cfg.k:
            raise ValueError(
                f"resume k={self.cfg.k} contradicts the checkpointed "
                f"model's k={gen.k}; match the config or start fresh"
            )
        extra = dict(meta.get("extra") or {})
        if self._source_fn is None and extra.get("batch_idx", 0):
            raise ValueError(
                "resume with an iterable source cannot replay the stream "
                "position; pass a callable t -> batch source"
            )
        self.batch_idx = int(extra.get("batch_idx", 0))
        # The refit-schedule counter is replay state too: without it a
        # resumed run's min_refit_batches gate and refit_every cadence
        # drift off the undisturbed run's schedule.
        self._since_refit = int(extra.get("since_refit", 0))
        self.window._compact_seq = int(extra.get("compact_seq", 0))
        drift_state = extra.get("drift_state")
        if isinstance(drift_state, dict):
            self.monitor.restore(drift_state)
        if "window_pts" in arrays and "window_w" in arrays:
            self.window.restore(np.asarray(arrays["window_pts"]),
                                np.asarray(arrays["window_w"]),
                                splits=arrays.get("window_splits"))

    # --------------------------------------------------------------- refit
    def _publish(self, centroids, *, trigger: str,
                 inertia_pp: Optional[float]) -> Generation:
        pts, w, splits = self.window.snapshot_parts()
        meta: dict = {
            "batch_idx": int(self.batch_idx),
            "since_refit": int(self._since_refit),
            "compact_seq": int(self.window.compactions),
            "drift_state": self.monitor.state(),
        }
        if inertia_pp is not None:
            meta["inertia_pp"] = float(inertia_pp)
        return self.registry.publish(
            centroids, trigger=trigger, meta=meta,
            extra_arrays={"window_pts": pts, "window_w": w,
                          "window_splits": splits},
        )

    def _refit(self, trigger: str) -> Generation:
        """Fit on the window (warm-start unless from scratch), publish."""
        from kmeans_tpu_torch.obs import tracing as _tracing

        t0 = time.perf_counter()
        with _tracing.span("continuous.refit", category="refit",
                           trigger=trigger, batch=int(self.batch_idx)):
            # The refit site sits before the fit: an injected kill here is
            # the worst case (drift detected, nothing recovered yet), and
            # a transient raise leaves window + registry untouched for
            # the next batch to retry.
            faults.check("continuous.refit")
            import torch

            from kmeans_tpu_torch.config import KMeansConfig
            from kmeans_tpu_torch.models.lloyd import fit_lloyd

            pts, w = self.window.snapshot()
            cur = self.registry.current()
            warm = cur is not None and trigger != "scratch"
            kcfg = KMeansConfig(
                k=self.cfg.k, max_iter=self.cfg.refit_iters,
                chunk_size=self.cfg.chunk_size,
                compute_dtype=self.cfg.compute_dtype,
                # Stranded-center healing: a drifted cluster can leave a
                # warm-started center empty; reseed it into the worst-fit
                # mass instead of carrying a dead centroid forever.
                empty="farthest", seed=self.cfg.seed,
            )
            gen = torch.Generator(device=self.device).manual_seed(
                (self.cfg.seed << 8) ^ (self.batch_idx or 1))
            state = fit_lloyd(
                pts, self.cfg.k, generator=gen, config=kcfg,
                init=(cur.centroids if warm else "k-means++"),
                weights=w, device=self.device,
            )
            inertia_pp = float(state.inertia) / max(float(np.sum(w)), 1e-9)
            # Post-refit state BEFORE the publish, so the checkpointed
            # resume state is exactly what the undisturbed run carries
            # forward (rebase/reset are idempotent under a REFIT_RETRY
            # rerun): the detectors' new normal is the refit quality
            # itself, and the refit-schedule counter restarts here.
            self.monitor.rebase(inertia_pp)
            self._since_refit = 0
            gen = self._publish(state.centroids.cpu().numpy(),
                                trigger=trigger, inertia_pp=inertia_pp)
        _REFITS_TOTAL.labels(trigger=trigger).inc()
        _REFIT_SECONDS.observe(time.perf_counter() - t0)
        return gen

    # ----------------------------------------------------------------- run
    def _next_batch(self) -> Optional[np.ndarray]:
        if self._source_fn is not None:
            return np.asarray(self._source_fn(self.batch_idx), np.float32)
        try:
            return np.asarray(next(self._source_it), np.float32)
        except StopIteration:
            return None

    def _batch_inertia(self, batch: np.ndarray,
                      gen: Optional[Generation]) -> Optional[float]:
        if gen is None:
            return None
        from kmeans_tpu_torch.device import as_tensor
        from kmeans_tpu_torch.ops.distance import assign

        if self._served[0] != gen.generation:
            self._served = (gen.generation,
                            as_tensor(gen.centroids, self.device))
        _, mind = assign(as_tensor(batch, self.device), self._served[1],
                         chunk_size=self.cfg.chunk_size,
                         compute_dtype=self.cfg.compute_dtype,
                         device=self.device)
        # numpy's mean of the f32 distances, as the reference reads it.
        return float(np.mean(mind.cpu().numpy()))

    def run(
        self,
        steps: int,
        *,
        callback: Optional[Callable[[BatchInfo], None]] = None,
        telemetry=None,
    ) -> Optional[Generation]:
        """Consume stream batches ``batch_idx .. steps-1``; returns the
        served generation at exit (None if the stream ended before the
        initial fit).

        ``telemetry`` is a :class:`~kmeans_tpu_torch.obs.TelemetryWriter`: one
        ``batch`` event per batch (the :class:`BatchInfo` fields),
        bracketed by ``run_start``/``run_done``.
        """
        from kmeans_tpu_torch.obs import tracing as _tracing
        from kmeans_tpu_torch.utils.preempt import PreemptionGuard

        if steps < self.batch_idx:
            raise ValueError(
                f"steps={steps} is behind the stream position "
                f"{self.batch_idx}; raise steps to continue"
            )
        if telemetry is not None:
            telemetry.event("run_start", model="continuous", k=self.cfg.k,
                            start_batch=int(self.batch_idx),
                            steps=int(steps))
        with _tracing.span("continuous.run", category="run",
                           model="continuous", k=self.cfg.k,
                           steps=int(steps)):
          with PreemptionGuard() as guard:
            while self.batch_idx < steps:
                t0 = time.perf_counter()
                batch = self._next_batch()
                if batch is None:
                    break                      # iterable source ran dry
                with _tracing.span("continuous.batch",
                                   category="continuous",
                                   batch=int(self.batch_idx)):
                    gen = self.registry.current()
                    inertia_pp = self._batch_inertia(batch, gen)
                    self.window.push(batch)
                    self.batch_idx += 1
                    self._since_refit += 1
                    drifted = (self.monitor.update(inertia_pp)
                               if inertia_pp is not None else [])
                    trigger = None
                    if gen is None:
                        if self.batch_idx >= self.cfg.warmup_batches:
                            trigger = "initial"
                    elif drifted and \
                            self._since_refit > self.cfg.min_refit_batches:
                        trigger = "drift"
                    elif self.cfg.refit_every and \
                            self._since_refit >= self.cfg.refit_every:
                        trigger = "scheduled"
                    if trigger is not None:
                        gen = REFIT_RETRY.call(self._refit, trigger,
                                               site="continuous.refit")
                _BATCHES_TOTAL.inc()
                info = BatchInfo(
                    self.batch_idx - 1, inertia_pp, drifted, trigger,
                    gen.generation if gen is not None else 0,
                    time.perf_counter() - t0,
                )
                if telemetry is not None:
                    telemetry.event("batch", model="continuous",
                                    **info.as_dict())
                if callback is not None:
                    callback(info)
                if guard.triggered and self.batch_idx < steps:
                    self._preempt_exit(steps)
            # A signal on the final batch must still surface (the guard's
            # contract: never swallowed silently) — and unlike the
            # streamed fits, raising here discards nothing: the product
            # lives in the registry object, which outlives the raise.
            if guard.triggered:
                self._preempt_exit(steps)
        if telemetry is not None:
            telemetry.event("run_done", model="continuous",
                            batches=int(self.batch_idx),
                            generation=self.registry.generation)
        return self.registry.current()

    def _preempt_exit(self, steps: int) -> None:
        from kmeans_tpu_torch.utils.preempt import Preempted

        cur = self.registry.current()
        path = self.registry.path
        if cur is not None and path:
            # Publish the exact stream position (same centroids, new
            # generation) so the resumed run replays zero lost batches.
            self._publish(cur.centroids, trigger="preempt",
                          inertia_pp=cur.meta.get("inertia_pp"))
        resumable = path if cur is not None else None
        raise Preempted.during(
            f"continuous pipeline preempted by signal at batch "
            f"{self.batch_idx}/{steps}",
            path=resumable,
            step=self.batch_idx,
            resume_hint=(f"--resume --model-dir {resumable}"
                         if resumable else None),
        )
