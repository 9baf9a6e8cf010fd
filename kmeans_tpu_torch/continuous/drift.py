"""Drift detection over the per-batch inertia/shift telemetry.

A copy of ``kmeans_tpu/continuous/drift.py``, its drift family on the
port's ``obs``.

The continuous pipeline feeds each incoming batch's *per-point inertia*
(mean squared distance to the nearest current centroid — the same
quantity the telemetry stream's ``iter`` events report, normalized so
batch size drops out) into a :class:`DriftMonitor`.  Two complementary
detectors vote:

* :class:`ThresholdDetector` — fires when the value exceeds the level at
  the last refit by a fixed ratio.  Catches *abrupt* drift (a cluster
  jumped) in one batch, but needs a baseline to compare against.
* :class:`EWMADetector` — exponentially-weighted mean/variance with a
  k-sigma band.  Catches *gradual* drift the ratio test sleeps through
  (the baseline itself decays toward the creeping value), and adapts its
  own noise floor.

Either firing marks the batch drifted.  Both detectors serialize to a
small JSON-safe dict (``state()`` / ``restore()``) so the pipeline's
generation checkpoints carry them — a killed-and-resumed pipeline keeps
the same drift memory an uninterrupted one would have.
"""

from __future__ import annotations

import math
from typing import Optional

from kmeans_tpu_torch.obs import counter as _obs_counter

__all__ = ["ThresholdDetector", "EWMADetector", "DriftMonitor"]

#: Drift observability: which detector fires tells whether the workload
#: drifts abruptly (threshold) or creeps (ewma), and so how to tune the
#: other.
_DRIFT_EVENTS_TOTAL = _obs_counter(
    "kmeans_tpu_continuous_drift_events_total",
    "Drift detector firings in the continuous pipeline",
    labels=("detector",),
)


class ThresholdDetector:
    """Fire when ``value > baseline * (1 + ratio)``.

    The baseline is the value recorded at the last :meth:`rebase` (the
    pipeline rebases after every refit, so "drift" always means "worse
    than the current model was when it was fit", never "worse than some
    ancient epoch").  Before the first rebase the detector is silent —
    there is no model to have drifted from.
    """

    name = "threshold"

    def __init__(self, ratio: float = 0.25):
        if ratio <= 0:
            raise ValueError(f"ratio must be > 0, got {ratio}")
        self.ratio = float(ratio)
        self.baseline: Optional[float] = None
        self.last: Optional[float] = None

    def update(self, value: float) -> bool:
        self.last = float(value)
        if self.baseline is None or not math.isfinite(value):
            return False
        return value > self.baseline * (1.0 + self.ratio)

    def rebase(self, value: float) -> None:
        """Adopt ``value`` as the new normal (call after a refit)."""
        self.baseline = float(value)

    def state(self) -> dict:
        return {"baseline": self.baseline, "last": self.last}

    def restore(self, state: dict) -> None:
        self.baseline = state.get("baseline")
        self.last = state.get("last")


class EWMADetector:
    """k-sigma band around an exponentially-weighted mean.

    Maintains EWMA estimates of mean and variance (West's recurrence);
    fires when a value lands more than ``k_sigma`` standard deviations
    *above* the mean (one-sided: a batch fitting unusually WELL is not
    drift).  ``warmup`` observations must arrive before it can fire, so
    the band has something to be a band around.  A fired-or-rebased
    detector re-seeds its statistics from the next observation — the
    post-refit regime is a new distribution, not an outlier of the old.
    """

    name = "ewma"

    def __init__(self, alpha: float = 0.3, k_sigma: float = 6.0,
                 warmup: int = 5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if k_sigma <= 0:
            raise ValueError(f"k_sigma must be > 0, got {k_sigma}")
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        self.alpha = float(alpha)
        self.k_sigma = float(k_sigma)
        self.warmup = int(warmup)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.count = 0

    def update(self, value: float) -> bool:
        value = float(value)
        if not math.isfinite(value):
            return False
        if self.mean is None:
            self.mean, self.var, self.count = value, 0.0, 1
            return False
        fired = (self.count >= self.warmup
                 and value > self.mean + self.k_sigma * math.sqrt(self.var))
        if fired:
            return True
        # Only in-band values update the statistics: a drifted batch must
        # not drag the band toward itself before the refit lands.
        delta = value - self.mean
        self.mean += self.alpha * delta
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta**2)
        self.count += 1
        return False

    def rebase(self, value: float) -> None:
        """Re-seed the statistics at the post-refit level."""
        self.mean, self.var, self.count = float(value), 0.0, 1

    def state(self) -> dict:
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def restore(self, state: dict) -> None:
        self.mean = state.get("mean")
        self.var = float(state.get("var", 0.0))
        self.count = int(state.get("count", 0))


class DriftMonitor:
    """Threshold + EWMA detectors voting over one watched value.

    ``update(value)`` returns the list of detector names that fired
    (empty = no drift); ``rebase(value)`` resets both after a refit.
    The whole monitor round-trips through ``state()``/``restore()`` so
    generation checkpoints can carry it.
    """

    def __init__(self, *, ratio: float = 0.25, alpha: float = 0.3,
                 k_sigma: float = 6.0, warmup: int = 5):
        self.threshold = ThresholdDetector(ratio=ratio)
        self.ewma = EWMADetector(alpha=alpha, k_sigma=k_sigma, warmup=warmup)
        self._detectors = (self.threshold, self.ewma)

    def update(self, value: float) -> list:
        fired = [d.name for d in self._detectors if d.update(value)]
        for name in fired:
            _DRIFT_EVENTS_TOTAL.labels(detector=name).inc()
        return fired

    def rebase(self, value: float) -> None:
        for d in self._detectors:
            d.rebase(value)

    def state(self) -> dict:
        return {d.name: d.state() for d in self._detectors}

    def restore(self, state: dict) -> None:
        for d in self._detectors:
            if d.name in state:
                d.restore(state[d.name])
