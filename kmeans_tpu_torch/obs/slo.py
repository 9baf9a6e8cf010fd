"""Rolling-window SLO monitor with burn-rate gating.

A copy of ``kmeans_tpu/obs/slo.py``.

The serve layer's "shed before you collapse" half (docs/OBSERVABILITY.md
"Fleet observability"): every worker — and the fleet supervisor, fed by
its per-worker scrape outcomes — embeds one :class:`SLOMonitor` that
records request outcomes into a rolling window and evaluates two SLOs
over multiple lookback windows:

* **latency** — a request is *bad* when its wall time exceeds
  ``latency_target_s``; the objective says what fraction must be good
  (0.99 -> a 1% error budget);
* **availability** — a request is *bad* when it errored (5xx) or was
  shed by admission control; objective likewise.

Each (window, slo) pair carries a **burn rate**: the bad fraction
divided by the error budget (1 - objective).  Burn 1.0 = consuming the
budget exactly as fast as it accrues; the per-window thresholds follow
the multi-window alerting shape (short windows demand a much higher
burn before they fire, so one slow request cannot flip readiness, while
the long window catches slow leaks).  A breach — burn >= threshold with
at least ``min_samples`` events in the window — flips
:meth:`SLOMonitor.healthy` to False, which the serve layer surfaces as
``/readyz`` 503 (an LB drains the worker before users feel it), and
increments ``kmeans_tpu_slo_breach_total{window,slo}`` once per
transition into breach.  Recovery is the window draining: when load
drops, events age out, the sample floor is no longer met, and the
breach clears.

Evaluation is lazy and rate-limited (``eval_s``): :meth:`healthy` is
called on every request's readiness path, so it must cost one time
check in steady state — no background thread.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from kmeans_tpu_torch.obs import registry as _registry

__all__ = ["SLOMonitor", "window_label", "DEFAULT_WINDOWS_S",
           "DEFAULT_BURN_THRESHOLDS"]

#: Default lookback windows: 10 s / 1 m / 5 m.
DEFAULT_WINDOWS_S: Tuple[float, ...] = (10.0, 60.0, 300.0)

#: Default per-window burn-rate thresholds (multi-window alerting
#: shape): the 10 s window needs a 14.4x burn to fire, the 5 m window
#: fires at 1x — short windows react fast but only to severe burns.
DEFAULT_BURN_THRESHOLDS: Tuple[float, ...] = (14.4, 6.0, 1.0)

_SLO_BREACH_TOTAL = _registry.counter(
    "kmeans_tpu_slo_breach_total",
    "SLO breach transitions: a (window, slo) pair's burn rate crossed "
    "its threshold with the sample floor met (slo = latency | "
    "availability; counted once per transition into breach, not per "
    "evaluation)",
    labels=("window", "slo"),
)
_SLO_BURN_RATE = _registry.gauge(
    "kmeans_tpu_slo_burn_rate",
    "Most recently evaluated burn rate per (window, slo): bad-event "
    "fraction / error budget; >= the configured threshold means breach",
    labels=("window", "slo"),
)
_SLO_LATENCY_P99_SECONDS = _registry.gauge(
    "kmeans_tpu_slo_latency_p99_seconds",
    "p99 request latency over each rolling SLO window at the most "
    "recent evaluation (NaN until the window has samples)",
    labels=("window",),
)


def window_label(seconds: float) -> str:
    """``10.0 -> "10s"``, ``60.0 -> "1m"``, ``300.0 -> "5m"`` — the
    closed label set for the ``window`` metric label."""
    s = float(seconds)
    if s >= 60.0 and s % 60.0 == 0.0:
        return f"{int(s // 60)}m"
    if s == int(s):
        return f"{int(s)}s"
    return f"{s:g}s"


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile of an ascending list (empty -> nan)."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1,
            max(0, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[i]


class SLOMonitor:
    """Record request outcomes; gate readiness on burn-rate breaches.

    Thread-safe; :meth:`record` is O(1) amortized, :meth:`healthy` is
    one time check between evaluations.
    """

    def __init__(self, *,
                 latency_target_s: float = 0.25,
                 latency_objective: float = 0.99,
                 availability_objective: float = 0.999,
                 windows_s: Tuple[float, ...] = DEFAULT_WINDOWS_S,
                 burn_thresholds: Tuple[float, ...] =
                 DEFAULT_BURN_THRESHOLDS,
                 min_samples: int = 50,
                 eval_s: float = 0.25,
                 max_events: int = 100_000,
                 clock=time.monotonic):
        if len(burn_thresholds) != len(windows_s):
            raise ValueError(
                f"burn_thresholds {burn_thresholds} must match "
                f"windows_s {windows_s} one-to-one")
        if not 0.0 < latency_objective < 1.0:
            raise ValueError(f"latency_objective {latency_objective} "
                             "must be in (0, 1)")
        if not 0.0 < availability_objective < 1.0:
            raise ValueError(
                f"availability_objective {availability_objective} "
                "must be in (0, 1)")
        self.latency_target_s = float(latency_target_s)
        self.latency_objective = float(latency_objective)
        self.availability_objective = float(availability_objective)
        self.windows_s = tuple(float(w) for w in windows_s)
        self.burn_thresholds = tuple(float(t) for t in burn_thresholds)
        self.min_samples = int(min_samples)
        self.eval_s = float(eval_s)
        self._clock = clock
        # (ts, seconds, bad_avail); maxlen bounds memory no matter the
        # traffic — at the cap, windows cover the most recent events
        # only, which under-counts age-outs (conservative direction).
        self._events: Deque[Tuple[float, float, bool]] = deque(
            maxlen=int(max_events))
        self._lock = threading.Lock()
        self._last_eval = float("-inf")
        self._breached: Dict[Tuple[str, str], bool] = {}
        self._snapshot: Dict[str, dict] = {}
        self._healthy = True

    # ------------------------------------------------------------ record
    def record(self, seconds: float, *, error: bool = False,
               shed: bool = False) -> None:
        """One finished request: wall time plus its availability
        outcome (an error or a shed is an availability-bad event)."""
        with self._lock:
            self._events.append(
                (self._clock(), float(seconds), bool(error or shed)))

    # -------------------------------------------------------- evaluation
    def _evaluate(self, now: float) -> None:
        """Recompute every (window, slo) burn under the lock."""
        horizon = now - max(self.windows_s)
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()
        events = list(ev)
        snap: Dict[str, dict] = {}
        healthy = True
        budget_lat = 1.0 - self.latency_objective
        budget_avail = 1.0 - self.availability_objective
        # events is time-ascending; each window is a suffix.
        times = [e[0] for e in events]
        for w, thresh in zip(self.windows_s, self.burn_thresholds):
            lo = bisect.bisect_left(times, now - w)
            win = events[lo:]
            n = len(win)
            lats = sorted(e[1] for e in win)
            bad_lat = sum(1 for e in win if e[1] > self.latency_target_s)
            bad_avail = sum(1 for e in win if e[2])
            burn_lat = (bad_lat / n) / budget_lat if n else 0.0
            burn_avail = (bad_avail / n) / budget_avail if n else 0.0
            label = window_label(w)
            row = {
                "window_s": w,
                "n": n,
                "qps": round(n / w, 3),
                "p50_ms": round(_quantile(lats, 0.50) * 1e3, 3)
                if n else None,
                "p99_ms": round(_quantile(lats, 0.99) * 1e3, 3)
                if n else None,
                "error_rate": round(bad_avail / n, 6) if n else 0.0,
                "burn": {"latency": round(burn_lat, 3),
                         "availability": round(burn_avail, 3)},
                "threshold": thresh,
                "breach": {},
            }
            for slo, burn in (("latency", burn_lat),
                              ("availability", burn_avail)):
                breached = n >= self.min_samples and burn >= thresh
                row["breach"][slo] = breached
                key = (label, slo)
                if breached and not self._breached.get(key):
                    _SLO_BREACH_TOTAL.labels(
                        window=label, slo=slo).inc()
                self._breached[key] = breached
                _SLO_BURN_RATE.labels(window=label, slo=slo).set(burn)
                if breached:
                    healthy = False
            # 0.0, not the quantile's NaN, for an empty window: NaN
            # survives the exposition round-trip but poisons every
            # consumer doing max()/comparisons on the scraped value.
            _SLO_LATENCY_P99_SECONDS.labels(window=label).set(
                _quantile(lats, 0.99) if n else 0.0)
            snap[label] = row
        self._snapshot = snap
        self._healthy = healthy
        self._last_eval = now

    def healthy(self, now: Optional[float] = None) -> bool:
        """True while no (window, slo) pair is in breach.  Re-evaluates
        at most every ``eval_s`` — the readiness-path cost between
        evaluations is one time check."""
        t = self._clock() if now is None else now
        if t - self._last_eval < self.eval_s:
            return self._healthy
        with self._lock:
            if t - self._last_eval < self.eval_s:
                return self._healthy
            self._evaluate(t)
            return self._healthy

    def snapshot(self, now: Optional[float] = None,
                 *, force: bool = False) -> Dict[str, dict]:
        """Per-window stats at the most recent evaluation (forced fresh
        with ``force=True``): n / qps / p50 / p99 / error_rate / burn /
        breach per window label."""
        t = self._clock() if now is None else now
        with self._lock:
            if force or t - self._last_eval >= self.eval_s:
                self._evaluate(t)
            return {k: dict(v) for k, v in self._snapshot.items()}

    def breaches(self) -> List[Tuple[str, str]]:
        """Currently breached (window_label, slo) pairs, sorted."""
        with self._lock:
            return sorted(k for k, v in self._breached.items() if v)
