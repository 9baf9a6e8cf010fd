"""Structured run telemetry: one JSONL event per iteration/step.

A copy of ``kmeans_tpu/obs/telemetry.py``.  In the port the producer is
``LloydRunner.run`` (:mod:`kmeans_tpu_torch.models.runner`, and so the
CLI's ``train --telemetry``), whose ``phase`` tag marks the first call of
each sweep function (on the card, the kernel library's load) instead of an
XLA compile.

The observability layer's top half (docs/OBSERVABILITY.md): where the
registry answers "how is the process doing right now", the telemetry
stream answers "what did THIS run do, iteration by iteration" — the
numeric analog of the reference dashboard's per-iteration delta stream
(SURVEY.md §5.5), durable enough to diff across runs.

One event is one JSON object on one line:

    {"event": "iter", "ts": 1722700000.123, "iteration": 3,
     "inertia": 1234.5, "shift_sq": 0.01, "seconds": 0.08,
     "converged": false, "model": "lloyd", "device": "tpu",
     "phase": "step"}

``phase`` distinguishes compile from steady state: the first step a
jitted program runs includes its XLA compile, so that event carries
``"phase": "compile+step"`` and every later one ``"phase": "step"`` —
subtracting a steady-state ``seconds`` from the first event bounds the
compile cost.  Producers: ``LloydRunner.run`` (and therefore the CLI's
``fit --telemetry`` and the serve train stream), the streamed fits'
per-step callbacks, and ``bench.py --telemetry`` (per timed window), all
writing the same schema so benchmarks and production report identical
numbers (tools/bench_table.py ``--telemetry`` renders either).

Non-finite floats (a diverged fit's NaN inertia) are written as JSON
``null`` — every line stays strictly parseable JSON.

Every event additionally carries a ``run_id`` (minted per writer unless
the caller supplies one in ``common``), so multiple runs appended to
one JSONL file stay separable (:func:`summarize_by_run` groups them
back apart), and a ``trace_id`` whenever a span context is active at
event time — the cross-reference key between the JSONL stream, the
span tracer's Perfetto export, and the serve layer's ``X-Trace-Id``
response header (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Union

from kmeans_tpu_torch.obs import tracing as _tracing

__all__ = ["TelemetryWriter", "read_events", "summarize_events",
           "summarize_by_run"]


def _clean(obj: Any) -> Any:
    """JSON-safe copy: numpy/jax scalars to Python, non-finite to None."""
    if isinstance(obj, dict):
        return {str(k): _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    # numpy / jax scalars: anything with .item() collapses to a Python
    # scalar; re-clean so a NaN still maps to None.
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return _clean(item())
        except (TypeError, ValueError):
            return str(obj)
    return str(obj)


class TelemetryWriter:
    """Append structured events to a JSONL stream; thread-safe.

    ``sink`` is a path (opened for write, or append with ``append=True``)
    or any object with ``write``/``flush``.  ``common`` fields are merged
    into every event (run id, model, device); a ``run_id`` is minted
    when ``common`` doesn't carry one, so every stream is separable
    after concatenation.  Each event is flushed as one line, so a
    concurrently-tailing consumer (or a crash) always sees whole events.
    """

    def __init__(self, sink: Union[str, Any], *,
                 common: Optional[Dict[str, Any]] = None,
                 append: bool = False):
        if isinstance(sink, str):
            self._f = open(sink, "a" if append else "w", encoding="utf-8")
            self._owns = True
        else:
            self._f = sink
            self._owns = False
        self._common = dict(common or {})
        self._common.setdefault("run_id", _tracing.new_run_id())
        self._lock = threading.Lock()
        self._closed = False

    @property
    def run_id(self) -> str:
        """The run id stamped into every event of this stream."""
        return self._common["run_id"]

    def event(self, kind: str, **fields) -> Dict[str, Any]:
        """Write one event; returns the record that was written.

        A ``trace_id`` is stamped from the ambient span context when one
        is active (and the caller didn't set one explicitly) — the
        JSONL/span/HTTP cross-reference key.
        """
        rec = {"event": str(kind), "ts": round(time.time(), 6),
               **self._common, **fields}
        if "trace_id" not in rec:
            tid = _tracing.current_trace_id()
            if tid is not None:
                rec["trace_id"] = tid
        rec = _clean(rec)
        line = json.dumps(rec, allow_nan=False, separators=(",", ":"))
        with self._lock:
            if self._closed:
                raise ValueError("TelemetryWriter is closed")
            self._f.write(line + "\n")
            self._f.flush()
        return rec

    def iteration(self, info, **extra) -> Dict[str, Any]:
        """One ``iter`` event from an :class:`IterInfo`-shaped object
        (anything with ``as_dict()``)."""
        return self.event("iter", **info.as_dict(), **extra)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._owns:
                self._f.close()

    def __enter__(self) -> "TelemetryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> List[Dict[str, Any]]:
    """All events from a JSONL telemetry file, in order.

    Raises ``ValueError`` naming the offending line number on a torn or
    malformed line — a telemetry file that doesn't parse is a bug, not
    something to skip silently.
    """
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed telemetry event: {e}"
                ) from e
    return out


def summarize_events(events: Iterable[Dict[str, Any]], *,
                     kind: str = "iter",
                     seconds_key: str = "seconds") -> Dict[str, Any]:
    """Aggregate one event kind's timing into the numbers the bench
    artifacts report: count, total/mean/min/max seconds, and the implied
    rate — THE one derivation shared by ``bench.py --telemetry`` and
    ``tools/bench_table.py --telemetry``, so the two can't drift.

    Events missing ``seconds_key`` (or carrying null) count toward
    ``count`` but not the timing aggregates.
    """
    count = 0
    timed: List[float] = []
    for ev in events:
        if ev.get("event") != kind:
            continue
        count += 1
        s = ev.get(seconds_key)
        if isinstance(s, (int, float)) and not isinstance(s, bool) \
                and math.isfinite(float(s)):
            timed.append(float(s))
    total = sum(timed)
    return {
        "event": kind,
        "count": count,
        "timed": len(timed),
        "total_s": total,
        "mean_s": (total / len(timed)) if timed else None,
        "min_s": min(timed) if timed else None,
        "max_s": max(timed) if timed else None,
        "rate_per_s": (len(timed) / total) if total > 0 else None,
    }


def summarize_by_run(events: Iterable[Dict[str, Any]], *,
                     kind: str = "iter",
                     seconds_key: str = "seconds") -> Dict[Any, Dict]:
    """Per-run :func:`summarize_events`: ``{run_id: summary}`` in first-
    seen order (events missing ``run_id`` — pre-tracing streams — group
    under ``None``) — so appended runs never blend into one bogus
    aggregate.  Finer groupings (``tools/bench_table.py --telemetry``
    splits by (run, model)) filter first and feed the same
    :func:`summarize_events` derivation per group."""
    by_run: Dict[Any, List[Dict[str, Any]]] = {}
    for ev in events:
        by_run.setdefault(ev.get("run_id"), []).append(ev)
    return {run: summarize_events(evs, kind=kind, seconds_key=seconds_key)
            for run, evs in by_run.items()}
