"""Structured tracing: spans, trace-context propagation, Perfetto export.

A copy of ``kmeans_tpu/obs/tracing.py`` with one repair: a span's ``tid``
is a sequence number that a thread takes at its first span and keeps, not
``threading.get_ident()``.  Python hands a finished thread's ident on to a
new thread, so in the reference the spans of threads that did not live at
the same time (one HTTP handler thread per connection) share a lane of
the export; here every thread has a lane of its own, named after the
thread.

The observability layer's third half (docs/OBSERVABILITY.md): the
registry answers "how is the process doing", the telemetry stream
answers "what did this run do per iteration" — this module answers
"where did THIS request's 400 ms go": a causal chain of timed spans
from an HTTP train request through the job slot, the runner, and its
compile / assign / update / host-sync / checkpoint phases.

Design constraints mirror the registry's:

* **zero dependencies** — the span model, IDs, and the Chrome
  trace-event export are pure stdlib;
* **thread-safe** — serve request threads, training workers, and the
  prefetch producer all open spans concurrently; completed spans land
  in one lock-guarded ring buffer and the active-span context is a
  ``contextvars.ContextVar`` (per-thread/per-task, never shared);
* **near-zero cost when disabled** — the tracer is OFF by default;
  every ``span(...)`` call on the disabled path is one attribute check
  plus returning a shared no-op span, so hot loops keep their span
  callsites unconditionally (guarded by tests/test_tracing.py's
  overhead test, the twin of the registry's).

Two usage shapes::

    with span("assign", category="assign", model="lloyd"):
        ...                      # nested: parent/child linkage is automatic

    s = start_span("train_job", category="train")   # async boundary:
    ...                                             # does NOT touch the
    s.end()                                         # ambient context

Cross-thread propagation is explicit: ``ctx = current_context()`` on
the producing thread, ``with use_context(ctx):`` on the consumer — the
consumer's spans become children of the producer's span even though
``contextvars`` never crosses a ``threading.Thread`` boundary on its
own.  The serve layer uses exactly this to hand an HTTP request's trace
to its background train job.

Export is Chrome trace-event JSON (``{"traceEvents": [...]}``, ``ph:
"X"`` complete events, microsecond timestamps) — load the file in
Perfetto (https://ui.perfetto.dev) or render a text flamegraph with
``tools/trace_view.py``.  The span-leak lint (TRC701/TRC702,
docs/ANALYSIS.md) flags ``span(...)`` calls that are neither context-
managed nor explicitly ended.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import math
import os
import re
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "TraceContext",
    "TRACER",
    "span",
    "start_span",
    "current_context",
    "current_trace_id",
    "use_context",
    "new_trace_id",
    "new_run_id",
    "is_trace_id",
    "enable",
    "disable",
    "enabled",
    "export_chrome_trace",
    "span_to_event",
]

#: Default completed-span ring capacity.  At ~200 bytes/span this bounds
#: the tracer at a few MB no matter how long the process lives.
DEFAULT_CAPACITY = 65536

# Epoch anchor: spans time with perf_counter (monotonic, sub-µs) and the
# export maps that onto unix microseconds via one anchor taken at import.
_T0_PERF = time.perf_counter()
_T0_EPOCH = time.time()

_TRACE_ID_RE = re.compile(r"[0-9a-fA-F][0-9a-fA-F-]{7,63}\Z")

#: The ambient (trace_id, span_id) of the innermost active ``with
#: span(...)`` block.  contextvars: per-thread AND per-asyncio-task,
#: and deliberately NOT inherited by new threads — cross-thread handoff
#: must be explicit (``current_context()`` / ``use_context``).
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "kmeans_tpu_trace_ctx", default=None
)

_SPAN_IDS = itertools.count(1)
_SPAN_IDS_LOCK = threading.Lock()

#: Each thread's export lane: ``(tid, thread name)``, taken at the thread's
#: first span from ``_LANE_IDS`` and never handed to another thread.
_LANE = threading.local()
_LANE_IDS = itertools.count(1)


def _next_span_id() -> int:
    with _SPAN_IDS_LOCK:
        return next(_SPAN_IDS)


def _thread_lane():
    """This thread's ``(tid, name)``, taken at its first span."""
    lane = getattr(_LANE, "lane", None)
    if lane is None:
        with _SPAN_IDS_LOCK:
            tid = next(_LANE_IDS)
        lane = _LANE.lane = (tid, threading.current_thread().name)
    return lane


def new_trace_id() -> str:
    """A fresh process-unique trace id (hex, 16 chars)."""
    return uuid.uuid4().hex[:16]


def new_run_id() -> str:
    """A fresh run id for telemetry streams (hex, 12 chars)."""
    return uuid.uuid4().hex[:12]


def is_trace_id(value) -> bool:
    """Whether ``value`` is acceptable as an externally-supplied trace
    id (the serve layer's ``X-Trace-Id`` adoption gate): hex/dash, 8-64
    chars — arbitrary strings must not flow into telemetry fields."""
    return isinstance(value, str) and bool(_TRACE_ID_RE.match(value))


class TraceContext:
    """An immutable (trace_id, span_id) snapshot — the explicit
    cross-thread propagation token."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: Optional[int]):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


def _json_value(v: Any) -> Any:
    """One JSON-safe attr value: finite numbers/bools/strings/None pass
    through, non-finite floats become None, everything else stringifies
    (the export must ALWAYS be strictly parseable)."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _json_value(item())
        except (TypeError, ValueError):
            return str(v)
    return str(v)


class _NullSpan:
    """The shared disabled-path span: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def end(self) -> None:
        return None

    def set(self, **attrs) -> "_NullSpan":
        return self

    @property
    def trace_id(self) -> Optional[str]:
        return None


_NULL_SPAN = _NullSpan()


class Span:
    """One timed operation.  Created == started.

    Use as a context manager (``with tracer.span(...)``: activates the
    span as the ambient parent for the block) or end explicitly with
    :meth:`end` (``start_span``: never touches the ambient context, so
    the span may be ended from another thread).
    """

    __slots__ = ("name", "category", "trace_id", "span_id", "parent_id",
                 "attrs", "tid", "thread_name", "t0", "ts_us", "dur_us",
                 "_tracer", "_token", "_ended")

    def __init__(self, tracer: "Tracer", name: str, category: str,
                 trace_id: Optional[str], parent, attrs: Dict[str, Any]):
        if parent is None:
            parent = _CTX.get()
        if isinstance(parent, Span):
            parent = TraceContext(parent.trace_id, parent.span_id)
        if parent is not None and trace_id is None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            # Root span: an explicit trace_id wins (the serve layer's
            # adopted X-Trace-Id), else mint one.
            self.trace_id = trace_id or new_trace_id()
            self.parent_id = None
        self.name = str(name)
        self.category = str(category)
        self.span_id = _next_span_id()
        self.attrs = attrs
        self.tid, self.thread_name = _thread_lane()
        self._tracer = tracer
        self._token = None
        self._ended = False
        self.dur_us = None
        self.t0 = time.perf_counter()
        self.ts_us = (_T0_EPOCH + (self.t0 - _T0_PERF)) * 1e6

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attrs mid-span (e.g. a result computed
        before :meth:`end`)."""
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        """Finish the span and append it to the tracer's ring buffer.
        Idempotent — a double end keeps the first duration."""
        if self._ended:
            return
        self._ended = True
        self.dur_us = (time.perf_counter() - self.t0) * 1e6
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        self._token = _CTX.set(TraceContext(self.trace_id, self.span_id))
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        self.end()
        return False


class Tracer:
    """A bounded ring of completed spans plus the enabled switch.

    Eviction drops the OLDEST completed span first.  Because children
    always complete before their parents, eviction can drop a child
    while its (later-finishing) parent survives — never the reverse for
    same-thread nesting — so every exported parent reference either
    resolves inside the export or points at an evicted ancestor; the
    export itself stays valid either way (Chrome trace nesting is by
    time containment per thread, not by pointer).
    """

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        #: Plain attribute, same contract as the metrics registry: the
        #: disabled-path cost must stay one attribute load.
        self.enabled = enabled
        self.capacity = capacity
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        #: Optional completed-span sink (``fn(span)``), called after the
        #: ring append — the fleet trace spool
        #: (kmeans_tpu_torch.obs.fleetview.SpanSpool) hooks here so spans
        #: outlive the ring AND the process.  Must be fast and must not
        #: raise; exceptions are swallowed (a broken spool must never
        #: take down the traced request).
        self._sink = None

    def set_sink(self, sink) -> None:
        """Install (or clear, with ``None``) the completed-span sink."""
        self._sink = sink

    # ------------------------------------------------------------ control
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -------------------------------------------------------------- spans
    def span(self, name: str, *, category: str = "span",
             trace_id: Optional[str] = None, parent=None, **attrs):
        """A started span for a ``with`` block (activates the ambient
        context on ``__enter__``).  Returns the shared no-op span when
        disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, category, trace_id, parent, attrs)

    def start_span(self, name: str, *, category: str = "span",
                   trace_id: Optional[str] = None, parent=None, **attrs):
        """Explicit start for async boundaries: never modifies the
        ambient context; the caller owns :meth:`Span.end` (possibly on
        another thread).  The span-leak lint (TRC702) checks that an
        ``end`` is reachable."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, category, trace_id, parent, attrs)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
        sink = self._sink
        if sink is not None:
            try:
                sink(span)
            except Exception:  # allow-silent-except: a failing sink (spool disk full, torn dir) must not take down the traced operation; the ring above already kept the span
                pass

    def snapshot(self) -> List[Span]:
        """Completed spans currently buffered, oldest first."""
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # ------------------------------------------------------------- export
    def to_events(self) -> List[Dict[str, Any]]:
        """Chrome trace-event dicts (``ph: "X"`` complete events plus
        thread-name metadata), strictly JSON-safe."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        names: Dict[int, str] = {}
        for s in self.snapshot():
            names[s.tid] = s.thread_name
            events.append(span_to_event(s, pid))
        meta = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "kmeans_tpu"},
        }]
        for tid in sorted(names):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"{names[tid]} ({tid})"},
            })
        return meta + events

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """The Perfetto-loadable JSON document; also written to ``path``
        when given.  ``allow_nan=False``: the export is either strictly
        parseable or an error here, never a file Perfetto rejects."""
        doc = {"traceEvents": self.to_events(), "displayTimeUnit": "ms"}
        text = json.dumps(doc, allow_nan=False)
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
        return text


def span_to_event(s: Span, pid: Optional[int] = None) -> Dict[str, Any]:
    """One completed span as a Chrome trace-event dict (``ph: "X"``),
    strictly JSON-safe — shared by :meth:`Tracer.to_events` and the
    fleet trace spool, so a spooled span and a ring-exported span render
    identically."""
    args: Dict[str, Any] = {"trace_id": s.trace_id, "span_id": s.span_id}
    if s.parent_id is not None:
        args["parent_id"] = s.parent_id
    for k, v in s.attrs.items():
        args[str(k)] = _json_value(v)
    return {
        "name": s.name,
        "cat": s.category,
        "ph": "X",
        "ts": round(s.ts_us, 3),
        "dur": round(s.dur_us or 0.0, 3),
        "pid": os.getpid() if pid is None else pid,
        "tid": s.tid,
        "args": args,
    }


#: The process-global default tracer (disabled until a capture turns it
#: on: ``kmeans_tpu.cli fit --trace``, the serve layer, bench --trace).
TRACER = Tracer()


def span(name: str, *, category: str = "span",
         trace_id: Optional[str] = None, parent=None, **attrs):
    """Open a span on the default tracer (``with span(...):``)."""
    return TRACER.span(name, category=category, trace_id=trace_id,
                       parent=parent, **attrs)


def start_span(name: str, *, category: str = "span",
               trace_id: Optional[str] = None, parent=None, **attrs):
    """Explicitly start a span on the default tracer (caller ends it)."""
    return TRACER.start_span(name, category=category, trace_id=trace_id,
                             parent=parent, **attrs)


def current_context() -> Optional[TraceContext]:
    """The ambient trace context, or None outside any active span."""
    return _CTX.get()


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Activate a captured :class:`TraceContext` for a block — the
    consumer half of explicit cross-thread propagation.  ``None`` is a
    no-op (the producer had no active trace)."""
    if ctx is None:
        yield
        return
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def enabled() -> bool:
    return TRACER.enabled


def export_chrome_trace(path: Optional[str] = None) -> str:
    """Export the default tracer's buffer (see
    :meth:`Tracer.export_chrome_trace`)."""
    return TRACER.export_chrome_trace(path)
