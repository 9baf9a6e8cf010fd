"""Tracing and profiling hooks, layered on the span tracer.

Counterpart of ``kmeans_tpu/utils/profiling.py``:

* :func:`capture`: one context manager for "where did the time go".  It
  enables the span tracer (:mod:`kmeans_tpu_torch.obs.tracing`) and writes
  its Chrome trace-event JSON on exit, optionally composed with
  :func:`trace`, so one flag captures both the host span timeline and the
  device timeline (the CLI's ``--trace out.json [--xla-trace dir]``).
* :func:`trace`: the device timeline of the block, written into a
  directory.  The reference runs ``jax.profiler.trace`` there; the port
  runs :mod:`torch.profiler` (CPU activity, and CUDA activity where a card
  is present) and writes its Chrome trace, ``trace.json``, into the
  directory.  Exception-safe (a profiler that fails to start is never
  stopped) and non-reentrant: nested activation is an error, as the
  reference's is.
* :class:`Timer`: named wall-clock sections with a summary; each section
  also opens a ``timer``-category span.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from kmeans_tpu_torch.obs import tracing as _tracing

__all__ = ["trace", "capture", "Timer"]

_TRACE_LOCK = threading.Lock()
_TRACE_ACTIVE = False

#: The file :func:`trace` writes inside its directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile everything inside the block with :mod:`torch.profiler` and
    write its Chrome trace to ``<logdir>/trace.json`` (Perfetto loads it).

    * If the profiler fails to start, the error propagates without a
      stop: there is nothing to stop, and stopping would mask the real
      failure.
    * Nested or concurrent activation raises ``RuntimeError`` up front:
      the profiler is process-global, so an inner block would cut the
      outer capture short.
    """
    global _TRACE_ACTIVE
    import torch

    with _TRACE_LOCK:
        if _TRACE_ACTIVE:
            raise RuntimeError(
                "profiling.trace is already active in this process; "
                "torch.profiler keeps ONE global trace, so nested or "
                "concurrent activation would silently truncate the "
                "outer capture"
            )
        _TRACE_ACTIVE = True
    prof = None
    try:
        os.makedirs(logdir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        started = torch.profiler.profile(activities=activities)
        started.__enter__()
        prof = started
        yield
    finally:
        with _TRACE_LOCK:
            _TRACE_ACTIVE = False
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def capture(trace_path: Optional[str] = None, *,
            xla_dir: Optional[str] = None,
            name: str = "capture") -> Iterator[None]:
    """Host spans and/or the device timeline under one flag.

    With ``trace_path``: enables the process span tracer for the block
    (restoring its previous switch state after), wraps the block in a root
    ``capture``-category span, and writes the tracer's Chrome trace-event
    JSON to ``trace_path`` on exit, on the error path too, so a crashed run
    still leaves its partial timeline.  With ``xla_dir`` (the reference's
    name for the device trace's directory): also runs :func:`trace` around
    the block, so the host spans and the device profile cover the same
    window.  With neither, a plain no-op.
    """
    with contextlib.ExitStack() as stack:
        if xla_dir:
            stack.enter_context(trace(xla_dir))
        if trace_path:
            was_enabled = _tracing.TRACER.enabled
            if not was_enabled:
                # A capture starting from a disabled tracer owns the
                # buffer: clear stale spans from earlier captures in this
                # process so the export is this run's timeline.  (Composing
                # with an already-enabled tracer appends instead.)
                _tracing.TRACER.clear()
            _tracing.TRACER.enable()

            def _export():
                _tracing.TRACER.enabled = was_enabled
                _tracing.TRACER.export_chrome_trace(trace_path)

            stack.callback(_export)
            stack.enter_context(
                _tracing.span(name, category="capture"))
        yield


class Timer:
    """Named wall-clock sections: ``with timer.section("assign"): ...``."""

    def __init__(self):
        self.sections: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with _tracing.span(name, category="timer"):
            try:
                yield
            finally:
                self.sections.setdefault(name, []).append(
                    time.perf_counter() - t0
                )

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, ts in self.sections.items():
            out[name] = {
                "count": len(ts),
                "total_s": sum(ts),
                "mean_s": sum(ts) / len(ts),
                "max_s": max(ts),
            }
        return out
