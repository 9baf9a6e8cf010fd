"""The fleet trace spool: a process's completed spans as JSONL on disk.

The worker half of ``kmeans_tpu/obs/fleetview.py``, copied:
:class:`SpanSpool` and :func:`spool_path`, which a server installs as the
tracer's completed-span sink when ``ServeConfig.trace_dir`` is set, so the
spans outlive the ring and the process.  The supervisor half (the merged
``/api/trace``, the aggregated ``/metrics``) waits for the port's fleet.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from kmeans_tpu_torch.obs import tracing as _tracing

__all__ = ["SpanSpool", "spool_path"]

_SPOOL_PREFIX = "spans-"


def spool_path(trace_dir: str, pid: Optional[int] = None) -> str:
    """The per-process span spool file under ``trace_dir``."""
    return os.path.join(trace_dir,
                        f"{_SPOOL_PREFIX}{os.getpid() if pid is None else pid}.jsonl")


class SpanSpool:
    """Durable completed-span sink: JSONL events under ``trace_dir``.

    Installed via ``Tracer.set_sink``; each completed span is converted
    with ``tracing.span_to_event`` and buffered, and the buffer flushes
    to ``spans-<pid>.jsonl`` when it reaches ``flush_events`` entries or
    ``flush_s`` has passed since the last flush — no background thread,
    bounded write amplification.  Append-only, one JSON object per
    line: a crash can tear at most the final line, and
    :func:`read_spool_events` skips torn tails.
    """

    def __init__(self, trace_dir: str, *, flush_events: int = 32,
                 flush_s: float = 0.5):
        os.makedirs(trace_dir, exist_ok=True)
        self.path = spool_path(trace_dir)
        self._pid = os.getpid()
        self._flush_events = int(flush_events)
        self._flush_s = float(flush_s)
        self._buf: List[str] = []
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._closed = False

    def __call__(self, span) -> None:
        """The ``Tracer`` sink entry point."""
        line = json.dumps(_tracing.span_to_event(span, self._pid),
                          allow_nan=False)
        to_write: List[str] = []
        with self._lock:
            if self._closed:
                return
            self._buf.append(line)
            now = time.monotonic()
            if (len(self._buf) >= self._flush_events
                    or now - self._last_flush >= self._flush_s):
                to_write, self._buf = self._buf, []
                self._last_flush = now
        # File I/O outside the lock: a slow disk must not convoy the
        # traced request threads.  Appends may interleave across
        # flushing threads, which is fine — merge_spool sorts by ts.
        self._write(to_write)

    def _write(self, lines: List[str]) -> None:
        if lines:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")

    def flush(self) -> None:
        with self._lock:
            to_write, self._buf = self._buf, []
            self._last_flush = time.monotonic()
        self._write(to_write)

    def close(self) -> None:
        with self._lock:
            to_write, self._buf = self._buf, []
            self._closed = True
        self._write(to_write)
