"""The device trace of a traced run, and its reduction.

``torch.profiler`` records host operations and the card's kernels, copies
and fills (CUPTI) over the traced part of the window; its Chrome trace is
written to a temporary file, read back and reduced to:

* the device intervals, each with its kernel's base name;
* ``busy_s``: the union of device intervals inside the traced window;
* the device operations that took the most time, summed by base name;
* the idle gaps, each named by the innermost host operation running at the
  gap's midpoint on the thread that opened the window, summed by name.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import List, NamedTuple

import torch

__all__ = ["Kernel", "TraceSummary", "base_name", "Profiler", "reduce_trace",
           "WINDOW_SPAN"]

#: The harness's annotation around the traced part of the window.
WINDOW_SPAN = "bench.window"
#: Entries of each list of the breakdown.
TOP = 10
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")


class Kernel(NamedTuple):
    base: str
    ts: float      # microseconds, the trace's clock
    dur: float     # microseconds
    stream: int
    cat: str


class TraceSummary(NamedTuple):
    kernels: List[Kernel]          # device intervals inside the window, in order
    window_s: float
    busy_s: float
    device_ops: list               # [[base name, seconds], ...] largest first
    idle_gaps: list                # [[host operation, seconds], ...] largest first


_TEMPLATE = re.compile(r"<[^<>]*>")


def base_name(name: str) -> str:
    """The function's own name in a demangled kernel name: ``void
    (anonymous namespace)::core_score_kernel<bf16, true>(CUtensorMap, ...)``
    gives ``core_score_kernel``.  A name with no argument list is returned
    as it is."""
    s = name.replace("(anonymous namespace)", "anon")
    while True:
        t = _TEMPLATE.sub("", s)
        if t == s:
            break
        s = t
    if "(" not in s:
        return name
    head = s.split("(", 1)[0].strip().split(" ")[-1]
    return head.split("::")[-1] or name


class Profiler:
    """``torch.profiler`` over the host and the card, started and stopped
    by the harness around the traced part of the window."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._span = None

    def start(self) -> None:
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> "TraceSummary":
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_trace(events)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list) -> TraceSummary:
    """Reduce Chrome trace events to a :class:`TraceSummary`; the window is
    the :data:`WINDOW_SPAN` annotation's interval."""
    span = next((e for e in events if e.get("name") == WINDOW_SPAN
                 and e.get("ph") == "X"), None)
    if span is None:
        raise ValueError(f"no {WINDOW_SPAN!r} span in the trace")
    w0 = float(span["ts"])
    w1 = w0 + float(span["dur"])
    main = (span.get("pid"), span.get("tid"))
    kernels = []
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            if ts + dur <= w0 or ts >= w1:
                continue
            args = e.get("args") or {}
            name = e.get("name", "")
            kernels.append(Kernel(base_name(name) if cat == "kernel" else name,
                                  ts, dur,
                                  int(args.get("stream", 0) or 0), cat))
        elif (cat in _HOST_CATS and (e.get("pid"), e.get("tid")) == main
              and e.get("name") != WINDOW_SPAN):
            host.append((ts, ts + dur, e.get("name", "")))
    kernels.sort(key=lambda k: k.ts)
    busy = _union((max(k.ts, w0), min(k.ts + k.dur, w1)) for k in kernels)
    busy_us = sum(e - s for s, e in busy)
    by_op = defaultdict(float)
    for k in kernels:
        by_op[k.base] += k.dur * 1e-6
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host.sort(key=lambda h: (h[0], -h[1]))
    by_host = defaultdict(float)
    mids = [0.5 * (s + e) for s, e in gaps]
    for (s, e), name in zip(gaps, _name_gaps(host, mids)):
        by_host[name] += (e - s) * 1e-6
    return TraceSummary(kernels, (w1 - w0) * 1e-6, busy_us * 1e-6,
                        _largest(by_op), _largest(by_host))


def _largest(totals: dict) -> list:
    return [[name, sec] for name, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def _name_gaps(host: list, mids: list) -> list:
    """The innermost host operation running at each of the sorted times
    ``mids`` (one thread's operations nest, so a stack of the open ones
    holds them), or ``"host: outside any operation"``."""
    out = []
    stack = []
    i = 0
    for t in mids:
        while i < len(host) and host[i][0] <= t:
            s, e, n = host[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, n))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host: outside any operation")
    return out
