"""Fleet-wide observability plane: one pane for N worker processes.

A copy of ``kmeans_tpu/obs/fleetview.py`` on the port's ``obs``.  A fleet
(:mod:`kmeans_tpu_torch.serve.fleet`) breaks the one-process view three
ways, and this module mends each:

* **metrics**: every worker accepts on the same ``SO_REUSEPORT`` port, so
  a scrape of it reaches whichever worker the kernel picks.  Each worker
  opens a second endpoint on an ephemeral port (:class:`WorkerObsServer`,
  announced on its ``FLEET_READY`` line) and the supervisor's
  :class:`FleetObsServer` scrapes them all, parses the text back
  (``obs.registry.parse_exposition``) and exposes every series twice:
  labelled per worker (``worker="0".."N-1"``, the supervisor's own
  registry as ``worker="sup"``) and, for counters and histograms, as an
  unlabelled fleet rollup summed over the worker lanes only
  (:func:`aggregate_families`);
* **traces**: a worker's span ring dies with it.  Workers spool completed
  spans as JSONL to ``<trace_dir>/spans-<pid>.jsonl`` (:class:`SpanSpool`,
  the tracer's sink) and :func:`merge_spool` joins the files into one
  strict-JSON Chrome trace with a process lane per worker, which the
  supervisor serves at ``/api/trace``.  The port's tracer numbers each
  thread's lane once and never hands the number on (see
  :mod:`kmeans_tpu_torch.obs.tracing`), so a merged trace keeps one lane
  per (pid, thread);
* **SLO**: the supervisor's ``/readyz`` is gated on an
  ``obs.slo.SLOMonitor`` fed by its per-worker scrape outcomes.

A dead or garbled worker scrape never poisons the rollup: its lane is
dropped from that pass and ``kmeans_tpu_fleet_scrape_errors_total{worker}``
counts it.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from kmeans_tpu_torch.obs import registry as _registry
from kmeans_tpu_torch.obs.registry import (ParsedFamily, ParsedSample,
                                           parse_exposition,
                                           render_exposition)
from kmeans_tpu_torch.obs import tracing as _tracing

__all__ = [
    "SpanSpool",
    "spool_path",
    "read_spool_events",
    "merge_spool",
    "aggregate_families",
    "aggregate_expositions",
    "WorkerObsServer",
    "FleetObsServer",
    "SUPERVISOR_LANE",
]

_FLEET_SCRAPE_SECONDS = _registry.histogram(
    "kmeans_tpu_fleet_scrape_seconds",
    "Wall time of one supervisor-side scrape of one worker's obs "
    "/metrics endpoint (failures observe their elapsed time too — a "
    "timeout is the slowest scrape there is)",
)
_FLEET_SCRAPE_ERRORS_TOTAL = _registry.counter(
    "kmeans_tpu_fleet_scrape_errors_total",
    "Per-worker scrape failures during fleet /metrics aggregation "
    "(connect/read error, timeout, or unparseable exposition); the "
    "lane is dropped from that pass's rollup, the rest aggregate",
    labels=("worker",),
)

#: The supervisor's own lane label in the aggregated exposition.
SUPERVISOR_LANE = "sup"

#: Metric kinds whose cross-lane sum is meaningful.  Gauges are NOT
#: summed ("rooms in worker 0" + "rooms in worker 1" is fine, but
#: "generation 3" + "generation 3" = 6 is nonsense) — they stay
#: per-lane only.
_ROLLUP_KINDS = frozenset({"counter", "histogram"})

_SPOOL_PREFIX = "spans-"
_SPOOL_RE = re.compile(r"spans-(\d+)\.jsonl\Z")


# --------------------------------------------------------------- trace spool
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


def read_spool_events(trace_dir: str) -> Dict[int, List[dict]]:
    """``{pid: [event, ...]}`` from every spool file under
    ``trace_dir``.  A torn final line (crash mid-append) is skipped;
    any other malformed line raises."""
    out: Dict[int, List[dict]] = {}
    for path in sorted(glob.glob(
            os.path.join(trace_dir, f"{_SPOOL_PREFIX}*.jsonl"))):
        m = _SPOOL_RE.search(os.path.basename(path))
        if m is None:
            continue
        pid = int(m.group(1))
        events: List[dict] = []
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                if i == len(lines) - 1:
                    continue            # torn tail: tolerated
                raise
        out[pid] = events
    return out


def merge_spool(trace_dir: str,
                lane_names: Optional[Dict[int, str]] = None) -> dict:
    """One Chrome trace document over every process's spool: per-pid
    process lanes (``process_name`` metadata, worker slot names when
    ``lane_names`` maps them) plus per-(pid, tid) thread names, then
    every spooled span event.  Strictly JSON-serializable
    (``json.dumps(..., allow_nan=False)`` safe) by construction: the
    spool lines were written with ``allow_nan=False``."""
    by_pid = read_spool_events(trace_dir)
    meta: List[dict] = []
    events: List[dict] = []
    for pid in sorted(by_pid):
        name = (lane_names or {}).get(pid)
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name or f"kmeans_tpu pid {pid}"},
        })
        tids = sorted({e.get("tid", 0) for e in by_pid[pid]})
        for tid in tids:
            meta.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": f"thread-{tid}"},
            })
        events.extend(by_pid[pid])
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


# -------------------------------------------------------------- aggregation
def _lane_key(lane: str):
    """Numeric lanes first in numeric order, then named lanes."""
    return (0, int(lane), "") if lane.isdigit() else (1, 0, lane)


def _with_worker(labels: Tuple[Tuple[str, str], ...],
                 lane: str) -> Tuple[Tuple[str, str], ...]:
    """Re-label a sample with its lane.  A pre-existing ``worker``
    label (e.g. the supervisor's own ``fleet_scrape_errors_total``)
    is renamed ``exported_worker`` — the Prometheus federation
    convention — so the lane label never clobbers it into duplicate
    sample keys."""
    return tuple(("exported_worker" if k == "worker" else k, v)
                 for k, v in labels) + (("worker", lane),)


def aggregate_families(
        lane_families: Dict[str, Dict[str, ParsedFamily]],
) -> Dict[str, ParsedFamily]:
    """Merge per-lane parsed expositions into one fleet exposition.

    Per family (name-sorted): first the **rollup** samples — counter
    and histogram samples summed across every WORKER lane per (sample
    name, label set), so a fleet counter is the arithmetic sum of the
    lanes' and histogram buckets merge bucket-wise — then every lane's
    samples re-labeled with ``worker="<lane>"`` (lanes numeric-first).
    Gauge (and untyped) families get no rollup: summing "current
    value" across processes is semantically wrong, so they stay
    per-lane.  The supervisor lane (``"sup"``) is likewise excluded
    from rollups: its registry is the supervisor *process's* own
    telemetry, and folding a same-named supervisor counter into the
    rollup would break the invariant that a fleet rollup equals the
    sum of the individual worker scrapes.
    """
    names: List[str] = sorted(
        {n for fams in lane_families.values() for n in fams})
    lanes = sorted(lane_families, key=_lane_key)
    out: Dict[str, ParsedFamily] = {}
    for name in names:
        present = [(lane, lane_families[lane][name]) for lane in lanes
                   if name in lane_families[lane]]
        kind = next((f.kind for _, f in present if f.kind != "untyped"),
                    "untyped")
        help_ = next((f.help for _, f in present if f.help), "")
        merged = ParsedFamily(name, kind, help_)
        if kind in _ROLLUP_KINDS:
            # Insertion order follows the first lane that emitted each
            # (sample name, labels) key, so a histogram's rollup keeps
            # its bucket-ascending / _sum / _count order.
            sums: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
            for lane, fam in present:
                if lane == SUPERVISOR_LANE:
                    continue
                for s in fam.samples:
                    key = (s.name, s.labels)
                    sums[key] = sums.get(key, 0.0) + s.value
            for (sname, labels), value in sums.items():
                merged.samples.append(ParsedSample(sname, labels, value))
        for lane, fam in present:
            for s in fam.samples:
                merged.samples.append(ParsedSample(
                    s.name, _with_worker(s.labels, lane), s.value))
        out[name] = merged
    return out


def aggregate_expositions(
        texts: Dict[str, str],
) -> Tuple[Dict[str, ParsedFamily], List[str]]:
    """Parse per-lane exposition texts and aggregate; a lane whose text
    fails to parse is dropped (partial aggregate) and reported in the
    returned ``bad_lanes`` list."""
    lane_families: Dict[str, Dict[str, ParsedFamily]] = {}
    bad: List[str] = []
    for lane, text in texts.items():
        try:
            lane_families[lane] = parse_exposition(text)
        except ValueError:
            bad.append(lane)
    return aggregate_families(lane_families), sorted(bad, key=_lane_key)


# -------------------------------------------------------------- HTTP plumbing
class _ObsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # The obs endpoints are low-rate (scrapes, probes); the default
    # backlog is plenty, unlike the serving port's 128.
    allow_reuse_address = True


def _scrape(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


class _BaseObsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):          # pragma: no cover
        pass                                    # probes must not spam stderr

    def _send(self, status: int, body: bytes,
              content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, obj) -> None:
        self._send(status, json.dumps(obj, allow_nan=False).encode())


_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class WorkerObsServer:
    """A worker's private obs endpoint on an ephemeral port.

    The serving port is ``SO_REUSEPORT``-shared across the fleet, so a
    scrape of it lands on an arbitrary worker; this second tiny server
    gives the supervisor a per-worker address.  Routes: ``/metrics``
    (this process's registry) and ``/api/trace`` (this process's span
    ring).  The bound port is announced to the supervisor through the
    worker's ``FLEET_READY`` line (``obs=<port>``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):

        class Handler(_BaseObsHandler):
            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, _registry.REGISTRY.expose().encode(),
                               _PROM_CONTENT_TYPE)
                elif self.path == "/api/trace":
                    self._send(200,
                               _tracing.TRACER.export_chrome_trace()
                               .encode())
                else:
                    self._send_json(404, {"error": "not found"})

        self._httpd = _ObsHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WorkerObsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="worker-obs", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class FleetObsServer:
    """The supervisor's observability endpoint (one pane for the fleet).

    Routes:

    * ``GET /metrics`` — scrape every live worker's obs endpoint, parse,
      aggregate (:func:`aggregate_families`: per-worker labels +
      worker-lane rollups, supervisor's own registry riding along as
      lane ``"sup"``), re-expose.  A failed
      or unparseable worker scrape drops that lane and bumps
      ``kmeans_tpu_fleet_scrape_errors_total{worker=...}``; every scrape
      outcome also feeds the supervisor's SLO monitor.
    * ``GET /api/trace`` — the merged trace-spool view across worker
      pids (requires a configured ``trace_dir``; 503 otherwise).
    * ``GET /healthz`` — supervisor process liveness.
    * ``GET /readyz`` — 200 only while ``ready_fn`` says the fleet can
      serve AND no SLO burn window is in breach.

    ``targets_fn`` returns the live ``[(lane, obs_port), ...]`` list on
    every scrape — the supervisor's worker table is the source of
    truth, so respawns and drains are picked up without re-wiring.
    """

    def __init__(self, *,
                 targets_fn: Callable[[], List[Tuple[str, int]]],
                 host: str = "127.0.0.1", port: int = 0,
                 trace_dir: Optional[str] = None,
                 lane_names_fn: Optional[
                     Callable[[], Dict[int, str]]] = None,
                 slo=None,
                 ready_fn: Optional[Callable[[], Tuple[bool, dict]]] = None,
                 scrape_timeout_s: float = 2.0):
        self._targets_fn = targets_fn
        self._trace_dir = trace_dir
        self._lane_names_fn = lane_names_fn
        self._slo = slo
        self._ready_fn = ready_fn
        self._timeout = float(scrape_timeout_s)
        outer = self

        class Handler(_BaseObsHandler):
            def do_GET(self):
                if self.path == "/metrics":
                    body = outer.scrape_fleet().encode()
                    self._send(200, body, _PROM_CONTENT_TYPE)
                elif self.path == "/api/trace":
                    outer._handle_trace(self)
                elif self.path == "/healthz":
                    self._send_json(200, {"ok": True, "role": "supervisor"})
                elif self.path == "/readyz":
                    ready, detail = outer.readiness()
                    self._send_json(200 if ready else 503, detail)
                else:
                    self._send_json(404, {"error": "not found"})

        self._httpd = _ObsHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- scraping
    def scrape_fleet(self) -> str:
        """One aggregated exposition pass over the live fleet."""
        texts: Dict[str, str] = {}
        for lane, port in self._targets_fn():
            t0 = time.perf_counter()
            failed = False
            try:
                texts[lane] = _scrape(
                    f"http://127.0.0.1:{port}/metrics", self._timeout)
            except Exception:
                failed = True
            elapsed = time.perf_counter() - t0
            _FLEET_SCRAPE_SECONDS.observe(elapsed)
            if failed:
                _FLEET_SCRAPE_ERRORS_TOTAL.labels(worker=lane).inc()
            if self._slo is not None:
                self._slo.record(elapsed, error=failed)
        # The supervisor lane is rendered LAST so this pass's scrape
        # durations/errors are already in it.
        texts[SUPERVISOR_LANE] = _registry.REGISTRY.expose()
        families, bad = aggregate_expositions(texts)
        for lane in bad:
            _FLEET_SCRAPE_ERRORS_TOTAL.labels(worker=lane).inc()
        if bad:
            # The error bumps above postdate the sup lane's render;
            # re-aggregate so the exposition the scraper sees already
            # reflects them.
            texts = {k: v for k, v in texts.items()
                     if k not in bad or k == SUPERVISOR_LANE}
            texts[SUPERVISOR_LANE] = _registry.REGISTRY.expose()
            families, _ = aggregate_expositions(texts)
        return render_exposition(families.values())

    # ------------------------------------------------------------ readiness
    def readiness(self) -> Tuple[bool, dict]:
        ready, detail = (True, {}) if self._ready_fn is None \
            else self._ready_fn()
        detail = dict(detail)
        if self._slo is not None:
            # Evaluate FIRST (healthy() re-runs the burn math, rate
            # limited by eval_s) so the breach list reflects this
            # evaluation, not the previous one.
            if not self._slo.healthy():
                ready = False
            detail["slo"] = {
                "breaches": [list(b) for b in self._slo.breaches()],
                "windows": self._slo.snapshot(),
            }
        detail["ready"] = ready
        return ready, detail

    # ---------------------------------------------------------------- trace
    def _handle_trace(self, handler: _BaseObsHandler) -> None:
        if self._trace_dir is None:
            handler._send_json(503, {
                "error": "no trace_dir configured; the merged fleet "
                         "trace needs ServeConfig.trace_dir"})
            return
        lane_names = (self._lane_names_fn() if self._lane_names_fn
                      else {})
        doc = merge_spool(self._trace_dir, lane_names)
        handler._send(200, json.dumps(doc, allow_nan=False).encode())

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetObsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="fleet-obs", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
