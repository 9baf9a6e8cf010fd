"""HTTP/SSE server: the board and ``POST /api/assign``, on the card.

Counterpart of ``kmeans_tpu/serve/server.py``: :class:`KMeansServer` and
:func:`serve` answer every route of the reference's server, with its status
codes, headers and bodies.

The board (the reference's collaborative k-means app, served same-origin):

* ``/``, ``/index.html`` and ``/app.js`` (copies of the reference's
  ``serve/static/``); ``GET /api/state`` (a room's cards, zones, metrics,
  deltas, suggestions, presence and peers), ``/api/export``, ``/api/events``
  (SSE: a ``hello``, then numbered ``change`` / ``train`` events, replayed
  after ``Last-Event-ID`` from a per-room ring, a keepalive comment or a
  ping when idle), ``POST /api/mutate`` (every op of the reference's
  ``apply``), ``/api/hello`` and ``/api/import``; 400 for a bad op or body,
  409 past the centroid cap, 413 past ``max_import_bytes`` or
  ``max_render_cards``, 503 + ``Retry-After`` when the room table or the
  train slots are full.
* Rooms live in a bounded table (the longest-idle room without
  subscribers is evicted) and, with ``persist_dir``, on disk: every
  version bump schedules a debounced atomic write of the room's export
  JSON, boot reloads the directory, and an evicted room revives from its
  file.  The file is the reference's format: a room saved by either
  package revives in the other.
* The ``autoAssign`` op fits on the server's device
  (:func:`kmeans_tpu_torch.session.auto_assign`); the ``train`` op runs
  ``lloyd`` on :class:`~kmeans_tpu_torch.models.runner.LloydRunner` (one
  SSE ``train`` event per iteration, with the live centroid positions at
  d = 2 and k <= 64), and ``accelerated``, ``minibatch`` and ``trimmed``
  in one call, on a worker thread that shares the device with the
  assignment engine; a k > 3 result is merged to the board through
  :func:`~kmeans_tpu_torch.models.hierarchy.merge_to_k`.

The model routes:

* ``POST /api/assign``: JSON or the binary frames of
  :mod:`kmeans_tpu_torch.serve.assign`, per-tenant admission first, then
  the registry's current generation through the assignment engine on the
  server's device (the card unless ``device="cpu"``); with the distances
  flag the handler computes the distances on the host.  404 without a
  registry, 503 + ``Retry-After`` before the first generation or under
  backpressure, 413 past ``assign_max_points``, 400 for a bad shape, a NaN
  or a malformed frame.
* ``GET /api/model``, ``POST /api/model/reload``, ``/healthz``,
  ``/readyz`` (gated on the model, the engine and, with ``slo``, the
  burn-rate monitor), ``/metrics`` and ``/api/trace``.

Known differences from the reference:

* :meth:`KMeansServer.stop` drains: it ends every SSE stream, then lets
  every accepted request finish on the engine before it stops, where the
  reference's stop fails the queued ones with 503; a fleet worker's drain
  (:mod:`kmeans_tpu_torch.serve.fleet`) relies on it.  Rooms with a
  pending save are written after the drain.
* The ``train`` op's data is the port's ``make_blobs`` from a
  :class:`torch.Generator` seeded with ``seed`` (and its k-means++ from
  ``seed + 1``), not the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import queue
import random
import re
import socket
import sys
import threading
import time
import urllib.parse
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from kmeans_tpu_torch import obs
from kmeans_tpu_torch.config import MAX_CENTROIDS, ServeConfig
from kmeans_tpu_torch.continuous.registry import ModelRegistry
from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.obs import tracing as _tracing
from kmeans_tpu_torch.obs.fleetview import SpanSpool
from kmeans_tpu_torch.obs.slo import SLOMonitor
from kmeans_tpu_torch.serve import assign as serve_assign
from kmeans_tpu_torch.session import (
    CentroidLimitError,
    Document,
    auto_assign,
    dataset_to_document,
    ensure_jessica_once,
    export_filename,
    export_json,
    hard_reset,
    import_json,
    metrics_deltas,
    populate_test_data,
    snapshot_metrics,
    suggestion_from_counts,
    to_plain,
    trait_counts_for,
)
from kmeans_tpu_torch.session.schema import _js_safe, parse_import
from kmeans_tpu_torch.utils import faults
from kmeans_tpu_torch.utils.rooms import code4

__all__ = ["KMeansServer", "serve", "RoomTableFullError", "CapacityError"]

_STATIC = Path(__file__).parent / "static"

# ---------------------------------------------------------------------------
# HTTP observability, the reference's families.  ``route`` is normalized to
# the known endpoint set, the reference's, board routes included, so that
# arbitrary paths mint no label values and the labels match its server's.
# ---------------------------------------------------------------------------
_HTTP_REQUESTS_TOTAL = obs.counter(
    "kmeans_tpu_http_requests_total",
    "HTTP requests handled by the serve layer",
    labels=("method", "route", "status"),
)
_HTTP_REQUEST_SECONDS = obs.histogram(
    "kmeans_tpu_http_request_seconds",
    "HTTP request handling wall time (SSE subscriptions excluded)",
    labels=("method", "route"),
)
_HTTP_503_TOTAL = obs.counter(
    "kmeans_tpu_http_503_total",
    "Capacity rejections (503 + Retry-After: train slots or room table "
    "exhausted)",
)
_TRAIN_STARTED_TOTAL = obs.counter(
    "kmeans_tpu_train_started_total",
    "Training jobs accepted by the serve layer",
    labels=("model",),
)
_TRAIN_ERRORS_TOTAL = obs.counter(
    "kmeans_tpu_train_errors_total",
    "Training jobs that ended in a train_error event",
)
_ROOMS_GAUGE = obs.gauge(
    "kmeans_tpu_rooms",
    "Rooms currently resident in the server's room table",
)
_TRAIN_SLOTS_IN_USE = obs.gauge(
    "kmeans_tpu_train_slots_in_use",
    "Training worker slots currently held (the training-queue depth "
    "against ServeConfig.max_concurrent_train)",
)
_SSE_SUBSCRIBERS = obs.gauge(
    "kmeans_tpu_sse_subscribers",
    "Live SSE subscriber connections across all rooms",
)
_ASSIGN_POINTS_TOTAL = obs.counter(
    "kmeans_tpu_assign_points_total",
    "Points labeled by the /api/assign nearest-centroid endpoint",
)
_REQUESTS_SHED_TOTAL = obs.counter(
    "kmeans_tpu_requests_shed_total",
    "Requests shed by per-tenant admission control (token bucket "
    "exhausted, or the tenant's priority class crossed its overload "
    "shed threshold) — 503 + honest Retry-After, counted by the "
    "tenant's priority class, before any model work or body parse",
    labels=("tenant_class",),
)

_KNOWN_ROUTES = frozenset((
    "/", "/index.html", "/app.js", "/api/state", "/api/export",
    "/api/events", "/api/mutate", "/api/hello", "/api/import",
    "/healthz", "/readyz", "/metrics", "/api/trace", "/api/assign",
    "/api/model", "/api/model/reload",
))


def _route_label(path: str) -> str:
    return path if path in _KNOWN_ROUTES else "other"


#: Probe and introspection routes the SLO monitor never records: a breached
#: /readyz answers 503 by design, and feeding it back into the burn rate
#: would make a breach sustain itself.
_SLO_EXEMPT_ROUTES = frozenset((
    "/healthz", "/readyz", "/metrics", "/api/trace", "/api/events",
))

#: The ``train`` op's one-shot families (``lloyd`` streams per iteration
#: on the runner instead): op name -> fit on ``kmeans_tpu_torch.models``.
_TRAIN_FITS = {
    "accelerated": "fit_lloyd_accelerated",
    "minibatch": "fit_minibatch",
    "spherical": "fit_spherical",
    "bisecting": "fit_bisecting",
    "fuzzy": "fit_fuzzy",
    "gmm": "fit_gmm",
    "kernel": "fit_kernel_kmeans",
    "kmedoids": "fit_kmedoids",
    "trimmed": "fit_trimmed",   # outliers come back as unassigned cards
    "balanced": "fit_balanced",  # same-size clusters via Sinkhorn OT
    "spectral": "fit_spectral",  # graph clustering (rings/moons shapes)
    "xmeans": "fit_xmeans",     # k acts as k_max; BIC discovers the k
    "gmeans": "fit_gmeans",     # k_max likewise; Anderson-Darling test
}

#: k-medoids' medoid update is O(n²·d): the cap on what one request may
#: demand of the server.
_KMEDOIDS_MAX_N = 20_000

def _state_k(state) -> int:
    """The fitted k of a state: its center array's rows (x-means and
    g-means return fewer than k_max), else the length of its per-cluster
    counts (kernel k-means has no input-space centers)."""
    from kmeans_tpu_torch.models import state_centers

    centers = state_centers(state)
    if centers is not None:
        return centers.shape[0]
    return state.counts.shape[0]


#: The reference's deploy-time security headers, on every response.
_SECURITY_HEADERS = {
    "Content-Security-Policy": (
        "default-src 'none'; script-src 'self'; style-src 'self' "
        "'unsafe-inline'; img-src 'self' data:; connect-src 'self'; "
        "base-uri 'none'; form-action 'self'; frame-ancestors 'none'"
    ),
    "Referrer-Policy": "no-referrer",
    "Permissions-Policy": (
        "camera=(), microphone=(), geolocation=(), payment=()"
    ),
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "Cache-Control": "no-store",
}

#: Refcounted holds on the process-global span tracer: overlapping server
#: lifetimes must not let the first stop() switch tracing off under a
#: server still running.  The switch state seen before the first hold is
#: restored when the last hold releases.
_TRACER_HOLDS_LOCK = threading.Lock()
_TRACER_HOLDS = [0]
_TRACER_PRIOR = [False]

#: Seconds a presence heartbeat keeps a name on the roster.
_PRESENCE_TTL_S = 30.0

#: Per-room SSE event ring: numbered events a reconnecting subscriber
#: replays with ``Last-Event-ID`` (512 covers a 100-iteration train stream
#: plus board chatter across a reconnect).
_EVENT_RING = 512

#: SSE liveness cadence: a ``: keepalive`` comment every idle interval; every
#: third idle interval the full ping event (version + peers) instead.
_SSE_IDLE_S = 5.0

#: Room codes: the reference's alphabet shape, alnum / dash, <= 16 chars
#: (app.mjs:19), which keeps arbitrary strings out of file names.
_ROOM_RE = re.compile(r"[A-Z0-9-]{1,16}")
_MAX_ROOMS = 256

#: Ceiling on the queue-derived ``Retry-After`` (seconds): past a minute
#: the estimate reports an outage, not backpressure.
_RETRY_AFTER_CAP = 60.0


class RoomTableFullError(RuntimeError):
    """Every resident room has subscribers -> 503 with ``Retry-After``."""


class CapacityError(RuntimeError):
    """Server-wide train capacity exhausted -> 503 with ``Retry-After``."""


class PayloadTooLargeError(ValueError):
    """Request body (or imported board) exceeds a configured cap -> 413."""


class _TenantAdmission:
    """Per-tenant admission control and priority-ordered load shedding on
    ``POST /api/assign``, the reference's.

    ``ServeConfig.tenant_classes`` declares ``(class, priority,
    rate_per_s, burst)`` tuples; a request's ``X-Tenant`` names its tenant,
    whose class is the one it names (anything else, no header included,
    falls to the lowest-priority class).  Two gates: a token bucket per
    tenant at its class's rate (0 = unmetered; LRU-bounded table), and
    shedding by priority once the assign queue passes
    ``shed_start_fraction`` of its limit, lowest priority first, the top
    class only at a full queue.  Disabled, at the cost of one attribute
    read, when ``tenant_classes`` is empty.
    """

    _MAX_TENANTS = 1024

    def __init__(self, config: ServeConfig):
        classes = tuple(config.tenant_classes or ())
        self.enabled = bool(classes)
        if not self.enabled:
            return
        self._classes = {}
        for name, prio, rate, burst in classes:
            self._classes[str(name)] = (int(prio), float(rate),
                                        float(burst))
        ranked = sorted(self._classes,
                        key=lambda n: self._classes[n][0])
        self.default_class = ranked[0]
        start = min(max(float(config.shed_start_fraction), 0.0), 1.0)
        n = len(ranked)
        #: class -> queue-fraction threshold at which it sheds.
        self._shed_at = {
            name: (start if n == 1
                   else start + (1.0 - start) * (i / (n - 1)))
            for i, name in enumerate(ranked)
        }
        self._buckets: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def resolve(self, tenant: Optional[str]) -> str:
        """The priority class a request's ``X-Tenant`` value lands in."""
        t = (tenant or "").strip()
        return t if t in self._classes else self.default_class

    def decide(self, tenant: Optional[str], queue_fraction: float,
               now: Optional[float] = None) -> Optional[tuple]:
        """``None`` = admitted; ``(tenant_class, reason)`` = shed.
        ``queue_fraction`` is the measured assign-queue depth over its
        limit."""
        if not self.enabled:
            return None
        cls = self.resolve(tenant)
        prio, rate, burst = self._classes[cls]
        if queue_fraction >= self._shed_at[cls]:
            return (cls, f"overloaded (assign queue at "
                         f"{queue_fraction:.0%}); tenant class "
                         f"{cls!r} shed first — retry shortly")
        if rate <= 0.0:
            return None
        key = (tenant or "").strip() or cls
        t = time.monotonic() if now is None else now
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                # A fresh bucket is born full.
                b = self._buckets[key] = [burst, t]
                while len(self._buckets) > self._MAX_TENANTS:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(key)
            tokens, last = b
            tokens = min(burst, tokens + (t - last) * rate)
            if tokens >= 1.0:
                b[0], b[1] = tokens - 1.0, t
                return None
            b[0], b[1] = tokens, t
        return (cls, f"tenant {key!r} over its {rate:g} req/s rate; "
                     "retry shortly")


class _Room:
    """One board: its document, presence, SSE subscribers and event ring,
    the reference's."""

    def __init__(self, code: str):
        self.code = code
        self.doc = Document(room=code)
        self.subscribers: Dict[int, queue.Queue] = {}
        self.presence: Dict[str, float] = {}     # name -> last heartbeat
        self.last_active = time.time()
        #: (event_id, event) ring for Last-Event-ID replay; ids are
        #: per-room, increasing, never reused.
        self.events: "collections.deque" = collections.deque(
            maxlen=_EVENT_RING)
        self._next_event_id = 1
        self._next_sub = 0
        self._lock = threading.Lock()
        self.train_lock = threading.Lock()
        #: Debounce timer of the durability writer (None: nothing pending).
        self._save_timer: Optional[threading.Timer] = None
        ensure_jessica_once(self.doc)
        self.doc.on_change(self._broadcast)

    def touch(self) -> None:
        self.last_active = time.time()

    # -- presence ----------------------------------------------------------
    def hello(self, name: str) -> None:
        if name:
            with self._lock:
                self.presence[name] = time.time()

    def roster(self) -> list:
        now = time.time()
        with self._lock:
            stale = [n for n, t in self.presence.items()
                     if now - t > _PRESENCE_TTL_S]
            for n in stale:
                del self.presence[n]
            return sorted(self.presence)

    # -- SSE ---------------------------------------------------------------
    def subscribe(self) -> tuple:
        with self._lock:
            sid = self._next_sub
            self._next_sub += 1
            q: queue.Queue = queue.Queue(maxsize=64)
            self.subscribers[sid] = q
            return sid, q

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self.subscribers.pop(sid, None)

    def wake_subscribers(self) -> None:
        """Put the end-of-stream mark (None) in every subscriber's queue: a
        draining server ends its streams."""
        with self._lock:
            for q in self.subscribers.values():
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass   # its loop checks the drain flag at its next event

    def _broadcast(self, doc: Document) -> None:
        self.broadcast_event({"type": "change", "version": doc.version})

    def broadcast_event(self, event: dict) -> None:
        with self._lock:
            eid = self._next_event_id
            self._next_event_id += 1
            self.events.append((eid, event))
            for q in self.subscribers.values():
                try:
                    q.put_nowait((eid, event))
                except queue.Full:
                    pass   # a slow client refetches state on its next event

    def events_since(self, last_id: int) -> list:
        """Ring events newer than ``last_id`` (Last-Event-ID replay); a
        reconnect whose id fell off the ring gets what the ring holds."""
        with self._lock:
            return [(i, e) for i, e in self.events if i > last_id]

    def peer_count(self) -> int:
        with self._lock:
            return len(self.subscribers)

    # -- state payload ------------------------------------------------------
    def state(self) -> dict:
        doc = self.doc
        with doc.read_lock():
            return self._state_locked()

    def _state_locked(self) -> dict:
        doc = self.doc
        now_m = snapshot_metrics(doc.cards, doc.centroids)
        prev = doc.meta.get("prevSnapshot")
        suggestions = {}
        for cent in doc.centroids:
            cs = [c for c in doc.cards if c.get("assignedTo") == cent["id"]]
            counts = trait_counts_for(cs)
            top = sorted(
                counts.values(), key=lambda v: (-v["count"], v["label"])
            )[:3]
            suggestions[cent["id"]] = {
                "top": top,
                "suggested": suggestion_from_counts(counts),
            }
        return _js_safe({
            "room": self.code,
            "version": doc.version,
            "cards": doc.cards,
            "centroids": doc.centroids,
            "meta": doc.meta,
            "metrics": now_m,
            "deltas": metrics_deltas(prev, now_m),
            "suggestions": suggestions,
            "unassigned": doc.unassigned_count,
            "presence": self.roster(),
            "peers": max(0, self.peer_count() - 1),
            "maxCentroids": MAX_CENTROIDS,
        })


class _BackloggedHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a serving-grade accept backlog (128, not
    socketserver's 5, which overflows at a few hundred connections a
    second), and ``SO_REUSEPORT`` set before the bind when asked.

    It counts its busy requests for a drain: a connection's first request
    from its accept, each later keep-alive request from its parse, each
    until its response is written (:meth:`wait_idle`).  Once ``draining``
    is set every response carries ``Connection: close``."""

    request_queue_size = 128

    def __init__(self, addr, handler, *, reuse_port: bool = False):
        self._reuse_port = bool(reuse_port)
        self._busy = 0
        self._busy_cv = threading.Condition()
        self.draining = False
        super().__init__(addr, handler)

    def process_request(self, request, client_address):
        self.busy(+1)
        try:
            super().process_request(request, client_address)
        except BaseException:
            self.busy(-1)
            raise

    def busy(self, delta: int) -> None:
        with self._busy_cv:
            self._busy += delta
            if self._busy <= 0:
                self._busy_cv.notify_all()

    def serve_pending(self) -> None:
        """Hand each connection already in the accept queue to a handler
        (after the serve loop has stopped), so that closing the listener
        resets none of them: the serve loop's last wake-up is a
        connection it leaves unaccepted."""
        if self.socket.fileno() < 0:     # closed by an earlier stop()
            return
        self.socket.setblocking(False)
        while True:
            try:
                request, client_address = self.get_request()
            except OSError:          # the queue is empty
                return
            request.setblocking(True)
            try:
                self.process_request(request, client_address)
            except Exception:
                self.handle_error(request, client_address)
                self.shutdown_request(request)

    def wait_idle(self, timeout: float) -> int:
        """Wait, at most ``timeout`` seconds, until no accepted request is
        unanswered; returns how many still are."""
        with self._busy_cv:
            self._busy_cv.wait_for(lambda: self._busy <= 0, timeout)
            return max(self._busy, 0)

    def server_bind(self):
        if self._reuse_port:
            if not hasattr(socket, "SO_REUSEPORT"):
                raise OSError(
                    "reuse_port requested but this platform has no "
                    "SO_REUSEPORT — a fleet cannot share the port")
            self.socket.setsockopt(socket.SOL_SOCKET,
                                   socket.SO_REUSEPORT, 1)
        super().server_bind()


class KMeansServer:
    """The board's rooms, the model registry, the assignment engine and the
    HTTP server object.

    ``registry`` injects a live
    :class:`~kmeans_tpu_torch.continuous.registry.ModelRegistry` (a
    publisher in the same process swaps generations under running
    requests); with ``config.model_dir`` and no registry one is built over
    that directory and its newest verified generation restored.  The
    engine scores, and the board's ``autoAssign`` and ``train`` ops fit, on
    ``device``: None is the card, and with no card the constructor raises
    (pass ``device="cpu"`` to run the plain versions).  With
    ``config.persist_dir`` the rooms saved there are revived at
    construction.
    """

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 registry=None, device=None):
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        self.model_registry = registry
        if self.model_registry is None and self.config.model_dir:
            self.model_registry = ModelRegistry(path=self.config.model_dir)
            # A missing checkpoint is a fresh deployment (503 until a
            # generation lands); a corrupt one propagates.
            self.model_registry.load_latest()
        # The engine is a queue until the first /api/assign submit starts
        # its dispatcher; assign_batching=False keeps the per-request
        # NumPy path.
        self.assign_engine = (
            serve_assign.AssignEngine(self.current_model, self.config,
                                      device=self.device)
            if self.config.assign_batching else None)
        self.admission = _TenantAdmission(self.config)
        #: Burn-rate SLO monitor (``config.slo``): fed by every finished
        #: non-probe request, gates readiness().
        self.slo_monitor = None
        if self.config.slo:
            self.slo_monitor = SLOMonitor(
                latency_target_s=self.config.slo_latency_target_s,
                latency_objective=self.config.slo_latency_objective,
                availability_objective=(
                    self.config.slo_availability_objective),
                windows_s=tuple(self.config.slo_windows_s),
                burn_thresholds=tuple(self.config.slo_burn_thresholds),
                min_samples=self.config.slo_min_samples,
                eval_s=self.config.slo_eval_s,
            )
        #: Span spool (config.trace_dir), the tracer's completed-span sink
        #: for the start()..stop() window.
        self._span_spool = None
        self._train_sem = threading.BoundedSemaphore(
            self.config.max_concurrent_train)
        #: Train slots currently held, tracked beside the semaphore for
        #: the queue-depth gauge.
        self._train_inflight = 0
        self._train_inflight_lock = threading.Lock()
        self.rooms: Dict[str, _Room] = {}
        self._save_locks: Dict[str, threading.Lock] = {}
        self._save_locks_guard = threading.Lock()
        self._lock = threading.Lock()
        #: Set when stop() begins: every SSE stream ends at its next wake.
        self._streams_closed = threading.Event()
        self.httpd: Optional[ThreadingHTTPServer] = None
        # Scrape-time gauges over the live table and semaphore; the last
        # server constructed in a process owns them, as in the reference.
        _ROOMS_GAUGE.set_function(lambda: len(self.rooms))
        _TRAIN_SLOTS_IN_USE.set_function(lambda: self._train_inflight)
        _SSE_SUBSCRIBERS.set_function(
            lambda: sum(r.peer_count() for r in list(self.rooms.values())))
        if self.config.telemetry_path:
            # Fail at construction, before any process-global state
            # changes, so a failed construction leaves nothing behind.
            try:
                obs.probe_writable(self.config.telemetry_path)
            except OSError as e:
                raise ValueError(
                    f"telemetry_path {self.config.telemetry_path!r} is "
                    f"not writable: {e}"
                ) from e
        obs.record_build_info(self.device.type)
        self._tracer_held = False
        #: Accepted requests the last stop() left unanswered when its
        #: drain ran out of ``fleet_drain_s`` (0 on a clean drain).
        self.drain_unanswered = 0
        if self.config.persist_dir:
            os.makedirs(self.config.persist_dir, exist_ok=True)
            self._load_persisted_rooms()

    # --------------------------------------------------------- durability
    # Every version bump debounce-schedules an atomic export-JSON write and
    # boot reloads whatever the directory holds: kill -9 at any moment
    # loses at most the last debounce window.

    def _room_path(self, code: str) -> str:
        return os.path.join(self.config.persist_dir, f"{code}.json")

    def _revive_or_create(self, code: str) -> _Room:
        """A room missing from the table: its persisted board if one
        exists (an evicted room must not come back as a fresh seed doc
        whose first save would overwrite the file), else a fresh room."""
        room = _Room(code)
        if self.config.persist_dir:
            path = self._room_path(code)
            if os.path.exists(path):
                try:
                    with open(path, encoding="utf-8") as f:
                        import_json(room.doc, f.read())
                except Exception as e:
                    print(f"kmeans_tpu.serve: could not revive room "
                          f"{path}: {e}", file=sys.stderr)
        return room

    def _load_persisted_rooms(self) -> None:
        # At most the room-table bound, newest first: eviction never
        # deletes files, and the rest revive on first access.
        paths = sorted(
            glob.glob(os.path.join(self.config.persist_dir, "*.json")),
            key=lambda p: os.path.getmtime(p), reverse=True,
        )
        for path in paths[:_MAX_ROOMS]:
            code = os.path.splitext(os.path.basename(path))[0]
            if not _ROOM_RE.fullmatch(code):
                continue                      # a foreign file, not ours
            room = self._revive_or_create(code)
            self._wire_persistence(room)
            with self._lock:
                self.rooms[code] = room

    def _wire_persistence(self, room: _Room) -> None:
        if not self.config.persist_dir:
            return
        room.doc.on_change(lambda _doc: self._schedule_save(room))

    def _schedule_save(self, room: _Room) -> None:
        delay = max(0.0, float(self.config.persist_debounce_s))
        with room._lock:
            if room._save_timer is not None:
                return                        # a write is already pending
            t = threading.Timer(delay, self._save_room, args=(room,))
            t.daemon = True
            room._save_timer = t
            t.start()

    def _code_save_lock(self, code: str) -> threading.Lock:
        """One save lock per room code, not per _Room: a fired timer of an
        evicted instance and its revived successor must not interleave."""
        with self._save_locks_guard:
            lock = self._save_locks.get(code)
            if lock is None:
                lock = self._save_locks[code] = threading.Lock()
            return lock

    def _flush_pending_save(self, room: _Room, *,
                            always: bool = False) -> None:
        """Cancel a pending debounce timer and write now (when one was
        pending, or with ``always``)."""
        with room._lock:
            pending = room._save_timer is not None
            if pending:
                room._save_timer.cancel()
        if pending or always:
            self._save_room(room)

    def _save_room(self, room: _Room) -> None:
        with room._lock:
            room._save_timer = None
        try:
            # One writer at a time per room code, and a per-thread tmp
            # name, so os.replace never publishes a torn or stale file.
            with self._code_save_lock(room.code):
                with room.doc.read_lock():
                    text = export_json(room.doc)
                path = self._room_path(room.code)
                tmp = (f"{path}.tmp.{os.getpid()}."
                       f"{threading.get_ident()}")
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(text)
                os.replace(tmp, path)         # atomic: never a torn file
        except Exception as e:
            print(f"kmeans_tpu.serve: persisting room {room.code} failed: "
                  f"{e}", file=sys.stderr)

    def flush_rooms(self) -> None:
        """Write every room with a pending debounced save now (a clean
        shutdown; kill -9 skips this and loses only the debounce window)."""
        if not self.config.persist_dir:
            return
        for room in list(self.rooms.values()):
            self._flush_pending_save(room)

    def current_model(self):
        """The registry's current generation, or None (no registry or
        nothing published): the one read the /api/assign path does."""
        reg = self.model_registry
        return reg.current() if reg is not None else None

    def assign_queue_fraction(self) -> float:
        """Measured assign-queue depth over its limit, in [0, 1]: the
        overload signal admission control sheds on (0.0 on the direct
        path, which has no queue)."""
        eng = self.assign_engine
        if eng is None:
            return 0.0
        limit = max(1, int(self.config.assign_pending_limit))
        return min(1.0, eng.queue_depth() / limit)

    def retry_after_s(self) -> float:
        """``Retry-After``: the measured backlog over the measured drain
        rate, capped, with the static ``retry_after_s`` as its floor and
        its no-signal value."""
        floor = float(self.config.retry_after_s)
        eng = self.assign_engine
        if eng is None:
            return floor
        depth, rate = eng.queue_depth(), eng.drain_rate()
        if depth <= 0 or rate <= 0.0:
            return floor
        return min(max(depth / rate, floor), _RETRY_AFTER_CAP)

    def readiness(self) -> tuple:
        """``(ready, detail)`` for ``GET /readyz``: ready iff a model is
        servable (or no registry is configured), the engine has not been
        stopped, and no SLO burn window is in breach (with ``slo``)."""
        gen = self.current_model()
        model_ready = self.model_registry is None or gen is not None
        eng = self.assign_engine
        engine_ready = eng is None or not eng.closed
        detail = {
            "model": "none" if self.model_registry is None
                     else (gen.generation if gen is not None else 0),
            "engine": ("direct" if eng is None
                       else "stopped" if eng.closed else "warm"),
        }
        slo_ready = True
        mon = self.slo_monitor
        if mon is not None:
            slo_ready = mon.healthy()
            detail["slo"] = {
                "ok": slo_ready,
                "breaches": [list(b) for b in mon.breaches()],
            }
        return model_ready and engine_ready and slo_ready, detail

    def assign_points(self, points):
        """Label ``points`` (n, d) float32: returns ``(labels, generation,
        path)`` with ``path`` ``batched`` (the engine) or ``direct``
        (per-request NumPy, ``assign_batching=False``).  Raises the
        engine's retryable errors (-> 503) or ValueError (-> 400)."""
        eng = self.assign_engine
        if eng is not None:
            labels, gen = eng.submit(points)
            return labels, gen, "batched"
        gen = self.current_model()
        if gen is None:
            raise serve_assign.NoModelError(
                "no model generation published yet; retry shortly")
        if points.ndim != 2 or points.shape[1] != gen.d:
            raise ValueError(
                f"points must be (n, {gen.d}) for generation "
                f"{gen.generation}; got shape {tuple(points.shape)}")
        return serve_assign.assign_direct(gen, points), gen, "direct"

    def room(self, code: Optional[str]) -> _Room:
        """The room of ``code`` (normalized to the reference's room-code
        shape; a fresh code when none is usable), revived or created when
        it is not resident.  A full table evicts its longest-idle room
        without subscribers, after writing it; RoomTableFullError when
        every room has one."""
        code = (code or "").strip().upper()
        if not _ROOM_RE.fullmatch(code or ""):
            code = code4() if not code else "".join(
                ch for ch in code if ch.isalnum() or ch == "-"
            )[:16] or code4()
        with self._lock:
            room = self.rooms.get(code)
            if room is None:
                if len(self.rooms) >= _MAX_ROOMS:
                    idle = [r for r in self.rooms.values()
                            if r.peer_count() == 0]
                    if not idle:
                        raise RoomTableFullError(
                            f"room table full ({_MAX_ROOMS} active rooms)"
                        )
                    victim = min(idle, key=lambda r: r.last_active)
                    # On disk before its code can revive (under the lock,
                    # so no revive overtakes the flush).
                    if self.config.persist_dir:
                        self._flush_pending_save(victim, always=True)
                    del self.rooms[victim.code]
                room = self.rooms[code] = self._revive_or_create(code)
                self._wire_persistence(room)
            room.touch()
            return room

    # ------------------------------------------------------------- mutate
    def apply(self, room: _Room, op: str, args: dict) -> dict:
        """Apply one mutation op (the reference's: the board's controls
        plus ``autoAssign`` and ``train``); returns a small result
        payload."""
        doc = room.doc
        if op == "addCard":
            title = str(args.get("title", "")).strip()
            if not title:
                raise ValueError("title required")     # app.mjs:251 guard
            card = doc.add_card(
                title,
                (str(args.get("traitA", "")).strip(),
                 str(args.get("traitB", "")).strip()),
                created_by=str(args.get("by", "anon")) or "anon",
            )
            return {"id": card["id"]}
        if op == "addCentroid":
            cent = doc.add_centroid(str(args.get("name", "")).strip())
            return {"id": cent["id"]}
        if op == "removeCentroid":
            doc.remove_centroid(args["id"])
            return {}
        if op == "renameCentroid":
            doc.rename_centroid(args["id"], str(args.get("name", "")))
            return {}
        if op == "setLocked":
            doc.set_locked(args["id"], bool(args.get("locked")))
            return {}
        if op == "assign":
            pos = args.get("pos")
            ok = doc.assign_card(
                args["id"], args.get("centroid"),
                pos=(pos["x"], pos["y"]) if pos else None,
            )
            return {"ok": ok}
        if op == "setPos":
            doc.set_card_pos(args["id"], args["x"], args["y"])
            return {}
        if op == "deleteCard":
            doc.delete_card(args["id"])
            return {}
        if op == "shuffleUnassigned":
            doc.shuffle_unassigned()
            return {}
        if op == "restartAll":
            doc.restart_all()
            return {}
        if op == "setMode":
            doc.set_mode(str(args.get("mode", "learn")))
            return {}
        if op == "setIteration":
            doc.set_iteration(int(args.get("iteration", 0)))
            return {}
        if op == "populate":
            return {"added": populate_test_data(doc)}
        if op == "hardReset":
            hard_reset(doc, args.get("mode"))
            return {}
        if op == "hello":
            room.hello(str(args.get("name", "")).strip())
            return {"roster": room.roster()}
        if op == "autoAssign":
            outliers = int(args.get("outliers", 0))
            if not 0 <= outliers <= self.config.max_render_cards:
                raise ValueError("outliers out of range")
            snap = auto_assign(doc, seed=int(args.get("seed", 0)),
                               features=str(args.get("features", "traits")),
                               outliers=outliers, device=self.device)
            return {"metrics": _js_safe(snap)}
        if op == "train":
            return self._start_training(room, args)
        raise ValueError(f"unknown op {op!r}")

    # ------------------------------------------------------- live training
    def _train_slot_acquire(self) -> bool:
        if not self._train_sem.acquire(blocking=False):
            return False
        with self._train_inflight_lock:
            self._train_inflight += 1
        return True

    def _train_slot_release(self) -> None:
        with self._train_inflight_lock:
            self._train_inflight -= 1
        self._train_sem.release()

    def _start_training(self, room: _Room, args: dict) -> dict:
        """Run a fit on a worker thread on the server's device, streaming
        SSE ``train`` events (one an iteration for ``lloyd``); a 2-D result
        with at most 3 clusters, directly or through the dendrogram merge,
        replaces the room's board as an imported document."""
        model = str(args.get("model", "lloyd"))
        n = min(int(args.get("n", 2000)), 100_000)
        d = min(int(args.get("d", 2)), 512)
        k = min(int(args.get("k", 3)), 100)
        max_iter = min(int(args.get("max_iter", 30)), 100)
        seed = int(args.get("seed", 0))
        init = str(args.get("init", "k-means++"))
        if model != "lloyd" and model not in _TRAIN_FITS:
            raise ValueError(f"unknown train model {model!r}")
        if init not in ("k-means++", "k-means||", "random"):
            raise ValueError(f"unknown train init {init!r}")
        if "trim_fraction" in args and model != "trimmed":
            # A knob that would be silently ignored is refused.
            raise ValueError("trim_fraction requires model 'trimmed'")
        trim_fraction = float(args.get("trim_fraction", 0.05))
        if not 0.0 <= trim_fraction < 1.0:
            raise ValueError("trim_fraction must be in [0, 1)")
        if n < k or n < 1 or d < 1 or k < 1:
            raise ValueError("invalid train shape")
        if model in ("kmedoids", "kernel"):
            if n > _KMEDOIDS_MAX_N:
                raise ValueError(
                    f"{model} is O(n²); n must be <= {_KMEDOIDS_MAX_N} here"
                )
            # The work, not just n: the medoid update and the kernel-mass
            # sweep are O(n²·d·max_iter); 8e10 is the other families'
            # worst case (n·d = 8e6 × k = 100 × max_iter = 100).
            if n * n * d * max_iter > 8e10:
                raise ValueError(
                    f"{model} work too large: n²·d·max_iter must be <= 8e10"
                )
        # The data volume one unauthenticated request may demand.
        if n * d > 8_000_000:
            raise ValueError("train shape too large: n*d must be <= 8e6")
        if model == "balanced":
            # Each outer iteration runs sinkhorn_sweeps (200 by default)
            # O(n·k) log-domain sweeps (two logsumexps each) on top of the
            # distance product: the same 8e10 work budget.
            if n * k * max_iter * 400 > 8e10:
                raise ValueError(
                    "balanced work too large: n·k·max_iter·400 must be "
                    "<= 8e10"
                )
        if model in ("xmeans", "gmeans"):
            # Worst case ~max_rounds·(2k split fits + 1 global fit) full-
            # array passes at the fit's default max_rounds=16: the same
            # 8e10 work budget as the other families' worst case.
            if 48 * n * d * k * max_iter > 8e10:
                raise ValueError(
                    f"{model} work too large: 48·n·d·k·max_iter must be "
                    "<= 8e10")
        # One training per room and a server-wide bound on them.
        if not self._train_slot_acquire():
            raise CapacityError(
                "server training capacity exhausted; retry after "
                f"{self.config.retry_after_s}s"
            )
        if not room.train_lock.acquire(blocking=False):
            self._train_slot_release()
            raise ValueError("training already running in this room")
        _TRAIN_STARTED_TOTAL.labels(model=model).inc()

        # The request's span context is captured here and re-activated in
        # the worker, so the job's spans chain back to the request; run_id
        # and trace_id are stamped into every train_* event.
        trace_ctx = _tracing.current_context()
        trace_id = trace_ctx.trace_id if trace_ctx is not None else None
        run_id = _tracing.new_run_id()

        def _stamp(ev: dict) -> dict:
            ev["run_id"] = run_id
            if trace_id is not None:
                ev["trace_id"] = trace_id
            return ev

        def work():
            tw = None
            try:
                with _tracing.use_context(trace_ctx), \
                        _tracing.span("train_job", category="train",
                                      model=model, run_id=run_id,
                                      room=room.code):
                    if self.config.telemetry_path:
                        # One appended JSONL stream per job: whole-line
                        # appends interleave safely and run_id separates
                        # concurrent jobs.
                        tw = obs.TelemetryWriter(
                            self.config.telemetry_path, append=True,
                            common={"run_id": run_id, "room": room.code})
                    self._train_job(room, model, n, d, k, max_iter, seed,
                                    init, trim_fraction, run_id, _stamp, tw)
            except Exception as e:   # stream the failure, keep the room
                _TRAIN_ERRORS_TOTAL.inc()
                room.broadcast_event(_stamp({"type": "train_error",
                                             "error": str(e)}))
            finally:
                if tw is not None:
                    tw.close()
                room.train_lock.release()
                self._train_slot_release()

        threading.Thread(target=work, daemon=True).start()
        started = {"started": True, "n": n, "d": d, "k": k,
                   "run_id": run_id}
        if trace_id is not None:
            started["trace_id"] = trace_id
        return started

    def _train_job(self, room, model, n, d, k, max_iter, seed, init,
                   trim_fraction, run_id, stamp, tw) -> None:
        """The ``train`` op's fit on the server's device, its events and
        its board (the worker thread's body)."""
        import kmeans_tpu_torch.models as models
        from kmeans_tpu_torch.config import KMeansConfig
        from kmeans_tpu_torch.data.synthetic import generator_for, make_blobs

        dev = self.device
        x, _, _ = make_blobs(seed, n, d, k, cluster_std=0.6, device=dev)
        # steps=max_iter keeps the request's work cap meaningful for the
        # minibatch family, which reads steps, not max_iter.
        kcfg = KMeansConfig(k=k, init=init, max_iter=max_iter,
                            steps=max_iter)
        gen = generator_for(seed + 1, dev)
        if model == "lloyd":
            # The step-paced runner: one SSE event an iteration.
            runner = models.LloydRunner(x, k, generator=gen, config=kcfg,
                                        device=dev)
            runner.init()
            # d = 2 fits stream the centroid positions, normalized to the
            # data's bounding box, so the board can animate the loop; k <=
            # 64 bounds the event.
            lo = x.amin(0).cpu().numpy()
            span = np.maximum(x.amax(0).cpu().numpy() - lo, 1e-9)

            def cb(info):
                ev = stamp({"type": "train", **info.as_dict()})
                if d == 2 and k <= 64:
                    cpos = (runner.centroids.cpu().numpy() - lo) / span
                    ev["centroids"] = [
                        [round(float(px), 4), round(float(py), 4)]
                        for px, py in np.clip(cpos, 0.0, 1.0)
                    ]
                room.broadcast_event(ev)

            state = runner.run(max_iter=max_iter, callback=cb, telemetry=tw,
                               run_id=run_id)
        else:
            # The other families fit in one call: a start marker, then the
            # result.
            room.broadcast_event(stamp(
                {"type": "train", "model": model, "iteration": 0}))
            fit = getattr(models, _TRAIN_FITS[model])
            fit_kw = ({"trim_fraction": trim_fraction}
                      if model == "trimmed" else {})
            state = fit(x, k, generator=gen, config=kcfg, device=dev,
                        **fit_kw)
        board_labels = state.labels.cpu().numpy()
        if d >= 2 and _state_k(state) > MAX_CENTROIDS and \
                models.state_centers(state) is not None and \
                models.state_counts(state) is not None:
            # A k > 3 fit reaches the board merged down the size-weighted
            # ward dendrogram to the 3-zone cap; train_done reports the
            # real k.
            board_labels, _ = models.merge_to_k(state, MAX_CENTROIDS)
        if d >= 2 and np.unique(
                board_labels[board_labels >= 0]).size <= MAX_CENTROIDS:
            cap = self.config.max_render_cards
            viz = dataset_to_document(
                x[:cap].cpu().numpy(), board_labels, room=room.code,
                max_cards=cap)
            import_json(room.doc, to_plain(viz))
        objective = models.state_objective(state)
        done = stamp({
            "type": "train_done",
            "model": model,
            "inertia": float(objective),
            "n_iter": int(state.n_iter),
            "converged": bool(state.converged),
            "k": int(_state_k(state)),
        })
        if tw is not None and model != "lloyd":
            # The runner already wrote run_start / iter / run_done; a
            # one-shot fit records its result as one event.
            tw.event("train_done", model=model, inertia=float(objective),
                     n_iter=int(state.n_iter),
                     converged=bool(state.converged))
        room.broadcast_event(done)

    # -------------------------------------------------------------- serve
    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet by default
                pass

            # -- drain accounting ------------------------------------------
            def setup(self):
                super().setup()
                # Busy since the accept (process_request counted it).
                self._busy_now = True

            def parse_request(self):
                if not self._busy_now:       # a later keep-alive request
                    self._busy_now = True
                    self.server.busy(+1)
                return super().parse_request()

            def handle_one_request(self):
                try:
                    super().handle_one_request()
                finally:
                    if self._busy_now:
                        self._busy_now = False
                        self.server.busy(-1)

            def end_headers(self):
                if self.server.draining:
                    # Send the client elsewhere for its next request.
                    self.send_header("Connection", "close")
                super().end_headers()

            # -- plumbing --------------------------------------------------
            def send_response(self, code, message=None):
                # Every response funnels through here: the one place the
                # request metrics learn the status code.
                self._obs_status = int(code)
                super().send_response(code, message)

            def _observe_request(self, method, path, t0):
                route = _route_label(path)
                status = getattr(self, "_obs_status", 0)
                _HTTP_REQUESTS_TOTAL.labels(
                    method=method, route=route, status=str(status),
                ).inc()
                if route != "/api/events":
                    elapsed = time.perf_counter() - t0
                    _HTTP_REQUEST_SECONDS.labels(
                        method=method, route=route,
                    ).observe(elapsed)
                    mon = server.slo_monitor
                    if mon is not None and route not in _SLO_EXEMPT_ROUTES:
                        mon.record(elapsed, error=status >= 500)

            def _request_trace_id(self):
                """Adopt a well-formed incoming ``X-Trace-Id``, mint one
                otherwise: arbitrary header strings never reach spans."""
                hdr = self.headers.get("X-Trace-Id")
                return hdr if _tracing.is_trace_id(hdr) \
                    else _tracing.new_trace_id()

            def _trace_header(self):
                tid = getattr(self, "_trace_id", None)
                if tid:
                    self.send_header("X-Trace-Id", tid)

            def _headers_for(self, ctype, extra=None, length=None):
                self.send_response(HTTPStatus.OK)
                self.send_header("Content-Type", ctype)
                for k, v in _SECURITY_HEADERS.items():
                    self.send_header(k, v)
                self._trace_header()
                if extra:
                    for k, v in extra.items():
                        self.send_header(k, v)
                if length is not None:
                    self.send_header("Content-Length", str(length))
                self.end_headers()

            def _json(self, obj, status=HTTPStatus.OK, extra=None):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                for k, v in _SECURITY_HEADERS.items():
                    self.send_header(k, v)
                self._trace_header()
                if extra:
                    for k, v in extra.items():
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, msg, status=HTTPStatus.BAD_REQUEST,
                       extra=None):
                self._json({"error": str(msg)}, status=status, extra=extra)

            def _busy(self, msg):
                """503 + ``Retry-After``: the measured base
                (server.retry_after_s) plus bounded jitter, so a rejected
                cohort does not come back as one herd; whole seconds, as
                RFC 9110 delay-seconds are integers."""
                _HTTP_503_TOTAL.inc()
                ra = server.retry_after_s()
                jit = float(server.config.retry_after_jitter_s)
                if jit > 0:
                    ra += random.uniform(0.0, jit)
                self._error(
                    msg, HTTPStatus.SERVICE_UNAVAILABLE,
                    extra={"Retry-After": str(int(ra))},
                )

            def _read_bounded(self):
                """Read the request body; PayloadTooLargeError (413) past
                ``max_import_bytes``."""
                length = int(self.headers.get("Content-Length") or 0)
                if length < 0:
                    # read(-1) would read to EOF: an unbounded stream.
                    raise ValueError("invalid Content-Length")
                if length > server.config.max_import_bytes:
                    raise PayloadTooLargeError(
                        f"request body {length} bytes exceeds the "
                        f"{server.config.max_import_bytes}-byte cap"
                    )
                return self.rfile.read(length) if length else b""

            def _drain_body(self):
                """Consume the unread body before an early response on a
                keep-alive connection (unread bytes would parse as the next
                request line); an oversized body closes the connection."""
                length = int(self.headers.get("Content-Length") or 0)
                if length <= 0:
                    return
                if length > server.config.max_import_bytes:
                    self.close_connection = True
                    return
                self.rfile.read(length)

            def _query(self):
                return dict(urllib.parse.parse_qsl(
                    urllib.parse.urlparse(self.path).query
                ))

            def _body(self):
                raw = self._read_bounded()
                if not raw:
                    return {}
                return json.loads(raw)

            # -- GET -------------------------------------------------------
            def do_GET(self):
                path = urllib.parse.urlparse(self.path).path
                q = self._query()
                t0 = time.perf_counter()
                self._trace_id = self._request_trace_id()
                try:
                    # The request span roots the request's trace (a train
                    # job chains off it); the id is echoed as X-Trace-Id on
                    # every response.
                    with _tracing.span("GET " + _route_label(path),
                                       category="http",
                                       trace_id=self._trace_id):
                        return self._do_get(path, q)
                except RoomTableFullError as e:
                    return self._busy(e)
                finally:
                    self._observe_request("GET", path, t0)

            def _do_get(self, path, q):
                if path in ("/", "/index.html"):
                    return self._static("index.html",
                                        "text/html; charset=utf-8")
                if path == "/app.js":
                    return self._static(
                        "app.js", "application/javascript; charset=utf-8"
                    )
                if path == "/api/state":
                    room = server.room(q.get("room"))
                    payload = room.state()
                    # The client's cache-restore gate: with persistence on,
                    # a fresh doc means the server really has nothing.
                    payload["persisted"] = bool(server.config.persist_dir)
                    return self._json(payload)
                if path == "/api/export":
                    room = server.room(q.get("room"))
                    with room.doc.read_lock():
                        body = export_json(room.doc).encode()
                    self._headers_for(
                        "application/json",
                        extra={
                            "Content-Disposition":
                                "attachment; filename="
                                f"\"{export_filename(room.code)}\"",
                        },
                        length=len(body),
                    )
                    self.wfile.write(body)
                    return
                if path == "/api/events":
                    # Last-Event-ID: the standard header on an EventSource
                    # reconnect, or the query parameter.
                    raw = (self.headers.get("Last-Event-ID")
                           or q.get("lastEventId") or "").strip()
                    last = int(raw) if raw.isdigit() else None
                    return self._sse(server.room(q.get("room")),
                                     last_event_id=last)
                if path == "/api/model":
                    if server.model_registry is None:
                        # No registry can never resolve by waiting: 404,
                        # not the retryable 503.
                        return self._error("no model registry configured",
                                           HTTPStatus.NOT_FOUND)
                    gen = server.current_model()
                    if gen is None:
                        return self._busy("no model generation published "
                                          "yet; retry shortly")
                    return self._json(gen.describe())
                if path == "/healthz":
                    # Liveness only; readiness is /readyz.
                    return self._json({"ok": True,
                                       "rooms": len(server.rooms)})
                if path == "/readyz":
                    ready, detail = server.readiness()
                    if ready:
                        return self._json({"ok": True, **detail})
                    return self._busy(
                        "not ready: " + json.dumps(detail))
                if path == "/metrics":
                    if not server.config.metrics:
                        return self._error("metrics disabled",
                                           HTTPStatus.NOT_FOUND)
                    # Each scrape reports the render cost of the ones
                    # before it.
                    t_sc = time.perf_counter()
                    body = obs.REGISTRY.expose().encode()
                    obs.SCRAPE_SECONDS.observe(time.perf_counter() - t_sc)
                    self._headers_for(
                        "text/plain; version=0.0.4; charset=utf-8",
                        length=len(body),
                    )
                    self.wfile.write(body)
                    return
                if path == "/api/trace":
                    # The span ring as Chrome trace-event JSON (Perfetto).
                    if not server.config.tracing:
                        return self._error("tracing disabled",
                                           HTTPStatus.NOT_FOUND)
                    body = _tracing.TRACER.export_chrome_trace().encode()
                    self._headers_for("application/json", length=len(body))
                    self.wfile.write(body)
                    return
                self._error("not found", HTTPStatus.NOT_FOUND)

            def _static(self, name, ctype):
                p = _STATIC / name
                if not p.exists():
                    return self._error("missing static", HTTPStatus.NOT_FOUND)
                body = p.read_bytes()
                self._headers_for(ctype, length=len(body))
                self.wfile.write(body)

            def _sse(self, room, last_event_id=None):
                sid, q = room.subscribe()

                def emit(ev, eid=None):
                    # The fault harness's site: an InjectedFault is an
                    # OSError, the path a torn client socket takes.
                    faults.check("serve.sse_emit")
                    frame = f"data: {json.dumps(ev)}\n\n"
                    if eid is not None:
                        # Numbered events move the browser's Last-Event-ID,
                        # so its reconnect replays what a drop skipped.
                        frame = f"id: {eid}\n" + frame
                    self.wfile.write(frame.encode())
                    self.wfile.flush()

                try:
                    self.send_response(HTTPStatus.OK)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-store")
                    for k, v in _SECURITY_HEADERS.items():
                        if k not in ("Cache-Control",
                                     "Content-Security-Policy"):
                            self.send_header(k, v)
                    self._trace_header()
                    self.end_headers()
                    emit({"type": "hello", "version": room.doc.version,
                          "peers": max(0, room.peer_count() - 1)})
                    # Replay after subscribing: an event racing the
                    # reconnect lands in both the ring slice and the queue,
                    # and the replayed high-water mark drops the copy.
                    replayed = 0
                    if last_event_id is not None:
                        for eid, ev in room.events_since(last_event_id):
                            emit(ev, eid)
                            replayed = eid
                    idle = 0
                    while not server._streams_closed.is_set():
                        try:
                            item = q.get(timeout=_SSE_IDLE_S)
                        except queue.Empty:
                            idle += 1
                            if idle % 3 == 0:
                                # The version rides the ping, so a change
                                # dropped on a full queue self-heals.
                                emit({"type": "ping",
                                      "version": room.doc.version,
                                      "peers": max(0,
                                                   room.peer_count() - 1)})
                            else:
                                # A comment frame: ignored by EventSource,
                                # keeps proxies from reaping the stream.
                                faults.check("serve.sse_emit")
                                self.wfile.write(b": keepalive\n\n")
                                self.wfile.flush()
                            continue
                        if item is None:          # the drain's wake-up
                            break
                        idle = 0
                        eid, ev = item
                        if eid <= replayed:
                            continue          # already served by replay
                        emit(ev, eid)
                    # A draining server ends the stream and the connection.
                    self.close_connection = True
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    room.unsubscribe(sid)

            # -- POST ------------------------------------------------------
            def do_POST(self):
                path = urllib.parse.urlparse(self.path).path
                q = self._query()
                t0 = time.perf_counter()
                self._trace_id = self._request_trace_id()
                try:
                    with _tracing.span("POST " + _route_label(path),
                                       category="http",
                                       trace_id=self._trace_id):
                        return self._do_post(path, q)
                finally:
                    self._observe_request("POST", path, t0)

            def _do_post(self, path, q):
                try:
                    if path == "/api/mutate":
                        room = server.room(q.get("room"))
                        body = self._body()
                        result = server.apply(
                            room, str(body.get("op", "")),
                            body.get("args") or {})
                        return self._json({"ok": True, **result})
                    if path == "/api/hello":
                        room = server.room(q.get("room"))
                        room.hello(str(self._body().get("name", "")).strip())
                        return self._json({"roster": room.roster()})
                    if path == "/api/import":
                        room = server.room(q.get("room"))
                        obj = parse_import(self._read_bounded() or b"{}")
                        # A non-dict top level falls through to
                        # import_json's "must be an object" 400.
                        cards = (obj.get("cards") or []
                                 if isinstance(obj, dict) else [])
                        if (isinstance(cards, list) and len(cards)
                                > server.config.max_render_cards):
                            raise PayloadTooLargeError(
                                f"import has {len(cards)} cards; the board "
                                f"cap is {server.config.max_render_cards}"
                            )
                        import_json(room.doc, obj)
                        return self._json({"ok": True})
                    if path == "/api/assign":
                        return self._assign()
                    if path == "/api/model/reload":
                        # The body is unused; read it, or a close with it
                        # unread resets the connection under the response.
                        self._drain_body()
                        if server.model_registry is None:
                            return self._error("no model registry "
                                               "configured",
                                               HTTPStatus.NOT_FOUND)
                        loaded = server.model_registry.load_latest()
                        if loaded is None and \
                                server.model_registry.current() is None:
                            return self._busy("no model checkpoint to "
                                              "load yet; retry shortly")
                        return self._json({
                            "generation": server.model_registry.generation,
                        })
                    self._drain_body()
                    self._error("not found", HTTPStatus.NOT_FOUND)
                except PayloadTooLargeError as e:
                    # The body is left unread: drop the connection after
                    # responding rather than drain an attacker-sized stream.
                    self.close_connection = True
                    self._error(e, HTTPStatus.REQUEST_ENTITY_TOO_LARGE)
                except CentroidLimitError as e:
                    self._error(str(e), HTTPStatus.CONFLICT)
                except (RoomTableFullError, CapacityError) as e:
                    self._busy(e)
                except (KeyError, ValueError, TypeError) as e:
                    self._error(e)

            def _assign(self):
                """Nearest-centroid labels against one immutable
                generation: the engine reads the generation once a
                coalesced batch and every request in it reports that
                snapshot, so a swap mid-flight drops nothing.

                Content-Type ``application/x-kmeans-points`` selects the
                binary frame both ways; anything else takes the JSON path.
                A malformed frame raises WireError, a ValueError: 400 with
                a JSON error body."""
                if server.admission.enabled:
                    # Admission decides first, so a shed request costs no
                    # decode or model work (its body is drained, never
                    # parsed).
                    shed = server.admission.decide(
                        self.headers.get("X-Tenant"),
                        server.assign_queue_fraction())
                    if shed is not None:
                        cls, why = shed
                        _REQUESTS_SHED_TOTAL.labels(
                            tenant_class=cls).inc()
                        self._drain_body()
                        return self._busy(why)
                if server.model_registry is None:
                    # No registry will ever have a model: 404, not a retry.
                    self._drain_body()
                    return self._error("no model registry configured",
                                       HTTPStatus.NOT_FOUND)
                gen = server.current_model()
                if gen is None:
                    # Retryable: no generation published or loaded yet.
                    self._drain_body()
                    return self._busy("no model generation published yet; "
                                      "retry shortly")
                ctype = (self.headers.get("Content-Type") or "")
                ctype = ctype.split(";", 1)[0].strip().lower()
                binary = ctype == serve_assign.WIRE_POINTS_CONTENT_TYPE
                raw = self._read_bounded()
                serve_assign.WIRE_REQUESTS_TOTAL.labels(
                    format="binary" if binary else "json").inc()
                serve_assign.WIRE_BYTES_TOTAL.labels(
                    direction="rx").inc(len(raw))
                flags = 0
                if binary:
                    x, flags = serve_assign.decode_points(
                        raw, max_points=int(server.config.assign_max_points))
                else:
                    body = json.loads(raw) if raw else {}
                    pts = body.get("points")
                    if not isinstance(pts, list) or not pts:
                        raise ValueError("points must be a non-empty list "
                                         "of rows")
                    cap = int(server.config.assign_max_points)
                    if len(pts) > cap:
                        raise PayloadTooLargeError(
                            f"assign accepts at most {cap} points per "
                            f"request, got {len(pts)}"
                        )
                    x = np.asarray(pts, np.float32)
                if x.ndim != 2 or x.shape[1] != gen.d:
                    raise ValueError(
                        f"points must be (n, {gen.d}) for generation "
                        f"{gen.generation}; got shape {tuple(x.shape)}"
                    )
                if not np.isfinite(x).all():
                    raise ValueError(
                        "points must be finite (got NaN/Inf values)")
                t0 = time.perf_counter()
                try:
                    labels, gen_used, path = server.assign_points(x)
                except (serve_assign.NoModelError,
                        serve_assign.QueueFullError,
                        serve_assign.AssignTimeoutError) as e:
                    return self._busy(e)
                serve_assign.ASSIGN_REQUEST_SECONDS.labels(
                    path=path).observe(time.perf_counter() - t0)
                _ASSIGN_POINTS_TOTAL.inc(x.shape[0])
                if binary:
                    dist = None
                    if flags & serve_assign.WIRE_FLAG_DISTANCES:
                        # On the host, here: the engine returns labels
                        # only, and only clients that ask pay the pass.
                        diff = x - gen_used.centroids[labels]
                        dist = np.sqrt(np.einsum("nd,nd->n", diff, diff,
                                                 dtype=np.float32))
                    frame = serve_assign.encode_labels(
                        labels, generation=gen_used.generation,
                        k=gen_used.k, distances=dist)
                    serve_assign.WIRE_BYTES_TOTAL.labels(
                        direction="tx").inc(len(frame))
                    self._headers_for(
                        serve_assign.WIRE_LABELS_CONTENT_TYPE,
                        length=len(frame))
                    self.wfile.write(frame)
                    return
                payload = json.dumps({
                    "labels": [int(v) for v in labels],
                    "generation": gen_used.generation,
                    "k": gen_used.k,
                }).encode()
                serve_assign.WIRE_BYTES_TOTAL.labels(
                    direction="tx").inc(len(payload))
                self._headers_for("application/json", length=len(payload))
                self.wfile.write(payload)

        return Handler

    def start(self, *, background: bool = True) -> ThreadingHTTPServer:
        self.httpd = _BackloggedHTTPServer(
            (self.config.host, self.config.port), self.make_handler(),
            reuse_port=self.config.reuse_port,
        )
        # The tracer hold rides start()/stop(), taken after the bind: a
        # failed bind propagates without a stop() to release it.
        if self.config.tracing and not self._tracer_held:
            with _TRACER_HOLDS_LOCK:
                if _TRACER_HOLDS[0] == 0:
                    _TRACER_PRIOR[0] = _tracing.TRACER.enabled
                _TRACER_HOLDS[0] += 1
                self._tracer_held = True
                _tracing.TRACER.enable()
        if self.config.tracing and self.config.trace_dir \
                and self._span_spool is None:
            self._span_spool = SpanSpool(self.config.trace_dir)
            _tracing.TRACER.set_sink(self._span_spool)
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        if not background:
            # The loop runs on a thread of its own even here, so that a
            # Ctrl-C's KeyboardInterrupt lands in this thread's join, never
            # in the loop between an accept and its handler thread, where
            # it would lose that request.  The join is timed: an untimed
            # one does not wake for ``_thread.interrupt_main``.
            try:
                while t.is_alive():
                    t.join(0.5)
            finally:
                self.httpd.shutdown()
        return self.httpd

    def stop(self):
        """Drain, then stop: end every SSE stream (a stream never finishes
        by itself), stop accepting, let every accepted request finish (at
        most ``fleet_drain_s``; each response from then on closes its
        connection), write the rooms with a pending save, then stop the
        engine after its last batch."""
        self._streams_closed.set()
        for room in list(self.rooms.values()):
            room.wake_subscribers()
        if self.httpd:
            self.httpd.draining = True
            self.httpd.shutdown()
            self.httpd.serve_pending()
            self.httpd.server_close()
            self.drain_unanswered = self.httpd.wait_idle(
                float(self.config.fleet_drain_s))
        self.flush_rooms()
        if self.assign_engine is not None:
            # After the HTTP teardown: a handler still waiting on a batch
            # past the drain gets its 503 instead of hanging.
            self.assign_engine.stop()
        if self._span_spool is not None:
            _tracing.TRACER.set_sink(None)
            self._span_spool.close()
            self._span_spool = None
        if self._tracer_held:        # idempotent: one release per server
            self._tracer_held = False
            with _TRACER_HOLDS_LOCK:
                _TRACER_HOLDS[0] -= 1
                if _TRACER_HOLDS[0] == 0:
                    _tracing.TRACER.enabled = _TRACER_PRIOR[0]


def serve(host: str = "127.0.0.1", port: int = 8787, *,
          background: bool = False,
          persist_dir: Optional[str] = None,
          metrics: bool = True,
          telemetry_path: Optional[str] = None,
          model_dir: Optional[str] = None,
          assign_batching: Optional[bool] = None,
          assign_max_delay_s: Optional[float] = None,
          assign_max_batch_rows: Optional[int] = None,
          assign_max_points: Optional[int] = None,
          assign_quant: Optional[str] = None,
          trace_dir: Optional[str] = None,
          slo: Optional[bool] = None,
          slo_latency_target_s: Optional[float] = None,
          slo_min_samples: Optional[int] = None,
          device=None) -> KMeansServer:
    """Build a :class:`KMeansServer` and start it (in the foreground
    unless ``background``).  None leaves a knob at its ``ServeConfig``
    default."""
    extra = {k: v for k, v in (
        ("assign_batching", assign_batching),
        ("assign_max_delay_s", assign_max_delay_s),
        ("assign_max_batch_rows", assign_max_batch_rows),
        ("assign_max_points", assign_max_points),
        ("assign_quant", assign_quant),
        ("trace_dir", trace_dir),
        ("slo", slo),
        ("slo_latency_target_s", slo_latency_target_s),
        ("slo_min_samples", slo_min_samples),
    ) if v is not None}
    s = KMeansServer(ServeConfig(host=host, port=port,
                                 persist_dir=persist_dir,
                                 metrics=metrics,
                                 telemetry_path=telemetry_path,
                                 model_dir=model_dir,
                                 **extra), device=device)
    try:
        s.start(background=background)
    except KeyboardInterrupt:
        # Foreground Ctrl-C: stop cleanly (the streams end, accepted
        # requests finish, pending room saves are written), then re-raise
        # so callers keep interrupt semantics.
        s.stop()
        raise
    return s
