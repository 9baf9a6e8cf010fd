"""HTTP model server: ``POST /api/assign`` and its routes, on the card.

Counterpart of the model-serving surface of ``kmeans_tpu/serve/server.py``:
:class:`KMeansServer` and :func:`serve` answer every route a model server
answers, with the reference's status codes, headers and bodies:

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

Known differences from the reference: the board (rooms, SSE, ``/api/state``,
``/api/mutate``, ``/api/hello``, ``/api/import`` / ``export``, the static
app and the ``train`` op) is not ported yet, so its routes answer the
reference's 404 ``not found``, ``/healthz`` reports ``"rooms": 0`` and a
``persist_dir`` is refused.  :meth:`KMeansServer.stop` drains: accepted
requests finish on the engine before it stops, where the reference's stop
fails the queued ones with 503; a fleet worker's drain
(:mod:`kmeans_tpu_torch.serve.fleet`) relies on it.
"""

from __future__ import annotations

import collections
import json
import random
import socket
import threading
import time
import urllib.parse
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from kmeans_tpu_torch import obs
from kmeans_tpu_torch.config import ServeConfig
from kmeans_tpu_torch.continuous.registry import ModelRegistry
from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.obs import tracing as _tracing
from kmeans_tpu_torch.obs.fleetview import SpanSpool
from kmeans_tpu_torch.obs.slo import SLOMonitor
from kmeans_tpu_torch.serve import assign as serve_assign

__all__ = ["KMeansServer", "serve"]

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

#: Ceiling on the queue-derived ``Retry-After`` (seconds): past a minute
#: the estimate reports an outage, not backpressure.
_RETRY_AFTER_CAP = 60.0


class PayloadTooLargeError(ValueError):
    """Request body exceeds a configured cap -> 413."""


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
    """The model server: a registry, the assignment engine and the HTTP
    server object.

    ``registry`` injects a live
    :class:`~kmeans_tpu_torch.continuous.registry.ModelRegistry` (a
    publisher in the same process swaps generations under running
    requests); with ``config.model_dir`` and no registry one is built over
    that directory and its newest verified generation restored.  The
    engine scores on ``device``: None is the card, and with no card the
    constructor raises (pass ``device="cpu"`` to run the plain versions).
    """

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 registry=None, device=None):
        self.config = config or ServeConfig()
        if self.config.persist_dir:
            raise ValueError(
                f"persist_dir={self.config.persist_dir!r}: board "
                "persistence is not ported; the port serves models only")
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
        self.httpd: Optional[ThreadingHTTPServer] = None
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

            # -- GET -------------------------------------------------------
            def do_GET(self):
                path = urllib.parse.urlparse(self.path).path
                t0 = time.perf_counter()
                self._trace_id = self._request_trace_id()
                try:
                    # The request span roots the request's trace; the id
                    # is echoed as X-Trace-Id on every response.
                    with _tracing.span("GET " + _route_label(path),
                                       category="http",
                                       trace_id=self._trace_id):
                        return self._do_get(path)
                finally:
                    self._observe_request("GET", path, t0)

            def _do_get(self, path):
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
                    # Liveness only; readiness is /readyz.  No board, so
                    # no rooms.
                    return self._json({"ok": True, "rooms": 0})
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

            # -- POST ------------------------------------------------------
            def do_POST(self):
                path = urllib.parse.urlparse(self.path).path
                t0 = time.perf_counter()
                self._trace_id = self._request_trace_id()
                try:
                    with _tracing.span("POST " + _route_label(path),
                                       category="http",
                                       trace_id=self._trace_id):
                        return self._do_post(path)
                finally:
                    self._observe_request("POST", path, t0)

            def _do_post(self, path):
                try:
                    if path == "/api/assign":
                        return self._assign()
                    if path == "/api/model/reload":
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
        if background:
            t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
            t.start()
        else:
            self.httpd.serve_forever()
        return self.httpd

    def stop(self):
        """Drain, then stop: stop accepting, let every accepted request
        finish (at most ``fleet_drain_s``; each response from then on
        closes its connection), then stop the engine after its last
        batch."""
        if self.httpd:
            self.httpd.draining = True
            self.httpd.shutdown()
            self.httpd.serve_pending()
            self.httpd.server_close()
            self.drain_unanswered = self.httpd.wait_idle(
                float(self.config.fleet_drain_s))
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
        # Foreground Ctrl-C: stop cleanly (the engine's queue drains with
        # 503s), then re-raise so callers keep interrupt semantics.
        s.stop()
        raise
    return s
