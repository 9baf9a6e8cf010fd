"""Observability: metrics registry, run telemetry, tracing and SLOs.

Counterpart of ``kmeans_tpu/obs``, whose modules the port copies (none of
them imports JAX, but importing them would run ``kmeans_tpu/__init__.py``,
which does):

* :mod:`kmeans_tpu_torch.obs.registry`: the thread-safe Prometheus-style
  registry (counters, gauges and histograms with labels) and its text
  exposition, served at ``GET /metrics``.  Metric names stay the
  reference's (``kmeans_tpu_*``), so one dashboard reads either server.
* :mod:`kmeans_tpu_torch.obs.telemetry`: per-run JSONL event streams.
* :mod:`kmeans_tpu_torch.obs.tracing`: the span tracer and its Chrome
  trace-event export (``GET /api/trace``), with each thread on a lane of
  its own (see that module).
* :mod:`kmeans_tpu_torch.obs.slo`: the burn-rate SLO monitor that gates
  ``/readyz``.
* :mod:`kmeans_tpu_torch.obs.fleetview`: the fleet's pane: the span spool,
  the merged trace, the aggregated ``/metrics`` and the obs endpoints.

The reference's ``costmodel`` is bound to JAX's compiled programs and is
not here.  ``enable()`` / ``disable()`` toggle the metrics registry; the
span tracer has its own switch (``obs.tracing.enable()``).
"""

from kmeans_tpu_torch.obs import tracing
from kmeans_tpu_torch.obs.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ParsedFamily,
    ParsedSample,
    REGISTRY,
    counter,
    gauge,
    histogram,
    parse_exposition,
    render_exposition,
)
from kmeans_tpu_torch.obs import fleetview, slo
from kmeans_tpu_torch.obs.telemetry import (
    TelemetryWriter,
    read_events,
    summarize_by_run,
    summarize_events,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "ParsedFamily",
    "ParsedSample",
    "parse_exposition",
    "render_exposition",
    "TelemetryWriter",
    "read_events",
    "summarize_events",
    "summarize_by_run",
    "tracing",
    "fleetview",
    "slo",
    "enable",
    "disable",
    "enabled",
    "probe_writable",
    "record_build_info",
    "BUILD_INFO",
    "SCRAPE_SECONDS",
]

#: Build/runtime identity, Prometheus build-info convention: the value is
#: always 1, the information lives in the labels.  The family registers at
#: import; the child appears once :func:`record_build_info` runs (the
#: server does at construction).
BUILD_INFO = gauge(
    "kmeans_tpu_build_info",
    "Build/runtime identity (value is always 1; see the labels)",
    labels=("version", "backend"),
)

#: Self-observation: how long one ``GET /metrics`` exposition render
#: takes (observed by the serve handler around ``REGISTRY.expose()``, so
#: each scrape reports the cost of the previous ones).
SCRAPE_SECONDS = histogram(
    "kmeans_tpu_metrics_scrape_seconds",
    "Wall time of one /metrics text-exposition render",
)


def probe_writable(path: str) -> None:
    """Open ``path`` for append and close it: raises ``OSError`` when an
    observability output path cannot be written.  Appends nothing and
    never truncates; callers turn the OSError into their surface's failure
    shape (the server's construction ``ValueError``)."""
    with open(path, "a", encoding="utf-8"):
        pass


def record_build_info(backend: str = None) -> None:
    """Seed the :data:`BUILD_INFO` child for this process.  ``backend`` is
    the device type the process serves on (``"cuda"`` or ``"cpu"``); the
    default is ``"cuda"`` when torch sees a card, else ``"cpu"``."""
    if backend is None:
        import torch

        backend = "cuda" if torch.cuda.is_available() else "cpu"
    import kmeans_tpu_torch

    BUILD_INFO.labels(
        version=getattr(kmeans_tpu_torch, "__version__", "unknown"),
        backend=str(backend),
    ).set(1)


def enable() -> None:
    """Enable the default registry (mutations record again)."""
    REGISTRY.enable()


def disable() -> None:
    """Disable the default registry: every inc/set/observe becomes one
    attribute check and a return."""
    REGISTRY.disable()


def enabled() -> bool:
    return REGISTRY.enabled
