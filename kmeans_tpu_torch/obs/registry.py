"""Zero-dependency metrics registry: counters, gauges, histograms.

A copy of ``kmeans_tpu/obs/registry.py`` (which imports no JAX), so
the port and the reference expose the same metric families and text.

The observability layer's bottom half (docs/OBSERVABILITY.md).  Every
subsystem registers its metrics here at import time and the serve layer
exposes the whole registry as Prometheus text exposition (``GET
/metrics``).  Design constraints, in order:

* **zero dependencies** — the container has no prometheus_client; this is
  the text-format subset we need (counter / gauge / histogram, labels,
  ``# HELP``/``# TYPE``), nothing more;
* **thread-safe** — the serve layer scrapes from request threads while
  training workers increment; every child holds its own lock and the
  registry lock covers registration only;
* **near-zero cost when disabled** — :func:`MetricsRegistry.disable`
  turns every mutation into one attribute check + return, so the Lloyd
  hot loop can keep its instrumentation callsites unconditionally
  (guarded by tests/test_obs.py's overhead test).

Naming convention (enforced by tools/check_metrics.py): every metric is
``kmeans_tpu_<subsystem>_<noun>[_<unit>|_total]``, documented in the
docs/OBSERVABILITY.md catalog.  Registration is get-or-create: asking for
the same (name, kind, labels) again returns the existing metric (so
sibling modules can share a metric family), while re-registering a name
with a different kind or label set raises.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "DEFAULT_BUCKETS",
    "ParsedSample",
    "ParsedFamily",
    "parse_exposition",
    "render_exposition",
]

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")

#: Default histogram buckets, tuned for step/request latencies: 1 ms up
#: to 30 s (a Lloyd sweep at the headline config is ~0.1 s; an HTTP
#: request is ~ms; a sharded fit can run tens of seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render without a decimal point
    (scrape-diff friendliness), everything else as repr(float)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else _fmt_value(bound)


def _render_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label_value(v)}"'
             for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Child:
    """One (labelvalues) time series of a metric.

    Every mutation starts with the registry-enabled check — it must live
    HERE, not only on the metric facade, because hot loops hold child
    handles directly (``metric.labels(...)`` once, ``child.inc()`` per
    iteration) and the disable switch has to cover that path too.
    """

    __slots__ = ("_lock", "_registry")

    def __init__(self, registry: "MetricsRegistry"):
        self._lock = threading.Lock()
        self._registry = registry


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, registry):
        super().__init__(registry)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError(f"counters only go up; inc({amount})")
        with self._lock:
            self._value += amount

    def get(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value", "_fn")

    def __init__(self, registry):
        super().__init__(registry)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(value)
            self._fn = None

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate ``fn()`` at scrape time instead of storing a value —
        the natural shape for "how many rooms exist right now" gauges."""
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            # A scrape must never die because one gauge callback's
            # underlying object is mid-teardown; NaN marks the sample
            # as unreadable instead.
            return float("nan")


class _HistogramChild(_Child):
    __slots__ = ("_bounds", "_counts", "_sum", "_count")

    def __init__(self, registry, bounds: Tuple[float, ...]):
        super().__init__(registry)
        self._bounds = bounds                    # finite bounds, ascending
        self._counts = [0] * (len(bounds) + 1)   # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)  # le is inclusive
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[int, float, List[int]]:
        """``(count, sum, cumulative bucket counts)`` — the cumulative
        list has one entry per finite bound plus the ``+Inf`` total."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return total, s, cum


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


class Metric:
    """One metric family: a name, a kind, label names, and children."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Tuple[str, ...]):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not labelnames:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self) -> _Child:
        return _CHILD_TYPES[self.kind](self._registry)

    def labels(self, **labelvalues) -> _Child:
        """The child for one label-value combination (created on first
        use, cached after — hold the handle outside hot loops)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._make_child()
        return child

    def _require_default(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.name} is labeled ({', '.join(self.labelnames)}); "
                "use .labels(...) first"
            )
        return self._default

    def samples(self) -> List[str]:
        """This family's exposition sample lines (no HELP/TYPE header)."""
        out = []
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:
            out.extend(self._child_samples(key, child))
        return out

    def _child_samples(self, key, child) -> List[str]:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._require_default().inc(amount)

    def value(self, **labelvalues) -> float:
        child = (self.labels(**labelvalues) if labelvalues
                 else self._require_default())
        return child.get()

    def _child_samples(self, key, child):
        lab = _render_labels(self.labelnames, key)
        return [f"{self.name}{lab} {_fmt_value(child.get())}"]


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._require_default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._require_default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._require_default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        # Deliberately NOT gated on enabled: wiring a callback is
        # registration, not a hot-path mutation.
        self._require_default().set_function(fn)

    def value(self, **labelvalues) -> float:
        child = (self.labels(**labelvalues) if labelvalues
                 else self._require_default())
        return child.get()

    def _child_samples(self, key, child):
        lab = _render_labels(self.labelnames, key)
        return [f"{self.name}{lab} {_fmt_value(child.get())}"]


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets
                              if not math.isinf(float(b))))
        if not bounds:
            raise ValueError(f"{name}: at least one finite bucket bound")
        if "le" in labelnames:
            raise ValueError(f"{name}: 'le' is reserved for buckets")
        self.buckets = bounds
        super().__init__(registry, name, help, labelnames)

    def _make_child(self) -> _Child:
        return _HistogramChild(self._registry, self.buckets)

    def observe(self, value: float) -> None:
        self._require_default().observe(value)

    def snapshot(self, **labelvalues) -> Tuple[int, float, List[int]]:
        child = (self.labels(**labelvalues) if labelvalues
                 else self._require_default())
        return child.snapshot()

    def _child_samples(self, key, child):
        count, total, cum = child.snapshot()
        out = []
        for bound, c in zip(self.buckets + (float("inf"),), cum):
            lab = _render_labels(self.labelnames, key,
                                 extra=("le", _fmt_le(bound)))
            out.append(f"{self.name}_bucket{lab} {c}")
        lab = _render_labels(self.labelnames, key)
        out.append(f"{self.name}_sum{lab} {_fmt_value(total)}")
        out.append(f"{self.name}_count{lab} {count}")
        return out


class MetricsRegistry:
    """A set of metric families plus the enabled/disabled master switch."""

    def __init__(self, *, enabled: bool = True):
        #: Mutations no-op while False.  A plain attribute (not a lock-
        #: guarded flag): readers tolerate a stale value for one op, and
        #: the hot-loop cost of the check must stay at one attribute load.
        self.enabled = enabled
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ control
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # ------------------------------------------------------- registration
    def _get_or_create(self, cls, name: str, help: str,
                       labels: Iterable[str], **kw) -> Metric:
        labelnames = tuple(labels)
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"{name}: invalid label name {ln!r}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels "
                        f"{existing.labelnames}; cannot re-register as "
                        f"{cls.kind} with labels {labelnames}"
                    )
                if cls is Histogram:
                    # Different buckets = a different time series shape;
                    # silently handing back the old bounds would funnel
                    # the new caller's observations into +Inf.
                    want = tuple(sorted(
                        float(b) for b in kw.get("buckets", DEFAULT_BUCKETS)
                        if not math.isinf(float(b))))
                    if existing.buckets != want:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {existing.buckets}; cannot "
                            f"re-register with buckets {want}"
                        )
                return existing
            metric = cls(self, name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    # --------------------------------------------------------- inspection
    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def describe(self) -> Dict[str, Tuple[str, Tuple[str, ...], str]]:
        """``{name: (kind, labelnames, help)}`` — the lint's view."""
        with self._lock:
            return {m.name: (m.kind, m.labelnames, m.help)
                    for m in self._metrics.values()}

    # --------------------------------------------------------- exposition
    def expose(self) -> str:
        """Prometheus text exposition (format version 0.0.4) of every
        registered family, name-sorted, newline-terminated."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.samples())
        return "\n".join(lines) + "\n" if lines else ""


# ------------------------------------------------------------------ parser
#
# The exact inverse of :meth:`MetricsRegistry.expose` — the fleet
# supervisor scrapes every worker's /metrics, parses the text back into
# structured samples, relabels and rolls them up, and re-renders
# (kmeans_tpu_torch.obs.fleetview).  The round-trip contract
# ``render_exposition(parse_exposition(text)) == text`` for any text
# this module's :meth:`expose` produces is pinned by tests/test_obs.py.


@dataclasses.dataclass(frozen=True)
class ParsedSample:
    """One exposition sample line: name, ordered labels, value."""

    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float

    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


@dataclasses.dataclass
class ParsedFamily:
    """One metric family as scraped: HELP/TYPE header plus samples."""

    name: str
    kind: str                       # counter | gauge | histogram | untyped
    help: str
    samples: List[ParsedSample] = dataclasses.field(default_factory=list)


#: Exposition suffixes that attach a sample to its histogram family.
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"      # metric name
    r"(\{.*\})?"                        # optional label block
    r"\s+(\S+)"                         # value
    r"(?:\s+(-?\d+))?$"                 # optional timestamp (ignored)
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(s: str, *, quote: bool) -> str:
    """Reverse :func:`_escape_help` / :func:`_escape_label_value`."""
    if "\\" not in s:
        return s
    out: List[str] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if quote and nxt == '"':
                out.append('"')
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_value(token: str) -> float:
    low = token.lower()
    if low in ("+inf", "inf"):
        return float("inf")
    if low == "-inf":
        return float("-inf")
    if low == "nan":
        return float("nan")
    return float(token)


def _parse_labels(block: str) -> Tuple[Tuple[str, str], ...]:
    """``{a="x",b="y"}`` -> ``(("a","x"), ("b","y"))``; strict."""
    inner = block[1:-1]
    if not inner:
        return ()
    pairs: List[Tuple[str, str]] = []
    pos = 0
    while True:
        m = _LABEL_PAIR_RE.match(inner, pos)
        if m is None:
            raise ValueError(f"malformed label block {block!r} at {pos}")
        pairs.append((m.group(1), _unescape(m.group(2), quote=True)))
        pos = m.end()
        if pos == len(inner):
            break
        if inner[pos] != ",":
            raise ValueError(f"malformed label block {block!r} at {pos}")
        pos += 1
    return tuple(pairs)


def _family_for(name: str,
                families: Dict[str, ParsedFamily]) -> ParsedFamily:
    """The family a sample line belongs to: exact name, or — for
    histogram exposition samples — the base name before the suffix."""
    fam = families.get(name)
    if fam is not None:
        return fam
    for sfx in _HIST_SUFFIXES:
        if name.endswith(sfx):
            base = families.get(name[: -len(sfx)])
            if base is not None and base.kind == "histogram":
                return base
    fam = families[name] = ParsedFamily(name, "untyped", "")
    return fam


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Parse Prometheus text exposition (format 0.0.4) back into
    families, insertion-ordered as encountered.

    The inverse of :meth:`MetricsRegistry.expose`: every sample —
    including escaped label values and histogram ``+Inf`` buckets —
    round-trips exactly through :func:`render_exposition`.  Malformed
    lines raise ``ValueError`` (a truncated or corrupt worker scrape
    must be *rejected*, not silently half-aggregated)."""
    families: Dict[str, ParsedFamily] = {}
    for raw in text.splitlines():
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        if line.startswith("#"):
            for prefix in ("# HELP ", "# TYPE "):
                if line.startswith(prefix):
                    rest = line[len(prefix):]
                    name, sep, payload = rest.partition(" ")
                    if not _NAME_RE.match(name):
                        raise ValueError(
                            f"malformed header line {line!r}")
                    fam = families.get(name)
                    if fam is None:
                        fam = families[name] = ParsedFamily(
                            name, "untyped", "")
                    if prefix == "# HELP ":
                        fam.help = _unescape(payload, quote=False)
                    else:
                        kind = payload.strip()
                        if kind not in ("counter", "gauge", "histogram",
                                        "summary", "untyped"):
                            raise ValueError(
                                f"unknown metric type {kind!r} for "
                                f"{name!r}")
                        fam.kind = kind
                    break
            # Any other comment line is legal exposition: skip it.
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line {line!r}")
        name, block, value_tok = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(block) if block else ()
        fam = _family_for(name, families)
        fam.samples.append(
            ParsedSample(name, labels, _parse_value(value_tok)))
    return families


def render_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    """Parsed-label tuple back to exposition text (``{}``-free when
    empty) — the formatting twin of :func:`_render_labels`."""
    if not labels:
        return ""
    pairs = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    return "{" + ",".join(pairs) + "}"


def render_exposition(families: Iterable[ParsedFamily]) -> str:
    """Families back to exposition text, preserving family and sample
    order — ``render_exposition(parse_exposition(t).values()) == t``
    for any ``t`` that :meth:`MetricsRegistry.expose` produced."""
    lines: List[str] = []
    for fam in families:
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            lines.append(
                f"{s.name}{render_labels(s.labels)} {_fmt_value(s.value)}")
    return "\n".join(lines) + "\n" if lines else ""


#: The process-global default registry every subsystem registers into.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labels: Iterable[str] = ()) -> Counter:
    """Get-or-create a counter on the default registry."""
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
    """Get-or-create a gauge on the default registry."""
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Iterable[str] = (),
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    """Get-or-create a histogram on the default registry."""
    return REGISTRY.histogram(name, help, labels, buckets=buckets)
