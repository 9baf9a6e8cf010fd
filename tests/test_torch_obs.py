"""The port's observability copies against the JAX package's, on the CPU.

The unit tests of ``tests/test_obs.py`` (the registry, its exposition and
parser, the disable switch, telemetry), ``tests/test_slo.py`` (the burn-rate
monitor and the server's readiness gate) and ``tests/test_tracing.py`` (the
span model and its export) run here once per package (``pkg``): the
modules are copies, so both must pass the same bodies.  The one repaired
behaviour, a lane per thread in the tracer's export, runs against the
port's tracer only: the reference's own test of it fails by design (its
``tid`` is ``threading.get_ident()``, which Python reuses).
"""

import io
import json
import math
import threading
import time
import types

import numpy as np
import pytest

import kmeans_tpu.obs as ref_obs
import kmeans_tpu_torch.obs as port_obs
from test_obs import validate_prometheus_text


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    """One package's ``obs``: the package, its registry, tracing, slo and
    telemetry modules."""
    o = ref_obs if request.param == "ref" else port_obs
    from importlib import import_module

    base = o.__name__
    return types.SimpleNamespace(
        obs=o, registry=import_module(base + ".registry"),
        tracing=import_module(base + ".tracing"),
        slo=import_module(base + ".slo"),
        telemetry=import_module(base + ".telemetry"))


@pytest.fixture(autouse=True)
def _fresh_global_tracers():
    """Each test starts from disabled, empty global tracers."""
    was = [t.TRACER.enabled for t in (ref_obs.tracing, port_obs.tracing)]
    for t in (ref_obs.tracing, port_obs.tracing):
        t.TRACER.disable()
        t.TRACER.clear()
    yield
    for t, w in zip((ref_obs.tracing, port_obs.tracing), was):
        t.TRACER.enabled = w


# ---------------------------------------------------------------------------
# Registry (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_basics(pkg):
    reg = pkg.registry.MetricsRegistry()
    c = reg.counter("kmeans_tpu_t_total", "ticks", labels=("site",))
    c.labels(site="a").inc()
    c.labels(site="a").inc(2.5)
    c.labels(site="b").inc()
    assert c.value(site="a") == 3.5
    assert c.value(site="b") == 1.0
    with pytest.raises(ValueError):
        c.labels(site="a").inc(-1)
    g = reg.gauge("kmeans_tpu_t_gauge", "level")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value() == 3.0
    g.set_function(lambda: 42)
    assert g.value() == 42
    h = reg.histogram("kmeans_tpu_t_seconds", "timings",
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 5.0, 50.0):
        h.observe(v)
    count, total, cum = h.snapshot()
    assert count == 5 and math.isclose(total, 55.65)
    assert cum == [2, 3, 4, 5]


def test_get_or_create_and_mismatch(pkg):
    reg = pkg.registry.MetricsRegistry()
    a = reg.counter("kmeans_tpu_x_total", "x", labels=("k",))
    assert reg.counter("kmeans_tpu_x_total", "x", labels=("k",)) is a
    with pytest.raises(ValueError):
        reg.gauge("kmeans_tpu_x_total", "now a gauge")
    with pytest.raises(ValueError):
        reg.counter("kmeans_tpu_x_total", "x", labels=("other",))
    with pytest.raises(ValueError):
        reg.counter("bad name!", "x")
    with pytest.raises(ValueError):
        reg.counter("kmeans_tpu_y_total", "y", labels=("bad-label",))
    with pytest.raises(ValueError):
        reg.histogram("kmeans_tpu_h_seconds", "h", labels=("le",))
    h = reg.histogram("kmeans_tpu_h2_seconds", "h", buckets=(1.0, 5.0))
    assert reg.histogram("kmeans_tpu_h2_seconds", "h",
                         buckets=(1.0, 5.0)) is h
    with pytest.raises(ValueError):
        reg.histogram("kmeans_tpu_h2_seconds", "h", buckets=(60.0, 300.0))
    c = reg.counter("kmeans_tpu_l_total", "l", labels=("a",))
    with pytest.raises(ValueError):
        c.inc()
    with pytest.raises(ValueError):
        c.labels(b="nope")


def test_exposition_is_valid_and_escapes_labels(pkg):
    reg = pkg.registry.MetricsRegistry()
    c = reg.counter("kmeans_tpu_esc_total", 'help with \\ and\nnewline',
                    labels=("path",))
    c.labels(path='a"b\\c\nd').inc()
    h = reg.histogram("kmeans_tpu_esc_seconds", "h", labels=("m",),
                      buckets=(0.5, 2.0))
    h.labels(m="x").observe(1.0)
    text = reg.expose()
    families, _ = validate_prometheus_text(text)
    assert families["kmeans_tpu_esc_total"] == "counter"
    assert r'path="a\"b\\c\nd"' in text
    assert "# HELP kmeans_tpu_esc_total help with \\\\ and\\nnewline" \
        in text.splitlines()
    validate_prometheus_text(pkg.obs.REGISTRY.expose())


def test_parse_exposition_round_trips(pkg):
    reg = pkg.registry.MetricsRegistry()
    c = reg.counter("kmeans_tpu_rt_total", "requests", labels=("path",))
    c.labels(path='a"b\\c\nd').inc(3)
    reg.gauge("kmeans_tpu_rt_depth", "queue depth").set(-2.5)
    h = reg.histogram("kmeans_tpu_rt_seconds", "latency",
                      buckets=(0.5, 2.0))
    h.observe(1.0)
    h.observe(100.0)
    parse, render = pkg.registry.parse_exposition, \
        pkg.registry.render_exposition
    families = parse(reg.expose())
    (s,) = families["kmeans_tpu_rt_total"].samples
    assert s.label_dict() == {"path": 'a"b\\c\nd'} and s.value == 3.0
    buckets = {s.label_dict()["le"]: s.value
               for s in families["kmeans_tpu_rt_seconds"].samples
               if s.name == "kmeans_tpu_rt_seconds_bucket"}
    assert buckets == {"0.5": 0.0, "2": 1.0, "+Inf": 2.0}
    assert parse(render(families.values())) == families
    real = parse(pkg.obs.REGISTRY.expose())
    assert parse(render(real.values())) == real
    with pytest.raises(ValueError):
        parse("}{ not an exposition\n")
    with pytest.raises(ValueError):
        parse('kmeans_tpu_x_total{unclosed="v 1\n')


def test_same_registry_same_text(pkg):
    """The copy renders the same bytes as the reference for the same
    operations."""
    texts = []
    for mod in (ref_obs.registry, pkg.registry):
        reg = mod.MetricsRegistry()
        reg.counter("kmeans_tpu_a_total", "a", labels=("k",)).labels(
            k="x").inc(2)
        reg.gauge("kmeans_tpu_b", "b").set(0.25)
        h = reg.histogram("kmeans_tpu_c_seconds", "c", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(3.0)
        texts.append(reg.expose())
    assert texts[0] == texts[1]


def test_concurrent_increments_are_lossless(pkg):
    reg = pkg.registry.MetricsRegistry()
    c = reg.counter("kmeans_tpu_cc_total", "c", labels=("t",))
    child = c.labels(t="x")
    n, threads = 2000, 8

    def work():
        for _ in range(n):
            child.inc()

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert c.value(t="x") == n * threads


def test_disabled_registry_records_nothing_and_is_near_free(pkg):
    reg = pkg.registry.MetricsRegistry(enabled=False)
    c = reg.counter("kmeans_tpu_d_total", "d", labels=("s",))
    c.labels(s="a").inc()
    g = reg.gauge("kmeans_tpu_d_gauge", "d")
    g.set(5)
    h = reg.histogram("kmeans_tpu_d_seconds", "d")
    h.observe(1.0)
    assert c.value(s="a") == 0.0 and g.value() == 0.0
    assert h.snapshot() == (0, 0.0, [0] * (len(pkg.obs.DEFAULT_BUCKETS) + 1))
    cc, hc = c.labels(s="x"), h
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        cc.inc()
        hc.observe(0.1)
    dt = time.perf_counter() - t0
    assert dt < 2 * n * 5e-6, f"{dt / (2 * n) * 1e6:.2f} µs per op"
    reg.enable()
    c.labels(s="a").inc()
    assert c.value(s="a") == 1.0


def test_telemetry_writer_jsonl_and_summaries(pkg, tmp_path):
    o = pkg.obs
    buf = io.StringIO()
    with o.TelemetryWriter(buf, common={"run": "r1"}) as tw:
        tw.event("iter", seconds=0.5, inertia=float("nan"),
                 shift=float("inf"))
        tw.event("done", n=np.int64(3), v=np.float32(1.5))
    lines = buf.getvalue().strip().splitlines()
    ev, ev2 = json.loads(lines[0]), json.loads(lines[1])
    assert ev["run"] == "r1" and ev["inertia"] is None and ev["shift"] is None
    assert ev2["n"] == 3 and ev2["v"] == 1.5
    p = tmp_path / "t.jsonl"
    with o.TelemetryWriter(str(p)) as tw:
        tw.event("iter", seconds=0.25)
    assert o.read_events(str(p))[0]["seconds"] == 0.25
    p.write_text('{"event": "iter"}\n{torn', encoding="utf-8")
    with pytest.raises(ValueError, match="2"):
        o.read_events(str(p))
    s = o.summarize_events([
        {"event": "iter", "seconds": 0.2}, {"event": "iter", "seconds": 0.3},
        {"event": "iter", "seconds": None}, {"event": "other",
                                             "seconds": 9.0}])
    assert s["count"] == 3 and s["timed"] == 2
    assert math.isclose(s["total_s"], 0.5) and math.isclose(s["min_s"], 0.2)
    assert math.isclose(s["rate_per_s"], 4.0)


def test_telemetry_trace_id_stamped_from_ambient_span(pkg):
    tracing = pkg.tracing
    tracing.enable()
    buf = io.StringIO()
    with pkg.obs.TelemetryWriter(buf) as tw:
        with tracing.span("run", category="run") as s:
            tw.event("iter", seconds=0.1)
        tw.event("outside")
    lines = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    assert lines[0]["trace_id"] == s.trace_id
    assert "trace_id" not in lines[1]
    assert lines[0]["run_id"] == lines[1]["run_id"]


def test_probe_writable_and_build_info(pkg, tmp_path):
    o = pkg.obs
    o.probe_writable(str(tmp_path / "ok.jsonl"))
    assert not (tmp_path / "ok.jsonl").read_text()
    with pytest.raises(OSError):
        o.probe_writable(str(tmp_path / "no_dir" / "x.jsonl"))
    o.record_build_info("cpu")
    line = [ln for ln in o.REGISTRY.expose().splitlines()
            if ln.startswith("kmeans_tpu_build_info{")
            and 'backend="cpu"' in ln]
    assert line and line[0].endswith(" 1")


# ---------------------------------------------------------------------------
# SLO monitor (tests/test_slo.py)
# ---------------------------------------------------------------------------

def _clocked(pkg, **kw):
    now = [1000.0]
    kw.setdefault("eval_s", 0.0)
    return pkg.slo.SLOMonitor(clock=lambda: now[0], **kw), now


def test_window_label_and_ctor_validation(pkg):
    wl = pkg.slo.window_label
    assert [wl(10.0), wl(60.0), wl(300.0), wl(2.0), wl(1.5)] == \
        ["10s", "1m", "5m", "2s", "1.5s"]
    with pytest.raises(ValueError, match="one-to-one"):
        pkg.slo.SLOMonitor(windows_s=(10.0, 60.0), burn_thresholds=(1.0,))
    for kw in ({"latency_objective": 0.0}, {"latency_objective": 1.0},
               {"availability_objective": 1.5}):
        with pytest.raises(ValueError):
            pkg.slo.SLOMonitor(**kw)


def test_burn_rate_floor_and_availability(pkg):
    mon, _ = _clocked(pkg, latency_target_s=0.1, latency_objective=0.9,
                      windows_s=(10.0,), burn_thresholds=(100.0,),
                      min_samples=1)
    for i in range(10):
        mon.record(0.5 if i < 2 else 0.01)
    snap = mon.snapshot(force=True)
    assert snap["10s"]["burn"]["latency"] == pytest.approx(2.0)
    assert snap["10s"]["n"] == 10 and mon.healthy()
    mon, _ = _clocked(pkg, latency_target_s=0.01, windows_s=(10.0,),
                      burn_thresholds=(1.0,), min_samples=50)
    for _ in range(49):
        mon.record(1.0)
    assert mon.healthy() and mon.breaches() == []
    mon.record(1.0)
    assert not mon.healthy() and mon.breaches() == [("10s", "latency")]
    mon, _ = _clocked(pkg, availability_objective=0.5, windows_s=(10.0,),
                      burn_thresholds=(1.0,), min_samples=4,
                      latency_target_s=10.0)
    mon.record(0.01, error=True)
    mon.record(0.01, shed=True)
    mon.record(0.01)
    mon.record(0.01)
    assert not mon.healthy()
    assert ("10s", "availability") in mon.breaches()
    assert ("10s", "latency") not in mon.breaches()


def test_breach_transitions_and_recovery(pkg):
    mon, now = _clocked(pkg, latency_target_s=0.01, windows_s=(10.0,),
                        burn_thresholds=(1.0,), min_samples=5)
    ctr = pkg.slo._SLO_BREACH_TOTAL
    base = ctr.value(window="10s", slo="latency")
    for _ in range(10):
        mon.record(1.0)
    assert not mon.healthy()
    now[0] += 1.0
    assert not mon.healthy()
    assert ctr.value(window="10s", slo="latency") == base + 1
    now[0] += 11.0                       # the window drains
    assert mon.healthy() and mon.breaches() == []
    assert mon.snapshot(force=True)["10s"]["n"] == 0
    for _ in range(10):
        mon.record(1.0)
    assert not mon.healthy()
    assert ctr.value(window="10s", slo="latency") == base + 2


def test_eval_rate_limit_and_multi_window(pkg):
    mon, now = _clocked(pkg, latency_target_s=0.01, windows_s=(10.0,),
                        burn_thresholds=(1.0,), min_samples=5, eval_s=5.0)
    assert mon.healthy()
    for _ in range(10):
        mon.record(1.0)
    now[0] += 1.0
    assert mon.healthy()                 # the cached verdict stands
    now[0] += 5.0
    assert not mon.healthy()
    mon, _ = _clocked(pkg, latency_target_s=0.01, latency_objective=0.99,
                      windows_s=(10.0, 60.0), burn_thresholds=(14.4, 1.0),
                      min_samples=10)
    for i in range(100):
        mon.record(1.0 if i % 10 == 0 else 0.001)
    assert not mon.healthy()
    assert mon.breaches() == [("1m", "latency")]
    snap = mon.snapshot(force=True)
    assert snap["10s"]["breach"]["latency"] is False
    assert snap["1m"]["breach"]["latency"] is True


def test_snapshot_reports_percentiles(pkg):
    mon, _ = _clocked(pkg, windows_s=(60.0,), burn_thresholds=(100.0,),
                      min_samples=1, latency_target_s=10.0)
    for ms in (1, 2, 3, 4, 100):
        mon.record(ms / 1e3)
    row = mon.snapshot(force=True)["1m"]
    assert row["n"] == 5 and row["error_rate"] == 0.0
    assert row["p99_ms"] == pytest.approx(100.0)
    assert row["p50_ms"] == pytest.approx(3.0)


@pytest.mark.parametrize("side", ["ref", "port"])
def test_server_readiness_gated_on_slo(pkg, side):
    """Both servers gate /readyz on their monitor, and build none without
    ``slo``."""
    if side == "ref":
        from kmeans_tpu.config import ServeConfig
        from kmeans_tpu.serve.server import KMeansServer
        kw = {}
    else:
        from kmeans_tpu_torch.config import ServeConfig
        from kmeans_tpu_torch.serve.server import KMeansServer
        kw = {"device": "cpu"}
    s = KMeansServer(ServeConfig(port=0, slo=True, tracing=False), **kw)
    assert s.slo_monitor is not None
    mon, now = _clocked(pkg, latency_target_s=0.01, windows_s=(10.0,),
                        burn_thresholds=(1.0,), min_samples=5)
    s.slo_monitor = mon
    assert s.readiness()[0]
    for _ in range(10):
        mon.record(1.0)
    ready, detail = s.readiness()
    assert not ready and detail["slo"]["ok"] is False
    assert ["10s", "latency"] in detail["slo"]["breaches"]
    now[0] += 11.0
    assert s.readiness()[0]
    s2 = KMeansServer(ServeConfig(port=0, tracing=False), **kw)
    assert s2.slo_monitor is None and "slo" not in s2.readiness()[1]


# ---------------------------------------------------------------------------
# Tracing (tests/test_tracing.py)
# ---------------------------------------------------------------------------

def test_span_nesting_ids_and_parent_linkage(pkg):
    tracing = pkg.tracing
    t = tracing.Tracer(enabled=True)
    with t.span("outer", category="run") as outer:
        with t.span("inner", category="assign") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
        with t.span("inner2", category="update") as inner2:
            assert inner2.parent_id == outer.span_id
    assert [s.name for s in t.snapshot()] == ["inner", "inner2", "outer"]
    assert outer.parent_id is None
    assert tracing.current_context() is None
    with t.span("req", category="http", trace_id="abc123def4567890") as s:
        assert s.trace_id == "abc123def4567890" and s.parent_id is None


def test_cross_thread_context_handoff(pkg):
    tracing = pkg.tracing
    t = tracing.Tracer(enabled=True)
    seen = {}

    def worker(ctx):
        with tracing.use_context(ctx):
            with t.span("train_job", category="train") as s:
                seen["job"] = (s.trace_id, s.parent_id)

    def orphan():
        with t.span("alone") as s:
            seen["orphan"] = (s.trace_id, s.parent_id)

    with t.span("request", category="http") as root:
        th = threading.Thread(target=worker,
                              args=(tracing.current_context(),))
        th.start()
        th.join(timeout=30)
    th = threading.Thread(target=orphan)
    th.start()
    th.join(timeout=30)
    assert seen["job"] == (root.trace_id, root.span_id)
    assert seen["orphan"][0] != root.trace_id and seen["orphan"][1] is None


def test_start_span_does_not_touch_ambient_context(pkg):
    tracing = pkg.tracing
    t = tracing.Tracer(enabled=True)
    with t.span("outer") as outer:
        s = t.start_span("async_child")
        assert tracing.current_context().span_id == outer.span_id
        assert s.parent_id == outer.span_id
        s.end()
        s.end()
    assert [sp.name for sp in t.snapshot()].count("async_child") == 1


def test_ring_buffer_eviction_keeps_export_consistent(pkg):
    t = pkg.tracing.Tracer(capacity=8, enabled=True)
    for i in range(40):
        with t.span("outer", category="run", i=i):
            with t.span("inner", category="assign", i=i):
                pass
    assert len(t) == 8
    evs = [e for e in json.loads(t.export_chrome_trace())["traceEvents"]
           if e.get("ph") == "X"]
    assert len(evs) == 8
    by_id = {e["args"]["span_id"]: e for e in evs}
    for e in evs:
        p = by_id.get(e["args"].get("parent_id"))
        if p is not None:
            assert p["ts"] <= e["ts"] + 1e-3
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3


def test_export_writes_file_and_metadata(pkg, tmp_path):
    t = pkg.tracing.Tracer(enabled=True)
    with t.span("root", category="run", answer=42, bad=float("nan")):
        pass
    path = str(tmp_path / "trace.json")
    t.export_chrome_trace(path)
    doc = json.loads(open(path, encoding="utf-8").read())
    assert doc["displayTimeUnit"] == "ms"
    metas = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    assert any(e["name"] == "process_name" for e in metas)
    assert any(e["name"] == "thread_name" for e in metas)
    (root,) = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert root["args"]["answer"] == 42 and root["args"]["bad"] is None
    assert root["cat"] == "run" and root["dur"] >= 0


def test_disabled_tracer_is_near_free_and_ids_validate(pkg):
    tracing = pkg.tracing
    t = tracing.Tracer(enabled=False)
    with t.span("x", category="run"):
        pass
    assert len(t) == 0
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with t.span("x"):
            pass
    dt = time.perf_counter() - t0
    assert dt < n * 5e-6, f"{dt / n * 1e6:.2f} µs per disabled span"
    assert tracing.is_trace_id("abcdef0123456789")
    assert tracing.is_trace_id("a" * 8)
    for bad in ("short", "not hex chars!!!", None, "a" * 65):
        assert not tracing.is_trace_id(bad)


def test_concurrent_threads_export_strict_json():
    """tests/test_tracing.py's body, against the port's tracer: eight
    threads that need not live at the same time get eight lanes, each
    nesting cleanly, and the lanes' names are their threads'."""
    t = port_obs.tracing.Tracer(enabled=True)
    n_threads, n_iters = 8, 40

    def work(i):
        for j in range(n_iters):
            with t.span("iteration", category="iteration", thread=i,
                        iteration=j):
                with t.span("sweep", category="assign"):
                    pass

    threads = [threading.Thread(target=work, args=(i,), name=f"worker-{i}")
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    doc = json.loads(t.export_chrome_trace())
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(evs) == n_threads * n_iters * 2
    by_tid = {}
    for e in evs:
        by_tid.setdefault(e["tid"], []).append(e)
    assert len(by_tid) == n_threads
    for tid, es in by_tid.items():
        assert len({e["args"]["thread"] for e in es
                    if e["name"] == "iteration"}) == 1
        es.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in es:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] \
                    - 1e-3:
                stack.pop()
            if stack:
                assert e["ts"] + e["dur"] <= \
                    stack[-1]["ts"] + stack[-1]["dur"] + 1e-3
            stack.append(e)
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name"}
    assert set(names) == set(by_tid)
    assert sorted(n.split(" ")[0] for n in names.values()) == \
        [f"worker-{i}" for i in range(n_threads)]


def test_finished_threads_never_share_a_lane():
    """Threads that run one after another (the reference reuses their
    idents) each keep a lane of their own."""
    t = port_obs.tracing.Tracer(enabled=True)
    for i in range(6):
        th = threading.Thread(target=lambda: t.span("s", i=i).end())
        th.start()
        th.join(timeout=30)
    assert len({s.tid for s in t.snapshot()}) == 6
