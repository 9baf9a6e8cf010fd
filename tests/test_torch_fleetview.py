"""The port's fleet observability plane against the JAX package's, on the CPU.

``tests/test_fleetview.py``'s behaviour runs once per package (``side``):
the aggregation semantics (counter and histogram rollups over the worker
lanes, per-worker labels, no rollup of gauges or of the supervisor's lane,
``exported_worker``), the span spool and its merge, a torn spool tail,
scrape resilience against dead and garbled lanes, readiness gated on the
SLO monitor, and the two-worker mini-drill: the supervisor's rollup equals
the sum of the individual worker scrapes, and the merged trace holds one
``X-Trace-Id`` across both worker pids.  The port's workers run with
``device="cpu"``.

Across the packages: the same lane texts aggregate to the same exposition
text, ``merge_spool`` turns the same spool files into the same document,
and after the same requests the two fleets' aggregated ``/metrics`` name
the same families, under the same label names (the port's families are a
subset of the reference's; the fit's three, C2, are in both).  The
reference's attribution test of ``tools/trace_view.py`` is a tool of the
JAX package and has no port.
"""

import json
import os
import socket
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from kmeans_tpu.config import ServeConfig as RefServeConfig
from kmeans_tpu.continuous.registry import ModelRegistry as RefRegistry
from kmeans_tpu.obs import fleetview as ref_fv
from kmeans_tpu.obs import registry as ref_reg
from kmeans_tpu.obs import slo as ref_slo
from kmeans_tpu.obs import tracing as ref_tracing
from kmeans_tpu.serve import fleet as RF
from kmeans_tpu_torch.config import ServeConfig
from kmeans_tpu_torch.continuous.registry import ModelRegistry
from kmeans_tpu_torch.obs import fleetview as port_fv
from kmeans_tpu_torch.obs import registry as port_reg
from kmeans_tpu_torch.obs import slo as port_slo
from kmeans_tpu_torch.obs import tracing as port_tracing
from kmeans_tpu_torch.serve import fleet as PF

SIDES = ["ref", "port"]
#: Seconds a fleet may take to boot, and any one HTTP call.
BOOT_S = 60.0
WAIT_S = 20.0
#: The fit's metric families (C2), on every worker of either package.
FIT_FAMILIES = ("kmeans_tpu_sweep_recompute_rows_total",
                "kmeans_tpu_sweep_group_filter_fraction",
                "kmeans_tpu_accel_steps_total")


@pytest.fixture(autouse=True)
def npz_format(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _mods(side):
    """``(fleetview, registry, tracing, slo)`` of one package."""
    if side == "ref":
        return ref_fv, ref_reg, ref_tracing, ref_slo
    return port_fv, port_reg, port_tracing, port_slo


def _fam(reg, name, kind, samples, help_=""):
    f = reg.ParsedFamily(name, kind, help_)
    f.samples.extend(samples)
    return f


def _s(reg, name, labels, value):
    return reg.ParsedSample(name, tuple(labels), float(value))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Aggregation semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_counter_rollup_is_arithmetic_sum_plus_per_lane(side):
    fv, reg, _, _ = _mods(side)
    lanes = {
        "1": {"kmeans_tpu_x_total": _fam(reg, "kmeans_tpu_x_total",
                                         "counter", [
            _s(reg, "kmeans_tpu_x_total", [("route", "/a")], 3.0)])},
        "0": {"kmeans_tpu_x_total": _fam(reg, "kmeans_tpu_x_total",
                                         "counter", [
            _s(reg, "kmeans_tpu_x_total", [("route", "/a")], 2.0),
            _s(reg, "kmeans_tpu_x_total", [("route", "/b")], 7.0)])},
    }
    fam = fv.aggregate_families(lanes)["kmeans_tpu_x_total"]
    rollup = {s.labels: s.value for s in fam.samples
              if "worker" not in s.label_dict()}
    assert rollup == {(("route", "/a"),): 5.0, (("route", "/b"),): 7.0}
    per_lane = {(s.label_dict()["worker"], s.label_dict()["route"]):
                s.value for s in fam.samples
                if "worker" in s.label_dict()}
    assert per_lane == {("0", "/a"): 2.0, ("0", "/b"): 7.0,
                        ("1", "/a"): 3.0}
    workers = [s.label_dict()["worker"] for s in fam.samples
               if "worker" in s.label_dict()]
    assert workers == sorted(workers, key=int)


@pytest.mark.parametrize("side", SIDES)
def test_histogram_buckets_merge_bucketwise(side):
    fv, reg, _, _ = _mods(side)

    def lane(count_01, count_inf, total, n):
        name = "kmeans_tpu_h_seconds"
        return {name: _fam(reg, name, "histogram", [
            _s(reg, name + "_bucket", [("le", "0.1")], count_01),
            _s(reg, name + "_bucket", [("le", "+Inf")], count_inf),
            _s(reg, name + "_sum", [], total),
            _s(reg, name + "_count", [], n)])}

    fam = fv.aggregate_families({"0": lane(1, 4, 2.5, 4),
                                 "1": lane(2, 6, 3.5, 6)})[
        "kmeans_tpu_h_seconds"]
    rollup = [s for s in fam.samples if "worker" not in s.label_dict()]
    assert [(s.name, s.labels, s.value) for s in rollup] == [
        ("kmeans_tpu_h_seconds_bucket", (("le", "0.1"),), 3.0),
        ("kmeans_tpu_h_seconds_bucket", (("le", "+Inf"),), 10.0),
        ("kmeans_tpu_h_seconds_sum", (), 6.0),
        ("kmeans_tpu_h_seconds_count", (), 10.0),
    ]


@pytest.mark.parametrize("side", SIDES)
def test_gauges_are_per_lane_only(side):
    fv, reg, _, _ = _mods(side)
    lanes = {lane: {"kmeans_tpu_gen": _fam(reg, "kmeans_tpu_gen", "gauge", [
        _s(reg, "kmeans_tpu_gen", [], 3.0)])} for lane in ("0", "1")}
    fam = fv.aggregate_families(lanes)["kmeans_tpu_gen"]
    assert all("worker" in s.label_dict() for s in fam.samples)
    assert sorted((s.label_dict()["worker"], s.value)
                  for s in fam.samples) == [("0", 3.0), ("1", 3.0)]


@pytest.mark.parametrize("side", SIDES)
def test_preexisting_worker_label_renamed_exported_worker(side):
    fv, reg, _, _ = _mods(side)
    name = "kmeans_tpu_fleet_scrape_errors_total"
    lanes = {"sup": {name: _fam(reg, name, "counter", [
        _s(reg, name, [("worker", "0")], 1.0),
        _s(reg, name, [("worker", "1")], 2.0)])}}
    fam = fv.aggregate_families(lanes)[name]
    assert all("exported_worker" in s.label_dict() for s in fam.samples)
    assert {(s.label_dict()["exported_worker"], s.label_dict()["worker"]):
            s.value for s in fam.samples} == {("0", "sup"): 1.0,
                                              ("1", "sup"): 2.0}


@pytest.mark.parametrize("side", SIDES)
def test_sup_lane_excluded_from_rollup(side):
    fv, reg, _, _ = _mods(side)

    def fam_def(v):
        return {"kmeans_tpu_x_total": _fam(
            reg, "kmeans_tpu_x_total", "counter",
            [_s(reg, "kmeans_tpu_x_total", [("route", "/a")], v)])}

    fam = fv.aggregate_families({"0": fam_def(2.0), "1": fam_def(3.0),
                                 "sup": fam_def(100.0)})["kmeans_tpu_x_total"]
    rollup = [s for s in fam.samples if "worker" not in s.label_dict()]
    assert [(s.labels, s.value) for s in rollup] == [
        ((("route", "/a"),), 5.0)]
    assert {s.label_dict()["worker"]: s.value for s in fam.samples
            if "worker" in s.label_dict()} == {
        "0": 2.0, "1": 3.0, "sup": 100.0}


@pytest.mark.parametrize("side", SIDES)
def test_aggregate_expositions_drops_unparseable_lane(side):
    fv, _, _, _ = _mods(side)
    good = ("# TYPE kmeans_tpu_ok_total counter\n"
            "kmeans_tpu_ok_total 4\n")
    families, bad = fv.aggregate_expositions({"0": good, "1": "{{{ nope\n"})
    assert bad == ["1"]
    assert {s.labels: s.value
            for s in families["kmeans_tpu_ok_total"].samples} == {
        (): 4.0, (("worker", "0"),): 4.0}


def test_same_lane_texts_aggregate_to_the_same_exposition():
    """Both packages' aggregation, then rendering, of the same lane texts
    (counters, a histogram, a gauge, a lane with a worker label of its
    own, a garbled lane, lanes 10 and 2 out of order)."""
    texts = {
        "10": ("# HELP kmeans_tpu_req_total Requests\n"
               "# TYPE kmeans_tpu_req_total counter\n"
               'kmeans_tpu_req_total{route="/a",status="200"} 7\n'
               'kmeans_tpu_req_total{route="/b",status="503"} 1\n'
               "# TYPE kmeans_tpu_lat_seconds histogram\n"
               'kmeans_tpu_lat_seconds_bucket{le="0.1"} 2\n'
               'kmeans_tpu_lat_seconds_bucket{le="+Inf"} 3\n'
               "kmeans_tpu_lat_seconds_sum 0.75\n"
               "kmeans_tpu_lat_seconds_count 3\n"
               "# TYPE kmeans_tpu_gen gauge\nkmeans_tpu_gen 4\n"),
        "2": ("# TYPE kmeans_tpu_req_total counter\n"
              'kmeans_tpu_req_total{route="/a",status="200"} 5\n'
              "# TYPE kmeans_tpu_lat_seconds histogram\n"
              'kmeans_tpu_lat_seconds_bucket{le="0.1"} 1\n'
              'kmeans_tpu_lat_seconds_bucket{le="+Inf"} 1\n'
              "kmeans_tpu_lat_seconds_sum 0.05\n"
              "kmeans_tpu_lat_seconds_count 1\n"
              "# TYPE kmeans_tpu_gen gauge\nkmeans_tpu_gen 4\n"),
        "sup": ("# TYPE kmeans_tpu_fleet_scrape_errors_total counter\n"
                'kmeans_tpu_fleet_scrape_errors_total{worker="3"} 2\n'
                "# TYPE kmeans_tpu_req_total counter\n"
                'kmeans_tpu_req_total{route="/a",status="200"} 100\n'),
        "3": "}{ garbled\n",
    }
    out = []
    for fv, reg in ((ref_fv, ref_reg), (port_fv, port_reg)):
        families, bad = fv.aggregate_expositions(texts)
        assert bad == ["3"]
        out.append(reg.render_exposition(families.values()))
    assert out[0] == out[1]
    assert 'kmeans_tpu_req_total{route="/a",status="200"} 12' in out[1]


# ---------------------------------------------------------------------------
# Trace spool + merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_span_spool_roundtrip_and_merge(side, tmp_path):
    fv, _, tracing, _ = _mods(side)
    tracer = tracing.Tracer(enabled=True)
    spool = fv.SpanSpool(str(tmp_path), flush_events=1)
    tracer.set_sink(spool)
    with tracer.span("req", category="http", trace_id="ab12cd34", rows=2):
        with tracer.span("inner", category="serve_kernel"):
            pass
    spool.close()
    by_pid = fv.read_spool_events(str(tmp_path))
    assert list(by_pid) == [os.getpid()]
    events = by_pid[os.getpid()]
    assert {e["name"] for e in events} == {"req", "inner"}
    req = next(e for e in events if e["name"] == "req")
    assert req["ph"] == "X" and req["cat"] == "http"
    assert req["args"]["trace_id"] == "ab12cd34"
    doc = fv.merge_spool(str(tmp_path), {os.getpid(): "worker 0"})
    json.dumps(doc, allow_nan=False)
    procs = [e for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"]
    assert procs[0]["args"]["name"] == "worker 0"
    assert len([e for e in doc["traceEvents"] if e.get("ph") == "X"]) == 2


@pytest.mark.parametrize("side", SIDES)
def test_read_spool_tolerates_torn_tail_only(side, tmp_path):
    fv, _, _, _ = _mods(side)
    path = fv.spool_path(str(tmp_path), pid=123)
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"name": "ok", "ph": "X", "ts": 1.0}) + "\n")
        f.write('{"name": "torn-mid-append')
    assert fv.read_spool_events(str(tmp_path)) == {
        123: [{"name": "ok", "ph": "X", "ts": 1.0}]}
    with open(path, "w", encoding="utf-8") as f:
        f.write('{"oops\n')
        f.write(json.dumps({"name": "ok", "ph": "X", "ts": 1.0}) + "\n")
    with pytest.raises(ValueError):
        fv.read_spool_events(str(tmp_path))


def test_merge_spool_is_the_references_on_the_same_files(tmp_path):
    """Spools of three pids written by both tracers, threads that came and
    went included, a torn tail and a file that is no spool: both packages
    merge them into the same document, with one lane per (pid, thread)
    and each pid's lanes under its worker name."""
    spool_dir = str(tmp_path)
    for pid, tracing in ((101, ref_tracing), (202, port_tracing),
                         (303, port_tracing)):
        tracer = tracing.Tracer(enabled=True)
        events = []
        tracer.set_sink(lambda s, pid=pid, events=events:
                        events.append(tracing.span_to_event(s, pid)))

        def work(i):
            with tracer.span(f"POST /api/assign", category="http",
                             trace_id=f"{pid:08x}{i:08x}"):
                with tracer.span("assign.queue", category="serve_queue",
                                 rows=64):
                    pass

        for i in range(3):                    # one thread after another
            t = threading.Thread(target=work, args=(i,))
            t.start()
            t.join(timeout=WAIT_S)
        work(3)
        with open(port_fv.spool_path(spool_dir, pid), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(json.dumps(e, allow_nan=False)
                              for e in events) + "\n")
            if pid == 303:
                f.write('{"name": "torn')
    with open(os.path.join(spool_dir, "spans-x.jsonl"), "w") as f:
        f.write("not a spool\n")
    names = {101: "worker 0", 202: "worker 1"}
    ref_doc = ref_fv.merge_spool(spool_dir, names)
    port_doc = port_fv.merge_spool(spool_dir, names)
    assert port_doc == ref_doc
    json.dumps(port_doc, allow_nan=False)
    meta = [e for e in port_doc["traceEvents"] if e["ph"] == "M"]
    assert [e["args"]["name"] for e in meta
            if e["name"] == "process_name"] == [
        "worker 0", "worker 1", "kmeans_tpu pid 303"]
    spans = [e for e in port_doc["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 24
    lanes = {(e["pid"], e["tid"]) for e in meta if e["name"] ==
             "thread_name"}
    assert {(e["pid"], e["tid"]) for e in spans} == lanes
    # The port's tracer gives each of its four threads a lane of its own.
    for pid in (202, 303):
        assert len({tid for p, tid in lanes if p == pid}) == 4


# ---------------------------------------------------------------------------
# Scrape resilience
# ---------------------------------------------------------------------------

class _FixedHandler(BaseHTTPRequestHandler):
    body = b""

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)


def _fixed_server(body: bytes):
    handler = type("H", (_FixedHandler,), {"body": body})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize("side", SIDES)
def test_scrape_fleet_partial_aggregate_and_error_counters(side):
    fv, reg, _, _ = _mods(side)
    good = _fixed_server(b"# TYPE kmeans_tpu_ok_total counter\n"
                         b"kmeans_tpu_ok_total 5\n")
    garbage = _fixed_server(b"}{ definitely not an exposition\n")
    dead_port = _free_port()
    errs = fv._FLEET_SCRAPE_ERRORS_TOTAL
    base = {lane: errs.value(worker=lane) for lane in ("0", "1", "2")}
    obs = fv.FleetObsServer(
        targets_fn=lambda: [("0", good.server_address[1]),
                            ("1", garbage.server_address[1]),
                            ("2", dead_port)],
        scrape_timeout_s=2.0)
    try:
        text = obs.scrape_fleet()
    finally:
        obs._httpd.server_close()
        good.shutdown()
        garbage.shutdown()
    families = reg.parse_exposition(text)
    fam = families["kmeans_tpu_ok_total"]
    assert {s.labels: s.value for s in fam.samples} == {
        (): 5.0, (("worker", "0"),): 5.0}
    assert errs.value(worker="1") == base["1"] + 1
    assert errs.value(worker="2") == base["2"] + 1
    assert errs.value(worker="0") == base["0"]
    efam = families["kmeans_tpu_fleet_scrape_errors_total"]
    sup_copies = {s.label_dict()["exported_worker"]: s.value
                  for s in efam.samples
                  if s.label_dict().get("worker") == "sup"}
    assert sup_copies["1"] >= 1.0 and sup_copies["2"] >= 1.0
    assert not any("worker" not in s.label_dict() for s in efam.samples)


@pytest.mark.parametrize("side", SIDES)
def test_fleet_obs_readiness_gates_on_slo(side):
    fv, _, _, slo = _mods(side)
    now = [500.0]
    mon = slo.SLOMonitor(latency_target_s=0.01, windows_s=(10.0,),
                         burn_thresholds=(1.0,), min_samples=5, eval_s=0.0,
                         clock=lambda: now[0])
    obs = fv.FleetObsServer(targets_fn=lambda: [], slo=mon,
                            ready_fn=lambda: (True, {"role": "supervisor"}))
    try:
        ready, detail = obs.readiness()
        assert ready and detail["ready"]
        for _ in range(10):
            mon.record(1.0)
        ready, detail = obs.readiness()
        assert not ready
        assert ["10s", "latency"] in detail["slo"]["breaches"]
        now[0] += 11.0
        ready, _ = obs.readiness()
        assert ready
    finally:
        obs._httpd.server_close()


# ---------------------------------------------------------------------------
# The mini-drill: 2 workers, the real supervisor pane
# ---------------------------------------------------------------------------

_DRILL_TRACE_ID = "fade0000fade0000"
_DRILLS = {}


def _assign_traced(base, rows):
    req = urllib.request.Request(
        base + "/api/assign",
        data=json.dumps({"points": rows}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Trace-Id": _DRILL_TRACE_ID}, method="POST")
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return r.status, json.loads(r.read())


def _scrape(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as r:
        return r.status, r.read().decode("utf-8")


def _run_drill(side, root):
    """One side's fleet: 2 workers under the supervisor pane, 40 traced
    requests, each worker's scrape and the supervisor's, a graceful stop,
    then the merged spool.  Runs once per side for the module."""
    if side in _DRILLS:
        return _DRILLS[side]
    tmp, trace_dir = str(root / "model"), str(root / "spool")
    reg = (RefRegistry if side == "ref" else ModelRegistry)(path=tmp)
    reg.publish(np.arange(12, dtype=np.float32).reshape(4, 3) * 10.0,
                trigger="initial")
    port = _free_port()
    knobs = dict(host="127.0.0.1", port=port, model_dir=tmp,
                 assign_batching=False, metrics=True, tracing=True,
                 trace_dir=trace_dir, fleet_heartbeat_s=0.1,
                 fleet_heartbeat_timeout_s=1.0, fleet_backoff_base_s=0.05,
                 fleet_reload_poll_s=0.05)
    if side == "ref":
        sup = RF.FleetSupervisor(RefServeConfig(**knobs), workers=2)
    else:
        sup = PF.FleetSupervisor(ServeConfig(**knobs), workers=2,
                                 device="cpu")
    base = f"http://127.0.0.1:{port}"
    out = {"statuses": []}
    _DRILLS[side] = out
    try:
        sup.start()
        out["ready"] = sup.wait_ready(timeout=BOOT_S)
        assert out["ready"], sup.events
        out["targets"] = sup._obs_targets()
        for _ in range(40):
            out["statuses"].append(_assign_traced(base, [[0.0, 0.0, 0.0]]))
        out["per_worker"] = {lane: _scrape(
            f"http://127.0.0.1:{obs_port}/metrics")
            for lane, obs_port in out["targets"]}
        out["fleet"] = _scrape(f"http://127.0.0.1:{sup.obs_port}/metrics")
        out["readyz"] = _scrape(
            f"http://127.0.0.1:{sup.obs_port}/readyz")[0]
        out["clean"] = sup.stop(graceful=True)
        out["events"] = list(sup.events)
    finally:
        sup.stop(graceful=False)
    out["trace"] = (ref_fv if side == "ref"
                    else port_fv).merge_spool(trace_dir)
    return out


@pytest.mark.parametrize("side", SIDES)
def test_fleet_obs_mini_drill(side, tmp_path_factory):
    """The supervisor's ``/metrics`` rollup equals the arithmetic sum of
    the individual worker scrapes, every worker has its series, and the
    merged trace holds one X-Trace-Id across >= 2 worker pids."""
    _, reg, _, _ = _mods(side)
    drill = _run_drill(side, tmp_path_factory.mktemp(f"drill_{side}"))
    assert len(drill["targets"]) == 2 and all(p for _, p in drill["targets"])
    assert all(st == 200 and out["generation"] == 1
               for st, out in drill["statuses"])
    assert len(drill["statuses"]) == 40
    per_worker = {}
    for lane, (st, text) in drill["per_worker"].items():
        assert st == 200
        per_worker[lane] = reg.parse_exposition(text)
    st, text = drill["fleet"]
    assert st == 200
    fleet = reg.parse_exposition(text)
    fam = fleet["kmeans_tpu_http_requests_total"]
    lanes_seen = {s.label_dict().get("worker") for s in fam.samples
                  if "worker" in s.label_dict()}
    assert {"0", "1"} <= lanes_seen
    rollups = [s for s in fam.samples if "worker" not in s.label_dict()]
    assert rollups
    for s in rollups:
        expected = sum(
            w.value for lane in per_worker
            for w in per_worker[lane].get(
                "kmeans_tpu_http_requests_total",
                reg.ParsedFamily("", "counter", "")).samples
            if w.name == s.name and w.labels == s.labels)
        assert s.value == expected, (s.name, s.labels)
    assign = [s for s in rollups
              if s.label_dict().get("route") == "/api/assign"
              and s.label_dict().get("status") == "200"]
    assert sum(s.value for s in assign) == 40.0
    assert drill["readyz"] == 200
    assert drill["clean"], drill["events"]
    doc = drill["trace"]
    json.dumps(doc, allow_nan=False)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    req_spans = [e for e in spans if e.get("cat") == "http"
                 and e.get("args", {}).get("trace_id") == _DRILL_TRACE_ID]
    assert len(req_spans) == 40
    assert len({e["pid"] for e in req_spans}) >= 2


def _label_names(families):
    """``{family: {label names of each worker lane's sample}}``; the
    supervisor's lane (``sup``) is this test process's own registry,
    whose series depend on what ran here before."""
    return {name: {tuple(sorted(k for k, _ in s.labels))
                   for s in fam.samples
                   if s.label_dict().get("worker") not in (None, "sup")}
            for name, fam in families.items()}


def test_two_fleets_aggregate_the_same_families(tmp_path_factory):
    """After the same requests, the port fleet's aggregated ``/metrics``
    names a subset of the reference fleet's families, C2's three among
    them in both, each under the same label names but build info (a
    known difference: only the port's workers fill it); the families the
    requests drive carry samples and the same request count."""
    got, assigned = {}, {}
    for side in SIDES:
        drill = _run_drill(side, tmp_path_factory.mktemp(f"drill_{side}"))
        st, text = drill["fleet"]
        assert st == 200
        families = _mods(side)[1].parse_exposition(text)
        got[side] = _label_names(families)
        assigned[side] = [
            s.value
            for s in families["kmeans_tpu_http_requests_total"].samples
            if s.label_dict().get("route") == "/api/assign"
            and "worker" not in s.label_dict()]
    assert assigned["port"] == assigned["ref"] == [40.0]
    assert set(got["port"]) <= set(got["ref"]), \
        set(got["port"]) - set(got["ref"])
    for name in FIT_FAMILIES:
        assert name in got["port"] and name in got["ref"], name
    # The port's server seeds its build-info child at construction (its
    # backend label is the device type); the reference's workers leave
    # the family empty.
    assert got["ref"]["kmeans_tpu_build_info"] == set()
    for name in set(got["port"]) - {"kmeans_tpu_build_info"}:
        assert got["port"][name] == got["ref"][name], name
    for name in ("kmeans_tpu_http_requests_total",
                 "kmeans_tpu_http_request_seconds",
                 "kmeans_tpu_build_info", "kmeans_tpu_accel_steps_total"):
        assert got["port"][name], name
    for name in ("kmeans_tpu_fleet_workers",
                 "kmeans_tpu_fleet_scrape_seconds"):
        assert name in got["port"], name
