"""The port's HTTP model server against the JAX package's, on the CPU.

Both servers run on port 0 over one model directory (npz bundles: the
reference's side runs with ``orbax.checkpoint`` hidden from ``sys.modules``,
so it writes and reads the shared format).  The port's server runs with
``device="cpu"``, where its engine takes K5's plain version; the reference's
runs its jitted routes under JAX on the CPU.

* Parity: the same request gets the same status, the same presence of
  ``Retry-After``, the same content type and the same body bytes from both
  (JSON and binary frames, distances, every error, ``/api/model``,
  ``/healthz``, ``/readyz``, a reload), on tie-free data made with numpy
  from a seed; distances agree to 1e-6 relative.
* The model-serving tests of ``tests/test_server.py``, the HTTP tests of
  ``tests/test_serve_wire.py``, the admission and readiness tests of
  ``tests/test_fleet.py`` and the server tests of ``tests/test_tracing.py``
  run once per server (``side``).
* The port's own surface: no card without ``device="cpu"`` raises, the
  CLI, and a lane per handler thread in
  ``/api/trace``.

Every server is stopped in teardown and every wait has a timeout.
"""

import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kmeans_tpu.config import ServeConfig as RefServeConfig
from kmeans_tpu.continuous.registry import ModelRegistry as RefRegistry
from kmeans_tpu.obs import tracing as ref_tracing
from kmeans_tpu.serve.server import KMeansServer as RefServer
from kmeans_tpu_torch import cli
from kmeans_tpu_torch.config import ServeConfig
from kmeans_tpu_torch.continuous.registry import ModelRegistry
from kmeans_tpu_torch.obs import tracing as port_tracing
from kmeans_tpu_torch.serve import assign as A
from kmeans_tpu_torch.serve.server import KMeansServer, _TenantAdmission

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Seconds any one HTTP call or join may take.
WAIT_S = 20.0
SIDES = ["ref", "port"]


@pytest.fixture(autouse=True)
def npz_format(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


@pytest.fixture(autouse=True)
def _tracers_restored():
    was = (ref_tracing.TRACER.enabled, port_tracing.TRACER.enabled)
    yield
    ref_tracing.TRACER.enabled, port_tracing.TRACER.enabled = was


@pytest.fixture()
def servers():
    """``start(side, registry=None, **config)`` -> a started server with
    ``.base``; every one is stopped at teardown."""
    started = []

    def start(side, registry=None, **kw):
        if side == "ref":
            cfg = dataclasses.replace(RefServeConfig(port=0), **kw)
            s = RefServer(cfg, registry=registry)
        else:
            cfg = dataclasses.replace(ServeConfig(port=0), **kw)
            s = KMeansServer(cfg, registry=registry, device="cpu")
        httpd = s.start(background=True)
        started.append(s)
        s.base = f"http://127.0.0.1:{httpd.server_address[1]}"
        return s

    yield start
    for s in started:
        s.stop()


def _registry(side, path=None):
    return (RefRegistry if side == "ref" else ModelRegistry)(path=path)


def _call(base, path, data=None, ctype="application/json", headers=None,
          method=None):
    """``(status, headers, body bytes)`` of one request."""
    hdrs = dict(headers or {})
    if data is not None:
        hdrs["Content-Type"] = ctype
    req = urllib.request.Request(base + path, data=data, headers=hdrs,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post_json(base, path, obj):
    st, hdrs, body = _call(base, path, json.dumps(obj).encode())
    return st, hdrs, json.loads(body)


def _separated(k, d, n, seed):
    """Centroids far apart and queries near them: tie-free labels."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)) * 10
    x = c[rng.integers(0, k, size=n)] + 0.1 * rng.normal(size=(n, d))
    return c.astype(np.float32), x.astype(np.float32)


def _assert_retry_after(config, headers):
    raw = headers["Retry-After"]
    assert raw.isdigit(), raw
    lo = int(config.retry_after_s)
    assert lo <= int(raw) <= lo + int(config.retry_after_jitter_s)


# ---------------------------------------------------------------------------
# Parity: the same request, the same answer, byte for byte
# ---------------------------------------------------------------------------

_K, _D = 12, 16
_C, _X = _separated(_K, _D, 40, seed=3)


def _frame(x, **kw):
    return A.encode_points(x, **kw), A.WIRE_POINTS_CONTENT_TYPE


_GOOD = A.encode_points(np.ones((2, _D), np.float32))
#: name -> (method, path, body, content type).
_CASES = {
    "json": ("POST", "/api/assign",
             json.dumps({"points": _X.tolist()}).encode(), "application/json"),
    "binary": ("POST", "/api/assign", *_frame(_X)),
    "binary_distances": ("POST", "/api/assign",
                         *_frame(_X, want_distances=True)),
    "json_empty": ("POST", "/api/assign", b'{"points": []}',
                   "application/json"),
    "json_no_body": ("POST", "/api/assign", b"", "application/json"),
    "json_bad_json": ("POST", "/api/assign", b"{torn", "application/json"),
    "json_wrong_d": ("POST", "/api/assign", b'{"points": [[1, 2]]}',
                     "application/json"),
    "json_nan": ("POST", "/api/assign",
                 json.dumps({"points": [[float("nan")] * _D]}).encode(),
                 "application/json"),
    "json_too_many": ("POST", "/api/assign",
                      json.dumps({"points": [[0] * _D] * 4097}).encode(),
                      "application/json"),
    "binary_truncated": ("POST", "/api/assign", _GOOD[:10],
                         A.WIRE_POINTS_CONTENT_TYPE),
    "binary_magic": ("POST", "/api/assign", b"XXXX" + _GOOD[4:],
                     A.WIRE_POINTS_CONTENT_TYPE),
    "binary_version": ("POST", "/api/assign", _GOOD[:4] + b"\x09" + _GOOD[5:],
                       A.WIRE_POINTS_CONTENT_TYPE),
    "binary_dtype": ("POST", "/api/assign", _GOOD[:5] + b"\x07" + _GOOD[6:],
                     A.WIRE_POINTS_CONTENT_TYPE),
    "binary_length": ("POST", "/api/assign", _GOOD[:-4],
                      A.WIRE_POINTS_CONTENT_TYPE),
    "binary_too_many": ("POST", "/api/assign",
                        *_frame(np.ones((4097, _D), np.float32))),
    "binary_nan": ("POST", "/api/assign",
                   *_frame(np.full((2, _D), np.nan, np.float32))),
    "binary_wrong_d": ("POST", "/api/assign",
                       *_frame(np.ones((2, _D + 1), np.float32))),
    "model": ("GET", "/api/model", None, None),
    "healthz": ("GET", "/healthz", None, None),
    "readyz": ("GET", "/readyz", None, None),
    "reload": ("POST", "/api/model/reload", b"{}", "application/json"),
    "not_found_get": ("GET", "/nope", None, None),
    "not_found_post": ("POST", "/nope", b"{}", "application/json"),
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A reference and a port server booted from one model directory that
    holds one generation, and a pair over an empty directory."""
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "orbax", None)
    mp.setitem(sys.modules, "orbax.checkpoint", None)
    root = tmp_path_factory.mktemp("models")
    full, empty = str(root / "full"), str(root / "empty")
    ModelRegistry(path=full).publish(_C, trigger="initial",
                                     meta={"source": "seed 3"})
    out = {}
    for name, path in (("full", full), ("empty", empty)):
        # tracing=False: a module-lived server must hold no tracer.
        ref = RefServer(RefServeConfig(port=0, model_dir=path,
                                       tracing=False))
        port = KMeansServer(ServeConfig(port=0, model_dir=path,
                                        tracing=False), device="cpu")
        out[name] = []
        for s in (ref, port):
            s.base = f"http://127.0.0.1:{s.start().server_address[1]}"
            out[name].append(s)
    yield out
    for ss in out.values():
        for s in ss:
            s.stop()
    mp.undo()


def _both(servers, name):
    method, path, data, ctype = _CASES[name]
    return [_call(s.base, path, data, ctype or "application/json",
                  method=method) for s in servers]


@pytest.mark.parametrize("name", sorted(_CASES))
def test_same_request_same_response(pair, name):
    (rs, rh, rb), (ps, ph, pb) = _both(pair["full"], name)
    assert rs == ps
    assert rh.get("Content-Type") == ph.get("Content-Type")
    assert ("Retry-After" in rh) == ("Retry-After" in ph)
    if name != "binary_distances":
        assert rb == pb, (rb[:200], pb[:200])
        return
    lab_r, dist_r, gen_r, k_r = A.decode_labels(rb)
    lab_p, dist_p, gen_p, k_p = A.decode_labels(pb)
    np.testing.assert_array_equal(lab_r, lab_p)
    assert (gen_r, k_r) == (gen_p, k_p) == (1, _K)
    np.testing.assert_allclose(dist_p, dist_r, rtol=1e-6)
    want = np.sqrt(((_X.astype(np.float64) - _C[lab_p]) ** 2).sum(1))
    np.testing.assert_allclose(dist_p, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["json", "binary", "model", "reload",
                                  "readyz", "healthz"])
def test_same_response_before_any_generation(pair, name):
    (rs, rh, rb), (ps, ph, pb) = _both(pair["empty"], name)
    assert rs == ps
    assert ("Retry-After" in rh) == ("Retry-After" in ph)
    if "Retry-After" in rh:
        assert rs == 503
        _assert_retry_after(ServeConfig(), ph)
    else:
        assert rb == pb


@pytest.mark.parametrize("path,method", [("/api/assign", "POST"),
                                         ("/api/model", "GET"),
                                         ("/api/model/reload", "POST")])
def test_same_404_without_a_registry(servers, path, method):
    data = b'{"points": [[0.0]]}' if method == "POST" else None
    out = [_call(servers(side).base, path, data, method=method)
           for side in SIDES]
    assert out[0][0] == out[1][0] == 404
    assert out[0][2] == out[1][2] == b'{"error": "no model registry configured"}'
    assert "Retry-After" not in out[1][1]


def test_labels_equal_the_reference_and_k5_plain(pair):
    """The port's labels are the reference's on the JSON and binary
    paths, and K5's plain version's."""
    from kmeans_tpu_torch.ops.cuda_lloyd import tiled_argmin_plain
    import torch

    _, _, body = _both(pair["full"], "binary")[1]
    lab, _, _, _ = A.decode_labels(body)
    c = torch.from_numpy(_C)
    want = tiled_argmin_plain(torch.from_numpy(_X), (c * -2).contiguous(),
                              (c * c).sum(1), k_tile=128,
                              raw_scores=True)[0]
    np.testing.assert_array_equal(lab, want.numpy())


# ---------------------------------------------------------------------------
# tests/test_server.py's model-serving tests, on each server
# ---------------------------------------------------------------------------

def _model_server(servers, side, tmp_path, **kw):
    reg = _registry(side, str(tmp_path / "model"))
    s = servers(side, registry=reg, **kw)
    s.reg = reg
    return s


@pytest.mark.parametrize("side", SIDES)
def test_assign_before_any_model_is_retryable_503(servers, side, tmp_path):
    s = _model_server(servers, side, tmp_path)
    st, headers, out = _post_json(s.base, "/api/assign",
                                  {"points": [[0.0, 0.0]]})
    assert st == 503 and "no model" in out["error"]
    _assert_retry_after(s.config, headers)


@pytest.mark.parametrize("side", SIDES)
def test_assign_and_model_metadata_after_publish(servers, side, tmp_path):
    s = _model_server(servers, side, tmp_path)
    s.reg.publish(np.array([[0.0, 0.0], [10.0, 10.0]], np.float32),
                  trigger="initial")
    st, _, out = _post_json(s.base, "/api/assign", {"points": [[1, 1],
                                                               [9, 9]]})
    assert st == 200 and out == {"labels": [0, 1], "generation": 1, "k": 2}
    _, _, raw = _call(s.base, "/api/model")
    meta = json.loads(raw)
    assert (meta["generation"], meta["k"], meta["d"], meta["trigger"]) == \
        (1, 2, 2, "initial")


@pytest.mark.parametrize("side", SIDES)
def test_assign_validates_shape_and_caps_rows(servers, side, tmp_path):
    s = _model_server(servers, side, tmp_path)
    s.reg.publish(np.zeros((2, 3), np.float32))
    st, _, out = _post_json(s.base, "/api/assign", {"points": [[1, 2]]})
    assert st == 400 and "(n, 3)" in out["error"]
    assert _post_json(s.base, "/api/assign", {"points": []})[0] == 400
    assert _post_json(s.base, "/api/assign",
                      {"points": [[0, 0, 0]] * 4097})[0] == 413


@pytest.mark.parametrize("side", SIDES)
def test_assign_hot_swap_zero_dropped_requests(servers, side, tmp_path):
    """Requests hammering /api/assign across many persisted swaps all
    land, each labelled against the generation it reports (generation g
    is the constant matrix g, so the nearest of [[g, g], [g + 1, g + 1]]
    to the origin is 0)."""
    s = _model_server(servers, side, tmp_path)
    s.reg.publish(np.array([[1.0, 1.0], [2.0, 2.0]], np.float32))
    stop = threading.Event()
    results = {"n": 0, "bad": []}
    lock = threading.Lock()

    def hammer():
        while not stop.is_set():
            st, _, out = _post_json(s.base, "/api/assign",
                                    {"points": [[0.0, 0.0]]})
            with lock:
                results["n"] += 1
                if st != 200 or out["labels"] != [0]:
                    results["bad"].append((st, out))

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    for g in range(2, 25):
        s.reg.publish(np.array([[g, g], [g + 1, g + 1]], np.float32),
                      trigger="drift")
    stop.set()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert results["n"] > 0 and not results["bad"], results["bad"][:3]


@pytest.mark.parametrize("publisher", SIDES)
@pytest.mark.parametrize("side", SIDES)
def test_model_reload_picks_up_new_checkpoint(servers, side, publisher,
                                              tmp_path):
    """Another process's registry (either package's) publishes a newer
    generation; POST /api/model/reload swaps it in."""
    s = _model_server(servers, side, tmp_path)
    s.reg.publish(np.zeros((2, 2), np.float32))
    other = _registry(publisher, s.reg.path)
    other.load_latest()
    other.publish(np.ones((2, 2), np.float32), trigger="drift")
    assert s.reg.generation == 1
    st, _, out = _post_json(s.base, "/api/model/reload", {})
    assert st == 200 and out["generation"] == 2
    assert _post_json(s.base, "/api/assign",
                      {"points": [[1, 1]]})[2]["generation"] == 2


@pytest.mark.parametrize("publisher", SIDES)
@pytest.mark.parametrize("side", SIDES)
def test_model_dir_boot_restore(servers, side, publisher, tmp_path):
    path = str(tmp_path / "model")
    _registry(publisher, path).publish(np.array([[5.0, 5.0]], np.float32),
                                       trigger="initial")
    s = servers(side, model_dir=path)
    st, _, out = _post_json(s.base, "/api/assign", {"points": [[5, 5]]})
    assert st == 200 and out["generation"] == 1


# ---------------------------------------------------------------------------
# tests/test_serve_wire.py's HTTP tests, on each server
# ---------------------------------------------------------------------------

@pytest.fixture()
def wire(servers, request):
    side = request.param
    reg = _registry(side)
    s = servers(side, registry=reg, assign_max_points=64, tracing=False)
    s.reg = reg
    return s


@pytest.mark.parametrize("wire", SIDES, indirect=True)
def test_binary_http_round_trip_and_distances(wire):
    c = np.random.RandomState(0).randn(32, 4).astype(np.float32)
    wire.reg.publish(c)
    x = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    st, hdrs, body = _call(wire.base, "/api/assign", *_frame(x))
    assert st == 200
    assert hdrs["Content-Type"] == A.WIRE_LABELS_CONTENT_TYPE
    lab, dist, gen, k = A.decode_labels(body)
    assert dist is None and gen == 1 and k == 32
    np.testing.assert_array_equal(lab, A.assign_direct(wire.reg.current(),
                                                       x))
    st, _, body = _call(wire.base, "/api/assign",
                        *_frame(x, want_distances=True))
    lab, dist, _, _ = A.decode_labels(body)
    want = np.sqrt(((x - c[lab]) ** 2).sum(1)).astype(np.float32)
    np.testing.assert_allclose(dist, want, rtol=1e-6)


@pytest.mark.parametrize("wire", SIDES, indirect=True)
def test_json_clients_see_the_legacy_response(wire):
    wire.reg.publish(np.zeros((2, 3), np.float32))
    st, hdrs, body = _call(wire.base, "/api/assign", json.dumps(
        {"points": [[0, 0, 0], [1, 1, 1]]}).encode())
    assert st == 200 and hdrs["Content-Type"] == "application/json"
    assert json.loads(body) == {"labels": [0, 0], "generation": 1, "k": 2}


@pytest.mark.parametrize("wire", SIDES, indirect=True)
def test_malformed_binary_frames_get_400_with_json_error(wire):
    wire.reg.publish(np.zeros((2, 3), np.float32))
    good = A.encode_points(np.ones((2, 3), np.float32))
    for frame in (good[:10], b"XXXX" + good[4:],
                  good[:4] + b"\x09" + good[5:],
                  good[:5] + b"\x07" + good[6:], good[:-4],
                  A.encode_points(np.ones((65, 3), np.float32)),
                  A.encode_points(np.full((2, 3), np.nan, np.float32)),
                  A.encode_points(np.ones((2, 5), np.float32))):
        st, hdrs, body = _call(wire.base, "/api/assign", frame,
                               A.WIRE_POINTS_CONTENT_TYPE)
        assert st == 400 and hdrs["Content-Type"] == "application/json"
        assert "error" in json.loads(body)


@pytest.mark.parametrize("side", SIDES)
def test_metrics_families(servers, side):
    """The wire, request, engine and registry families on ``/metrics``;
    the port exposes the reference's names."""
    reg = _registry(side)
    s = servers(side, registry=reg)
    reg.publish(np.zeros((2, 3), np.float32))
    _call(s.base, "/api/assign", *_frame(np.ones((2, 3), np.float32)))
    _call(s.base, "/api/assign", json.dumps({"points": [[0, 0, 0]]}).encode())
    _call(s.base, "/metrics")
    _, _, raw = _call(s.base, "/metrics")
    text = raw.decode()
    for want in ('kmeans_tpu_assign_wire_requests_total{format="binary"}',
                 'kmeans_tpu_assign_wire_requests_total{format="json"}',
                 'kmeans_tpu_assign_wire_bytes_total{direction="rx"}',
                 'kmeans_tpu_assign_wire_bytes_total{direction="tx"}',
                 'kmeans_tpu_http_requests_total{method="POST",'
                 'route="/api/assign",status="200"}',
                 'kmeans_tpu_assign_request_seconds_count{path="batched"}',
                 'kmeans_tpu_assign_batches_total{kernel="dense"}',
                 "kmeans_tpu_assign_batch_rows_count",
                 "kmeans_tpu_assign_queue_delay_seconds_count",
                 "kmeans_tpu_assign_points_total",
                 "kmeans_tpu_registry_generation",
                 "kmeans_tpu_metrics_scrape_seconds_count",
                 # The fit's families (C2): in every process of either
                 # package, the outcome series from import on.
                 "# TYPE kmeans_tpu_sweep_recompute_rows_total counter",
                 "# TYPE kmeans_tpu_sweep_group_filter_fraction gauge",
                 'kmeans_tpu_accel_steps_total{outcome="accepted"}',
                 'kmeans_tpu_accel_steps_total{outcome="rejected"}',
                 'kmeans_tpu_accel_steps_total{outcome="fallback"}',
                 # The step-paced runner's families, its model label
                 # seeded at import in either package.
                 "# TYPE kmeans_tpu_iteration_seconds histogram",
                 'kmeans_tpu_iteration_seconds_count{model="lloyd"}',
                 "# TYPE kmeans_tpu_iterations_total counter",
                 'kmeans_tpu_iterations_total{model="lloyd"}'):
        assert want in text, want
    if side == "port":
        from kmeans_tpu import obs as ref_obs
        from kmeans_tpu_torch import obs as port_obs

        fams = set(port_obs.REGISTRY.names())
        assert fams <= set(ref_obs.REGISTRY.names()), \
            fams - set(ref_obs.REGISTRY.names())
        assert 'backend="cpu"' in [ln for ln in text.splitlines()
                                   if ln.startswith("kmeans_tpu_build_info{")
                                   ][0]


# ---------------------------------------------------------------------------
# tests/test_fleet.py's admission and readiness tests, on each server
# ---------------------------------------------------------------------------

_THREE_CLASSES = (("batch", 0, 0.0, 0.0), ("standard", 1, 0.0, 0.0),
                  ("premium", 2, 0.0, 0.0))


def test_admission_sheds_by_priority_and_meters_by_tenant():
    cfg = ServeConfig
    assert not _TenantAdmission(cfg()).enabled
    adm = _TenantAdmission(cfg(tenant_classes=_THREE_CLASSES,
                               shed_start_fraction=0.5))
    assert adm.decide("batch", 0.49) is None
    assert adm.decide("batch", 0.5)[0] == "batch"
    assert adm.decide("standard", 0.74) is None
    assert adm.decide("standard", 0.75)[0] == "standard"
    assert adm.decide("premium", 0.99) is None
    assert adm.decide("premium", 1.0)[0] == "premium"
    assert adm.resolve("nobody-special") == adm.resolve(None) == "batch"
    adm = _TenantAdmission(cfg(tenant_classes=(("batch", 0, 10.0, 2.0),)))
    t0 = 100.0
    assert adm.decide("alice", 0.0, now=t0) is None
    assert adm.decide("alice", 0.0, now=t0) is None
    assert "rate" in adm.decide("alice", 0.0, now=t0)[1]
    assert adm.decide("alice", 0.0, now=t0 + 0.15) is None
    assert adm.decide("alice", 0.0, now=t0 + 0.15) is not None
    assert adm.decide("bob", 0.0, now=t0) is None      # a bucket each


@pytest.mark.parametrize("batching", [True, False])
@pytest.mark.parametrize("side", SIDES)
def test_healthz_liveness_and_readyz_readiness(servers, side, batching):
    reg = _registry(side)
    s = servers(side, registry=reg, assign_batching=batching)
    st, _, body = _call(s.base, "/healthz")
    assert st == 200 and json.loads(body) == {"ok": True, "rooms": 0}
    st, _, body = _call(s.base, "/readyz")
    assert st == 503 and "not ready" in json.loads(body)["error"]
    reg.publish(np.zeros((2, 2), np.float32))
    st, _, body = _call(s.base, "/readyz")
    assert st == 200 and json.loads(body) == {
        "ok": True, "model": 1, "engine": "warm" if batching else "direct"}
    assert s.retry_after_s() == float(s.config.retry_after_s)


@pytest.mark.parametrize("side", SIDES)
def test_shed_ordering_over_keepalive_http(servers, side):
    """The batch tenant's bucket empties and sheds 503 + Retry-After while
    premium stays unmetered, on one keep-alive socket whose framing
    survives the sheds."""
    reg = _registry(side)
    reg.publish(np.array([[0.0, 0.0], [10.0, 10.0]], np.float32))
    s = servers(side, registry=reg,
                tenant_classes=(("batch", 0, 0.001, 2.0),
                                ("premium", 1, 0.0, 0.0)))
    conn = http.client.HTTPConnection("127.0.0.1",
                                      int(s.base.rsplit(":", 1)[1]),
                                      timeout=WAIT_S)
    body = json.dumps({"points": [[1.0, 1.0]]})

    def roundtrip(tenant):
        conn.request("POST", "/api/assign", body=body,
                     headers={"Content-Type": "application/json",
                              "X-Tenant": tenant})
        r = conn.getresponse()
        return r.status, r.getheader("Retry-After"), r.read()

    try:
        statuses = [roundtrip("batch") for _ in range(6)]
        assert [st for st, _, _ in statuses] == [200] * 2 + [503] * 4
        for st, retry_after, payload in statuses[2:]:
            assert retry_after is not None and float(retry_after) >= 1.0
            assert "rate" in json.loads(payload)["error"]
        for _ in range(3):
            st, _, payload = roundtrip("premium")
            assert st == 200 and json.loads(payload)["labels"] == [0]
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# tests/test_tracing.py's server tests, on each server
# ---------------------------------------------------------------------------

def _tracing_of(side):
    return ref_tracing if side == "ref" else port_tracing


@pytest.mark.parametrize("side", SIDES)
def test_trace_ids_minted_and_adopted(servers, side):
    s = servers(side)
    tracing = _tracing_of(side)
    _, headers, _ = _call(s.base, "/healthz")
    assert tracing.is_trace_id(headers["X-Trace-Id"])
    mine = "feedfacecafe0123"
    _, headers, _ = _call(s.base, "/healthz", headers={"X-Trace-Id": mine})
    assert headers["X-Trace-Id"] == mine
    _, headers, _ = _call(s.base, "/healthz",
                          headers={"X-Trace-Id": "<script>alert(1)"})
    assert headers["X-Trace-Id"] != "<script>alert(1)"
    assert tracing.is_trace_id(headers["X-Trace-Id"])


@pytest.mark.parametrize("side", SIDES)
def test_tracer_holds_are_refcounted(side):
    tracing = _tracing_of(side)
    tracing.TRACER.disable()

    def make(**kw):
        if side == "ref":
            return RefServer(RefServeConfig(port=0, **kw))
        return KMeansServer(ServeConfig(port=0, **kw), device="cpu")

    s = make()
    s.stop()                             # harmless without a start
    assert not tracing.enabled()
    a, b = make(), make()
    a.start()
    b.start()
    try:
        assert tracing.enabled()
        a.stop()
        assert tracing.enabled()         # b still holds the tracer
    finally:
        a.stop()
        b.stop()
    assert not tracing.enabled()
    s = make(tracing=False)
    httpd = s.start()
    try:
        st, _, _ = _call(f"http://127.0.0.1:{httpd.server_address[1]}",
                         "/api/trace")
        assert st == 404 and not tracing.enabled()
    finally:
        s.stop()


@pytest.mark.parametrize("side", SIDES)
def test_failed_server_construction_leaves_no_tracer_state(side, tmp_path):
    tracing = _tracing_of(side)
    tracing.TRACER.disable()
    bad = str(tmp_path / "no_dir" / "t.jsonl")
    with pytest.raises(ValueError, match="not writable"):
        if side == "ref":
            RefServer(RefServeConfig(port=0, telemetry_path=bad))
        else:
            KMeansServer(ServeConfig(port=0, telemetry_path=bad),
                         device="cpu")
    assert not tracing.enabled()


def test_api_trace_has_a_lane_per_handler_thread(servers):
    """Each connection's handler thread keeps a tid of its own, also
    after it ends and a new one starts (the reference reuses idents)."""
    reg = ModelRegistry()
    reg.publish(np.zeros((2, 2), np.float32))
    s = servers("port", registry=reg)
    port = int(s.base.rsplit(":", 1)[1])
    body = json.dumps({"points": [[0.0, 0.0]]})
    ids = []
    for i in range(4):                   # one connection after another
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        trace = f"{i:016x}"
        ids.append(trace)
        try:
            for _ in range(3):
                conn.request("POST", "/api/assign", body=body, headers={
                    "Content-Type": "application/json",
                    "X-Trace-Id": trace})
                r = conn.getresponse()
                assert r.status == 200
                r.read()
        finally:
            conn.close()
    _, _, raw = _call(s.base, "/api/trace")
    doc = json.loads(raw.decode(), parse_constant=lambda c: 1 / 0)
    reqs = [e for e in doc["traceEvents"]
            if e.get("name") == "POST /api/assign"
            and e["args"]["trace_id"] in ids]
    tids = {}
    for e in reqs:
        tids.setdefault(e["args"]["trace_id"], set()).add(e["tid"])
    assert sorted(tids) == ids
    assert all(len(t) == 1 for t in tids.values())
    assert len(set.union(*tids.values())) == 4
    queued = {e["args"]["trace_id"] for e in doc["traceEvents"]
              if e.get("name") == "assign.queue"}
    assert set(ids) <= queued


# ---------------------------------------------------------------------------
# The port's own surface
# ---------------------------------------------------------------------------

def test_no_card_raises_naming_the_cpu_device(tmp_path):
    """No card without ``device="cpu"`` raises before anything is made: a
    ``persist_dir`` is not created (with ``device="cpu"`` it is, and its
    rooms are revived)."""
    rooms = tmp_path / "rooms"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeansServer(ServeConfig(port=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeansServer(ServeConfig(port=0, persist_dir=str(rooms)))
    assert not rooms.exists()
    KMeansServer(ServeConfig(port=0, persist_dir=str(rooms)), device="cpu")
    assert rooms.is_dir()


@pytest.mark.parametrize("argv", [
    ["--workers", "2"], ["--fleet-obs-port", "0"],
    ["--persist-dir", "rooms"], [],
    ["--workers", "2", "--device", "cpu"],
    ["--workers", "2", "--device", "cpu", "--persist-dir", "rooms"],
])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    """No card without ``--device cpu`` and a fleet on an ephemeral port
    (``--port 0``) exit 2 with one line, a ``--persist-dir`` given or
    not."""
    assert cli.main(["serve", "--port", "0"] + argv) == 2
    err = capsys.readouterr().err
    assert err.splitlines()[-1].startswith("error: ")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_model_dir(tmp_path):
    """``python -m kmeans_tpu_torch.cli serve --model-dir D --device cpu``
    serves the directory's generation; Ctrl-C stops it with exit 0."""
    path = str(tmp_path / "model")
    RefRegistry(path=path).publish(np.array([[0.0, 0.0], [4.0, 4.0]],
                                            np.float32))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KMEANS_TPU_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmeans_tpu_torch.cli", "serve",
         "--model-dir", path, "--device", "cpu", "--port", str(port)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                st, _, _ = _call(base, "/readyz")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
        assert st == 200
        st, _, body = _call(base, "/api/assign", *_frame(
            np.array([[0.5, 0.5], [3.0, 4.0]], np.float32)))
        assert st == 200
        lab, _, gen, k = A.decode_labels(body)
        assert lab.tolist() == [0, 1] and (gen, k) == (1, 2)
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=WAIT_S)
    assert proc.returncode == 0, err.decode()
    assert b"serving on" in err


def test_chip_smoke_http_client_holds_a_run(tmp_path):
    """``chip_smoke.py --http-client`` (phase 10's load, standard library
    and numpy only) against a server on the CPU: every response lands,
    across a publish and a reload, with the labels of its generation."""
    c, pool = _separated(6, 8, 512, seed=9)
    path = str(tmp_path / "model")
    ModelRegistry(path=path).publish(c, generation=1)
    s = KMeansServer(ServeConfig(port=0, model_dir=path), device="cpu")
    httpd = s.start()
    np.save(str(tmp_path / "pool.npy"), pool)
    spec = {"host": "127.0.0.1", "port": httpd.server_address[1],
            "pool": str(tmp_path / "pool.npy"),
            "out": str(tmp_path / "out.npz"), "points": 16, "clients": 4,
            "seconds": 0.5, "swap_wait": WAIT_S, "mode": "binary",
            "run": 1, "new_gen": 2}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--http-client", json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        deadline = time.monotonic() + WAIT_S   # generation 1 answers first
        while s.assign_engine.stats()["requests"] < 4:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        reg = ModelRegistry(path=path)
        reg.load_latest()
        reg.publish(c[::-1], generation=2)
        assert _post_json(f"http://127.0.0.1:{spec['port']}",
                          "/api/model/reload", {})[2] == {"generation": 2}
        _, err = proc.communicate(timeout=2 * WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        s.stop()
    assert proc.returncode == 0, err
    out = np.load(spec["out"])
    table, labels = out["table"], out["labels"]
    assert len(table) and (table[:, 1] == 200).all()
    assert not out["errors"].size and int(out["hung"]) == 0
    assert {int(g) for g in table[:, 2]} == {1, 2}
    for (lo, _, g, *_), lab in zip(table, labels):
        cg = c if g == 1 else c[::-1]
        x = pool[int(lo):int(lo) + 16]
        want = ((x[:, None, :] - cg[None]) ** 2).sum(-1).argmin(1)
        np.testing.assert_array_equal(lab, want)
