"""The port's assignment engine against the JAX package's, on the CPU.

The port's engine runs with ``device="cpu"``, where the dense route takes
K5's plain version (``tiled_argmin_plain``) and the device routes run in
PyTorch on the CPU; the reference's runs its jitted routes under JAX on the
CPU.  Both serve one generation made with numpy from a seed.

Tolerances: the wire codec and the closure tables are copies, so frames
are compared byte for byte and tables bit for bit.  The two packages sum
the same f32 products in other orders, so on the scored routes labels are
held equal on rows whose two nearest centroids are more than ``GAP_RTOL``
apart in f64 (the other rows must carry a label within ``GAP_RTOL`` of the
least f64 distance), and a certificate's ``ok`` equal on rows more than
``GAP_RTOL`` of their bound away from its margin.  Every threaded test
waits with a timeout, so a hang fails a test rather than the run.
"""

import dataclasses
import sys
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.config import ServeConfig as RefServeConfig
from kmeans_tpu.continuous.registry import Generation as RefGeneration
from kmeans_tpu.ops import hamerly as RH
from kmeans_tpu.serve import assign as RA
from kmeans_tpu_torch import KMeans
from kmeans_tpu_torch.config import ServeConfig
from kmeans_tpu_torch.continuous.registry import Generation, ModelRegistry
from kmeans_tpu_torch.convert import generation_from_numpy, publish_state
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.ops import cuda_lloyd as K
from kmeans_tpu_torch.ops import plan as P
from kmeans_tpu_torch.ops.hamerly import (closure_assign_device,
                                          closure_candidates)
from kmeans_tpu_torch.serve import assign as A

CPU = "cpu"
GAP_RTOL = 1e-4
#: Seconds any one wait in a threaded test may take.
WAIT_S = 20.0


def _cfg(**kw):
    return dataclasses.replace(ServeConfig(), **kw)


def _engine(gen_or_fn, **kw):
    fn = gen_or_fn if callable(gen_or_fn) else (lambda: gen_or_fn)
    return A.AssignEngine(fn, _cfg(**kw), device=CPU)


def _ref_engine(gen, **kw):
    cfg = dataclasses.replace(RefServeConfig(host="127.0.0.1", port=0,
                                             tracing=False), **kw)
    return RA.AssignEngine(lambda: gen, cfg)


def _separated(k, d, n, seed):
    """Centroids in meta-clusters (the structure closure tables prune on)
    and queries near their own centroid, so nearest centroids are
    tie-free; ``far`` rows far from every centroid fail certificates."""
    rng = np.random.default_rng(seed)
    g = max(2, int(round(k ** 0.5)))
    meta = rng.normal(size=(g, d)) * 10
    c = meta[rng.integers(0, g, size=k)] + rng.normal(size=(k, d))
    x = c[rng.integers(0, k, size=n)] + 0.1 * rng.normal(size=(n, d))
    return c.astype(np.float32), x.astype(np.float32)


def _far(n, d, seed):
    return (np.random.default_rng(seed).normal(size=(n, d)) * 30
            ).astype(np.float32)


def _dist64(x, c):
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    return ((x64 * x64).sum(1)[:, None] - 2.0 * x64 @ c64.T
            + (c64 * c64).sum(1)[None, :])


def _check_labels(x, c, got, want):
    """Equal labels on tie-free rows; any label near the minimum on the
    others.  Returns the tie-free fraction."""
    d2 = _dist64(x, c)
    srt = np.sort(d2, axis=1)
    scale = np.abs(srt[:, :2]).max(axis=1) + 1.0
    clear = srt[:, 1] - srt[:, 0] > GAP_RTOL * scale
    np.testing.assert_array_equal(np.asarray(got)[clear],
                                  np.asarray(want)[clear])
    rows = np.arange(len(x))
    for lab in (got, want):
        assert (d2[rows, np.asarray(lab)] - srt[:, 0]
                <= GAP_RTOL * scale).all()
    return clear.mean()


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


# ---------------------------------------------------------------------------
# Wire codec: byte for byte the reference's frames and errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,dist", [(1, 1, False), (5, 3, True),
                                      (64, 2048, False), (3, 7, True)])
def test_wire_frames_are_the_reference_byte_for_byte(n, d, dist):
    rng = np.random.default_rng(n * d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    frame = A.encode_points(x, want_distances=dist)
    assert frame == RA.encode_points(x, want_distances=dist)
    got, flags = A.decode_points(frame, max_points=n)
    want, rflags = RA.decode_points(frame, max_points=n)
    assert flags == rflags == (A.WIRE_FLAG_DISTANCES if dist else 0)
    np.testing.assert_array_equal(got, want)
    labels = rng.integers(0, 1000, size=n).astype(np.int32)
    dists = rng.random(n).astype(np.float32) if dist else None
    out = A.encode_labels(labels, generation=2 ** 40 + n, k=1000,
                          distances=dists)
    assert out == RA.encode_labels(labels, generation=2 ** 40 + n, k=1000,
                                   distances=dists)
    lab, dd, gen, k = A.decode_labels(out)
    np.testing.assert_array_equal(lab, labels)
    assert (gen, k) == (2 ** 40 + n, 1000)
    assert (dd is None) == (dists is None)
    assert (A.WIRE_POINTS_CONTENT_TYPE, A.WIRE_LABELS_CONTENT_TYPE,
            A.WIRE_VERSION) == (RA.WIRE_POINTS_CONTENT_TYPE,
                                RA.WIRE_LABELS_CONTENT_TYPE,
                                RA.WIRE_VERSION)


def _good_points():
    return RA.encode_points(np.ones((2, 3), np.float32))


def _good_labels():
    return RA.encode_labels(np.zeros(2, np.int32), generation=1, k=3)


MALFORMED = {
    "points truncated": (lambda: _good_points()[:10], "points"),
    "points bad magic": (lambda: b"XXXX" + _good_points()[4:], "points"),
    "points version": (lambda: _good_points()[:4] + b"\x02"
                       + _good_points()[5:], "points"),
    "points dtype": (lambda: _good_points()[:5] + b"\x07"
                     + _good_points()[6:], "points"),
    "points empty": (lambda: RA._POINTS_HEADER.pack(
        b"KMPT", 1, 1, 0, 0, 3), "points"),
    "points over the cap": (lambda: _good_points(), "points cap"),
    "points short payload": (lambda: _good_points()[:-4], "points"),
    "points long payload": (lambda: _good_points() + b"\0" * 4, "points"),
    "labels truncated": (lambda: _good_labels()[:20], "labels"),
    "labels bad magic": (lambda: b"KMPT" + _good_labels()[4:], "labels"),
    "labels version": (lambda: _good_labels()[:4] + b"\x09"
                       + _good_labels()[5:], "labels"),
    "labels length": (lambda: _good_labels()[:-1], "labels"),
    "encode empty": (lambda: np.zeros((0, 3), np.float32), "encode"),
    "encode 1-d": (lambda: np.zeros(3, np.float32), "encode"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_wire_errors_are_the_reference_errors(case):
    make, what = MALFORMED[case]
    calls = {"points": lambda m, f: m.decode_points(f),
             "points cap": lambda m, f: m.decode_points(f, max_points=1),
             "labels": lambda m, f: m.decode_labels(f),
             "encode": lambda m, f: m.encode_points(f)}[what]
    with pytest.raises(A.WireError) as got:
        calls(A, make())
    with pytest.raises(RA.WireError) as want:
        calls(RA, make())
    assert str(got.value) == str(want.value)
    assert issubclass(A.WireError, ValueError)


# ---------------------------------------------------------------------------
# Closure tables and the pruned device formulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,d,kw", [
    (200, 16, dict(n_groups=8, cand_len=40)),
    (512, 32, {}),
    (1000, 64, dict(seed=3)),
    (10, 4, dict(n_groups=2, cand_len=10)),
    (37, 5, dict(n_groups=40, iters=2)),
])
def test_closure_candidates_are_the_reference_bit_for_bit(k, d, kw):
    c, _ = _separated(k, d, 1, seed=k)
    got, want = closure_candidates(c, **kw), RH.closure_candidates(c, **kw)
    for a, b, name in zip(got, want, ("group centers", "candidates",
                                       "thresholds")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if kw.get("cand_len") == k:
        assert np.isinf(got[2]).all()


def _closure_args(c):
    gc, cand, thr = closure_candidates(c)
    csq = np.einsum("kd,kd->k", c, c).astype(np.float32)
    gsq = np.einsum("gd,gd->g", gc, gc).astype(np.float32)
    return gc, gsq, cand, csq[cand], thr, c


@pytest.mark.parametrize("m_tile", [1, 7, 32, 10_000])
def test_closure_assign_device_matches_the_reference(m_tile):
    c, x = _separated(512, 32, 300, seed=5)
    x = np.concatenate([x, _far(60, 32, 6)])
    args = _closure_args(c)
    got = closure_assign_device(torch.from_numpy(x),
                                *(torch.from_numpy(a) for a in args),
                                m_tile=m_tile, margin_rel=1e-3)
    want = RH.closure_assign_device(jnp.asarray(x),
                                    *(jnp.asarray(a) for a in args),
                                    m_tile=m_tile, margin_rel=1e-3)
    got = [t.numpy() for t in got]
    want = [np.asarray(a) for a in want]
    assert got[0].dtype == np.int32 and got[1].dtype == bool
    # The pruned label is the candidates' argmin: hold it on the rows the
    # certificate covers, where it is the dense label.
    ok = want[1]
    assert 0 < ok.sum() < len(x)
    _check_labels(x[ok], c, got[0][ok], want[0][ok])
    # ok away from the margin: b + m(b + dg + 1) against thr[g] - dg.
    gc, _, _, _, thr, _ = args
    dg2 = _dist64(x, gc)
    g = dg2.argmin(axis=1)
    dg = np.sqrt(np.maximum(dg2[np.arange(len(x)), g], 0.0))
    cand = args[2][g]
    b = np.sqrt(np.maximum(np.take_along_axis(_dist64(x, c), cand,
                                              axis=1).min(axis=1), 0.0))
    lhs, rhs = b + 1e-3 * (b + dg + 1.0), thr[g] - dg
    away = np.abs(lhs - rhs) > GAP_RTOL * (np.abs(lhs) + 1.0)
    np.testing.assert_array_equal(got[1][away], want[1][away])


# ---------------------------------------------------------------------------
# The two engines side by side, on every route
# ---------------------------------------------------------------------------

ROUTES = {
    "dense": dict(assign_prune_min_k=0),
    "pruned host": dict(assign_pruned_backend="host"),
    "pruned device": dict(assign_pruned_backend="device"),
    "quant int8 host": dict(assign_quant="int8", assign_quant_min_rows=1,
                            assign_pruned_backend="host"),
    "quant int8 device": dict(assign_quant="int8", assign_quant_min_rows=1,
                              assign_pruned_backend="device"),
    "quant bf16 host": dict(assign_quant="bf16", assign_quant_min_rows=1,
                            assign_pruned_backend="host"),
    "quant bf16 device": dict(assign_quant="bf16", assign_quant_min_rows=1,
                              assign_pruned_backend="device"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engines_give_equal_labels_per_request(route):
    """One reference generation, converted; requests sized 1 to 700 rows,
    some far from every centroid so certificates fail and rescore."""
    c, x = _separated(1024, 48, 900, seed=11)
    x = np.concatenate([x, _far(100, 48, 12)])
    ref_gen = RefGeneration(c, 7, trigger="refit", meta={"src": "test"})
    gen = generation_from_numpy(ref_gen)
    kw = ROUTES[route]
    eng, ref = _engine(gen, **kw), _ref_engine(ref_gen, **kw)
    try:
        for lo, hi in ((0, 1), (1, 65), (65, 765), (765, 1000)):
            got, g = eng.submit(x[lo:hi])
            want, rg = ref.submit(x[lo:hi])
            assert g is gen and g.generation == rg.generation == 7
            assert got.dtype == np.int32 and got.shape == (hi - lo,)
            _check_labels(x[lo:hi], c, got, want)
            _check_labels(x[lo:hi], c, got,
                          RA.assign_direct(ref_gen, x[lo:hi]))
        st, rst = eng.stats(), ref.stats()
        for key in ("batches", "requests", "rows", "quant_batches",
                    "batch_rows_pow2", "mean_batch_rows"):
            assert st[key] == rst[key], key
        assert "shape_cache_hits" not in st
        if "quant" in route:
            assert st["quant_batches"] == 4
            assert st["quant_rescore_rows"] > 0
        elif route != "dense":
            assert st["fallback_rows"] > 0
    finally:
        eng.stop()
        ref.stop()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_ties_go_to_the_lowest_index(route):
    """Exact duplicate centroids on every route: the lowest index wins, as
    the reference's dense argmin and the port's K5 take it."""
    c, _ = _separated(600, 16, 1, seed=2)
    c[301], c[599] = c[3], c[3]
    c[450] = c[300]
    x = c[[3, 300, 301, 450, 599, 5]] + np.float32(0.0)
    eng = _engine(Generation(c, 1), **ROUTES[route])
    try:
        labels, _ = eng.submit(x)
    finally:
        eng.stop()
    np.testing.assert_array_equal(labels, [3, 300, 3, 300, 3, 5])


def test_dense_route_runs_k5_over_its_column_ranges(monkeypatch):
    """Untiled, 128-column ranges (one range over all of k would give a
    serving batch a block per 128 rows); tiled, the planner's slice; the
    labels are the same, and K5's wrapper is what runs."""
    assert P.kernel_plan("classic", 2048, 1000, x_itemsize=4,
                         cd_itemsize=4).mode == "untiled"
    assert A.dense_k_tile(1000, 2048) == 128
    assert A.dense_k_tile(128, 8) == 128
    tiled = A.dense_k_tile(65536, 2048)
    assert tiled == P.kernel_plan("classic", 2048, 65536, x_itemsize=4,
                                  cd_itemsize=4).k_tile
    assert tiled % P.LANE == 0 and tiled < 65536
    c, x = _separated(700, 24, 400, seed=8)
    gen = Generation(c, 1)
    calls = []
    real = A.tiled_argmin_cuda

    def spy(x_t, neg2c, csq, *, k_tile, raw_scores=False, **kw):
        calls.append((x_t.device.type, k_tile, raw_scores))
        return real(x_t, neg2c, csq, k_tile=k_tile, raw_scores=raw_scores,
                    **kw)

    monkeypatch.setattr(A, "tiled_argmin_cuda", spy)
    want = A.assign_direct(gen, x)
    for k_tile in (768, 256, 128):
        monkeypatch.setattr(A, "dense_k_tile", lambda k, d: k_tile)
        eng = _engine(gen, assign_prune_min_k=0)
        try:
            got, _ = eng.submit(x)
        finally:
            eng.stop()
        _check_labels(x, c, got, want)
    assert calls == [("cpu", 768, True), ("cpu", 256, True),
                     ("cpu", 128, True)]


@pytest.mark.parametrize("route", sorted(r for r in ROUTES if r != "dense"))
def test_certificate_failures_rescore_on_k5_where_the_batch_was_staged(
        route, monkeypatch):
    """A device route rescores the rows its certificate fails with K5's
    wrapper on the rows already staged (its plain version here), so they
    carry the dense route's labels bit for bit; a host route on the CPU
    rescores them in NumPy, as the reference does."""
    c, x = _separated(1024, 48, 600, seed=13)
    x = np.concatenate([x, _far(90, 48, 14)])
    gen = Generation(c, 1)
    calls = []
    real = A.tiled_argmin_cuda

    def spy(x_t, neg2c, csq, *, k_tile, raw_scores=False, **kw):
        calls.append(x_t.clone())
        return real(x_t, neg2c, csq, k_tile=k_tile, raw_scores=raw_scores,
                    **kw)

    monkeypatch.setattr(A, "tiled_argmin_cuda", spy)
    eng = _engine(gen, **ROUTES[route])
    try:
        got, _ = eng.submit(x)
        st = eng.stats()
    finally:
        eng.stop()
    _check_labels(x, c, got, A.assign_direct(gen, x))
    if route.endswith("host"):
        assert calls == []
        return
    bad = st["quant_rescore_rows"] if "quant" in route else st[
        "fallback_rows"]
    assert bad > 0 and len(calls) == 1 and calls[0].shape == (bad, 48)
    # The rescored rows are the batch's own, and their labels are K5's.
    rows = np.flatnonzero((x[:, None, :] == calls[0].numpy()[None]
                           ).all(axis=2).any(axis=1))
    assert rows.size == bad
    neg2c, csq, k_tile = A.PreparedModel(gen, device=CPU).dense_dev()
    want = real(torch.from_numpy(x[rows]), neg2c, csq, k_tile=k_tile,
                raw_scores=True)[0].numpy()
    np.testing.assert_array_equal(got[rows], want)


def test_refused_column_range_fails_the_batch(monkeypatch):
    """A shape K5 refuses fails the batch's requests with the error;
    nothing gives way to another route."""
    monkeypatch.setattr(A, "dense_k_tile", lambda k, d: 100)
    eng = _engine(Generation(np.eye(4, dtype=np.float32), 1),
                  assign_prune_min_k=0)
    try:
        with pytest.raises(ValueError, match="multiple of 128"):
            eng.submit(np.ones((3, 4), np.float32))
        assert eng.stats()["batches"] == 0
    finally:
        eng.stop()


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = Generation(np.eye(3, dtype=np.float32), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.AssignEngine(lambda: gen, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.PreparedModel(gen)
    eng = A.AssignEngine(lambda: gen, ServeConfig(), device=CPU)
    try:
        assert eng._pruned_route() == "host"
        labels, _ = eng.submit(np.eye(3, dtype=np.float32))
        np.testing.assert_array_equal(labels, [0, 1, 2])
    finally:
        eng.stop()


def test_pruned_route_resolution():
    gen = Generation(np.eye(3, dtype=np.float32), 1)
    for backend, want in (("auto", "host"), ("quant", "host"),
                          ("host", "host"), ("device", "device")):
        eng = A.AssignEngine(lambda: gen, _cfg(
            assign_pruned_backend=backend), device=CPU)
        assert eng._pruned_route() == want
    # The device route's candidate chunk keeps the gather within 2**24
    # elements: 2 of 96 candidates at an imagenet batch, all at a small one.
    assert A.pruned_m_tile(3072, 2048, 96) == 2
    assert A.pruned_m_tile(8192, 2048, 768) == 1
    assert A.pruned_m_tile(64, 32, 96) == 96
    # On a CUDA device "auto" is the device route (no card needed to
    # resolve it: the route reads the engine's device).
    eng.device = torch.device("cuda")
    eng.cfg = _cfg()
    assert eng._pruned_route() == "device"


def test_read_only_wire_points_stage_without_a_copy_warning():
    c, x = _separated(300, 8, 50, seed=1)
    frame = A.encode_points(x)
    pts, _ = A.decode_points(frame)
    assert not pts.flags.writeable
    eng = _engine(Generation(c, 1))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = eng._stage(pts)
        assert t.dtype == torch.float32 and t.shape == pts.shape
        got, _ = eng.submit(pts)
        _check_labels(x, c, got, A.assign_direct(Generation(c, 1), x))
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# Engine behaviour (the reference's batch tests that need no HTTP server)
# ---------------------------------------------------------------------------

def _slow_kernel(engine, delay):
    """Hold the dispatcher in the kernel so that followers pile up."""
    orig = engine._run_kernel

    def slow(kind, prep, x, rows, **kw):
        time.sleep(delay)
        return orig(kind, prep, x, rows, **kw)

    engine._run_kernel = slow
    return engine


def test_concurrent_requests_coalesce_into_fewer_batches():
    gen = Generation(np.array([[0.0, 0.0], [10.0, 10.0]], np.float32), 1)
    eng = _slow_kernel(_engine(gen), 0.05)
    try:
        results = []
        lock = threading.Lock()

        def go(i):
            labels, g = eng.submit(
                np.full((4, 2), float(i % 11), np.float32))
            with lock:
                results.append((i, labels, g.generation))

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        _join(threads)
        assert len(results) == 12
        for i, labels, g in results:
            assert g == 1
            np.testing.assert_array_equal(labels, [int(i % 11 > 5)] * 4)
        st = eng.stats()
        assert st["requests"] == 12 and st["batches"] <= 4, st
    finally:
        eng.stop()


def test_lone_request_dispatches_immediately_despite_large_delay_cap():
    gen = Generation(np.zeros((2, 2), np.float32), 1)
    eng = _engine(gen, assign_max_delay_s=0.5)
    try:
        eng.submit(np.ones((1, 2), np.float32))      # threads started
        time.sleep(0.05)
        t0 = time.perf_counter()
        eng.submit(np.ones((1, 2), np.float32))
        assert time.perf_counter() - t0 < 0.25
    finally:
        eng.stop()


def test_queue_delay_bounded_under_slow_batches():
    gen = Generation(np.zeros((2, 2), np.float32), 1)
    kernel_s, delay_s = 0.15, 0.02
    eng = _slow_kernel(_engine(gen, assign_max_delay_s=delay_s), kernel_s)
    try:
        durations = []
        lock = threading.Lock()

        def go():
            t0 = time.perf_counter()
            eng.submit(np.ones((2, 2), np.float32))
            with lock:
                durations.append(time.perf_counter() - t0)

        threads = [threading.Thread(target=go) for _ in range(8)]
        for t in threads:
            t.start()
            time.sleep(0.01)         # a steady trickle, not one burst
        _join(threads)
        assert len(durations) == 8
        assert max(durations) < 2 * kernel_s + delay_s + 0.2
    finally:
        eng.stop()


def test_queue_full_backpressure():
    gen = Generation(np.zeros((2, 2), np.float32), 1)
    eng = _slow_kernel(_engine(gen, assign_pending_limit=2), 0.5)
    try:
        threads = [threading.Thread(
            target=lambda: eng.submit(np.ones((1, 2), np.float32)))
            for _ in range(3)]
        threads[0].start()
        time.sleep(0.15)   # the dispatcher is in the kernel with request 1
        for t in threads[1:]:
            t.start()      # these two fill the queue to its cap
        time.sleep(0.15)
        with pytest.raises(A.QueueFullError):
            eng.submit(np.ones((1, 2), np.float32))
        _join(threads)
    finally:
        eng.stop()


def test_no_model_and_stopped_engine_are_retryable_errors():
    eng = _engine(lambda: None)
    try:
        with pytest.raises(A.NoModelError, match="no model"):
            eng.submit(np.ones((1, 2), np.float32))
        with pytest.raises(ValueError, match=r"\(n, d\)"):
            eng.submit(np.ones(2, np.float32))
    finally:
        eng.stop()
    assert eng.closed
    with pytest.raises(A.NoModelError, match="stopped"):
        eng.submit(np.ones((1, 2), np.float32))


def test_d_changed_mid_flight_fails_only_those_requests():
    reg = ModelRegistry()
    reg.publish(np.zeros((2, 3), np.float32))
    eng = _slow_kernel(_engine(reg.current), 0.2)
    try:
        out = {}

        def go(name, d):
            try:
                out[name] = eng.submit(np.ones((2, d), np.float32))[1]
            except A.NoModelError as e:
                out[name] = e

        first = threading.Thread(target=go, args=("first", 3))
        first.start()
        time.sleep(0.05)            # the first batch holds generation 1
        reg.publish(np.zeros((2, 5), np.float32))
        late = [threading.Thread(target=go, args=(name, d))
                for name, d in (("old d", 3), ("new d", 5))]
        for t in late:
            t.start()
        _join([first, *late])
        assert out["first"].generation == 1
        assert isinstance(out["old d"], A.NoModelError)
        assert "changed mid-flight" in str(out["old d"])
        assert out["new d"].generation == 2
    finally:
        eng.stop()


def test_prepared_model_caches_per_generation():
    reg = ModelRegistry()
    reg.publish(_separated(300, 8, 1, seed=0)[0])
    eng = _engine(reg.current, assign_pruned_backend="device")
    try:
        eng.submit(np.ones((3, 8), np.float32))
        prep1 = next(iter(eng._prep.values()))
        assert prep1.pruned and prep1.csq.shape == (300,)
        assert prep1.device == torch.device(CPU)
        tensors = prep1.pruned_dev()
        eng.submit(np.ones((3, 8), np.float32))
        assert next(iter(eng._prep.values())) is prep1     # reused
        assert prep1.pruned_dev() is tensors
        for g in range(2, 7):
            reg.publish(_separated(300, 8, 1, seed=g)[0])
            eng.submit(np.ones((3, 8), np.float32))
        assert list(eng._prep) == [3, 4, 5, 6]             # 4 kept
    finally:
        eng.stop()


@pytest.mark.parametrize("route", ["dense", "pruned device"])
def test_hot_swap_hammer_every_response_self_consistent(route):
    """Clients hammer the engine while the registry swaps 40 times: zero
    drops, and every response's labels were computed against the
    generation it reports.  Generation g serves centroids [(-1)^g],
    [-(-1)^g], so the right label for the point [0.6] follows from the
    generation number alone."""
    def cents(g):
        sign = 1.0 if g % 2 == 0 else -1.0
        return np.array([[sign], [-sign]], np.float32)

    reg = ModelRegistry()
    reg.publish(cents(1), generation=1)
    eng = _engine(reg.current, **{**ROUTES[route], "assign_prune_min_k": 0
                                  if route == "dense" else 2})
    stop = threading.Event()
    bad, counts, seen = [], [0], set()
    lock = threading.Lock()

    def hammer():
        while not stop.is_set():
            try:
                labels, gen = eng.submit(np.full((3, 1), 0.6, np.float32))
            except Exception as e:      # a drop: recorded, then fails
                with lock:
                    bad.append(repr(e))
                continue
            with lock:
                counts[0] += 1
                seen.add(gen.generation)
                want = 0 if gen.generation % 2 == 0 else 1
                if list(labels) != [want] * 3:
                    bad.append(("inconsistent", gen.generation, labels))

    threads = [threading.Thread(target=hammer) for _ in range(6)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for g in range(2, 42):
            reg.publish(cents(g), generation=g)
            time.sleep(0.004)
        time.sleep(0.05)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        _join(threads)
        eng.stop()
    assert counts[0] > 20 and len(seen) > 5
    assert not bad, bad[:5]


# ---------------------------------------------------------------------------
# Registry, conversion, and the kernels' entry under threads
# ---------------------------------------------------------------------------

def test_registry_publish_swap_and_refusals(tmp_path):
    reg = ModelRegistry()
    assert reg.current() is None and reg.generation == 0
    c = np.arange(6, dtype=np.float64).reshape(3, 2)
    g1 = reg.publish(c, meta={"a": 1, "skip": [1]})
    c[0, 0] = 99.0                        # the generation holds a copy
    assert reg.current() is g1 and g1.generation == 1
    assert g1.centroids.dtype == np.float32 and g1.centroids[0, 0] == 0.0
    sq = g1.sq_norms()
    assert sq is g1.sq_norms()
    np.testing.assert_array_equal(sq, [1.0, 13.0, 41.0])
    assert g1.describe()["meta"] == {"a": 1} and g1.describe()["k"] == 3
    assert reg.publish(c, generation=1) is not reg.current()  # a reload
    with pytest.raises(ValueError, match="does not advance"):
        reg.publish(c, generation=0)
    waiter = threading.Thread(target=reg.wait_for, args=(3, WAIT_S))
    waiter.start()
    reg.publish(c)
    reg.publish(c)
    _join([waiter])
    assert reg.wait_for(3, timeout=0.0) and reg.generation == 3
    with pytest.raises(ValueError, match=r"\(k, d\)"):
        Generation(np.zeros(3), 1)
    # A registry with a path persists before it swaps: a fresh registry
    # over the directory restores the generation, and a fresh registry that
    # would publish under it is refused.
    path = str(tmp_path / "models")
    ModelRegistry(path).publish(c, generation=4)
    back, arrays, _ = ModelRegistry(path).load_latest()
    assert back.generation == 4
    np.testing.assert_array_equal(arrays["centroids"], c.astype(np.float32))
    with pytest.raises(ValueError, match="already holds generation 4"):
        ModelRegistry(path).publish(c)


def test_generation_and_fit_state_carry_across():
    ref = RefGeneration(np.eye(3), 5, trigger="drift", meta={"w": 2},
                        created_ts=123.5)
    gen = generation_from_numpy(ref)
    assert isinstance(gen, Generation)
    assert gen.describe() == ref.describe()
    np.testing.assert_array_equal(gen.centroids, ref.centroids)
    np.testing.assert_array_equal(gen.sq_norms(), ref.sq_norms())
    gen2 = generation_from_numpy({"centroids": np.ones((2, 2)),
                                  "generation": 9})
    assert (gen2.generation, gen2.trigger, gen2.meta) == (9, "publish", {})
    c, x = _separated(12, 4, 200, seed=3)
    km = KMeans(n_clusters=12, init=c, max_iter=5, device=CPU).fit(x)
    reg = ModelRegistry()
    g = publish_state(reg, km.state, trigger="fit")
    np.testing.assert_array_equal(g.centroids, km.cluster_centers_.numpy())
    assert reg.current() is g and g.trigger == "fit"
    g = publish_state(reg, km)
    assert g.generation == 2
    g = publish_state(reg, {"centroids": jnp.asarray(c)})
    np.testing.assert_array_equal(g.centroids, c)


def test_library_builds_once_under_concurrent_first_calls(monkeypatch):
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return {"path": "libfake.so"}

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    _build._load.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(
            _build.library())) for _ in range(8)]
        for t in threads:
            t.start()
        _join(threads)
        assert len(calls) == 1 and len(libs) == 8
        assert all(lib is libs[0] for lib in libs)
    finally:
        _build._load.cache_clear()


def test_launch_counts_lose_no_update_under_threads():
    workers, each = 16, 5000
    old = sys.getswitchinterval()
    K.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        def go():
            for _ in range(each):
                K._count(K.tiled_argmin_cuda)

        threads = [threading.Thread(target=go) for _ in range(workers)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert K.launch_counts()["tiled_argmin_cuda"] == workers * each
    finally:
        K.reset_launch_counts()
