"""The port's step-paced runner, state checkpoints and preemption guard
against the JAX package's, on the CPU.

Two kinds of test.  The behaviour tests are the reference's own
(``tests/test_runner_checkpoint.py``, ``test_update_auto.py``,
``test_yinyang.py``, ``test_hamerly.py``, ``test_anderson.py``,
``test_faults.py``, ``test_obs.py``), each body run once per package
(``pkg``: the reference's ``LloydRunner`` and checkpoint layer, or the
port's with ``device="cpu"``), on numpy data.  The parity tests run both
runners on identical inputs from one explicit ``init=`` array and hold the
port to the reference: the same iteration count and ``IterInfo`` stream
(iterations and convergence flags equal), per-iteration inertia within
``INERTIA_RTOL`` and shift² within ``SHIFT_ATOL`` + ``SHIFT_RTOL`` (both
packages sum the same f32 products, in another order), and labels equal
(the blobs are well separated, so no row sits on a tie).  A checkpoint
written by either package's runner resumes in the other to the same
centroids.  The reference writes orbax where it can import it, so every
checkpointing test hides ``orbax.checkpoint`` (its npz branch, the port's
format).
"""

import io
import json
import os
import shutil
import signal
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu.models as ref_models
from kmeans_tpu import obs as ref_obs
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import runner as ref_runner
from kmeans_tpu.models.accelerated import ACCEL_STEPS as REF_ACCEL_STEPS
from kmeans_tpu.utils import checkpoint as ref_ckpt
from kmeans_tpu.utils import preempt as ref_preempt
import kmeans_tpu_torch.models as port_models
from kmeans_tpu_torch import obs as port_obs
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.models import runner as port_runner
from kmeans_tpu_torch.models.accelerated import ACCEL_STEPS
from kmeans_tpu_torch.utils import checkpoint as port_ckpt
from kmeans_tpu_torch.utils import preempt as port_preempt

CPU = "cpu"
#: Per-iteration inertia: f32 sums of the same terms in another order.
INERTIA_RTOL = 1e-5
#: Per-iteration shift²: an absolute floor for the converged iterations
#: (shift² near 0 carries the f32 rounding of centroids of norm ≈ 10) and
#: a relative part for the early ones.
SHIFT_ATOL = 1e-4
SHIFT_RTOL = 1e-4
#: Final centroids of two runs of one package that took different paths
#: (resumed and uninterrupted), the reference's own tolerance.
CENTROID_TOL = 1e-5


def _blobs(seed, n, d, k, std=0.4, box=10.0):
    """Gaussian blobs (float32) made with numpy, centres uniform in
    [-box, box] as the packages' ``make_blobs`` draws them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-box, box, size=(k, d))
    lab = rng.integers(0, k, size=n)
    return (centers[lab] + std * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    return _blobs(0, 2000, 8, 4)


@pytest.fixture()
def npz_format(monkeypatch):
    """Hide orbax, so the reference writes and reads npz bundles."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _ns(side):
    """One package's surface: its runner (the port's on the CPU), its
    fused fit, config, checkpoint layer, preemption guard and obs."""
    if side == "ref":
        def runner(x, k, *, seed=None, **kw):
            if seed is not None:
                kw["key"] = jax.random.key(seed)
            return ref_models.LloydRunner(x, k, **kw)

        def fit(x, k, *, seed=None, **kw):
            if seed is not None:
                kw["key"] = jax.random.key(seed)
            return ref_models.fit_lloyd(jnp.asarray(x), k, **kw)

        return types.SimpleNamespace(
            side=side, Runner=runner, fit=fit, Config=RefConfig,
            ckpt=ref_ckpt, preempt=ref_preempt, obs=ref_obs,
            runner_mod=ref_runner, accel_steps=REF_ACCEL_STEPS,
            backend="xla")

    def runner(x, k, *, seed=None, **kw):
        if seed is not None:
            kw["generator"] = torch.Generator().manual_seed(seed)
        return port_models.LloydRunner(x, k, device=CPU, **kw)

    def fit(x, k, *, seed=None, **kw):
        if seed is not None:
            kw["generator"] = torch.Generator().manual_seed(seed)
        return port_models.fit_lloyd(x, k, device=CPU, **kw)

    return types.SimpleNamespace(
        side=side, Runner=runner, fit=fit, Config=KMeansConfig,
        ckpt=port_ckpt, preempt=port_preempt, obs=port_obs,
        runner_mod=port_runner, accel_steps=ACCEL_STEPS, backend="auto")


@pytest.fixture(params=["ref", "port"])
def pkg(request, npz_format):
    return _ns(request.param)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# tests/test_runner_checkpoint.py, once per package
# ---------------------------------------------------------------------------

def test_runner_matches_fused_fit(pkg, blobs):
    c0 = blobs[:4]
    runner = pkg.Runner(blobs, 4)
    runner.init(c0)
    state = runner.run(max_iter=20, tol=1e-10)
    want = pkg.fit(blobs, 4, init=c0, max_iter=20, tol=1e-10)
    np.testing.assert_allclose(_np(state.centroids), _np(want.centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(state.labels), _np(want.labels))
    assert int(state.n_iter) == int(want.n_iter)
    assert bool(state.converged) == bool(want.converged)


def test_runner_callback_stream(pkg, blobs):
    runner = pkg.Runner(blobs, 4)
    runner.init(blobs[:4])
    infos = []
    runner.run(max_iter=10, tol=1e-10, callback=infos.append)
    assert len(infos) >= 2
    assert [i.iteration for i in infos] == list(range(1, len(infos) + 1))
    vals = [i.inertia for i in infos]
    assert all(b <= a + 1e-3 for a, b in zip(vals, vals[1:]))
    assert infos[-1].converged
    assert all(i.seconds > 0 for i in infos)


def test_runner_checkpoint_resume(pkg, tmp_path, blobs):
    path = str(tmp_path / "ckpt")
    r1 = pkg.Runner(blobs, 4, config=pkg.Config(k=4, seed=7))
    r1.init(blobs[:4])
    r1.run(max_iter=3, tol=0.0, checkpoint_path=path, checkpoint_every=1)
    assert pkg.ckpt.latest_step(path) == 3

    r2 = pkg.Runner(blobs, 4, config=pkg.Config(k=4, seed=7))
    assert r2.resume(path) == 3
    np.testing.assert_allclose(_np(r2.centroids), _np(r1.centroids),
                               rtol=1e-6)
    s2 = r2.run(max_iter=30, tol=1e-10)
    full = pkg.Runner(blobs, 4)
    full.init(blobs[:4])
    sf = full.run(max_iter=33, tol=1e-10)
    np.testing.assert_allclose(_np(s2.centroids), _np(sf.centroids),
                               rtol=CENTROID_TOL, atol=CENTROID_TOL)


def test_runner_checkpoint_every_zero_rejected_cleanly(pkg, tmp_path, blobs):
    r = pkg.Runner(blobs, 4, config=pkg.Config(k=4, seed=7))
    r.init(blobs[:4])
    with pytest.raises(ValueError, match="checkpoint_every"):
        r.run(max_iter=5, checkpoint_path=str(tmp_path / "ckpt"),
              checkpoint_every=0)


def test_checkpoint_round_trip_state(pkg, tmp_path, blobs):
    state = pkg.fit(blobs, 4, seed=1)
    path = str(tmp_path / "ck")
    key = (jax.random.key(1) if pkg.side == "ref"
           else port_runner.seed_key_data(1))
    pkg.ckpt.save_checkpoint(path, state, step=int(state.n_iter),
                             config=pkg.Config(k=4), key=key)
    restored, meta = pkg.ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(_np(restored.centroids),
                                  _np(state.centroids))
    np.testing.assert_array_equal(_np(restored.labels), _np(state.labels))
    assert meta["config_obj"].k == 4
    # The key round-trips as the reference's key data for seed 1.
    np.testing.assert_array_equal(
        np.asarray(meta["key_data"]),
        np.asarray(jax.random.key_data(jax.random.key(1))))


def test_load_falls_back_to_old_after_crashed_swap(pkg, blobs, tmp_path):
    state = pkg.fit(blobs, 4, seed=1)
    path = str(tmp_path / "ck")
    pkg.ckpt.save_checkpoint(path, state, step=7, config=pkg.Config(k=4))
    os.rename(path, path + ".old")
    assert pkg.ckpt.latest_step(path) == 7
    restored, meta = pkg.ckpt.load_checkpoint(path)
    assert meta["step"] == 7
    np.testing.assert_array_equal(_np(restored.centroids),
                                  _np(state.centroids))


def test_corrupt_final_dir_falls_back_to_old_state_level(pkg, tmp_path,
                                                         blobs):
    state = pkg.fit(blobs, 4, seed=1)
    path = str(tmp_path / "ck")
    pkg.ckpt.save_checkpoint(path, state, step=7, config=pkg.Config(k=4))
    shutil.copytree(path, path + ".old")
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.write(b"\xff\xff\xff\xff")
    restored, meta = pkg.ckpt.load_checkpoint(path)
    assert meta["step"] == 7
    np.testing.assert_array_equal(_np(restored.centroids),
                                  _np(state.centroids))


def test_load_checkpoint_refuses_another_kind_of_bundle(pkg, tmp_path):
    """A verified bundle that is not a runner checkpoint is refused in the
    reference's words, naming the engine that saved it."""
    path = str(tmp_path / "ck")
    pkg.ckpt.save_array_checkpoint(
        path, {"centroids": np.zeros((2, 3), np.float32)}, step=4,
        extra={"engine": "fit_lloyd_sharded"})
    with pytest.raises(ValueError) as ei:
        pkg.ckpt.load_checkpoint(path)
    assert str(ei.value) == (
        f"checkpoint at {path!r} is not a step-paced runner checkpoint "
        "(missing labels, inertia, n_iter, converged, counts); it was "
        "saved by fit_lloyd_sharded")


def test_resolve_resume_params_adopts_checkpoint_values(pkg):
    r = pkg.ckpt.resolve_resume_params({"host_seed": 11, "batch_size": 256}, [
        ("seed", "host_seed", None, 0),
        ("batch_size", "batch_size", None, 1024),
    ])
    assert r == {"seed": 11, "batch_size": 256}


def test_resolve_resume_params_refuses_contradiction(pkg):
    ck = {"host_seed": 11}
    with pytest.raises(ValueError, match="contradicts"):
        pkg.ckpt.resolve_resume_params(ck, [("seed", "host_seed", 12, 0)])
    r = pkg.ckpt.resolve_resume_params(ck, [("seed", "host_seed", 11, 0)])
    assert r == {"seed": 11}


def test_resolve_resume_params_defaults_for_old_checkpoints(pkg):
    r = pkg.ckpt.resolve_resume_params({}, [
        ("seed", "host_seed", None, 0),
        ("batch_size", "batch_size", 128, 1024),
    ])
    assert r == {"seed": 0, "batch_size": 128}
    r = pkg.ckpt.resolve_resume_params({"kappa": "0.5"},
                                       [("kappa", "kappa", None, 1.0)])
    assert r == {"kappa": 0.5}


def test_periodic_saver_cadence_and_dedup(pkg):
    saves = []
    saver = pkg.ckpt.PeriodicSaver("ck", 3)
    for step in range(1, 8):
        saver.maybe(step, lambda: saves.append(step))
    saver.maybe(6, lambda: saves.append("dup"), force=True)
    saver.maybe(7, lambda: saves.append("forced"), force=True)
    assert saves == [3, 6, "forced"]
    none = pkg.ckpt.PeriodicSaver(None, 1)
    none.maybe(1, lambda: saves.append("no path"), force=True)
    assert saves[-1] == "forced"


# ---------------------------------------------------------------------------
# The update flavours (test_update_auto.py, test_yinyang.py,
# test_hamerly.py), once per package
# ---------------------------------------------------------------------------

def test_runner_default_runs_delta_and_matches_fit(pkg):
    x = _blobs(3, 2000, 8, 6)
    r = pkg.Runner(x, 6, seed=4)
    assert r._update == "delta"
    st = r.run(tol=1e-10, max_iter=30)
    want = pkg.fit(x, 6, seed=4, tol=1e-10, max_iter=30)
    np.testing.assert_array_equal(_np(st.labels), _np(want.labels))
    np.testing.assert_allclose(_np(st.centroids), _np(want.centroids),
                               rtol=1e-5, atol=1e-5)


def test_runner_delta_checkpoint_resume_parity(pkg, tmp_path):
    """Stop the runner mid-delta-stream; the resumed runner's first sweep
    is a refresh (carried state is process-local) and the final partition
    matches an uninterrupted run."""
    x = _blobs(3, 2000, 8, 6)
    ck = str(tmp_path / "ck")
    r1 = pkg.Runner(x, 6, seed=9)
    r1.init()
    full = r1.run(tol=1e-12, max_iter=30)
    r2 = pkg.Runner(x, 6, seed=9)
    r2.init()
    r2.run(tol=0.0, max_iter=7, checkpoint_path=ck, checkpoint_every=2)
    r3 = pkg.Runner(x, 6, seed=9)
    step = r3.resume(ck)
    assert step == r2.iteration and step >= 2 and r3._dstate is None
    resumed = r3.run(tol=1e-12, max_iter=30)
    np.testing.assert_array_equal(_np(resumed.labels), _np(full.labels))


@pytest.mark.parametrize("update", ["yinyang", "hamerly"])
def test_runner_bound_update_matches_fused_fit(pkg, update):
    """The bound-carrying runner reproduces the fused fit (same init, same
    sweeps) label-exactly (test_yinyang.py::test_runner_matches_fused_fit
    and its Hamerly twin)."""
    x = _blobs(5, 2000, 32, 8)
    cfg = pkg.Config(k=8, update=update, tol=1e-10, max_iter=25,
                     backend=pkg.backend)
    r = pkg.Runner(x, 8, seed=7, config=cfg)
    got = r.run()
    want = pkg.fit(x, 8, seed=7, config=cfg)
    np.testing.assert_array_equal(_np(got.labels), _np(want.labels))
    np.testing.assert_allclose(_np(got.centroids), _np(want.centroids),
                               rtol=1e-5, atol=1e-5)


def test_runner_bound_guards(pkg, blobs):
    with pytest.raises(ValueError, match="farthest"):
        pkg.Runner(blobs, 5, config=pkg.Config(k=5, update="hamerly",
                                               empty="farthest"))
    with pytest.raises(ValueError, match="accel"):
        pkg.Runner(blobs, 5, accel="anderson",
                   config=pkg.Config(k=5, update="hamerly"))


# ---------------------------------------------------------------------------
# Anderson (test_anderson.py), once per package
# ---------------------------------------------------------------------------

def _outcomes(pkg):
    return {o: pkg.accel_steps.value(outcome=o)
            for o in ("accepted", "rejected", "fallback")}


def test_runner_anderson_stamps_outcomes_and_matches_quality(pkg):
    x = _blobs(9, 4000, 12, 6, std=2.0)
    cfg = pkg.Config(k=6, max_iter=80, tol=1e-4)
    c0 = x[np.random.default_rng(1).integers(0, 4000, 6)]
    plain = pkg.Runner(x, 6, config=cfg)
    plain.init(c0)
    st_plain = plain.run()

    before = _outcomes(pkg)
    runner = pkg.Runner(x, 6, config=cfg, accel="anderson")
    runner.init(c0)
    buf = io.StringIO()
    st = runner.run(telemetry=pkg.obs.TelemetryWriter(buf))
    after = _outcomes(pkg)
    delta = {o: after[o] - before[o] for o in after}

    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    iters = [e for e in events if e["event"] == "iter"]
    assert len(iters) == int(st.n_iter)
    assert all(e["accel"] in ("accepted", "rejected", "fallback")
               for e in iters)
    assert sum(delta.values()) == len(iters)
    assert float(st.inertia) <= float(st_plain.inertia) * 1.01

    buf2 = io.StringIO()
    p2 = pkg.Runner(x, 6, config=cfg)
    p2.init(c0)
    p2.run(telemetry=pkg.obs.TelemetryWriter(buf2))
    assert all("accel" not in json.loads(line)
               for line in buf2.getvalue().splitlines()
               if '"iter"' in line)


def test_runner_rejects_bad_accel_combos(pkg):
    x = np.random.default_rng(0).normal(size=(200, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="anderson"):
        pkg.Runner(x, 3, config=pkg.Config(k=3), accel="beta")
    with pytest.raises(ValueError, match="farthest"):
        pkg.Runner(x, 3, config=pkg.Config(k=3, empty="farthest"),
                   accel="anderson")


# ---------------------------------------------------------------------------
# Preemption (test_faults.py), once per package
# ---------------------------------------------------------------------------

def test_preemption_guard_latches_and_restores(pkg):
    prev = signal.getsignal(signal.SIGTERM)
    with pkg.preempt.PreemptionGuard() as g:
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not g.triggered and time.monotonic() < deadline:
            time.sleep(0.005)   # the handler runs at the next bytecode check
        assert g.triggered
    assert signal.getsignal(signal.SIGTERM) is prev


def test_runner_preempted_cuts_checkpoint_and_resumes(pkg, blobs, tmp_path):
    path = str(tmp_path / "ck")

    def send_sigterm(info):
        if info.iteration == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    r1 = pkg.Runner(blobs, 4, config=pkg.Config(k=4, seed=7))
    r1.init(blobs[:4])
    with pytest.raises(pkg.preempt.Preempted) as ei:
        r1.run(max_iter=50, tol=0.0, checkpoint_path=path,
               checkpoint_every=10 ** 6, callback=send_sigterm)
    assert ei.value.step == 2
    assert ei.value.resume_hint == f"--resume {path}"
    assert pkg.ckpt.latest_step(path) == 2

    r2 = pkg.Runner(blobs, 4, config=pkg.Config(k=4, seed=7))
    assert r2.resume(path) == 2
    np.testing.assert_array_equal(_np(r2.centroids), _np(r1.centroids))
    state = r2.run(max_iter=50, tol=1e-10)
    assert bool(state.converged)


def test_runner_preempted_on_last_iteration_exits_resumable(pkg, blobs,
                                                            tmp_path):
    path = str(tmp_path / "ck")

    def send_sigterm(info):
        if info.iteration == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    r = pkg.Runner(blobs, 4, config=pkg.Config(k=4, seed=7))
    r.init(blobs[:4])
    with pytest.raises(pkg.preempt.Preempted) as ei:
        r.run(max_iter=3, tol=0.0, checkpoint_path=path,
              checkpoint_every=10 ** 6, callback=send_sigterm)
    assert ei.value.step == 3
    assert pkg.ckpt.latest_step(path) == 3


def test_runner_signal_on_converged_run_without_checkpoint_returns(pkg,
                                                                  blobs):
    def send_sigterm(info):
        if info.converged:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.01)   # let the latching handler run

    r = pkg.Runner(blobs, 4, config=pkg.Config(k=4, seed=7))
    r.init(blobs[:4])
    state = r.run(max_iter=100, tol=1e-8, callback=send_sigterm)
    assert bool(state.converged)


# ---------------------------------------------------------------------------
# Telemetry and metrics (test_obs.py), once per package
# ---------------------------------------------------------------------------

def test_runner_telemetry_events(pkg, tmp_path):
    x = np.random.default_rng(1).normal(size=(300, 2)).astype(np.float32)
    path = str(tmp_path / "run.jsonl")
    r = pkg.Runner(x, 3, seed=0)
    r.init()
    state = r.run(max_iter=12, telemetry=path)
    events = pkg.obs.read_events(path)
    assert events[0]["event"] == "run_start"
    assert events[-1]["event"] == "run_done"
    iters = [e for e in events if e["event"] == "iter"]
    assert len(iters) == int(state.n_iter)
    phases = [e["phase"] for e in iters]
    assert phases[0] == "compile+step"
    assert all(p == "step" for p in phases[2:])
    for e in iters:
        assert {"iteration", "inertia", "shift_sq", "seconds", "converged",
                "model", "device"} <= set(e)
    assert [e["iteration"] for e in iters] == \
        list(range(1, len(iters) + 1))
    assert events[-1]["converged"] == bool(state.converged)
    assert iters[0]["device"] == "cpu"


def test_runner_hot_loop_unobserved_when_disabled(pkg):
    x = np.random.default_rng(0).normal(size=(200, 2)).astype(np.float32)
    sec, tot = pkg.runner_mod.ITER_SECONDS, pkg.runner_mod.ITERS_TOTAL
    before = sec.snapshot(model="lloyd")[0]
    before_n = tot.value(model="lloyd")
    pkg.obs.disable()
    try:
        r = pkg.Runner(x, 3, seed=0)
        r.init()
        r.run(max_iter=5)
    finally:
        pkg.obs.enable()
    assert sec.snapshot(model="lloyd")[0] == before
    assert tot.value(model="lloyd") == before_n
    r2 = pkg.Runner(x, 3, seed=1)
    r2.init()
    state = r2.run(max_iter=5)
    assert sec.snapshot(model="lloyd")[0] - before == int(state.n_iter)
    assert tot.value(model="lloyd") - before_n == int(state.n_iter)


def test_runner_mesh_names_the_sharded_engine(blobs):
    """On a mesh the runner steps the dense reduction; the incremental
    updates are the sharded engine's (``fit_lloyd_sharded``), refused
    with the reference's line before the mesh is touched."""
    for update in ("delta", "hamerly", "yinyang"):
        with pytest.raises(ValueError, match="fit_lloyd_sharded"):
            port_models.LloydRunner(
                blobs, 4, config=KMeansConfig(k=4, update=update),
                mesh=object(), device=CPU)


def test_runner_raises_without_a_card(blobs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_models.LloydRunner(blobs, 4)


# ---------------------------------------------------------------------------
# The port against the reference on identical inputs
# ---------------------------------------------------------------------------

def _both_runs(x, k, c0, *, max_iter, tol, accel=None, **cfg):
    """``[(state, infos, telemetry iter events)]`` for the reference and
    the port, each runner from ``c0``."""
    out = []
    for side in ("ref", "port"):
        ns = _ns(side)
        r = ns.Runner(x, k, config=ns.Config(k=k, **cfg), accel=accel)
        r.init(c0)
        infos, buf = [], io.StringIO()
        st = r.run(max_iter=max_iter, tol=tol, callback=infos.append,
                   telemetry=ns.obs.TelemetryWriter(buf))
        events = [json.loads(line) for line in buf.getvalue().splitlines()]
        out.append((st, infos, [e for e in events if e["event"] == "iter"]))
    return out


@pytest.mark.parametrize("update,accel", [
    ("auto", None), ("matmul", None), ("hamerly", None), ("yinyang", None),
    ("delta", "anderson")])
def test_port_runner_matches_reference_runner(update, accel):
    x = _blobs(11, 2000, 16, 8, std=1.0)
    c0 = x[np.random.default_rng(2).integers(0, 2000, 8)]
    (ref, ref_infos, ref_ev), (got, infos, ev) = _both_runs(
        x, 8, c0, max_iter=40, tol=1e-6, accel=accel, update=update)
    assert len(infos) == len(ref_infos) == int(got.n_iter) \
        == int(ref.n_iter)
    assert [(i.iteration, i.converged) for i in infos] == \
        [(i.iteration, i.converged) for i in ref_infos]
    np.testing.assert_allclose([i.inertia for i in infos],
                               [i.inertia for i in ref_infos],
                               rtol=INERTIA_RTOL)
    np.testing.assert_allclose([i.shift_sq for i in infos],
                               [i.shift_sq for i in ref_infos],
                               rtol=SHIFT_RTOL, atol=SHIFT_ATOL)
    np.testing.assert_array_equal(_np(got.labels), np.asarray(ref.labels))
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=INERTIA_RTOL)
    # The telemetry streams carry the same fields, the same Anderson
    # outcomes and the same per-iteration recompute fractions.
    for mine, theirs in zip(ev, ref_ev):
        assert set(mine) == set(theirs) - {"compile_s", "compile_flops",
                                           "compile_bytes"}
        assert mine.get("accel") == theirs.get("accel")
        for key in ("recompute_fraction", "group_filter_fraction"):
            assert (key in mine) == (key in theirs)
            if key in mine:
                np.testing.assert_allclose(mine[key], theirs[key],
                                           rtol=1e-6)


def test_checkpoints_resume_across_packages(tmp_path, npz_format):
    """A checkpoint cut by either package's runner resumes in the other:
    the same step, the same centroids bit for bit, and a continued run that
    lands on the continuing package's own uninterrupted answer; both
    packages write the same arrays, dtypes and key data."""
    x = _blobs(13, 2000, 8, 6)
    c0 = x[np.random.default_rng(3).integers(0, 2000, 6)]
    sides = {"ref": _ns("ref"), "port": _ns("port")}
    arrays = {}
    for writer, reader in (("ref", "port"), ("port", "ref")):
        w, r = sides[writer], sides[reader]
        path = str(tmp_path / f"{writer}-ck")
        r1 = w.Runner(x, 6, config=w.Config(k=6, seed=5))
        r1.init(c0)
        r1.run(max_iter=4, tol=0.0, checkpoint_path=path, checkpoint_every=2)
        arrays[writer] = port_ckpt.load_array_checkpoint(path)
        r2 = r.Runner(x, 6, config=r.Config(k=6, seed=5))
        assert r2.resume(path) == 4
        np.testing.assert_array_equal(_np(r2.centroids), _np(r1.centroids))
        resumed = r2.run(max_iter=30, tol=1e-10)
        full = r.Runner(x, 6, config=r.Config(k=6, seed=5))
        full.init(c0)
        want = full.run(max_iter=34, tol=1e-10)
        np.testing.assert_array_equal(_np(resumed.labels), _np(want.labels))
        np.testing.assert_allclose(_np(resumed.centroids),
                                   _np(want.centroids),
                                   rtol=CENTROID_TOL, atol=CENTROID_TOL)
    (ra, rm), (pa, pm) = arrays["ref"], arrays["port"]
    assert sorted(ra) == sorted(pa)
    for name in ra:
        assert ra[name].dtype == pa[name].dtype and \
            ra[name].shape == pa[name].shape, name
    assert rm["empty_arrays"] == pm["empty_arrays"]
    np.testing.assert_array_equal(rm["key_data"], pm["key_data"])
    assert rm["config"] == pm["config"]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -1, 2 ** 32 - 1])
def test_key_data_is_the_references(seed):
    np.testing.assert_array_equal(
        port_runner.seed_key_data(seed),
        np.asarray(jax.random.key_data(jax.random.key(seed))))


def test_step_observer_records_and_calls_back(pkg):
    """The streamed fits' per-step bookkeeping: one histogram sample and
    one counter increment a step under the model's label, an IterInfo to
    the callback, ``wants_sync`` only with a callback."""
    mod = pkg.runner_mod
    before = mod.ITER_SECONDS.snapshot(model="minibatch_stream")[0]
    before_n = mod.ITERS_TOTAL.value(model="minibatch_stream")
    infos = []
    obs_ = mod.StepObserver("minibatch_stream", callback=infos.append)
    assert obs_.wants_sync
    assert not mod.StepObserver("minibatch_stream").wants_sync
    obs_.start()
    for step in (1, 2, 3):
        obs_.step(step, inertia=float(step), shift_sq=0.5)
        obs_.exclude()
    assert mod.ITER_SECONDS.snapshot(model="minibatch_stream")[0] \
        - before == 3
    assert mod.ITERS_TOTAL.value(model="minibatch_stream") - before_n == 3
    assert [i.as_dict()["iteration"] for i in infos] == [1, 2, 3]
    assert [(i.inertia, i.shift_sq, i.converged) for i in infos] == \
        [(1.0, 0.5, False), (2.0, 0.5, False), (3.0, 0.5, False)]
    assert all(i.seconds >= 0 for i in infos)
