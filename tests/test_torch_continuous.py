"""The port's coreset and continuous clustering against the JAX package's,
on the CPU.

torch cannot draw ``jax.random``'s indices, so every coreset draw of the
port (``coreset.draw_indices`` on a :class:`torch.Generator`) is recorded and
replayed through the reference by monkeypatching ``jax.random.choice`` in
the test (nothing of the JAX package changes): points then agree exactly
and importance weights to rtol 1e-6.  The window, the drift detectors and
the synthetic stream are held to the reference's; the pipeline resumes
from a registry the reference warmed up, in both packages, over the same
batches (the same triggers, generations and window sizes, centroids to
rtol 1e-4); ``cli continuous`` prints the reference's lines and errors and
resumes its model directory; transient faults are absorbed as the
reference absorbs them; ``cli train --coreset`` holds the reference's
guards and its draws replay through the reference.  The port runs with
``device="cpu"``: the kernels' plain versions.
"""

import functools
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu import cli as ref_cli
from kmeans_tpu import continuous as RC
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.data.coreset import lightweight_coreset as ref_coreset
from kmeans_tpu.models.streaming import fit_minibatch_stream as ref_stream_fit
from kmeans_tpu.obs import REGISTRY as REF_REGISTRY
from kmeans_tpu.utils import faults as ref_faults
from kmeans_tpu_torch import cli as port_cli
from kmeans_tpu_torch import continuous as PC
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.continuous import window as port_window
from kmeans_tpu_torch.data import coreset as coreset_module
from kmeans_tpu_torch.data.coreset import (coreset_probabilities,
                                           lightweight_coreset)
from kmeans_tpu_torch.models.lloyd import fit_lloyd
from kmeans_tpu_torch.models.streaming import fit_minibatch_stream
from kmeans_tpu_torch.obs import REGISTRY
from kmeans_tpu_torch.utils import faults, retry

CPU = "cpu"
SIDES = ("ref", "port")
#: The stream the pipeline tests share: drift at batch 8.
SRC = functools.partial(RC.drift_batch, n=192, d=4, k=3, seed=11,
                        drift_at=8, drift=8.0)
CFG = dict(k=3, warmup_batches=2, window_batches=4, compact_above=600,
           coreset_size=256, refit_iters=12, ewma_warmup=3,
           min_refit_batches=1, refit_every=5)


@pytest.fixture(autouse=True)
def npz_format(monkeypatch):
    """Hide orbax (npz checkpoints), and leave no fault plan behind."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    yield
    faults.clear()
    ref_faults.clear()


class Draws:
    """The port's coreset draws, recorded, then replayed through the
    reference's ``jax.random.choice`` (with its probabilities held to the
    port's)."""

    def __init__(self, monkeypatch):
        self.draws = []
        real = coreset_module.draw_indices

        def record(q, m, generator):
            idx = real(q, m, generator)
            self.draws.append((q.numpy().copy(), idx.numpy().copy()))
            return idx

        def replay(key, n, shape=(), replace=True, p=None):
            q, idx = self.draws.pop(0)
            assert replace and (n,) == q.shape and tuple(shape) == idx.shape
            np.testing.assert_allclose(np.asarray(p), q, rtol=1e-5,
                                       atol=1e-9)
            return jnp.asarray(idx, jnp.int32)

        monkeypatch.setattr(coreset_module, "draw_indices", record)
        monkeypatch.setattr(jax.random, "choice", replay)


# ---------------------------------------------------------------------------
# The coreset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m", [64, 900])
def test_coreset_replays_through_the_reference(monkeypatch, weighted, m):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(700, 6)).astype(np.float32) * 3
    w = rng.random(700).astype(np.float32) * 2 if weighted else None
    draws = Draws(monkeypatch)
    pts, cw = lightweight_coreset(7, x, m, weights=w, chunk_size=128,
                                  device=CPU)
    (_, idx), = draws.draws
    np.testing.assert_array_equal(pts.numpy(), x[idx])
    rp, rw = ref_coreset(jax.random.key(0), x, m, weights=w, chunk_size=128)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(rp))
    np.testing.assert_allclose(cw.numpy(), np.asarray(rw), rtol=1e-6)
    assert cw.dtype == torch.float32 and not draws.draws


def test_coreset_probabilities_and_edges():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    q = coreset_probabilities(x, torch.ones(500))
    assert abs(float(q.sum()) - 1.0) < 1e-5 and bool((q > 0).all())
    msgs = []
    for fn, key in ((ref_coreset, jax.random.key(0)), (lightweight_coreset,
                                                       0)):
        kw = {} if fn is ref_coreset else {"device": CPU}
        with pytest.raises(ValueError) as e:
            fn(key, x.numpy(), 0, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # The same generator state gives the same draws; total mass ≈ n.
    a = lightweight_coreset(5, x, 4000, device=CPU)
    b = lightweight_coreset(5, x, 4000, device=CPU)
    assert torch.equal(a[0], b[0])
    assert abs(float(a[1].sum()) - 500) / 500 < 0.1


def test_draw_indices_inverts_a_fixed_point_cdf():
    """The coreset's sampler: one seed gives one set of draws, whatever
    order the CDF is summed in; a row of probability 0 is never drawn; the
    draws' frequencies follow q."""
    q = torch.tensor([0.1, 0.0, 0.6, 0.3])
    a = coreset_module.draw_indices(q, 100_000,
                                    torch.Generator().manual_seed(3))
    b = coreset_module.draw_indices(q, 100_000,
                                    torch.Generator().manual_seed(3))
    assert a.dtype == torch.int64 and torch.equal(a, b)
    # The fixed-point CDF is exact: summed back to front it has the same
    # bits, so the draws cannot depend on the summation order.
    ticks = torch.round(q.double() * 2.0 ** 40).long()
    assert torch.equal(torch.cumsum(ticks, 0)[-1], ticks.flip(0).sum())
    freq = torch.bincount(a, minlength=4).double() / a.numel()
    assert float(freq[1]) == 0.0
    np.testing.assert_allclose(freq.numpy(), q.numpy(), atol=0.01)


# ---------------------------------------------------------------------------
# The window, the detectors and the stream
# ---------------------------------------------------------------------------

def _windows(**kw):
    cfg = dict(max_batches=4, compact_above=600, coreset_size=256,
               chunk_size=128)
    cfg.update(kw)
    return RC.SlidingWindow(**cfg), PC.SlidingWindow(device=CPU, **cfg)


def _same_window(ref, port):
    rp, rw, rs = ref.snapshot_parts()
    pp, pw, ps = port.snapshot_parts()
    np.testing.assert_array_equal(pp, rp)
    np.testing.assert_allclose(pw, rw, rtol=1e-6)
    np.testing.assert_array_equal(ps, rs)
    assert (port.n_points, port.n_batches, port.compactions) == \
        (ref.n_points, ref.n_batches, ref.compactions)


@pytest.mark.parametrize("decay", [1.0, 0.5])
def test_window_push_compact_and_restore_match(monkeypatch, decay):
    draws = Draws(monkeypatch)
    batches = [SRC(t) for t in range(11)]
    _, port = _windows(decay=decay)
    sizes = []
    for b in batches:
        port.push(b)
        sizes.append((port.n_points, port.compactions))
    ref, _ = _windows(decay=decay)
    for b, want in zip(batches, sizes):
        ref.push(b)
        assert (ref.n_points, ref.compactions) == want
    assert port.compactions >= 2 and not draws.draws
    _same_window(ref, port)
    # Either package restores the other's snapshot, entry for entry.
    r2, p2 = _windows(decay=decay)
    r2.restore(*port.snapshot_parts())
    p2.restore(*ref.snapshot_parts())
    _same_window(r2, p2)
    for w in (r2, p2):
        w.restore(*port.snapshot())
    assert r2.n_batches == p2.n_batches == 1
    with pytest.raises(ValueError, match="do not partition"):
        p2.restore(*port.snapshot(), splits=np.array([1]))


@pytest.mark.parametrize("kw", [dict(max_batches=0), dict(coreset_size=0),
                                dict(compact_above=100),
                                dict(decay=0.0)])
def test_window_refusals_equal_the_reference(kw):
    msgs = []
    for cls, extra in ((RC.SlidingWindow, {}),
                       (PC.SlidingWindow, {"device": CPU})):
        with pytest.raises(ValueError) as e:
            cls(**kw, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_window_compaction_faults_as_the_reference(monkeypatch):
    """A transient compaction failure leaves the window intact and is
    retried at the next push; past twice the cap it surfaces."""
    Draws(monkeypatch)
    sizes = {}
    for side, (w, flt) in {"port": (_windows()[1], faults),
                           "ref": (_windows()[0], ref_faults)}.items():
        seq = []
        with flt.active("continuous.compact:raise@1"):
            for t in range(6):
                w.push(SRC(t))
                seq.append((w.n_points, w.compactions))
        sizes[side] = seq
    assert sizes["ref"] == sizes["port"]
    assert sizes["port"][3] == (768, 0) and sizes["port"][4][1] == 1
    _, w = _windows(max_batches=10)
    with faults.active("continuous.compact:raise@1x99"):
        with pytest.raises(OSError):
            for t in range(10):
                w.push(SRC(t))
    assert w.n_points > 2 * w.compact_above


def test_drift_monitor_and_stream_copies_match():
    rng = np.random.default_rng(8)
    vals = list(rng.normal(10, 0.5, size=30)) + [30.0, 31.0] + \
        list(rng.normal(12, 3, size=20)) + [float("nan"), float("inf")]
    for kw in (dict(), dict(ratio=0.1, alpha=0.5, k_sigma=2.0, warmup=3)):
        mons = [RC.DriftMonitor(**kw), PC.DriftMonitor(**kw)]
        for i, v in enumerate(vals):
            assert mons[0].update(v) == mons[1].update(v)
            if i in (10, 33):
                for m in mons:
                    m.rebase(v)
            assert mons[0].state() == mons[1].state()
        fresh = PC.DriftMonitor(**kw)
        fresh.restore(mons[0].state())
        assert fresh.state() == mons[0].state()
    for cls in ("ThresholdDetector", "EWMADetector"):
        for bad in (dict(ratio=0), dict(alpha=0), dict(k_sigma=0),
                    dict(warmup=1)):
            try:
                getattr(RC, cls)(**bad)
                ok = True
            except (TypeError, ValueError) as e:
                ok = (type(e), str(e))
            try:
                getattr(PC, cls)(**bad)
                mine = True
            except (TypeError, ValueError) as e:
                mine = (type(e), str(e))
            assert ok == mine
    for t in (0, 7, 8, 30):
        for kw in (dict(), dict(d=16, k=5, drift_len=4, seed=3)):
            np.testing.assert_array_equal(PC.drift_batch(t, **kw),
                                          RC.drift_batch(t, **kw))
            np.testing.assert_array_equal(PC.true_centers(t, **kw),
                                          RC.true_centers(t, **kw))
    assert [b.sum() for b in PC.drift_stream(4, start=2)] == \
        [b.sum() for b in RC.drift_stream(4, start=2)]


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def _run(side, steps, registry, resume=False, **kw):
    infos = []
    cfg = dict(CFG)
    cfg.update(kw)
    if side == "ref":
        pipe = RC.ContinuousPipeline(SRC, RC.ContinuousConfig(**cfg),
                                     registry=registry, resume=resume)
    else:
        pipe = PC.ContinuousPipeline(SRC, PC.ContinuousConfig(**cfg),
                                     registry=registry, resume=resume,
                                     device=CPU)

    def cb(info):
        infos.append((info.batch, tuple(info.drifted), info.refit,
                      info.generation, pipe.window.n_points,
                      pipe.window.compactions, info.inertia_pp))

    gen = pipe.run(steps, callback=cb)
    return pipe, gen, infos


def _copy_registry(src, dst):
    import glob
    import os

    for path in glob.glob(src + "*"):
        shutil.copytree(path, dst + path[len(src):])
    assert os.path.isdir(dst)


def test_pipeline_resumed_from_the_references_warmup_matches(monkeypatch,
                                                             tmp_path):
    """The reference warms up (its initial k-means++ refit) and publishes;
    both packages resume from copies and consume batches 3..23: the same
    triggers, generations and window sizes, centroids to rtol 1e-4."""
    warm = str(tmp_path / "warm")
    _run("ref", 3, RC.ModelRegistry(path=warm))
    dirs = {s: str(tmp_path / s) for s in SIDES}
    for d in dirs.values():
        _copy_registry(warm, d)
    draws = Draws(monkeypatch)
    port = _run("port", 24, PC.ModelRegistry(path=dirs["port"]),
                resume=True)
    ref = _run("ref", 24, RC.ModelRegistry(path=dirs["ref"]), resume=True)
    assert not draws.draws
    assert port[0].batch_idx == ref[0].batch_idx == 24
    got = [i[:6] for i in port[2]]
    want = [i[:6] for i in ref[2]]
    assert got == want
    refits = {i[2] for i in got if i[2]}
    assert {"drift", "scheduled"} <= refits and got[-1][5] >= 2
    np.testing.assert_allclose([i[6] for i in port[2]],
                               [i[6] for i in ref[2]], rtol=1e-4)
    np.testing.assert_allclose(port[1].centroids, ref[1].centroids,
                               rtol=1e-4, atol=1e-4)
    assert port[1].generation == ref[1].generation


def test_pipeline_transient_refit_and_swap_faults_are_absorbed(monkeypatch,
                                                               tmp_path):
    """A raise at a refit's site or a publish's swap is retried: the same
    generations and centroids as the undisturbed run, in both packages."""
    Draws(monkeypatch)
    clean = _run("port", 12, PC.ModelRegistry(), compact_above=10**6)
    for spec in ("continuous.refit:raise@1", "continuous.refit:raise@2",
                 "registry.swap:raise@2"):
        seqs = []
        for side, flt, reg in (("port", faults, PC.ModelRegistry()),
                               ("ref", ref_faults, RC.ModelRegistry())):
            with flt.active(spec):
                seqs.append(_run(side, 12, reg, compact_above=10**6))
        port, ref = seqs
        assert [i[:4] for i in port[2]] == [i[:4] for i in clean[2]] == \
            [i[:4] for i in ref[2]], spec
        np.testing.assert_array_equal(port[1].centroids, clean[1].centroids)
    with faults.active("continuous.refit:raise@1x9"):
        with pytest.raises(retry.RetryError):
            _run("port", 12, PC.ModelRegistry(), compact_above=10**6)


def test_stream_read_faults_are_absorbed_as_the_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(900, 5)).astype(np.float32)
    c0 = x[:4].copy()
    kw = dict(steps=20, batch_size=64)
    a0 = retry._RETRIES_TOTAL.value(site="stream.read")
    with faults.active("stream.read:raise@2x2"):
        p = fit_minibatch_stream(x, 4, config=KMeansConfig(k=4, **kw),
                                 init=c0, device=CPU)
    with ref_faults.active("stream.read:raise@2x2"):
        r = ref_stream_fit(x, 4, config=RefConfig(k=4, **kw), init=c0)
    assert retry._RETRIES_TOTAL.value(site="stream.read") - a0 == 2
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(r.centroids),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_preemption_and_refusals(tmp_path):
    from kmeans_tpu_torch.utils.preempt import Preempted

    path = str(tmp_path / "m")
    with faults.active("continuous.refit:sigterm@2"):
        with pytest.raises(Preempted) as e:
            _run("port", 24, PC.ModelRegistry(path=path),
                 compact_above=10**6)
    assert e.value.path == path and 0 < e.value.step < 24
    assert e.value.resume_hint == f"--resume --model-dir {path}"
    pipe, gen, _ = _run("port", 24, PC.ModelRegistry(path=path),
                        resume=True, compact_above=10**6)
    assert pipe.batch_idx == 24 and gen.trigger in ("scheduled", "drift")
    with pytest.raises(ValueError, match="contradicts"):
        _run("port", 24, PC.ModelRegistry(path=path), resume=True, k=5)
    with pytest.raises(ValueError, match="behind the stream position"):
        _run("port", 3, PC.ModelRegistry(path=path), resume=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PC.ContinuousPipeline(SRC, PC.ContinuousConfig(k=3))


# ---------------------------------------------------------------------------
# cli continuous
# ---------------------------------------------------------------------------

def _main(side):
    if side == "ref":
        return ref_cli.main
    return lambda argv: port_cli.main(list(argv) + ["--device", "cpu"])


def _lines(out):
    return [json.loads(ln) for ln in out.strip().splitlines()]


def _strip(lines):
    return [{k: v for k, v in ln.items() if k not in ("ts", "inertia_pp")}
            for ln in lines]


CLI = ["continuous", "--k", "3", "--batch-n", "192", "--d", "4",
       "--stream-seed", "11", "--drift-at", "8", "--drift", "8",
       "--refit-every", "5"]


def test_cli_continuous_lines_equal_the_reference(tmp_path, capsys):
    got = {}
    for side in SIDES:
        d = str(tmp_path / side)
        rc = _main(side)(CLI + ["--batches", "16", "--model-dir", d,
                                "--progress"])
        out = capsys.readouterr()
        assert rc == 0, out.err
        got[side] = (_lines(out.out), _lines(out.err))
    ref, port = got["ref"], got["port"]
    assert _strip(port[0]) == _strip(ref[0])
    assert [ln["event"] for ln in port[0]][-1] == "done"
    assert {ln["trigger"] for ln in port[0]} >= {"initial", "drift"}
    np.testing.assert_allclose(
        [ln["inertia_pp"] or 0.0 for ln in port[0][:-1]],
        [ln["inertia_pp"] or 0.0 for ln in ref[0][:-1]], rtol=1e-3)
    strip = [{k: v for k, v in ln.items()
              if k not in ("seconds", "inertia_pp")} for ln in port[1]]
    assert strip == [{k: v for k, v in ln.items()
                      if k not in ("seconds", "inertia_pp")}
                     for ln in ref[1]]


@pytest.mark.parametrize("writer", SIDES)
def test_cli_continuous_resumes_the_other_packages_dir(writer, tmp_path,
                                                       capsys):
    d = str(tmp_path / "m")
    assert _main(writer)(CLI + ["--batches", "7", "--model-dir", d]) == 0
    first = _lines(capsys.readouterr().out)
    other = "port" if writer == "ref" else "ref"
    rc = _main(other)(CLI + ["--batches", "14", "--model-dir", d,
                             "--resume"])
    lines = _lines(capsys.readouterr().out)
    assert rc == 0
    assert lines[0]["event"] == "resumed"
    assert lines[0]["generation"] == first[-1]["generation"]
    assert lines[0]["batch_idx"] >= 6
    assert lines[-1]["event"] == "done" and lines[-1]["batches"] == 14


def _error_cases(tmp_path):
    one_d = str(tmp_path / "one.npy")
    np.save(one_d, np.zeros(10, np.float32))
    small = str(tmp_path / "small.npy")
    np.save(small, np.zeros((10, 4), np.float32))
    return {
        "resume no dir": ["continuous", "--resume"],
        "batches": ["continuous", "--batches", "0"],
        "missing": ["continuous", "--input", str(tmp_path / "none.npy")],
        "1-d": ["continuous", "--input", one_d],
        "few rows": ["continuous", "--input", small],
        "refit iters": ["continuous", "--refit-iters", "0"],
        "k": ["continuous", "--k", "0"],
        "window": ["continuous", "--window-batches", "0"],
        "compact": ["continuous", "--compact-above", "100", "--coreset",
                    "200"],
        "warmup": ["continuous", "--warmup-batches", "0"],
    }


@pytest.mark.parametrize("case", ["resume no dir", "batches", "missing",
                                  "1-d", "few rows", "refit iters", "k",
                                  "window", "compact", "warmup"])
def test_cli_continuous_errors_equal_the_reference(case, tmp_path, capsys):
    argv = _error_cases(tmp_path)[case]
    got = []
    for side in SIDES:
        rc = _main(side)(argv)
        out = capsys.readouterr()
        got.append((rc, out.out, out.err))
    assert got[0][0] == 2 and got[0] == got[1]


def test_cli_continuous_k_mismatch_and_the_card_default(tmp_path, capsys):
    d = str(tmp_path / "m")
    assert _main("ref")(CLI + ["--batches", "4", "--model-dir", d]) == 0
    capsys.readouterr()
    errs = []
    for side in SIDES:
        rc = _main(side)(["continuous", "--k", "5", "--model-dir", d,
                          "--resume"])
        errs.append((rc, capsys.readouterr().err))
    assert errs[0][0] == 2 and errs[0] == errs[1]
    if not torch.cuda.is_available():
        rc = port_cli.main(["continuous", "--k", "4", "--batches", "10"])
        err = capsys.readouterr().err.strip().splitlines()
        assert rc == 2 and len(err) == 1 and "--device cpu" in err[0]


def test_the_new_families_are_on_the_ports_registry():
    names = ["kmeans_tpu_continuous_batches_total",
             "kmeans_tpu_continuous_refits_total",
             "kmeans_tpu_continuous_refit_seconds",
             "kmeans_tpu_continuous_drift_events_total",
             "kmeans_tpu_continuous_window_points",
             "kmeans_tpu_continuous_compactions_total",
             "kmeans_tpu_continuous_compact_failures_total",
             "kmeans_tpu_prefetch_queue_depth",
             "kmeans_tpu_prefetch_producer_stalls_total",
             "kmeans_tpu_retry_attempts_total",
             "kmeans_tpu_retry_exhausted_total"]
    import kmeans_tpu.continuous  # noqa: F401  (registers the families)
    import kmeans_tpu.data.stream  # noqa: F401

    mine, theirs = REGISTRY.describe(), REF_REGISTRY.describe()
    for name in names:
        assert name in mine, name
        assert mine[name] == theirs[name], name


# ---------------------------------------------------------------------------
# cli train --coreset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--coreset", "0"], ["--coreset", "50", "--model", "minibatch"],
    ["--coreset", "50", "--progress"], ["--coreset", "50", "--checkpoint",
                                        "ck"]])
def test_cli_coreset_guards_equal_the_reference(extra, capsys):
    got = []
    for side in SIDES:
        rc = _main(side)(["train", "--n", "300", "--d", "3", "--k", "3"]
                         + extra)
        out = capsys.readouterr()
        got.append((rc, out.out, out.err))
    assert got[0][0] == 2 and got[0] == got[1]


@pytest.mark.parametrize("model", ["lloyd", "accelerated", "trimmed"])
def test_cli_coreset_draws_replay_through_the_reference(model, monkeypatch,
                                                        tmp_path, capsys):
    """``train --coreset 200``: the port draws from a generator seeded with
    seed + 1; the same draws through the reference's coreset give the same
    points and weights, and the fit on them is the CLI's."""
    rng = np.random.default_rng(6)
    centres = rng.uniform(-10, 10, size=(3, 4))
    x = (centres[rng.integers(0, 3, 1200)]
         + 0.3 * rng.normal(size=(1200, 4))).astype(np.float32)
    npy = str(tmp_path / "x.npy")
    np.save(npy, x)
    draws = Draws(monkeypatch)
    rc = _main("port")(["train", "--input", npy, "--k", "3", "--coreset",
                        "200", "--model", model, "--seed", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["coreset"] == 200 and res["n"] == 1200
    (q, idx), = draws.draws
    pts, w = lightweight_coreset(5, x, 200, device=CPU)
    np.testing.assert_array_equal(pts.numpy(), x[idx])
    assert draws.draws.pop(1)[1].tolist() == idx.tolist()
    rp, rw = ref_coreset(jax.random.key(5), x, 200)
    np.testing.assert_array_equal(np.asarray(rp), x[idx])
    np.testing.assert_allclose(np.asarray(rw), w.numpy(), rtol=1e-6)
    if model == "lloyd":
        st = fit_lloyd(pts, 3, config=KMeansConfig(k=3, seed=4),
                       weights=w, device=CPU)
        assert float(st.inertia) == res["inertia"]
