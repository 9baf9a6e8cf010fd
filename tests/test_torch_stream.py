"""The port's out-of-core streaming against the JAX package's, on the CPU.

The same numpy inputs go through both packages: the retry policy, the
native row gather (f32 and the fused f32 -> bf16, native and with
``KMEANS_TPU_NO_NATIVE=1``), ``sample_batches`` (bit for bit, also from a
middle step), the prefetch (order, values, a producer's error, the bounded
teardown join), the streamed seeding's subsample, ``fit_minibatch_stream``
from one explicit init (centroids and ``n_seen`` to rtol 1e-5, labels
exact on separated blobs, inertia allclose, for every ``transfer_dtype``),
checkpoints written by either package and resumed by the other, the resume
refusals (the same messages), ``assign_stream`` and ``cli train --stream``
(the same guard lines, the pairwise families' included), with
``--model gmm`` the streamed mixture's result line (its seeding replayed
through the reference) and its checkpoints resumed across the packages.
The port runs with ``device="cpu"``: the kernels' plain versions.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from kmeans_tpu import cli as ref_cli
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.data import stream as ref_stream
from kmeans_tpu.models import init as ref_init
from kmeans_tpu.models import streaming as ref_streaming
from kmeans_tpu.native import loader as ref_loader
from kmeans_tpu.utils import faults as ref_faults
from kmeans_tpu.utils import retry as ref_retry
from kmeans_tpu.utils.checkpoint import load_array_checkpoint as ref_load
from kmeans_tpu_torch import cli as port_cli
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data import stream
from kmeans_tpu_torch.models import init as port_init
from kmeans_tpu_torch.models import streaming
from kmeans_tpu_torch.native import loader
from kmeans_tpu_torch.utils import faults, retry
from kmeans_tpu_torch.utils.checkpoint import load_array_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SIDES = ("ref", "port")
#: Streamed fits of the two packages: the same batches and update, f32
#: sums in another order.
RTOL = 1e-5


@pytest.fixture(autouse=True)
def npz_format(monkeypatch):
    """Hide orbax, so the reference writes npz checkpoints."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _blobs(seed=0, n=3000, d=8, k=5, spread=6.0):
    """Separated blobs in random row order, and one row of each blob."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    pick = [int(np.flatnonzero(lab == j)[0]) for j in range(k)]
    return x, x[pick].copy()


def _bits(t):
    """A bf16 tensor or ml_dtypes array as its uint16 bits."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _special_rows():
    """f32 rows with the values a bf16 round must get right: ties to even,
    infinities, subnormals, signed zeros, the largest finite values."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 24)).astype(np.float32) * 100
    bits = x.view(np.uint32)
    bits[:20, :] = (bits[:20, :] & 0xFFFF0000) | 0x8000    # exact ties
    x[20, :6] = [np.inf, -np.inf, 1e-40, -1e-42, 0.0, -0.0]
    x[21, :3] = [np.finfo(np.float32).max, -np.finfo(np.float32).max,
                 np.finfo(np.float32).tiny]
    return x


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

POLICIES = [dict(), dict(max_attempts=5, base_delay=0.1, multiplier=3.0),
            dict(max_attempts=6, base_delay=0.5, max_delay=1.0),
            dict(max_attempts=1)]


@pytest.mark.parametrize("kw", POLICIES, ids=lambda kw: str(sorted(kw)))
def test_retry_delays_equal_the_reference(kw):
    assert list(retry.RetryPolicy(**kw).delays()) == \
        list(ref_retry.RetryPolicy(**kw).delays())


@pytest.mark.parametrize("fails", [0, 1, 3, 4, 6])
def test_retry_attempts_and_exhaustion_equal_the_reference(fails):
    """A callable that hits an injected fault site ``fails`` times: both
    policies absorb the same failures, or give up after the same number of
    attempts with the same message."""
    outcomes = []
    for pkg, flt in ((ref_retry, ref_faults), (retry, faults)):
        policy = pkg.RetryPolicy(max_attempts=4, base_delay=0.0)
        calls = [0]

        def fn():
            calls[0] += 1
            flt.check("stream.read")
            return "ok"

        with flt.active(f"stream.read:raise@1x{fails}"):
            try:
                got = policy.call(fn, site="stream.read")
                outcomes.append((got, calls[0]))
            except pkg.RetryError as e:
                outcomes.append((str(e), e.attempts, calls[0],
                                 type(e.__cause__).__name__))
    assert outcomes[0] == outcomes[1]


def test_retry_permanent_errors_and_the_metrics():
    """A non-retryable error propagates at once in both; the port's
    counters count an absorbed retry and an exhausted budget."""
    for pkg in (ref_retry, retry):
        policy = pkg.RetryPolicy(max_attempts=3, base_delay=0.0)
        with pytest.raises(KeyError):
            policy.call(lambda: {}["x"])
    fam = retry._RETRIES_TOTAL
    ex = retry._RETRY_EXHAUSTED_TOTAL
    a0, e0 = fam.value(site="t.x"), ex.value(site="t.x")

    def boom():
        raise OSError("flaky")

    with pytest.raises(retry.RetryError):
        retry.RetryPolicy(max_attempts=3, base_delay=0.0).call(
            boom, site="t.x")
    assert fam.value(site="t.x") - a0 == 2 and ex.value(site="t.x") - e0 == 1
    with pytest.raises(ValueError, match="max_attempts"):
        retry.RetryPolicy(max_attempts=0)


# ---------------------------------------------------------------------------
# The native gather
# ---------------------------------------------------------------------------

def test_native_source_is_the_reference_source():
    """Everything from the first #include on is the reference's source."""
    mine = open(loader.SOURCE, encoding="utf-8").read()
    theirs = open(ref_loader._SRC, encoding="utf-8").read()
    cut = "#include <cstdint>"
    assert mine[mine.index(cut):] == theirs[theirs.index(cut):]
    assert loader.BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("to_bf16", [False, True])
@pytest.mark.parametrize("into", [False, True])
def test_gather_equals_the_reference_numpy_and_torch(to_bf16, into):
    assert loader.native_available()
    x = _special_rows()
    idx = np.random.default_rng(4).integers(0, x.shape[0], size=150)
    loader.reset_gather_counts()
    out = (torch.empty((160, x.shape[1]),
                       dtype=torch.bfloat16 if to_bf16 else torch.float32)
           if into else None)
    got = loader.gather_rows(x, idx, to_bf16=to_bf16, out=out)
    ref = ref_loader.gather_rows(x, idx, to_bf16=to_bf16)
    assert loader.gather_counts() == {"native": 1, "numpy": 0}
    if into:
        assert got.data_ptr() == out.data_ptr()
    if to_bf16:
        assert got.dtype == torch.bfloat16
        want = torch.from_numpy(x[idx]).to(torch.bfloat16)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(
            _bits(got), x[idx].astype(ml_dtypes.bfloat16).view(np.uint16))
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), x[idx])


def test_gather_of_a_memmap_and_to_bfloat16(tmp_path):
    x = _special_rows()
    np.save(tmp_path / "x.npy", x)
    mm = stream.load_mmap(str(tmp_path / "x.npy"))
    idx = np.arange(0, 200, 3)
    np.testing.assert_array_equal(loader.gather_rows(mm, idx).numpy(),
                                  x[idx])
    np.testing.assert_array_equal(_bits(loader.to_bfloat16(x)),
                                  _bits(ref_loader.to_bfloat16(x)))
    # A 1-D array or an empty index falls back to numpy, as the reference.
    assert loader.gather_rows(x, np.zeros(0, np.int64)).shape == (0, 24)


@pytest.mark.parametrize("bad", ["2d_idx", "range", "bf16_of_f64"])
def test_gather_refusals_equal_the_reference(bad):
    x = _special_rows()
    args = {"2d_idx": (x, np.zeros((2, 2), np.int64), False),
            "range": (x, np.array([0, 200]), False),
            "bf16_of_f64": (x.astype(np.float64), np.array([0]), True)}[bad]
    errs = []
    for fn in (ref_loader.gather_rows, loader.gather_rows):
        with pytest.raises((ValueError, IndexError)) as e:
            fn(args[0], args[1], to_bf16=args[2])
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def test_numpy_route_under_the_kill_switch(tmp_path):
    """``KMEANS_TPU_NO_NATIVE=1``: no native library, the numpy route's
    gathers equal the native ones bit for bit."""
    x = _special_rows()
    np.save(tmp_path / "x.npy", x)
    idx = np.random.default_rng(9).integers(0, 200, size=77)
    np.save(tmp_path / "i.npy", idx)
    code = (
        "import sys, numpy as np, torch\n"
        "from kmeans_tpu_torch.native import loader as L\n"
        "x = np.load(sys.argv[1]); i = np.load(sys.argv[2])\n"
        "assert not L.native_available()\n"
        "a = L.gather_rows(x, i).numpy()\n"
        "b = L.gather_rows(x, i, to_bf16=True, out=torch.empty(80, 24,"
        " dtype=torch.bfloat16))\n"
        "c = L.to_bfloat16(x)\n"
        "np.save(sys.argv[3], a)\n"
        "np.save(sys.argv[4], b.view(torch.int16).numpy())\n"
        "np.save(sys.argv[5], c.view(torch.int16).numpy())\n"
        "print(L.gather_counts())\n")
    outs = [str(tmp_path / f"{n}.npy") for n in "abc"]
    env = dict(os.environ, KMEANS_TPU_NO_NATIVE="1")
    res = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "x.npy"),
         str(tmp_path / "i.npy"), *outs], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "'native': 0, 'numpy': 3" in res.stdout
    np.testing.assert_array_equal(np.load(outs[0]),
                                  loader.gather_rows(x, idx).numpy())
    np.testing.assert_array_equal(
        np.load(outs[1]).view(np.uint16),
        _bits(loader.gather_rows(x, idx, to_bf16=True)))
    np.testing.assert_array_equal(np.load(outs[2]).view(np.uint16),
                                  _bits(loader.to_bfloat16(x)))


# ---------------------------------------------------------------------------
# sample_batches and the prefetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("to_bf16", [False, True])
def test_sample_batches_equal_the_reference(start, to_bf16):
    x, _ = _blobs(n=1000)
    mine = list(stream.sample_batches(x, 64, 7, seed=11, start_step=start,
                                      to_bf16=to_bf16))
    ref = list(ref_stream.sample_batches(x, 64, 7, seed=11,
                                         start_step=start, to_bf16=to_bf16))
    assert len(mine) == len(ref) == 7 - start
    for a, b in zip(mine, ref):
        if to_bf16:
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="bad batch_size"):
        next(stream.sample_batches(x, 0, 3))


@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_keeps_order_and_values(background, depth):
    batches = [np.full((4, 2), i, np.float32) for i in range(9)]
    got = list(stream.prefetch_to_device(iter(batches), depth=depth,
                                         device=CPU, background=background))
    assert [int(b[0, 0]) for b in got] == list(range(9))
    assert all(b.device.type == "cpu" and b.dtype == torch.float32
               for b in got)
    with pytest.raises(ValueError, match="depth"):
        next(stream.prefetch_to_device(iter(batches), depth=0, device=CPU))


def test_prefetch_reraises_the_producer_error():
    def batches():
        yield np.zeros((2, 2), np.float32)
        raise OSError("disk gone")

    gen = stream.prefetch_to_device(batches(), depth=2, device=CPU,
                                    background=True)
    next(gen)
    with pytest.raises(OSError, match="disk gone"):
        next(gen)


def test_prefetch_teardown_joins_the_producer():
    """A cooperative producer joins inside the bounded wait, silently."""
    gen = stream.prefetch_to_device(
        iter([np.zeros((4, 2), np.float32)] * 50), depth=1, device=CPU,
        background=True)
    next(gen)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        gen.close()
    assert not any(t.name == "kt-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_prefetch_names_a_stalled_producer(monkeypatch):
    """A producer wedged in the upstream iterator cannot see the stop
    flag; teardown names the leaked thread."""
    monkeypatch.setattr(stream, "_JOIN_TIMEOUT", 0.3)
    never = threading.Event()

    def stalling():
        yield np.zeros((4, 2), np.float32)
        never.wait()

    gen = stream.prefetch_to_device(stalling(), depth=1, device=CPU,
                                    background=True)
    next(gen)
    with pytest.warns(RuntimeWarning, match="kt-prefetch.*still alive"):
        gen.close()
    never.set()


def test_foreach_chunk_and_the_card_default():
    x, _ = _blobs(n=1000)
    seen = []
    stream.foreach_chunk(x, 300, lambda xb, lo: seen.append(
        (lo, xb.numpy().copy())), device=CPU)
    assert [lo for lo, _ in seen] == [0, 300, 600, 900]
    np.testing.assert_array_equal(np.concatenate([b for _, b in seen]), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream.foreach_chunk(x, 300, lambda *a: None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            streaming.fit_minibatch_stream(x, 3, steps=2, batch_size=8)


# ---------------------------------------------------------------------------
# Seeding, the streamed fit and assign_stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(3000, 5), (70_000, 2)])
def test_host_subsample_seed_rows_equal_the_reference(monkeypatch, n, k):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    seen = {}

    def grab(which, real):
        def init(gen, xs, k, **kw):
            seen[which] = np.asarray(xs)
            return real(gen, xs, k, **kw)
        return init

    monkeypatch.setattr(port_init, "init_centroids",
                        grab("port", port_init.init_centroids))
    monkeypatch.setattr(ref_init, "init_centroids",
                        grab("ref", ref_init.init_centroids))
    cfg = KMeansConfig(k=k)
    c0 = port_init.host_subsample_seed(x, k, 0, cfg, None, host_seed=7,
                                       device=CPU)
    import jax

    ref_init.host_subsample_seed(x, k, jax.random.key(0), RefConfig(k=k),
                                 None, host_seed=7)
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    assert seen["port"].shape[0] == min(n, 65536)
    assert tuple(c0.shape) == (k, 4)
    with pytest.raises(ValueError, match="init centroids shape"):
        port_init.host_subsample_seed(x, k, 0, cfg, np.zeros((k + 1, 4)),
                                      host_seed=7, device=CPU)


def _ref_fit(x, c0, k, td, cd, **kw):
    return ref_streaming.fit_minibatch_stream(
        x, k, config=RefConfig(k=k, steps=50, batch_size=128,
                               compute_dtype=cd),
        init=c0, transfer_dtype=td, **kw)


def _port_fit(x, c0, k, td, cd, **kw):
    return streaming.fit_minibatch_stream(
        x, k, config=KMeansConfig(k=k, steps=50, batch_size=128,
                                  compute_dtype=cd),
        init=c0, transfer_dtype=td, device=CPU, **kw)


@pytest.mark.parametrize("td,cd", [(None, None), ("auto", "bfloat16"),
                                   ("auto", None), ("float32", "bfloat16"),
                                   ("bfloat16", None)])
def test_fit_minibatch_stream_equals_the_reference(tmp_path, td, cd):
    x, c0 = _blobs()
    r = _ref_fit(x, c0, 5, td, cd, checkpoint_path=str(tmp_path / "r"))
    p = _port_fit(x, c0, 5, td, cd, checkpoint_path=str(tmp_path / "p"))
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(r.centroids),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(p.labels.numpy(), np.asarray(r.labels))
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(r.counts))
    np.testing.assert_allclose(float(p.inertia), float(r.inertia),
                               rtol=RTOL)
    assert int(p.n_iter) == int(r.n_iter) == 50
    ra, rm = ref_load(str(tmp_path / "r"))
    pa, pm = load_array_checkpoint(str(tmp_path / "p"))
    np.testing.assert_allclose(pa["counts"], ra["counts"], rtol=RTOL)
    assert pm["extra"] == rm["extra"]
    assert pm["step"] == rm["step"] == 50


def test_final_pass_off_and_the_callback():
    x, c0 = _blobs(n=1000)
    infos = []
    from kmeans_tpu_torch.models.runner import ITER_SECONDS

    n0 = ITER_SECONDS.snapshot(model="minibatch_stream")[0]
    st = _port_fit(x, c0, 5, None, None, final_pass=False,
                   callback=infos.append)
    assert st.labels.shape == (0,) and float(st.inertia) == 0.0
    assert [i.iteration for i in infos] == list(range(1, 51))
    assert all(i.shift_sq is not None and i.inertia is None for i in infos)
    assert ITER_SECONDS.snapshot(model="minibatch_stream")[0] - n0 == 50


@pytest.mark.parametrize("writer", SIDES)
def test_a_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """20 steps by one package, the rest to 50 by the other: the centroids
    of an uninterrupted 50-step run."""
    x, c0 = _blobs()
    ck = str(tmp_path / "ck")
    first, then = ((_ref_fit, _port_fit) if writer == "ref"
                   else (_port_fit, _ref_fit))
    kw = dict(checkpoint_path=ck, checkpoint_every=5)
    first(x, c0, 5, None, None, steps=20, **kw)
    resumed = then(x, None, 5, None, None, resume=True, **kw)
    whole = then(x, c0, 5, None, None)
    assert int(resumed.n_iter) == 50
    np.testing.assert_allclose(np.asarray(resumed.centroids),
                               np.asarray(whole.centroids),
                               rtol=RTOL, atol=RTOL)


def _refusal_cases(tmp_path, x, c0):
    """(name, checkpoint dir, kwargs of the resume) for each refusal."""
    ck = str(tmp_path / "ck")
    return [
        ("init array", ck, dict(init=c0)),
        ("seed", ck, dict(seed=3)),
        ("batch size", ck, dict(batch_size=64)),
        ("width", ck, dict(transfer_dtype="bfloat16")),
        ("steps", ck, dict(steps=5)),
        ("no path", None, dict()),
    ]


def test_resume_refusals_print_the_reference_messages(tmp_path):
    x, c0 = _blobs()
    ck = str(tmp_path / "ck")
    _ref_fit(x, c0, 5, None, None, steps=10, checkpoint_path=ck)
    for name, path, kw in _refusal_cases(tmp_path, x, c0):
        msgs = []
        for fit in (_ref_fit, _port_fit):
            args = dict(checkpoint_path=path, resume=True)
            args.update(kw)
            init = args.pop("init", None)
            with pytest.raises(ValueError) as e:
                fit(x, init, 5, args.pop("transfer_dtype", None), None,
                    **args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], name
    # A runner checkpoint (no stream tag), a streamed-GMM one and one of
    # another k.
    from kmeans_tpu_torch.utils.checkpoint import save_array_checkpoint

    cases = [("untagged", {}), ("gmm", {"stream": "gmm"})]
    for name, extra in cases:
        d = str(tmp_path / name)
        save_array_checkpoint(d, {"centroids": c0, "counts": np.ones(5),
                                  "n_iter": np.array(3)}, step=3,
                              extra=extra)
        msgs = []
        for fit in (_ref_fit, _port_fit):
            with pytest.raises(ValueError) as e:
                fit(x, None, 5, None, None, checkpoint_path=d, resume=True)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], name
    with pytest.raises(ValueError, match="checkpoint centroids"):
        _port_fit(x[:, :8], None, 4, None, None, checkpoint_path=ck,
                  resume=True)
    # A mesh resume of a one-device stream: the reference's mesh_dp line.
    from types import SimpleNamespace

    mesh2 = SimpleNamespace(axis_sizes={"data": 2}, rank=0,
                            device=torch.device(CPU))
    with pytest.raises(ValueError, match=r"resume mesh \(data axis 2\) "
                       r"contradicts the checkpoint's \(absent\)"):
        _port_fit(x, None, 5, None, None, checkpoint_path=ck, resume=True,
                  mesh=mesh2)
    with pytest.raises(ValueError, match="transfer_dtype must be"):
        _port_fit(x, c0, 5, "int8", None)


def test_a_signal_cuts_a_checkpoint_and_the_resume_matches(tmp_path):
    """SIGTERM at step 7 (the callback raises it): a checkpoint at step 7,
    Preempted, and the resume ends at the uninterrupted run's centroids."""
    from kmeans_tpu_torch.utils.preempt import Preempted

    x, c0 = _blobs()
    ck = str(tmp_path / "ck")

    def at7(info):
        if info.iteration == 7:
            signal.raise_signal(signal.SIGTERM)

    with pytest.raises(Preempted) as e:
        _port_fit(x, c0, 5, None, None, checkpoint_path=ck,
                  checkpoint_every=0, callback=at7)
    assert e.value.step == 7 and e.value.path == ck
    assert load_array_checkpoint(ck)[1]["step"] == 7
    resumed = _port_fit(x, None, 5, None, None, checkpoint_path=ck,
                        resume=True)
    whole = _port_fit(x, c0, 5, None, None)
    np.testing.assert_array_equal(resumed.centroids.numpy(),
                                  whole.centroids.numpy())


def test_stream_read_faults_are_absorbed_or_exhaust():
    x, c0 = _blobs(n=1000)
    clean = _port_fit(x, c0, 5, None, None)
    fam = retry._RETRIES_TOTAL
    a0 = fam.value(site="stream.read")
    with faults.active("stream.read:raise@3x2"):
        noisy = _port_fit(x, c0, 5, None, None)
    assert fam.value(site="stream.read") - a0 == 2
    np.testing.assert_array_equal(noisy.centroids.numpy(),
                                  clean.centroids.numpy())
    with faults.active("stream.read:raise@2x9"):
        with pytest.raises(retry.RetryError):
            _port_fit(x, c0, 5, None, None)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_assign_stream_equals_the_reference(cd):
    x, c0 = _blobs(n=2000)
    lab, inertia = streaming.assign_stream(x, c0, chunk_size=300,
                                           compute_dtype=cd, device=CPU)
    rlab, rin = ref_streaming.assign_stream(x, c0, chunk_size=300,
                                            compute_dtype=cd)
    assert lab.dtype == np.int32
    np.testing.assert_array_equal(lab, rlab)
    np.testing.assert_allclose(inertia, rin, rtol=1e-6)


# ---------------------------------------------------------------------------
# cli train --stream
# ---------------------------------------------------------------------------

def _main(side):
    if side == "ref":
        return ref_cli.main
    return lambda argv: port_cli.main(list(argv) + ["--device", "cpu"])


@pytest.fixture()
def npy(tmp_path):
    x, _ = _blobs(n=1500, d=4, k=3)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    return path


def _guard_cases(tmp_path, npy):
    ck = str(tmp_path / "ck")
    base = ["train", "--stream", "--input", npy]
    return {
        "no input": ["train", "--stream"],
        "missing": ["train", "--stream", "--input",
                    str(tmp_path / "missing.npy")],
        "lloyd": base + ["--model", "lloyd"],
        "no-minibatch": base + ["--no-minibatch"],
        "max-iter": base + ["--max-iter", "5"],
        "progress": base + ["--progress"],
        "profile": base + ["--profile", str(tmp_path / "p")],
        "accel": base + ["--accel", "beta"],
        "schedule": base + ["--schedule", "nested"],
        "update": base + ["--update", "matmul"],
        "steps": base + ["--steps", "0"],
        "batch": base + ["--batch-size", "0"],
        "resume mismatch": base + ["--resume", ck, "--checkpoint",
                                   str(tmp_path / "other")],
        "resume missing": base + ["--resume", ck],
        "coreset": base + ["--coreset", "10"],
        "covariance": base + ["--covariance-type", "diag"],
    }


GUARDS = ["no input", "missing", "lloyd", "no-minibatch", "max-iter",
          "progress", "profile", "accel", "schedule", "update", "steps",
          "batch", "resume mismatch", "resume missing", "coreset",
          "covariance"]


@pytest.mark.parametrize("case", GUARDS)
def test_cli_stream_guard_lines_equal_the_reference(case, tmp_path, npy,
                                                    capsys):
    argv = _guard_cases(tmp_path, npy)[case]
    got = []
    for side in SIDES:
        rc = _main(side)(argv)
        out = capsys.readouterr()
        got.append((rc, out.out, out.err))
    assert got[0][0] == 2 and got[0] == got[1]


@pytest.mark.parametrize("extra", [
    ["--model", "kernel"], ["--model", "kmedoids", "--mesh", "2"],
    ["--model", "spectral", "--mesh", "4"]],
    ids=["kernel", "kmedoids-mesh", "spectral-mesh"])
def test_cli_stream_pairwise_families_give_the_references_guard(extra, npy,
                                                                capsys):
    """``--stream`` with a pairwise family (on a mesh too): the
    reference's stream guard, exit 2 and the same stderr, before any mesh
    starts."""
    got = []
    for side in SIDES:
        rc = _main(side)(["train", "--stream", "--input", npy] + extra)
        out = capsys.readouterr()
        got.append((rc, out.out, out.err))
    assert got[0][0] == 2 and got[0] == got[1]
    assert len(got[1][2].strip().splitlines()) == 1


def test_cli_stream_result_lines_agree(npy, capsys):
    import json

    lines = []
    for side in SIDES:
        rc = _main(side)(["train", "--stream", "--input", npy, "--k", "3",
                          "--steps", "40", "--batch-size", "128"])
        assert rc == 0
        lines.append(json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]))
    ref, port = lines
    assert sorted(ref) == sorted(port)
    assert {k: port[k] for k in ("n", "d", "k", "n_iter", "mode", "stream",
                                 "converged")} == \
        {k: ref[k] for k in ("n", "d", "k", "n_iter", "mode", "stream",
                             "converged")}
    np.testing.assert_allclose(port["inertia"], ref["inertia"], rtol=1e-2)


@pytest.mark.parametrize("writer", SIDES)
def test_cli_stream_resumes_the_other_packages_directory(writer, tmp_path,
                                                         npy, capsys):
    ck = str(tmp_path / "ck")
    base = ["train", "--stream", "--input", npy, "--k", "3",
            "--batch-size", "64"]
    assert _main(writer)(base + ["--steps", "10", "--checkpoint", ck]) == 0
    other = "port" if writer == "ref" else "ref"
    rc = _main(other)(base + ["--steps", "25", "--resume", ck])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and '"n_iter": 25' in out[-1]
    assert load_array_checkpoint(ck)[1]["step"] == 25
    shutil.rmtree(ck)


def _gmm_stream_lines(npy, capsys, monkeypatch, extra):
    """``train --stream --model gmm`` in both packages, the reference's
    seeding replaced by the port's (its k-means++ start on the same host
    subsample); returns the two result lines."""
    import json

    import jax.numpy as jnp

    from kmeans_tpu.models import gmm_stream as ref_gmm_stream
    from kmeans_tpu_torch.models import gmm_stream as port_gmm_stream

    starts = []
    real = port_gmm_stream.host_subsample_seed

    def record(*a, **kw):
        c0, xs = real(*a, **kw)
        starts.append(c0.numpy().copy())
        return c0, xs

    argv = ["train", "--stream", "--model", "gmm", "--input", npy, "--k",
            "3", "--batch-size", "128"] + extra
    with monkeypatch.context() as m:
        m.setattr(port_gmm_stream, "host_subsample_seed", record)
        assert _main("port")(argv) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref_real = ref_gmm_stream.host_subsample_seed

    def replay(data, k, key, cfg, init, **kw):
        return ref_real(data, k, key, cfg, jnp.asarray(starts[0]), **kw)

    monkeypatch.setattr(ref_gmm_stream, "host_subsample_seed", replay)
    assert _main("ref")(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return ref, port


@pytest.mark.parametrize("cov", ["diag", "spherical"])
def test_cli_stream_gmm_result_lines_agree(cov, npy, capsys, monkeypatch):
    """The streamed mixture's result line: the reference's keys, steps and
    mode, and its objective (the negated total log-likelihood) to 1e-5."""
    ref, port = _gmm_stream_lines(npy, capsys, monkeypatch, [
        "--steps", "30", "--covariance-type", cov])
    assert list(port) == list(ref)
    same = ("n", "d", "k", "n_iter", "mode", "stream", "converged")
    assert {k: port[k] for k in same} == {k: ref[k] for k in same}
    assert port["mode"] == "gmm" and port["n_iter"] == 30
    np.testing.assert_allclose(port["inertia"], ref["inertia"], rtol=1e-5)


@pytest.mark.parametrize("writer", SIDES)
def test_cli_stream_gmm_resumes_the_other_packages_directory(
        writer, tmp_path, npy, capsys):
    """A ``--stream --model gmm`` checkpoint of either package resumes in
    the other (the stream tag, schedule and statistics are the
    reference's), to the requested step."""
    ck = str(tmp_path / "ck")
    base = ["train", "--stream", "--model", "gmm", "--input", npy, "--k",
            "3", "--batch-size", "64"]
    assert _main(writer)(base + ["--steps", "10", "--checkpoint", ck]) == 0
    other = "port" if writer == "ref" else "ref"
    rc = _main(other)(base + ["--steps", "25", "--resume", ck])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and '"n_iter": 25' in out[-1] and '"gmm"' in out[-1]
    meta = load_array_checkpoint(ck)[1]
    assert meta["step"] == 25 and meta["extra"]["stream"] == "gmm"
    # A minibatch resume of the GMM directory is refused, as the
    # reference's is.
    plain = ["train", "--stream", "--input", npy, "--k", "3",
             "--batch-size", "64", "--steps", "30", "--resume", ck]
    got = [(_main(side)(plain), capsys.readouterr().err) for side in SIDES]
    assert got[0][0] == got[1][0] == 2 and got[0][1] == got[1][1]
    shutil.rmtree(ck)
