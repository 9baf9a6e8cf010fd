"""The port's fit, init and state conversion against the JAX package.

Fits start from an explicit ``init`` array made with numpy: torch cannot
reproduce ``jax.random``'s k-means++ draws.  The data are well-separated
blobs, so labels and sweep counts must be equal; centroids and inertia
agree to rtol 1e-5 and atol 1e-4·max|want| because both packages sum the
same f32 terms in different orders.  The port runs with ``device="cpu"``,
where its kernels' plain versions run; the reference runs its default (XLA)
route on the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu_torch import (KMeans, KMeansConfig, delta_pass, fit_lloyd,
                              kmeans_plus_plus, lloyd_pass, make_blobs)
from kmeans_tpu_torch.convert import state_from_numpy, state_to_numpy
from kmeans_tpu_torch.models.lloyd import fit_plan
from kmeans_tpu_torch.ops.yinyang import AUTO_MIN_ROWS

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = 1e-4 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _problem(seed=0, n=600, d=16, k=5):
    """Separated blobs and an explicit init of k data rows, two of them
    from one blob so the first sweeps move rows between clusters."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 6
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    pick = [int(np.flatnonzero(lab == j)[0]) for j in range(k - 1)]
    pick.append(int(np.flatnonzero(lab == 0)[1]))
    return x, x[pick].copy()


@pytest.mark.parametrize("update,cd,max_iter,tol", [
    ("delta", "float32", 20, -1.0),      # 20 sweeps: the refresh at 16 runs
    ("delta", "bfloat16", 20, -1.0),
    ("delta", "float32", 50, 1e-4),      # converges: n_iter must match
    ("matmul", "float32", 50, 1e-4),
    ("matmul", "bfloat16", 20, -1.0),
])
def test_fit_lloyd_matches_reference(update, cd, max_iter, tol):
    x, c0 = _problem()
    k = c0.shape[0]
    port = fit_lloyd(x, k, init=c0, device=CPU, max_iter=max_iter, tol=tol,
                     config=KMeansConfig(k=k, update=update,
                                         compute_dtype=cd))
    ref = kmeans_tpu.fit_lloyd(jnp.asarray(x), k, init=jnp.asarray(c0),
                               max_iter=max_iter, tol=tol,
                               config=RefConfig(k=k, update=update,
                                                compute_dtype=cd))
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.n_iter) == int(ref.n_iter)
    assert bool(port.converged) == bool(ref.converged)
    _close(port.centroids, ref.centroids, "centroids")
    _close(port.inertia, ref.inertia, "inertia")
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))


def test_fit_farthest_reseed_and_float64_input():
    x, c0 = _problem(seed=1)
    c0[1] = 1e3                      # a centroid no row chooses: reseeded
    cfg = dict(k=5, update="delta", empty="farthest")
    port = fit_lloyd(x.astype(np.float64), 5, init=c0, device=CPU,
                     config=KMeansConfig(**cfg))
    ref = kmeans_tpu.fit_lloyd(jnp.asarray(x), 5, init=jnp.asarray(c0),
                               config=RefConfig(**cfg))
    assert port.centroids.dtype == torch.float32
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.n_iter) == int(ref.n_iter)
    _close(port.centroids, ref.centroids, "centroids")


def test_kmeans_estimator_matches_reference():
    x, c0 = _problem(seed=2)
    port = KMeans(n_clusters=5, init=c0, update="delta", device=CPU).fit(x)
    ref = kmeans_tpu.KMeans(n_clusters=5, init=jnp.asarray(c0),
                            update="delta").fit(jnp.asarray(x))
    np.testing.assert_array_equal(port.labels_.numpy(),
                                  np.asarray(ref.labels_))
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.inertia_, ref.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(port.predict(x[:50]).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(x[:50]))))
    np.testing.assert_allclose(port.score(x), ref.score(jnp.asarray(x)),
                               rtol=1e-5)
    _close(port.transform(x[:20]), ref.transform(jnp.asarray(x[:20])))


def test_kmeans_restarts_keep_the_best_and_repeat_under_a_seed():
    x, _ = _problem(seed=3)
    a = KMeans(n_clusters=5, n_init=3, seed=7, device=CPU).fit(x)
    b = KMeans(n_clusters=5, n_init=3, seed=7, device=CPU).fit(x)
    one = KMeans(n_clusters=5, n_init=1, seed=7, device=CPU).fit(x)
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    assert a.inertia_ <= one.inertia_
    # One restart is a plain fit seeded with the estimator's seed.
    plain = fit_lloyd(x, 5, device=CPU, config=KMeansConfig(k=5, seed=7))
    assert torch.equal(one.cluster_centers_, plain.centroids)


def test_convert_round_trip():
    x, c0 = _problem(seed=4)
    ref = kmeans_tpu.fit_lloyd(jnp.asarray(x), 5, init=jnp.asarray(c0),
                               config=RefConfig(k=5, update="delta"))
    port = state_from_numpy(ref, device=CPU)
    back = state_to_numpy(port)
    for name in ("centroids", "labels", "counts", "inertia", "n_iter",
                 "converged"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(back[name], want, err_msg=name)
        assert back[name].dtype == want.dtype, name
    again = state_from_numpy(back, device=CPU)
    for a, b in zip(again, port):
        assert torch.equal(a, b)
    # A port state continues as a port fit from the carried centroids.
    cont = fit_lloyd(x, 5, init=port.centroids, device=CPU,
                     config=KMeansConfig(k=5, update="delta"))
    np.testing.assert_array_equal(cont.labels.numpy(), back["labels"])


def test_kmeans_plus_plus_properties():
    x, _ = _problem(seed=5, n=400)
    xt = torch.from_numpy(x)
    seeds = kmeans_plus_plus(11, xt, 8, device=CPU)
    rows = {tuple(r) for r in x}
    assert seeds.shape == (8, 16) and seeds.dtype == torch.float32
    assert all(tuple(s) in rows for s in seeds.numpy())
    assert len({tuple(s) for s in seeds.numpy()}) == 8
    again = kmeans_plus_plus(torch.Generator().manual_seed(11), xt, 8,
                             device=CPU)
    assert torch.equal(seeds, again)
    assert not torch.equal(seeds, kmeans_plus_plus(12, xt, 8, device=CPU))
    # Zero-weight rows are never chosen.
    w = torch.zeros(400)
    w[:50] = 1.0
    chosen = kmeans_plus_plus(13, xt, 8, weights=w, device=CPU)
    allowed = {tuple(r) for r in x[:50]}
    assert all(tuple(s) in allowed for s in chosen.numpy())


def test_make_blobs_on_cpu():
    x, labels, centres = make_blobs(3, 1000, 7, 4, dtype=torch.bfloat16,
                                    device=CPU)
    assert x.shape == (1000, 7) and x.dtype == torch.bfloat16
    assert labels.dtype == torch.int32 and centres.shape == (4, 7)
    assert int(labels.min()) >= 0 and int(labels.max()) < 4
    resid = x.float() - centres[labels.long()]
    assert 0.8 < float(resid.std()) < 1.2
    again = make_blobs(3, 1000, 7, 4, dtype=torch.bfloat16, device=CPU)[0]
    assert torch.equal(x, again)


def test_unported_update_flavours_raise():
    """Every update flavour is ported; what raises is what the reference
    refuses: the pruned flavours with the farthest-reseed policy.  The
    plan reports the adaptive loop where the reference's does."""
    x, c0 = _problem()
    for update in ("hamerly", "yinyang"):
        cfg = dict(k=5, update=update, empty="farthest")
        with pytest.raises(ValueError, match="farthest"):
            fit_lloyd(x, 5, init=c0, device=CPU, config=KMeansConfig(**cfg))
        with pytest.raises(ValueError, match="farthest"):
            fit_plan(x, 5, config=KMeansConfig(**cfg), device=CPU)
        with pytest.raises(ValueError, match="farthest"):
            kmeans_tpu.fit_lloyd(jnp.asarray(x), 5, init=jnp.asarray(c0),
                                 config=RefConfig(**cfg))
        plan = fit_plan(x, 5, config=KMeansConfig(k=5, update=update),
                        device=CPU)
        assert plan == {"update": update, "backend": "plain",
                        "delta_backend": "plain", "adaptive": False}
    big = np.zeros((AUTO_MIN_ROWS, 2), np.float32)
    for n, adaptive in ((AUTO_MIN_ROWS, True), (AUTO_MIN_ROWS - 1, False)):
        assert fit_plan(big[:n], 3, device=CPU) == {
            "update": "delta", "backend": "plain", "delta_backend": "plain",
            "adaptive": adaptive}
        assert kmeans_tpu.models.lloyd.fit_plan(
            big[:n], 3)["adaptive"] is adaptive
    # "farthest" keeps "auto" off the adaptive loop, as in the reference.
    assert not fit_plan(big, 3, config=KMeansConfig(k=3, empty="farthest"),
                        device=CPU)["adaptive"]
    assert fit_plan(x, 5, device=CPU)["adaptive"] is False
    with pytest.raises(ValueError, match="unknown backend"):
        KMeansConfig(k=5, backend="pallas").validate()


def test_public_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    x, c0 = _problem()
    calls = [
        lambda: fit_lloyd(x, 5, init=c0),
        lambda: KMeans(n_clusters=5).fit(x),
        lambda: make_blobs(0, 10, 2, 2),
        lambda: kmeans_plus_plus(0, x, 3),
        lambda: lloyd_pass(x, c0),
        lambda: delta_pass(x, c0, np.full(600, -1, np.int32),
                           np.zeros((5, 16), np.float32),
                           np.zeros(5, np.float32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="do not take"):
        lloyd_pass(x, c0, backend="cuda", device=CPU)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "import kmeans_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(kmeans_tpu_torch.__path__,"
        " 'kmeans_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'kmeans_tpu'"
        " or m.startswith('kmeans_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
