"""The port's kernel k-means (``kmeans_tpu_torch.models.kernel``) against
the JAX package's, on the CPU.

Both packages get the same numpy inputs: explicit (n,) init labels, or the
port's seeding replayed through the reference (``tests/torch_replay.py``).
Labels and iteration counts must be equal (tie-free blobs); the objective
and the counts agree to RTOL (1e-5) and the within-cluster mass T to
T_RTOL (1e-4: T sums n·k products of f32 kernel values in other orders);
Nyström features to NYS_ATOL (1e-4) on values of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import kernel as ref_kernel
from kmeans_tpu_torch import convert
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.models import kernel as port_kernel

RTOL = 1e-5
T_RTOL = 1e-4
NYS_ATOL = 1e-4
CPU = "cpu"


def _blobs(seed, n, d, k, std=0.6, spread=3.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, size=n)
    return (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)


X = _blobs(0, 400, 6, 4)
LAB0 = np.random.default_rng(1).integers(0, 4, 400).astype(np.int32)
XNEW = _blobs(2, 64, 6, 4)


def _pair(kernel="rbf", *, config=None, **kw):
    """The reference's and the port's fit on the same inputs."""
    cfg = dict(k=4, chunk_size=128) if config is None else config
    ref_kw = {name: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for name, v in kw.items()}
    want = ref_kernel.fit_kernel_kmeans(
        jnp.asarray(X), 4, kernel=kernel, config=RefConfig(**cfg), **ref_kw)
    got = port_kernel.fit_kernel_kmeans(
        X, 4, kernel=kernel, config=KMeansConfig(**cfg), device=CPU, **kw)
    return got, want


def _assert_state(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=RTOL)
    np.testing.assert_allclose(got.within_mass.numpy(),
                               np.asarray(want.within_mass), rtol=T_RTOL)


@pytest.mark.parametrize("kernel,kw", [
    ("rbf", {}), ("rbf", dict(gamma=0.5)), ("linear", {}),
    ("poly", dict(degree=3, coef0=1.0, gamma=0.05)),
    ("poly", dict(degree=2, coef0=0.5))],
    ids=["rbf", "rbf-gamma", "linear", "poly3", "poly2"])
def test_fit_matches_the_reference(kernel, kw):
    """Every kernel from the same labels: the same passes and labels."""
    _assert_state(*_pair(kernel, init=LAB0, max_iter=30, **kw))


def test_bf16_compute_keeps_the_tile_cast():
    """bf16 compute: the kernel tile is rounded to bf16 before the one-hot
    product, as the reference's is (l.108); the labels agree."""
    got, want = _pair("rbf", init=LAB0, max_iter=30, config=dict(
        k=4, chunk_size=128, compute_dtype="bfloat16"))
    _assert_state(got, want)


def test_weights_and_centroid_init_match_the_reference():
    """Fractional weights (a tenth of them 0) and a (k, d) centroid init
    (one assignment through ``assign``, K1 on the card)."""
    w = np.random.default_rng(3).uniform(0.5, 2.0, 400).astype(np.float32)
    w[::10] = 0.0
    _assert_state(*_pair("rbf", init=X[:4].copy(), weights=w, max_iter=30))


def test_linear_objective_is_the_partition_inertia():
    """The reference's oracle (its ``tests/test_kernel.py``): with the
    linear kernel the objective is Lloyd's inertia of the partition, in
    f64, also when ``max_iter`` stops the fit unconverged."""
    for max_iter in (1, 30):
        st = port_kernel.fit_kernel_kmeans(
            X, 4, kernel="linear", init=LAB0, max_iter=max_iter,
            config=KMeansConfig(k=4, chunk_size=64), device=CPU)
        lab = st.labels.numpy()
        x = X.astype(np.float64)
        want = sum(((x[lab == c] - x[lab == c].mean(0)) ** 2).sum()
                   for c in range(4) if np.any(lab == c))
        np.testing.assert_allclose(float(st.objective), want, rtol=1e-5)
        assert bool(st.converged) == (max_iter == 30)


def test_empty_cluster_stays_empty():
    """A cluster no row starts in has N = 0: masked to +inf, it stays
    empty, in both packages."""
    lab = np.where(LAB0 == 3, 2, LAB0).astype(np.int32)
    got, want = _pair("rbf", init=lab, max_iter=30)
    _assert_state(got, want)
    assert float(got.counts[3]) == 0.0
    assert not np.any(got.labels.numpy() == 3)


def test_kernel_assign_matches_the_reference_and_the_training_labels():
    """``kernel_assign`` with the fit's cached T and without it (T rebuilt
    from the training set) gives the reference's labels on new rows and
    the training labels on the training rows."""
    st = port_kernel.fit_kernel_kmeans(X, 4, init=LAB0, max_iter=30,
                                       config=KMeansConfig(k=4), device=CPU)
    for mass in (st.within_mass, None):
        got = port_kernel.kernel_assign(XNEW, X, st.labels, k=4,
                                        within_mass=mass, chunk_size=32,
                                        device=CPU)
        want = ref_kernel.kernel_assign(
            jnp.asarray(XNEW), jnp.asarray(X), jnp.asarray(st.labels.numpy()),
            k=4, within_mass=None if mass is None else jnp.asarray(
                mass.numpy()), chunk_size=32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        train = port_kernel.kernel_assign(X, X, st.labels, k=4,
                                          within_mass=mass, device=CPU)
        np.testing.assert_array_equal(train.numpy(), st.labels.numpy())


def test_estimator_replays_the_ports_seeding(monkeypatch):
    """``KernelKMeans(n_init=2)``: each start's labels are seeded by the
    port (k-means++ and one assignment) and replayed through the
    reference; the best start by objective, its ``predict`` and the
    counts agree."""
    starts = []
    real = port_kernel._resolve_labels0

    def record(*a, **kw):
        lab = real(*a, **kw)
        starts.append(lab.numpy().copy())
        return lab

    monkeypatch.setattr(port_kernel, "_resolve_labels0", record)
    est = port_kernel.KernelKMeans(n_clusters=4, n_init=2, seed=4,
                                   max_iter=30, chunk_size=128,
                                   device=CPU).fit(X)
    assert len(starts) == 2
    it = iter(starts)
    monkeypatch.setattr(ref_kernel, "_resolve_labels0",
                        lambda *a, **kw: jnp.asarray(next(it)))
    ref = ref_kernel.KernelKMeans(n_clusters=4, n_init=2, seed=4,
                                  max_iter=30, chunk_size=128).fit(
        jnp.asarray(X))
    _assert_state(est.state, ref.state)
    np.testing.assert_array_equal(est.predict(XNEW).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(XNEW))))


def test_a_reference_fit_carried_across_predicts_the_same():
    """``convert.kernel_from_numpy``: a reference fit (labels, counts,
    ``within_mass``) with the rows and weights it saw predicts in the port
    what it predicts in the reference."""
    w = np.random.default_rng(5).uniform(0.5, 1.5, 400).astype(np.float32)
    ref = ref_kernel.KernelKMeans(n_clusters=4, init=jnp.asarray(LAB0),
                                  max_iter=30).fit(jnp.asarray(X),
                                                   weights=jnp.asarray(w))
    est = port_kernel.KernelKMeans(n_clusters=4, device=CPU)
    est.state, est._x_fit, est._w_fit = convert.kernel_from_numpy(
        ref.state._asdict(), X, w, device=CPU)
    np.testing.assert_array_equal(est.predict(XNEW).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(XNEW))))


@pytest.mark.parametrize("kernel,m", [("rbf", 24), ("linear", 5),
                                      ("poly", 24)])
def test_nystrom_features_match_the_reference(kernel, m):
    """From the same landmarks: K_mm^{-1/2} = U f(S) Uᵀ does not depend on
    the signs ``eigh`` picks, so the features compare directly.  (The
    linear kernel's K_mm has rank d: past d landmarks its floored
    eigenvalues amplify rounding noise a thousandfold in either package,
    so it runs at m = 5 < d.)"""
    lm = X[::13][:m].copy()
    got = port_kernel.nystrom_features(X, m, kernel=kernel, landmarks=lm,
                                       chunk_size=128, device=CPU).numpy()
    want = np.asarray(ref_kernel.nystrom_features(
        jnp.asarray(X), m, kernel=kernel, landmarks=jnp.asarray(lm),
        chunk_size=128))
    assert got.shape == (400, m)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=NYS_ATOL * scale)


def test_nystrom_landmark_draw_is_replayed(monkeypatch):
    """Default landmarks: m distinct rows from the port's generator; the
    same rows replayed through ``jax.random.choice`` give the reference's
    features."""
    from torch_replay import replay_jax_random

    idx = torch.randperm(400, generator=torch.Generator().manual_seed(0))[:20]
    got = port_kernel.nystrom_features(X, 20, chunk_size=128,
                                       device=CPU).numpy()
    replay_jax_random(monkeypatch, "choice", [idx.numpy()])
    want = np.asarray(ref_kernel.nystrom_features(jnp.asarray(X), 20,
                                                  chunk_size=128))
    np.testing.assert_allclose(got, want, atol=NYS_ATOL)


def _errors(call_port, call_ref):
    with pytest.raises(ValueError) as got:
        call_port()
    with pytest.raises(ValueError) as want:
        call_ref()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", [
    "kernel", "gamma", "label shape", "float labels", "init shape",
    "nystrom m", "nystrom landmarks"])
def test_guards_raise_the_references_errors(case):
    x = X[:40]
    cases = {
        "kernel": dict(kernel="cosine"),
        "gamma": dict(gamma=0.0),
        "label shape": dict(init=LAB0[:39]),
        "float labels": dict(init=LAB0[:40].astype(np.float32)),
        "init shape": dict(init=X[:3].copy()),
    }
    if case in cases:
        kw = cases[case]
        ref_kw = {n: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for n, v in kw.items()}
        _errors(lambda: port_kernel.fit_kernel_kmeans(x, 4, device=CPU,
                                                      **kw),
                lambda: ref_kernel.fit_kernel_kmeans(
                    jnp.asarray(x), 4, key=jax.random.key(0), **ref_kw))
    elif case == "nystrom m":
        _errors(lambda: port_kernel.nystrom_features(x, 41, device=CPU),
                lambda: ref_kernel.nystrom_features(jnp.asarray(x), 41))
    else:
        _errors(lambda: port_kernel.nystrom_features(
                    x, 4, landmarks=X[:4, :5].copy(), device=CPU),
                lambda: ref_kernel.nystrom_features(
                    jnp.asarray(x), 4, landmarks=jnp.asarray(X[:4, :5])))
