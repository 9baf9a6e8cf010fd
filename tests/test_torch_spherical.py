"""The port's spherical k-means against the JAX package's, on the CPU.

Mirrors ``tests/test_spherical.py``.  Both fits start from one explicit
``init`` array made with numpy; the port runs with ``device="cpu"`` (the
classic sweep's plain version), the reference its XLA route.  On tie-free
data labels and ``n_iter`` must be equal; centroids agree to RTOL / ATOL
(1e-5: both packages sum the same f32 terms in other orders), every
centroid's norm is 1 within 1e-6, and the inertia agrees to RTOL.  The
chunked ``normalize_rows`` gives the whole-array f32 normalization's bits
(f32, and rounded to bf16), and the reference's to two f32 steps.  A
reference fit carried across with ``convert.state_from_numpy`` predicts
the same labels in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import SphericalKMeans as RefSphericalKMeans
from kmeans_tpu.models import fit_spherical as ref_fit_spherical
from kmeans_tpu.models.spherical import normalize_rows as ref_normalize
from kmeans_tpu_torch import KMeansConfig, SphericalKMeans, fit_spherical
from kmeans_tpu_torch.convert import state_from_numpy
from kmeans_tpu_torch.models import spherical
from kmeans_tpu_torch.models.spherical import normalize_rows

CPU = "cpu"
RTOL = 1e-5
ATOL = 1e-5
NORM_TOL = 1e-6
#: Two f32 steps: a row's norm summed in another order.
ULP_RTOL = 2.5e-7


def _directions(seed, n=800, d=12, k=5, spread=0.15):
    """Rows around k unit directions, with random magnitudes (spherical
    k-means must ignore them); the init is the first row of each
    cluster."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(k, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lab = rng.integers(0, k, size=n)
    lab[:k] = np.arange(k)
    x = (dirs[lab] + spread * rng.normal(size=(n, d)))
    x *= rng.uniform(0.5, 20.0, size=(n, 1))
    return x.astype(np.float32), x[:k].astype(np.float32).copy()


def _same(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=RTOL)
    norms = np.linalg.norm(got.centroids.numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=NORM_TOL)


@pytest.mark.parametrize("case", ["f32", "bf16", "weights", "prenorm"])
def test_fit_spherical_matches_the_reference(case):
    x, c0 = _directions(0)
    cfg = dict(init="given", chunk_size=128, tol=0.0, max_iter=15)
    kw, w = {}, None
    if case == "bf16":
        cfg["compute_dtype"] = "bfloat16"
    if case == "weights":
        w = np.random.default_rng(1).uniform(0.5, 2.0, x.shape[0]).astype(
            np.float32)
    if case == "prenorm":
        x = np.asarray(ref_normalize(jnp.asarray(x)))
        kw["pre_normalized"] = True
    want = ref_fit_spherical(
        jnp.asarray(x), 5, init=jnp.asarray(c0), config=RefConfig(k=5, **cfg),
        weights=None if w is None else jnp.asarray(w), **kw)
    got = fit_spherical(x, 5, init=c0, config=KMeansConfig(k=5, **cfg),
                        weights=w, device=CPU, **kw)
    _same(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_normalize_rows_keeps_the_whole_array_bits(dtype,
                                                           monkeypatch):
    """Each row normalized in f32 and rounded to ``dtype``, a block of rows
    at a time (blocks of 7 rows here, a ragged last block and a zero row
    included): the whole-array f32 normalization rounded afterwards, bit
    for bit, and the reference's to ``ULP_RTOL`` (the packages add a row's
    squares in other orders) or, in bf16, one bf16 step."""
    x, _ = _directions(2, n=52)
    x[9] = 0.0
    whole = normalize_rows(torch.from_numpy(x))
    monkeypatch.setattr(spherical, "NORMALIZE_CHUNK", 7)
    got = normalize_rows(torch.from_numpy(x), dtype=dtype)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  whole.to(got.dtype).float().numpy())
    assert not got[9].any()
    want = np.asarray(ref_normalize(jnp.asarray(x)).astype(dtype).astype(
        jnp.float32))
    rtol = ULP_RTOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=0)


def test_estimator_predict_and_similarity_match_the_reference():
    x, c0 = _directions(3)
    want = RefSphericalKMeans(n_clusters=5, init=jnp.asarray(c0),
                              chunk_size=128).fit(jnp.asarray(x))
    got = SphericalKMeans(n_clusters=5, init=c0, chunk_size=128,
                          device=CPU).fit(x)
    _same(got.state, want.state)
    q = _directions(4, n=200)[0]
    np.testing.assert_array_equal(got.predict(q).numpy(),
                                  np.asarray(want.predict(jnp.asarray(q))))
    np.testing.assert_allclose(got.similarity(q).numpy(),
                               np.asarray(want.similarity(jnp.asarray(q))),
                               rtol=RTOL, atol=ATOL)
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=RTOL)


def test_a_reference_fit_carried_across_predicts_alike():
    """A reference fit's state through ``convert.state_from_numpy`` is the
    port's model: its ``predict`` gives the reference's labels."""
    x, c0 = _directions(5)
    want = RefSphericalKMeans(n_clusters=5, init=jnp.asarray(c0)).fit(
        jnp.asarray(x))
    est = SphericalKMeans(n_clusters=5, device=CPU)
    est.state = state_from_numpy(want.state, device=CPU)
    q = _directions(6, n=300)[0]
    np.testing.assert_array_equal(est.predict(q).numpy(),
                                  np.asarray(want.predict(jnp.asarray(q))))


def test_seeded_fit_is_on_the_sphere_and_runs_on_the_card_by_default():
    """k-means++ on the normalized rows (the port's generator), centroids
    unit-norm; without ``device`` the fit wants the card."""
    x, _ = _directions(7)
    st = fit_spherical(x, 5, config=KMeansConfig(k=5, seed=3), device=CPU)
    np.testing.assert_allclose(np.linalg.norm(st.centroids.numpy(), axis=1),
                               1.0, atol=NORM_TOL)
    assert st.labels.shape == (x.shape[0],)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit_spherical(x, 5)
