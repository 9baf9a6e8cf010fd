"""The port's fuzzy c-means against the JAX package's, on the CPU.

Mirrors ``tests/test_fuzzy.py``.  Both fits start from one explicit
``init`` made with numpy; the port runs with ``device="cpu"``.  Labels,
``n_iter`` and ``converged`` must be equal (tie-free blobs); centroids
and soft counts agree to RTOL / ATOL (1e-5: the same f32 terms summed in
other orders), the objective J to RTOL.  In bf16 compute the centroids
and counts agree to BF16_TOL (1e-3) and J to BF16_J_TOL (5e-3): a
membership or centroid coordinate whose last f32 bit differs between the
packages can round to the neighbouring bf16 value, 2⁻⁸ away, before a
product, and J sums the bf16 expanded distances.
Memberships agree to 1e-6 and
every row sums to 1.  The singular rows — one that coincides with a
centroid, one at squared distance 1e-30 — take the reference's one-hot
and ratio-form memberships, with no overflow.  The ``n_init`` restarts
are the port's draws, replayed through the reference
(``tests/torch_replay.py``).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import kmeans_tpu.models.fuzzy as ref_fuzzy_module  # noqa: E402
from kmeans_tpu.config import KMeansConfig as RefConfig  # noqa: E402
from kmeans_tpu.models import FuzzyCMeans as RefFCM  # noqa: E402
from kmeans_tpu.models import fit_fuzzy as ref_fit_fuzzy  # noqa: E402
from kmeans_tpu.models.fuzzy import \
    fuzzy_memberships as ref_memberships  # noqa: E402
import kmeans_tpu_torch.models.fuzzy as port_fuzzy_module  # noqa: E402
from kmeans_tpu_torch import FuzzyCMeans, KMeansConfig, fit_fuzzy  # noqa: E402
from kmeans_tpu_torch.convert import fuzzy_from_numpy  # noqa: E402
from kmeans_tpu_torch.models.fuzzy import fuzzy_memberships  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
ATOL = 1e-5
U_ATOL = 1e-6
BF16_TOL = 1e-3
BF16_J_TOL = 5e-3


def _blobs(seed, n=700, d=6, k=4, std=0.6, spread=4.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, size=n)
    lab[:k] = np.arange(k)
    x = (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)
    return x, x[:k].copy()


def _cfg(cls, k, **kw):
    return cls(k=k, init="given", chunk_size=128, tol=1e-8, max_iter=12,
               **kw)


def _same(got, want, tol=RTOL, j_tol=RTOL):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=tol,
                               atol=max(tol, ATOL))
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=tol, atol=max(tol, ATOL))
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=j_tol)


@pytest.mark.parametrize("case", ["m2", "m1.5", "weights", "bf16"])
def test_fit_fuzzy_matches_the_reference(case):
    x, c0 = _blobs(0)
    m = 1.5 if case == "m1.5" else 2.0
    kw, w = {}, None
    if case == "bf16":
        kw["compute_dtype"] = "bfloat16"
    if case == "weights":
        w = np.random.default_rng(1).uniform(0.5, 2.0, x.shape[0]).astype(
            np.float32)
    want = ref_fit_fuzzy(jnp.asarray(x), 4, m=m, init=jnp.asarray(c0),
                         config=_cfg(RefConfig, 4, **kw),
                         weights=None if w is None else jnp.asarray(w))
    got = fit_fuzzy(x, 4, m=m, init=c0, config=_cfg(KMeansConfig, 4, **kw),
                    weights=w, device=CPU)
    if case == "bf16":
        _same(got, want, BF16_TOL, BF16_J_TOL)
    else:
        _same(got, want)


def test_memberships_match_the_reference():
    x, c0 = _blobs(2)
    u_w = np.asarray(ref_memberships(jnp.asarray(x), jnp.asarray(c0), m=2.0,
                                     chunk_size=100))
    u_g = fuzzy_memberships(x, c0, m=2.0, chunk_size=100,
                            device=CPU).numpy()
    np.testing.assert_allclose(u_g, u_w, atol=U_ATOL)
    np.testing.assert_allclose(u_g.sum(axis=1), 1.0, atol=1e-6)


def test_a_coincident_row_takes_a_one_hot_on_the_first_zero():
    """A row equal to a centroid (and to a duplicate of it) has squared
    distance 0: its membership is one-hot on the first such centroid, as
    the reference's ``argmax`` of the zero mask gives.  Small integer
    coordinates make the expanded distance exactly 0 in both packages."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, size=(50, 6)).astype(np.float32)
    c = x[:4].copy()
    c = np.concatenate([c, c[1:2]])             # centroids 1 and 4 equal
    x[10] = c[1]
    u_w = np.asarray(ref_memberships(jnp.asarray(x), jnp.asarray(c)))
    u_g = fuzzy_memberships(x, c, device=CPU).numpy()
    np.testing.assert_array_equal(u_g[10], np.eye(5)[1])
    np.testing.assert_array_equal(u_g[10], u_w[10])
    np.testing.assert_allclose(u_g, u_w, atol=U_ATOL)


def test_a_row_at_1e_30_stays_finite():
    """A row whose squared distance is 1e-30 (no exact zero): the ratio
    form keeps every powered term in (0, 1], so the naive
    ``d^(-2/(m-1))`` overflow never happens; the row's membership is the
    reference's, ~1 on its nearest centroid."""
    c = np.array([[0.0, 0.0], [3.0, 4.0]], np.float32)
    x = np.array([[1e-15, 0.0], [1.0, 1.0], [2.5, 4.0]], np.float32)
    for m in (2.0, 1.1):
        u_w = np.asarray(ref_memberships(jnp.asarray(x), jnp.asarray(c),
                                         m=m, compute_dtype="float32"))
        u_g = fuzzy_memberships(x, c, m=m, compute_dtype="float32",
                                device=CPU).numpy()
        assert np.isfinite(u_g).all()
        np.testing.assert_allclose(u_g, u_w, atol=U_ATOL)
        assert u_g[0, 0] == pytest.approx(1.0)


def test_estimator_restarts_replay_through_the_reference(monkeypatch):
    """``FuzzyCMeans(n_init=3)``: each restart starts from the port's
    k-means++ draw, replayed through the reference's restarts; both keep
    the lowest-J fit; ``soft_predict`` / ``predict`` of a reference fit
    carried across with ``convert.fuzzy_from_numpy`` are the
    reference's."""
    import torch_replay

    x, _ = _blobs(4)
    inits = []
    with monkeypatch.context() as m:
        torch_replay.record_fit_inputs(m, port_fuzzy_module, inits)
        got = FuzzyCMeans(n_clusters=4, n_init=3, seed=2, max_iter=12,
                          tol=1e-8, chunk_size=128, device=CPU).fit(x)
    used = torch_replay.replay_fit_inputs(monkeypatch, ref_fuzzy_module,
                                          inits)
    want = RefFCM(n_clusters=4, n_init=3, seed=2, max_iter=12, tol=1e-8,
                  chunk_size=128).fit(jnp.asarray(x))
    assert len(inits) == used() == 3
    _same(got.state, want.state)
    carried = FuzzyCMeans(n_clusters=4, device=CPU)
    carried.state = fuzzy_from_numpy(want.state, device=CPU)
    np.testing.assert_allclose(carried.soft_predict(x).numpy(),
                               np.asarray(want.soft_predict(x)),
                               atol=U_ATOL)
    np.testing.assert_array_equal(carried.predict(x).numpy(),
                                  np.asarray(want.predict(x)))
    assert carried.objective_ == want.objective_


def test_fuzziness_error_matches_the_reference():
    x, c0 = _blobs(5, n=40)
    with pytest.raises(ValueError) as want:
        ref_fit_fuzzy(jnp.asarray(x), 4, m=1.0, init=jnp.asarray(c0))
    with pytest.raises(ValueError) as got:
        fit_fuzzy(x, 4, m=1.0, init=c0, device=CPU)
    assert str(got.value) == str(want.value)
