"""The port's bisecting k-means, x-means and g-means against the JAX
package's, on the CPU.

Mirrors ``tests/test_bisecting.py``, ``tests/test_xmeans.py`` and
``tests/test_gmeans.py``.  These families seed their own inner 2-means fits
(the port from one :class:`torch.Generator`, the reference from
``jax.random`` keys), so each test records the port's inner starts and
replays them through the reference's ``fit_lloyd`` name
(``tests/torch_replay.py``); then every split is the same split.  On
separated blobs labels, the split count, the discovered k and ``n_iter``
must be equal; centroids and counts agree to RTOL / ATOL (1e-5) and the
inertia to ``INERTIA_RTOL`` (1e-5) plus ``INERTIA_ATOL_REL`` (1e-6) of
Σ w·‖x‖² (the packages round each row's expanded distance and sum the
rows in other orders; ``_same`` says why).  ``bic_score`` is the same
host arithmetic and must agree to 1e-12; ``anderson_darling_normal`` uses
``torch.special.ndtr`` in f64 where the reference uses jax's in f32, and
agrees to ``AD_RTOL`` (1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu.models.bisecting as ref_bisecting
import kmeans_tpu.models.xmeans as ref_xmeans
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import (BisectingKMeans as RefBisectingKMeans,
                               GMeans as RefGMeans, XMeans as RefXMeans,
                               anderson_darling_normal as ref_ad,
                               bic_score as ref_bic, fit_bisecting as ref_bis,
                               fit_gmeans as ref_gmeans,
                               fit_xmeans as ref_xmeans_fit)
import kmeans_tpu_torch.models.bisecting as port_bisecting
from kmeans_tpu_torch import KMeansConfig
from kmeans_tpu_torch.convert import state_from_numpy
from kmeans_tpu_torch.models import (BisectingKMeans, GMeans, XMeans,
                                     anderson_darling_normal, bic_score,
                                     fit_bisecting, fit_gmeans, fit_xmeans)
from torch_replay import record_fit_lloyd, replay_fit_lloyd

CPU = "cpu"
RTOL = 1e-5
ATOL = 1e-5
INERTIA_RTOL = 1e-5
INERTIA_ATOL_REL = 1e-6
#: The reference evaluates the normal CDF in f32 (jax with x64 off), the
#: port in f64: the statistic agrees to the f32 rounding of each term.
AD_RTOL = 1e-5


def _blobs(seed, n=1200, d=6, k=5, std=0.4, spread=6.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, size=n)
    return (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)


def _same(got, want, x=None, *, labels=True):
    if labels:
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    assert tuple(got.centroids.shape) == tuple(want.centroids.shape)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=RTOL, atol=ATOL)
    # Each row's ‖x−c‖² is ‖x‖² − 2·x·c + ‖c‖² in f32, rounded to a few
    # steps of ‖x‖² (far above ‖x−c‖² on tight blobs), so two summation
    # orders agree to INERTIA_ATOL_REL of Σ ‖x‖², not to a share of the
    # inertia itself.
    atol = 0.0 if x is None else INERTIA_ATOL_REL * float(
        (np.asarray(x, np.float64) ** 2).sum())
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=INERTIA_RTOL, atol=atol)


def _replayed(monkeypatch, run_port, run_ref, ref_module):
    """``(port state, reference state)``: the port's run with its inner
    starts recorded, then the reference's with them replayed."""
    inits = []
    with monkeypatch.context() as m:
        record_fit_lloyd(m, port_bisecting, inits)
        got = run_port()
    used = replay_fit_lloyd(monkeypatch, ref_module, inits)
    want = run_ref()
    assert used() == len(inits) > 0
    return got, want


@pytest.mark.parametrize("strategy", ["biggest_inertia", "largest_cluster"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bisecting_matches_the_reference(monkeypatch, strategy, weighted):
    x = _blobs(0)
    w = (np.random.default_rng(1).uniform(0.5, 2.0, x.shape[0]).astype(
        np.float32) if weighted else None)
    cfg = dict(seed=3, chunk_size=256)
    got, want = _replayed(
        monkeypatch,
        lambda: fit_bisecting(x, 6, config=KMeansConfig(k=6, **cfg),
                              strategy=strategy, weights=w, device=CPU),
        lambda: ref_bis(jnp.asarray(x), 6, config=RefConfig(k=6, **cfg),
                        strategy=strategy,
                        weights=None if w is None else jnp.asarray(w)),
        ref_bisecting)
    _same(got, want, x if w is None else x * np.sqrt(w)[:, None])
    assert int(got.n_iter) == 5


def test_bisecting_stops_when_nothing_splits(monkeypatch):
    """Three distinct points and k = 6: two splits, then no cluster has two
    members; the empty slots duplicate centroid 0 with zero counts."""
    x = np.repeat(np.array([[0.0, 0.0], [5.0, 5.0], [9.0, -3.0]],
                           np.float32), 4, axis=0)
    got, want = _replayed(
        monkeypatch,
        lambda: fit_bisecting(x, 6, config=KMeansConfig(k=6), device=CPU),
        lambda: ref_bis(jnp.asarray(x), 6, config=RefConfig(k=6)),
        ref_bisecting)
    _same(got, want, x)
    assert not bool(got.converged) and int(got.n_iter) == 2


def test_bisecting_refusals_match_the_reference():
    x = _blobs(2, n=50)
    for kw in (dict(strategy="worst"),
               dict(config=KMeansConfig(k=3, init="given"))):
        with pytest.raises(ValueError) as got:
            fit_bisecting(x, 3, device=CPU, **kw)
        ref_kw = dict(kw)
        if "config" in ref_kw:
            ref_kw["config"] = RefConfig(k=3, init="given")
        with pytest.raises(ValueError) as want:
            ref_bis(jnp.asarray(x), 3, **ref_kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k_min", [1, 3])
def test_xmeans_matches_the_reference(monkeypatch, k_min):
    x = _blobs(4, k=6)
    cfg = dict(seed=5, chunk_size=256)
    got, want = _replayed(
        monkeypatch,
        lambda: fit_xmeans(x, 12, k_min=k_min,
                           config=KMeansConfig(k=k_min, **cfg), device=CPU),
        lambda: ref_xmeans_fit(jnp.asarray(x), 12, k_min=k_min,
                               config=RefConfig(k=k_min, **cfg)),
        ref_xmeans)
    _same(got, want, x)
    assert got.centroids.shape[0] == 6


@pytest.mark.parametrize("alpha", [0.01, 0.10])
def test_gmeans_matches_the_reference(monkeypatch, alpha):
    x = _blobs(6, n=800, k=4)
    cfg = dict(seed=7, chunk_size=256)
    got, want = _replayed(
        monkeypatch,
        lambda: fit_gmeans(x, 6, alpha=alpha,
                           config=KMeansConfig(k=1, **cfg), device=CPU),
        lambda: ref_gmeans(jnp.asarray(x), 6, alpha=alpha,
                           config=RefConfig(k=1, **cfg)),
        ref_xmeans)
    _same(got, want, x)


def test_auto_k_reaches_k_max_and_max_rounds(monkeypatch):
    """The loop stops at k_max (not converged) and after max_rounds, as the
    reference's does."""
    x = _blobs(8, k=8)
    for kw in (dict(k_max=3), dict(k_max=16, max_rounds=1)):
        got, want = _replayed(
            monkeypatch,
            lambda: fit_xmeans(x, device=CPU, config=KMeansConfig(k=1),
                               **kw),
            lambda: ref_xmeans_fit(jnp.asarray(x), config=RefConfig(k=1),
                                   **kw),
            ref_xmeans)
        _same(got, want, x)
        assert not bool(got.converged)
        monkeypatch.undo()


def test_auto_k_refusals_match_the_reference():
    x = _blobs(9, n=60)
    cases = [
        (lambda: fit_xmeans(x, 2, k_min=3, device=CPU),
         lambda: ref_xmeans_fit(jnp.asarray(x), 2, k_min=3)),
        (lambda: fit_gmeans(x, 4, alpha=0.2, device=CPU),
         lambda: ref_gmeans(jnp.asarray(x), 4, alpha=0.2)),
        (lambda: fit_gmeans(x, 4, config=KMeansConfig(k=1, init="given"),
                            device=CPU),
         lambda: ref_gmeans(jnp.asarray(x), 4,
                            config=RefConfig(k=1, init="given"))),
    ]
    for got_call, want_call in cases:
        with pytest.raises(ValueError) as got:
            got_call()
        with pytest.raises(ValueError) as want:
            want_call()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [
    (100.0, 4, 1, 250.0, [100.0]),
    (100.0, 4, 2, 120.0, [55.0, 45.0]),
    (10.0, 3, 2, 0.0, [5.0, 5.0]),          # point masses: +inf
    (2.0, 3, 2, 1.0, [1.0, 1.0]),           # n <= k: -inf
    (50.0, 2, 3, 10.0, [20.0, 30.0, 0.0]),  # an empty cluster: -inf
])
def test_bic_score_matches_the_reference(args):
    got, want = bic_score(*args), ref_bic(*args)
    assert got == want or abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("case", ["normal", "bimodal", "small", "constant"])
def test_anderson_darling_matches_the_reference(case):
    rng = np.random.default_rng(10)
    z = {"normal": rng.normal(size=400),
         "bimodal": np.concatenate([rng.normal(-3, 1, 200),
                                    rng.normal(3, 1, 200)]),
         "small": rng.normal(size=7),
         "constant": np.full(40, 2.5)}[case]
    got, want = anderson_darling_normal(z), ref_ad(z)
    np.testing.assert_allclose(got, want, rtol=AD_RTOL, atol=1e-12)


@pytest.mark.parametrize("family", ["bisecting", "xmeans", "gmeans"])
def test_estimators_and_carried_fits_predict_alike(monkeypatch, family):
    """The estimators fit what the functions fit (the reference's
    estimators from the replayed starts), and a reference fit carried
    across with ``convert.state_from_numpy`` predicts the reference's
    labels in the port."""
    x = _blobs(11, k=4)
    port_est = {"bisecting": BisectingKMeans(n_clusters=4, seed=2,
                                             device=CPU),
                "xmeans": XMeans(k_max=8, seed=2, device=CPU),
                "gmeans": GMeans(k_max=8, seed=2, device=CPU)}[family]
    ref_est = {"bisecting": RefBisectingKMeans(n_clusters=4, seed=2),
               "xmeans": RefXMeans(k_max=8, seed=2),
               "gmeans": RefGMeans(k_max=8, seed=2)}[family]
    module = ref_bisecting if family == "bisecting" else ref_xmeans
    got, want = _replayed(monkeypatch, lambda: port_est.fit(x),
                          lambda: ref_est.fit(jnp.asarray(x)), module)
    _same(got.state, want.state, x)
    q = _blobs(12, n=300, k=4)
    np.testing.assert_array_equal(got.predict(q).numpy(),
                                  np.asarray(want.predict(jnp.asarray(q))))
    carried = {"bisecting": BisectingKMeans(device=CPU),
               "xmeans": XMeans(device=CPU),
               "gmeans": GMeans(device=CPU)}[family]
    carried.state = state_from_numpy(want.state, device=CPU)
    np.testing.assert_array_equal(carried.predict(q).numpy(),
                                  np.asarray(want.predict(jnp.asarray(q))))


def test_auto_k_fits_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = _blobs(13, n=40)
    for call in (lambda: fit_bisecting(x, 2), lambda: fit_xmeans(x, 3),
                 lambda: fit_gmeans(x, 3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
