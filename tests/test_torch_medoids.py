"""The port's k-medoids (``kmeans_tpu_torch.models.medoids``) against the
JAX package's, on the CPU.

Both packages get the same numpy inputs and explicit medoid indices, or
the port's draws (the D-sampling init, ``init="random"``) replayed
through the reference (``tests/torch_replay.py``).  Medoid indices,
medoid rows, labels and iteration counts must be equal (tie-free blobs on
a 1/8 grid: two rows reach the same cost only within f32 summation
order); the inertia agrees to RTOL (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import medoids as ref_medoids
from kmeans_tpu_torch import convert
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.models import medoids as port_medoids

RTOL = 1e-5
CPU = "cpu"


def _blobs(seed, n, d, k, std=0.6, spread=3.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, size=n)
    return (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)


# Rows on a 1/8 grid: every product and squared norm is exact in f32, so
# both packages compute the same distances (the expanded form's rounding
# in ‖x‖² − 2x·y + ‖y‖² would otherwise put sqrt noise of order 1e-3 on a
# row's distance to itself, enough to swap two near-central candidates).
X = np.round(_blobs(0, 400, 6, 4) * 8.0) / 8.0
IDX0 = np.array([0, 1, 2, 3], np.int32)
W = np.random.default_rng(3).uniform(0.5, 2.0, 400).astype(np.float32)
W[::9] = 0.0


def _pair(*, config=None, **kw):
    cfg = dict(k=4, chunk_size=64) if config is None else config
    ref_kw = {name: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for name, v in kw.items()}
    want = ref_medoids.fit_kmedoids(jnp.asarray(X), 4,
                                    config=RefConfig(**cfg), **ref_kw)
    got = port_medoids.fit_kmedoids(X, 4, config=KMeansConfig(**cfg),
                                    device=CPU, **kw)
    return got, want


def _assert_state(got, want):
    np.testing.assert_array_equal(got.medoid_indices.numpy(),
                                  np.asarray(want.medoid_indices))
    np.testing.assert_array_equal(got.medoids.numpy(),
                                  np.asarray(want.medoids))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=RTOL)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
@pytest.mark.parametrize("chunk", [64, 4096])
def test_fit_matches_the_reference(metric, chunk):
    """From the same indices, on uneven (64) and whole (4096) tiles."""
    _assert_state(*_pair(init=IDX0, metric=metric,
                         config=dict(k=4, chunk_size=chunk)))


def test_weights_match_the_reference():
    _assert_state(*_pair(init=IDX0, weights=W))


def test_zero_weight_rows_are_never_medoids():
    """A zero-weight row costs +inf, so it is never chosen, even where its
    position would be the best exemplar; the reference chooses the same."""
    got, want = _pair(init=np.array([1, 2, 3, 4], np.int32), weights=W)
    _assert_state(got, want)
    assert np.all(W[got.medoid_indices.numpy()] > 0)


def test_a_cluster_that_empties_keeps_its_medoid():
    """Two medoids on rows with the same coordinates: every row ties to the
    lower index, the other cluster is empty and keeps its medoid."""
    x = X.copy()
    x[6] = x[5]
    idx = np.array([5, 6, 100, 200], np.int32)
    for max_iter in (1, 10):
        want = ref_medoids.fit_kmedoids(jnp.asarray(x), 4,
                                        init=jnp.asarray(idx),
                                        max_iter=max_iter)
        got = port_medoids.fit_kmedoids(x, 4, init=idx, max_iter=max_iter,
                                        device=CPU)
        _assert_state(got, want)
    one = port_medoids.fit_kmedoids(x, 4, init=idx, max_iter=1, device=CPU)
    assert int(one.medoid_indices[1]) == 6


@pytest.mark.parametrize("init", ["k-means++", "random"])
def test_seeded_estimator_replays_the_ports_draws(monkeypatch, init):
    """``KMedoids(n_init=2)`` with ``init`` drawn by the port (D-sampling,
    each pick an assignment against one row; or distinct uniform rows),
    the indices replayed through the reference: the same best start."""
    from torch_replay import record_calls

    starts = []
    record_calls(monkeypatch, port_medoids, "resolve_medoid_init", starts)
    est = port_medoids.KMedoids(n_clusters=4, init=init, n_init=2, seed=6,
                                chunk_size=64, device=CPU).fit(X, weights=W)
    assert len(starts) == 2
    for idx in starts:
        assert len(set(idx.tolist())) == 4
        if init == "k-means++":
            assert np.all(W[idx] > 0)
    it = iter(starts)
    monkeypatch.setattr(ref_medoids, "resolve_medoid_init",
                        lambda *a, **kw: jnp.asarray(next(it)))
    ref = ref_medoids.KMedoids(n_clusters=4, init=init, n_init=2, seed=6,
                               chunk_size=64).fit(jnp.asarray(X),
                                                  weights=jnp.asarray(W))
    _assert_state(est.state, ref.state)
    xn = _blobs(9, 50, 6, 4)
    np.testing.assert_array_equal(est.predict(xn).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(xn))))


def test_d_sampling_draws_are_distinct_real_rows():
    """The port's D-sampling: k distinct rows, none of zero weight (log 0
    is −inf), and a seed reproduces them."""
    cfg = KMeansConfig(k=6, seed=2)
    a = port_medoids.fit_kmedoids(X, 6, config=cfg, weights=W, max_iter=0,
                                  device=CPU)
    b = port_medoids.fit_kmedoids(X, 6, config=cfg, weights=W, max_iter=0,
                                  device=CPU)
    idx = a.medoid_indices.numpy()
    assert len(set(idx.tolist())) == 6 and np.all(W[idx] > 0)
    np.testing.assert_array_equal(idx, b.medoid_indices.numpy())


def test_a_reference_fit_carried_across_predicts_the_same():
    """``convert.kmedoids_from_numpy`` / ``kmedoids_to_numpy``: a
    reference state predicts the same in the port, and a port state
    rebuilds the reference's."""
    ref = ref_medoids.KMedoids(n_clusters=4, init=jnp.asarray(IDX0)).fit(
        jnp.asarray(X))
    est = port_medoids.KMedoids(n_clusters=4, device=CPU)
    est.state = convert.kmedoids_from_numpy(ref.state._asdict(), device=CPU)
    xn = _blobs(9, 50, 6, 4)
    np.testing.assert_array_equal(est.predict(xn).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(xn))))
    back = ref_medoids.KMedoidsState(**convert.kmedoids_to_numpy(est.state))
    np.testing.assert_array_equal(np.asarray(back.medoid_indices),
                                  np.asarray(ref.state.medoid_indices))


@pytest.mark.parametrize("case", ["metric", "shape", "range", "given"])
def test_guards_raise_the_references_errors(case):
    kw = {"metric": dict(metric="cityblock"),
          "shape": dict(init=IDX0[:3]),
          "range": dict(init=np.array([0, 1, 2, 400], np.int32)),
          "given": dict(config="given")}[case]
    port_kw, ref_kw = dict(kw), dict(kw)
    if "config" in kw:
        port_kw["config"] = KMeansConfig(k=4, init="given")
        ref_kw["config"] = RefConfig(k=4, init="given")
    if "init" in kw:
        ref_kw["init"] = jnp.asarray(kw["init"])
    with pytest.raises(ValueError) as got:
        port_medoids.fit_kmedoids(X, 4, device=CPU, **port_kw)
    with pytest.raises(ValueError) as want:
        ref_medoids.fit_kmedoids(jnp.asarray(X), 4, key=jax.random.key(0),
                                 **ref_kw)
    assert str(got.value) == str(want.value)
