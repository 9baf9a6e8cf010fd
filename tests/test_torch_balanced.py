"""The port's balanced (Sinkhorn) k-means against the JAX package's, on
the CPU.

Mirrors ``tests/test_balanced.py``.  Both fits start from one explicit
``init`` made with numpy, with ``SWEEPS`` Sinkhorn sweeps (the default
200 is the card's; 20 keep the suite fast and already balance these
blobs); the port runs with ``device="cpu"``.  Labels, ``n_iter``,
``converged`` and the hard counts must be equal (no row sits near a tie
of ``d² − g``); centroids, inertia and the soft column masses agree to
RTOL / ATOL (1e-5: the two packages' logsumexps sum the same f32 terms in
other orders), the potentials to POT_ATOL (1e-4 of the distances' scale,
200 sweeps of those sums).  Zero-weight rows carry ``log a = −inf``: they
get a −inf potential and no plan mass, and nothing turns NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import BalancedKMeans as RefBalanced
from kmeans_tpu.models import fit_balanced as ref_fit_balanced
from kmeans_tpu.models.balanced import \
    resolve_capacities as ref_capacities
from kmeans_tpu.models.balanced import \
    sinkhorn_potentials as ref_potentials
from kmeans_tpu_torch import BalancedKMeans, KMeansConfig, fit_balanced
from kmeans_tpu_torch.convert import balanced_from_numpy
from kmeans_tpu_torch.models.balanced import (resolve_capacities,
                                              sinkhorn_potentials)

CPU = "cpu"
RTOL = 1e-5
ATOL = 1e-5
POT_ATOL = 1e-4
SWEEPS = 20


def _blobs(seed, n=600, d=5, k=4, std=0.6, spread=4.0, sizes=None):
    """Blobs of unequal sizes (``sizes`` fractions), so balancing moves
    rows; the init is the first row of each blob."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * spread
    p = None if sizes is None else np.asarray(sizes) / np.sum(sizes)
    lab = rng.choice(k, size=n, p=p)
    lab[:k] = np.arange(k)
    x = (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)
    return x, x[:k].copy()


def _cfg(cls, k, **kw):
    return cls(k=k, init="given", tol=1e-6, max_iter=8, **kw)


def _same(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    for name in ("centroids", "col_masses"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=RTOL)


@pytest.mark.parametrize("case", ["uniform", "capacities", "weights",
                                  "raw epsilon"])
def test_fit_balanced_matches_the_reference(case):
    x, c0 = _blobs(0, sizes=[0.4, 0.3, 0.2, 0.1])
    kw, w = dict(sinkhorn_sweeps=SWEEPS), None
    if case == "capacities":
        kw["capacities"] = [1.0, 2.0, 3.0, 4.0]
    if case == "weights":
        w = np.random.default_rng(1).uniform(0.5, 2.0, x.shape[0]).astype(
            np.float32)
    if case == "raw epsilon":
        kw.update(epsilon=2.0, normalize_epsilon=False)
    want = ref_fit_balanced(jnp.asarray(x), 4, init=jnp.asarray(c0),
                            config=_cfg(RefConfig, 4),
                            weights=None if w is None else jnp.asarray(w),
                            **kw)
    got = fit_balanced(x, 4, init=c0, config=_cfg(KMeansConfig, 4),
                       weights=w, device=CPU, **kw)
    _same(got, want)
    # The column masses are the capacities (sum 1).
    cap = resolve_capacities(4, kw.get("capacities"))
    np.testing.assert_allclose(got.col_masses.numpy(), cap.numpy(),
                               rtol=1e-4)


def test_sinkhorn_potentials_match_the_reference():
    rng = np.random.default_rng(2)
    d2 = rng.uniform(0.0, 10.0, size=(300, 6)).astype(np.float32)
    log_a = np.full(300, -np.log(300.0), np.float32)
    log_b = np.log(rng.dirichlet(np.ones(6))).astype(np.float32)
    f_w, g_w = ref_potentials(jnp.asarray(d2), jnp.asarray(log_a),
                              jnp.asarray(log_b), epsilon=0.5, sweeps=50)
    f_g, g_g = sinkhorn_potentials(torch.from_numpy(d2),
                                   torch.from_numpy(log_a),
                                   torch.from_numpy(log_b), epsilon=0.5,
                                   sweeps=50)
    np.testing.assert_allclose(f_g.numpy(), np.asarray(f_w), atol=POT_ATOL)
    np.testing.assert_allclose(g_g.numpy(), np.asarray(g_w), atol=POT_ATOL)
    # The column update runs last: the plan's columns carry exp(log_b).
    plan = np.exp((f_g.numpy()[:, None] + g_g.numpy()[None, :] - d2) / 0.5)
    np.testing.assert_allclose(plan.sum(axis=0), np.exp(log_b), rtol=1e-4)


def test_zero_weight_rows_carry_no_mass_and_no_nan():
    """A third of the rows at weight 0: their log row mass is −inf, their
    potential −inf and their plan row 0; the fit is the reference's, every
    output finite, and the zero-weight rows count in no cluster."""
    x, c0 = _blobs(3, sizes=[0.5, 0.2, 0.2, 0.1])
    w = np.ones(x.shape[0], np.float32)
    w[4::3] = 0.0
    kw = dict(sinkhorn_sweeps=SWEEPS)
    want = ref_fit_balanced(jnp.asarray(x), 4, init=jnp.asarray(c0),
                            config=_cfg(RefConfig, 4), weights=jnp.asarray(w),
                            **kw)
    got = fit_balanced(x, 4, init=c0, config=_cfg(KMeansConfig, 4),
                       weights=w, device=CPU, **kw)
    _same(got, want)
    for t in got:
        assert not torch.isnan(t.float()).any()
    assert float(got.counts.sum()) == float(w.sum())
    # Row potentials of the zero-weight rows are -inf, never NaN.
    d2 = np.random.default_rng(4).uniform(0, 5, size=(6, 3)).astype(
        np.float32)
    log_a = torch.tensor([-np.inf, np.log(0.5), -np.inf, np.log(0.25),
                          np.log(0.25), -np.inf])
    f, g = sinkhorn_potentials(torch.from_numpy(d2), log_a.float(),
                               torch.log(torch.full((3,), 1 / 3)),
                               epsilon=0.5, sweeps=5)
    assert torch.isinf(f[log_a == -np.inf]).all()
    assert torch.isfinite(g).all() and not torch.isnan(f).any()


def test_estimator_predicts_the_nearest_centroid_like_the_reference():
    """``BalancedKMeans`` fits as the reference's (same n_iter and labels)
    and predicts unconstrained nearest-centroid labels (K1 on the card, its
    plain version here); a reference fit carried across with
    ``convert.balanced_from_numpy`` predicts the reference's labels."""
    x, c0 = _blobs(5, sizes=[0.4, 0.3, 0.2, 0.1])
    kw = dict(n_clusters=4, init=c0, sinkhorn_sweeps=SWEEPS, max_iter=8)
    ref = RefBalanced(**dict(kw, init=jnp.asarray(c0))).fit(jnp.asarray(x))
    got = BalancedKMeans(device=CPU, **kw).fit(x)
    np.testing.assert_array_equal(got.labels_.numpy(),
                                  np.asarray(ref.labels_))
    assert got.n_iter_ == ref.n_iter_
    carried = BalancedKMeans(n_clusters=4, device=CPU)
    carried.state = balanced_from_numpy(ref.state, device=CPU)
    xq = np.random.default_rng(6).normal(size=(200, 5)).astype(np.float32) * 4
    np.testing.assert_array_equal(carried.predict(xq).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(xq))))
    np.testing.assert_allclose(carried.score(xq), ref.score(jnp.asarray(xq)),
                               rtol=RTOL)


def test_capacity_and_gate_errors_match_the_reference():
    np.testing.assert_allclose(resolve_capacities(3, [1, 1, 2]).numpy(),
                               np.asarray(ref_capacities(3, [1, 1, 2])))
    for bad in ([1.0, 2.0], [1.0, 0.0, 1.0]):
        with pytest.raises(ValueError) as want:
            ref_capacities(3, bad)
        with pytest.raises(ValueError) as got:
            resolve_capacities(3, bad)
        assert str(got.value) == str(want.value)
    x, c0 = _blobs(7, n=40)
    for kw in (dict(epsilon=0.0), dict(sinkhorn_sweeps=0)):
        with pytest.raises(ValueError) as want:
            ref_fit_balanced(jnp.asarray(x), 4, init=jnp.asarray(c0), **kw)
        with pytest.raises(ValueError) as got:
            fit_balanced(x, 4, init=c0, device=CPU, **kw)
        assert str(got.value) == str(want.value)
    # The (n, k) plan gate, before anything is allocated.
    big = np.zeros((150_001, 1), np.float32)
    with pytest.raises(ValueError) as want:
        ref_fit_balanced(big, 1000)
    with pytest.raises(ValueError) as got:
        fit_balanced(big, 1000, device=CPU)
    assert str(got.value) == str(want.value)
