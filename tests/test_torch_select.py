"""The port's selection by value against ``lax.top_k`` (ROADMAP C13).

``ops.select.top_stable`` must give ``lax.top_k``'s indices, and its values
bit for bit, on ties, signed zeros and -inf.  The farthest reseed and the
fits that reseed on tied worst-fit rows are then held to the JAX package:
the reseed bit for bit, the fits with equal labels and ``n_iter`` and
centroids and inertia to ``tests/test_torch_fit.py``'s tolerance (rtol
1e-5, atol 1e-4·max|want|: both packages sum the same f32 terms in other
orders).  Inputs are made with numpy from a seed; the port runs on the
CPU, the reference on its XLA route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import fit_trimmed as ref_fit_trimmed
from kmeans_tpu.ops.update import (
    reseed_empty_farthest as ref_reseed_empty_farthest)
from kmeans_tpu_torch import KMeansConfig, fit_lloyd, fit_trimmed
from kmeans_tpu_torch.ops.select import top_stable
from kmeans_tpu_torch.ops.update import reseed_empty_farthest

CPU = "cpu"


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = 1e-4 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _case(name):
    """``(v, m)`` of one selection case, made with numpy from a seed."""
    rng = np.random.default_rng(len(name))
    if name == "tied-blocks":
        return np.array([0.0] * 5 + [1.0] * 5, np.float32), 3
    if name == "signed-zeros":
        v = rng.choice(np.array([0.0, -0.0, 2.0, 5.0], np.float32), 40)
        v[:4] = [-0.0, 0.0, -0.0, 0.0]
        return v, 30
    if name == "minus-inf":
        v = rng.choice(np.array([-np.inf, 1.0, 3.0], np.float32), 50)
        return v, 45
    if name == "m-equals-n":
        return rng.integers(0, 4, 33).astype(np.float32), 33
    if name == "m-one":
        return np.array([2.0, 7.0, 7.0, -1.0, 7.0], np.float32), 1
    # Random f32 with many repeated values, across a large n.
    pool = rng.normal(size=37).astype(np.float32)
    return rng.choice(pool, 5000), 700


@pytest.mark.parametrize("name", ["tied-blocks", "signed-zeros", "minus-inf",
                                  "m-equals-n", "m-one", "repeated-random"])
def test_top_stable_equals_lax_top_k(name):
    v, m = _case(name)
    want_v, want_i = jax.lax.top_k(jnp.asarray(v), m)
    got_v, got_i = top_stable(torch.from_numpy(v), m)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))


def test_tied_reseed_matches_reference_bit_for_bit():
    """2000 integer-valued rows whose min_d2 ties in blocks, two empty
    slots: both take the reference's rows."""
    rng = np.random.default_rng(22)
    x = rng.integers(-3, 4, size=(2000, 6)).astype(np.float32)
    c = rng.normal(size=(9, 6)).astype(np.float32)
    counts = np.ones(9, np.float32)
    counts[[2, 7]] = 0
    mind = (x ** 2).sum(1).astype(np.float32)
    got = reseed_empty_farthest(torch.from_numpy(c), torch.from_numpy(counts),
                                torch.from_numpy(x), torch.from_numpy(mind))
    want = ref_reseed_empty_farthest(jnp.asarray(c), jnp.asarray(counts),
                                     jnp.asarray(x), jnp.asarray(mind))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _tied_outliers():
    """600 blob rows (sigma 0.1, d = 4) at the origin and 8 outliers at
    ±8·e_i, and an init of one centroid at the origin and three at 1e3:
    the first sweep empties three clusters, and the outliers tie in
    min_d2 (64 exactly)."""
    rng = np.random.default_rng(0)
    d = 4
    blob = rng.normal(0.0, 0.1, size=(600, d))
    out = np.concatenate([8 * np.eye(d), -8 * np.eye(d)])
    x = np.concatenate([blob, out]).astype(np.float32)
    c0 = np.full((4, d), 1e3, np.float32)
    c0[0] = 0.0
    return x, c0


@pytest.mark.parametrize("fit", ["matmul", "delta", "trimmed"])
def test_tied_outlier_fit_matches_reference(fit):
    """The farthest reseed picks the lowest-index tied outliers, as the
    reference does; ``trimmed`` trims two of them (n_trim=2), so six tied
    outliers stay eligible for the reseed."""
    x, c0 = _tied_outliers()
    k = c0.shape[0]
    if fit == "trimmed":
        cfg = dict(k=k, empty="farthest")
        got = fit_trimmed(x, k, n_trim=2, init=c0, device=CPU,
                          config=KMeansConfig(**cfg))
        want = ref_fit_trimmed(jnp.asarray(x), k, n_trim=2,
                               init=jnp.asarray(c0), config=RefConfig(**cfg))
        np.testing.assert_array_equal(got.outlier_mask.numpy(),
                                      np.asarray(want.outlier_mask))
    else:
        cfg = dict(k=k, update=fit, empty="farthest")
        got = fit_lloyd(x, k, init=c0, device=CPU,
                        config=KMeansConfig(**cfg))
        want = kmeans_tpu.fit_lloyd(jnp.asarray(x), k, init=jnp.asarray(c0),
                                    config=RefConfig(**cfg))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    _close(got.centroids, want.centroids, "centroids")
    _close(got.inertia, want.inertia, "inertia")
    # The reseeded slots sit on outliers, lowest index first.
    seeded = got.centroids.numpy()[1:]
    first = 602 if fit == "trimmed" else 600
    np.testing.assert_array_equal(seeded, x[first:first + 3])
