"""The port's minibatch k-means and nested ladder against the JAX package.

The same numpy inputs go through both packages: the port on the CPU
(``device="cpu"``: the kernels' plain versions), the reference on its XLA
route.  torch cannot draw ``jax.random``'s indices, so the Sculley loop is
held to the reference by replaying the port's draws (one generator seeded
with the config's seed, one ``randint(0, n, (batch_size,))`` per step)
through the reference's ``batch_update``.  Data are separated blobs, so
labels are equal; centroids, sums and inertia agree to rtol 1e-5 (the two
sum the same f32 terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import minibatch as RM
from kmeans_tpu.ops.distance import assign as ref_assign
from kmeans_tpu_torch import (KMeansConfig, MiniBatchKMeans, batch_update,
                              fit_minibatch, kmeans_plus_plus, nested_ladder)
from kmeans_tpu_torch.convert import minibatch_from_numpy
from kmeans_tpu_torch.models.minibatch import batch_stats

CPU = "cpu"
FIELDS = ("centroids", "labels", "inertia", "n_iter", "converged", "counts")


def _close(got, want, rtol=1e-5, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _blobs(seed=0, n=3000, d=8, k=5, spread=6.0):
    """Separated blobs in random row order, and k rows of distinct blobs."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    pick = [int(np.flatnonzero(lab == j)[0]) for j in range(k)]
    return x, x[pick].copy()


def _fields(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


# ---------------------------------------------------------------------------
# batch_stats / batch_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd,weight", [
    ("float32", None), ("bfloat16", None), ("float32", 0.5),
    ("float32", "rows")])
def test_batch_stats_matches_reference(cd, weight):
    x, c0 = _blobs(seed=1, n=512)
    c = c0 + np.float32(0.3)
    if weight == "rows":
        weight = np.random.default_rng(2).uniform(0.5, 2.0, size=512) \
            .astype(np.float32)
    ref = RM.batch_stats(jnp.asarray(c), jnp.asarray(x), compute_dtype=cd,
                         row_weight=weight)
    port = batch_stats(torch.from_numpy(c), torch.from_numpy(x),
                       compute_dtype=cd,
                       row_weight=None if weight is None
                       else torch.as_tensor(weight))
    for got, want, what in zip(port, ref, ("counts", "sums", "inertia")):
        _close(got, want, what=what)
    if weight is None:      # counts of unit weights are exact
        np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))


def _replay(x, c0, steps, batch_size, seed=0, early=None, cd=None):
    """The reference's batch_update over the port's draws; with ``early``
    (tol, max_no_improvement) the reference loop's stopping rule.  Returns
    (centroids, steps run, stopped early)."""
    gen = torch.Generator().manual_seed(seed)
    n = x.shape[0]
    c = jnp.asarray(c0)
    n_seen = jnp.zeros((c0.shape[0],), jnp.float32)
    alpha = jnp.float32(min(1.0, batch_size * 2.0 / (n + 1)))
    ewa = best = jnp.float32(np.inf)
    stale = 0
    for it in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=gen).numpy()
        c, n_seen, shift_sq, b_in = RM._batch_update_jit(
            c, n_seen, jnp.asarray(x[idx]), compute_dtype=cd)
        if early is None:
            continue
        tol, mni = early
        ewa = b_in if it == 0 else ewa * (1.0 - alpha) + b_in * alpha
        stale = 0 if bool(ewa < best) else stale + 1
        best = jnp.minimum(best, ewa)
        done = bool(shift_sq <= (-1.0 if tol is None else tol))
        if (mni or 0) > 0:
            done = done or stale >= mni
        if done:
            return c, it + 1, True
    return c, steps, False


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_sculley_loop_replays_through_reference(cd):
    x, c0 = _blobs(seed=3)
    k = c0.shape[0]
    port = fit_minibatch(x, k, init=c0, batch_size=128, steps=50, device=CPU,
                         config=KMeansConfig(k=k, compute_dtype=cd))
    want, _, _ = _replay(x, c0, 50, 128, cd=cd)
    _close(port.centroids, want, what="centroids")
    assert int(port.n_iter) == 50 and not bool(port.converged)
    labels, _ = ref_assign(jnp.asarray(x), want, compute_dtype=cd)
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(labels))


@pytest.mark.parametrize("tol,mni", [(1e-3, None), (None, 3)])
def test_early_stopping_replays_through_reference(tol, mni):
    x, c0 = _blobs(seed=4)
    k = c0.shape[0]
    port = fit_minibatch(x, k, init=c0, batch_size=128, steps=200, tol=tol,
                         max_no_improvement=mni, device=CPU)
    want, n_steps, stopped = _replay(x, c0, 200, 128, early=(tol, mni))
    assert stopped and n_steps < 200
    assert int(port.n_iter) == n_steps
    assert bool(port.converged)
    _close(port.centroids, want, what="centroids")


def test_fit_seeds_on_a_subsample_in_the_documented_order():
    """randperm picks the seeding subsample, k-means++ draws on it, then
    one randint per step — all from one generator seeded with the config's
    seed."""
    rng = np.random.default_rng(5)
    n, k = 70_000, 3
    x = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    got = fit_minibatch(x, k, batch_size=64, steps=3, device=CPU,
                        config=KMeansConfig(k=k, seed=11))
    gen = torch.Generator().manual_seed(11)
    sub = torch.randperm(n, generator=gen)[:65536]
    c = kmeans_plus_plus(gen, x[sub], k, device=CPU)
    n_seen = torch.zeros(k)
    for _ in range(3):
        idx = torch.randint(0, n, (64,), generator=gen)
        c, n_seen, _, _ = batch_update(c, n_seen, x[idx], compute_dtype=None)
    assert torch.equal(got.centroids, c)


# ---------------------------------------------------------------------------
# The nested ladder
# ---------------------------------------------------------------------------

def test_nested_ladder_matches_reference():
    x, c0 = _blobs(seed=6, n=20_000, k=6, spread=3.0)
    kw = dict(tol=1e-6, start=2048, chunk_size=4096)
    c, total, rungs = nested_ladder(x, c0, device=CPU, **kw)
    rc, rtotal, rrungs = RM.nested_ladder(x, jnp.asarray(c0), **kw)
    assert [b for b, _ in rungs] == [2048, 4096, 8192, 16384]
    assert rungs == rrungs and total == rtotal
    _close(c, rc, what="centroids")
    # 64·k ≥ n: no rung, the caller promotes at once.
    c1, total1, rungs1 = nested_ladder(x[:300], c0, device=CPU, **kw)
    assert total1 == 0 and rungs1 == [] and np.array_equal(c1.numpy(), c0)


def test_fit_minibatch_nested_matches_reference():
    x, c0 = _blobs(seed=7, n=12_000, k=4, spread=3.0)
    k = c0.shape[0]
    kw = dict(tol=1e-4, schedule="nested", return_ladder=True)
    port, rungs = fit_minibatch(x, k, init=c0, device=CPU,
                                config=KMeansConfig(k=k, nested_start=512),
                                **kw)
    ref, rrungs = kmeans_tpu.fit_minibatch(
        jnp.asarray(x), k, init=jnp.asarray(c0),
        config=RefConfig(k=k, nested_start=512), **kw)
    assert rungs == rrungs and len(rungs) >= 2
    assert int(port.n_iter) == int(ref.n_iter)
    assert bool(port.converged) and bool(ref.converged)
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    _close(port.centroids, ref.centroids, what="centroids")
    _close(port.inertia, ref.inertia, atol=0.0, what="inertia")


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

def _check_estimators(port, ref):
    _close(port.cluster_centers_, ref.cluster_centers_, what="centroids")
    _close(port._n_seen, ref._n_seen, what="n_seen")
    np.testing.assert_array_equal(port.labels_.numpy(),
                                  np.asarray(ref.labels_))
    _close(port.inertia_, ref.inertia_, atol=0.0, what="inertia")
    assert int(port.state.n_iter) == int(ref.state.n_iter)


def test_partial_fit_sequence_matches_reference():
    x, c0 = _blobs(seed=8)
    port = MiniBatchKMeans(n_clusters=5, init=c0, device=CPU)
    ref = kmeans_tpu.MiniBatchKMeans(n_clusters=5, init=jnp.asarray(c0))
    for i in range(6):
        batch = x[i * 200:(i + 1) * 200]
        port.partial_fit(batch)
        ref.partial_fit(jnp.asarray(batch))
        _check_estimators(port, ref)


@pytest.mark.parametrize("after", ["partial_fit", "fit"])
def test_reference_estimator_carries_on_in_the_port(after):
    """A reference estimator's state and lifetime counts, as numpy arrays,
    continue its partial_fit stream in the port (after fit, both rescale
    from the fitted counts)."""
    x, c0 = _blobs(seed=9)
    ref = kmeans_tpu.MiniBatchKMeans(n_clusters=5, init=jnp.asarray(c0),
                                     batch_size=128, steps=20)
    if after == "fit":
        ref.fit(jnp.asarray(x))
    else:
        for i in range(3):
            ref.partial_fit(jnp.asarray(x[i * 200:(i + 1) * 200]))
    n_seen = None if ref._n_seen is None else np.asarray(ref._n_seen)
    port = MiniBatchKMeans(n_clusters=5, init=c0, batch_size=128, steps=20,
                           device=CPU)
    port.state, port._n_seen = minibatch_from_numpy(
        _fields(ref.state), n_seen, device=CPU)
    for i in range(3, 6):
        batch = x[i * 200:(i + 1) * 200]
        port.partial_fit(batch)
        ref.partial_fit(jnp.asarray(batch))
        _check_estimators(port, ref)
    np.testing.assert_array_equal(port.predict(x[:100]).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(x[:100]))))
    _close(port.transform(x[:20]), ref.transform(jnp.asarray(x[:20])))
    _close(port.score(x), ref.score(jnp.asarray(x)), atol=0.0)


def test_estimator_fit_restarts_and_partial_fit_after_fit():
    x, _ = _blobs(seed=10)
    est = MiniBatchKMeans(n_clusters=5, batch_size=128, steps=30, n_init=2,
                          seed=3, device=CPU).fit(x)
    assert est.state.centroids.shape == (5, 8)
    assert int(est.state.n_iter) == 30
    est.partial_fit(x[:256])
    # The lifetime rates resume from the samples the fit processed.
    _close(est._n_seen.sum(), 30 * 128 + 256, what="n_seen")
    assert int(est.state.n_iter) == 31


@pytest.mark.parametrize("kwargs,match", [
    (dict(schedule="nested", steps=10), "nested"),
    (dict(schedule="nested", batch_size=64), "nested"),
    (dict(schedule="nested", max_no_improvement=3), "nested"),
    (dict(schedule="sometimes"), "schedule"),
    (dict(init=np.zeros((4, 8), np.float32)), "shape"),
    (dict(config=KMeansConfig(k=4)), "contradicts"),
])
def test_fit_minibatch_refusals(kwargs, match):
    x, _ = _blobs(n=500)
    with pytest.raises(ValueError, match=match):
        fit_minibatch(x, 5, device=CPU, **kwargs)


def test_partial_fit_refuses_a_misshapen_init():
    x, _ = _blobs(n=200)
    est = MiniBatchKMeans(n_clusters=3, init=np.zeros((4, 8), np.float32),
                          device=CPU)
    with pytest.raises(ValueError, match="shape"):
        est.partial_fit(x)
