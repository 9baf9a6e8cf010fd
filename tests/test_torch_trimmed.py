"""The port's trimmed k-means (k-means--) against the JAX package's.

Mirrors ``tests/test_trimmed.py``.  Both fits start from one explicit
``init`` array made with numpy (torch cannot reproduce ``jax.random``'s
k-means++ draws); the port runs with ``device="cpu"`` (the kernels' plain
versions), the reference its XLA route on the CPU.  On tie-free data the
labels, the outlier mask and ``n_iter`` must be equal; centroids and
counts agree to rtol 1e-5 and atol 1e-4·max|want| (both packages sum the
same f32 terms in different orders), and the inertia to 1e-4 of the
untrimmed inertia (the ``atol`` of ``_close``, scaled by what both packages
sum before they subtract the trimmed rows' share in f32).  The top-m selection is pinned against ``lax.top_k`` on adversarial
ties: the lowest index wins among equal distances, and zero-weight rows
come last, lowest index first.
The reference's sharded cases (planted ties, m above a shard's rows, zero
trim) run here on one device; the sharded engine is ROADMAP A4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models import TrimmedKMeans as RefTrimmedKMeans
from kmeans_tpu.models import TrimmedState as RefTrimmedState
from kmeans_tpu.models import fit_trimmed as ref_fit_trimmed
from kmeans_tpu.models.trimmed import resolve_n_trim as ref_resolve_n_trim
from kmeans_tpu.models.trimmed import trim_correction as ref_trim_correction
from kmeans_tpu_torch import (KMeansConfig, TrimmedKMeans, fit_lloyd,
                              fit_trimmed)
from kmeans_tpu_torch.convert import trimmed_from_numpy, trimmed_to_numpy
from kmeans_tpu_torch.models.init import init_centroids
from kmeans_tpu_torch.models.trimmed import (resolve_n_trim, trim_correction,
                                             trim_select)
from kmeans_tpu_torch.data.synthetic import generator_for

CPU = "cpu"


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = 1e-4 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _blobs(seed, n, d, k, std=0.5, far=0):
    """Separated blobs (tie-free distances) and, with ``far``, that many
    rows far out; the init is the first row of each blob."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 8
    lab = rng.integers(0, k, size=n)
    lab[:k] = np.arange(k)
    x = centres[lab] + std * rng.normal(size=(n, d))
    if far:
        x[-far:] = 60.0 + rng.normal(size=(far, d)) * 20
    x = x.astype(np.float32)
    return x, x[:k].copy()


def _both(x, k, **kw):
    """``(reference state, port state)`` of one fit from one init."""
    init = kw.pop("init")
    cfg = kw.pop("cfg", None) or dict(init="given", chunk_size=64)
    w = kw.pop("weights", None)
    ref = ref_fit_trimmed(
        jnp.asarray(x), k, init=jnp.asarray(init),
        weights=None if w is None else jnp.asarray(w),
        config=RefConfig(k=k, **cfg), **kw)
    got = fit_trimmed(x, k, init=init, weights=w,
                      config=KMeansConfig(k=k, **cfg), device=CPU, **kw)
    # The reference's fields, and the data the inertia check needs.
    return types.SimpleNamespace(**ref._asdict(), x=x, w=w), got


def _same(ref, got):
    """Labels, mask and n_iter equal; the floats to the stated tolerance."""
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.outlier_mask.numpy(),
                                  np.asarray(ref.outlier_mask))
    assert int(got.n_iter) == int(ref.n_iter)
    assert bool(got.converged) == bool(ref.converged)
    _close(got.centroids.numpy(), np.asarray(ref.centroids), "centroids")
    _close(got.counts.numpy(), np.asarray(ref.counts), "counts")
    x = np.asarray(ref.x, np.float64)
    c = np.asarray(ref.centroids, np.float64)
    d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1).min(1)
    w = np.ones(len(x)) if ref.w is None else np.asarray(ref.w, np.float64)
    untrimmed = float((w * d2).sum())
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=0, atol=1e-4 * untrimmed + 1e-30,
                               err_msg="inertia")
    assert got.labels.dtype == torch.int32
    assert got.outlier_mask.dtype == torch.bool


def _oracle_trimmed(x, c0, m, max_iter=50, tol=1e-10):
    """Textbook k-means-- in float64 NumPy (the reference test's oracle):
    assign, drop the m farthest (a stable sort: lowest index first among
    ties), update from the rest."""
    x = np.asarray(x, np.float64)
    c = np.asarray(c0, np.float64).copy()
    k = c.shape[0]

    def view(c):
        d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        labels, mind = d2.argmin(1), d2.min(1)
        out = np.zeros(len(x), bool)
        out[np.argsort(-mind, kind="stable")[:m]] = True
        return labels, mind, out

    for _ in range(max_iter):
        labels, _, out = view(c)
        new_c = c.copy()
        for j in range(k):
            sel = (labels == j) & ~out
            if sel.any():
                new_c[j] = x[sel].mean(0)
        shift = ((new_c - c) ** 2).sum()
        c = new_c
        if shift <= tol:
            break
    labels, mind, out = view(c)
    return c, np.where(out, -1, labels), out, mind[~out].sum()


def test_trimmed_matches_numpy_oracle_and_the_reference(rng):
    x = rng.normal(size=(200, 5)).astype(np.float32)
    c0 = x[:3].copy()
    ref, got = _both(x, 3, n_trim=10, init=c0, tol=1e-10, max_iter=50)
    _same(ref, got)
    want_c, want_l, want_out, want_inertia = _oracle_trimmed(x, c0, 10)
    np.testing.assert_allclose(got.centroids.numpy(), want_c, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.labels.numpy(), want_l)
    np.testing.assert_array_equal(got.outlier_mask.numpy(), want_out)
    np.testing.assert_allclose(float(got.inertia), want_inertia, rtol=1e-4)
    assert int(got.outlier_mask.sum()) == 10


def test_zero_trim_is_plain_lloyd(rng):
    x = rng.normal(size=(120, 4)).astype(np.float32)
    c0 = x[:3].copy()
    cfg = KMeansConfig(k=3, init="given", chunk_size=64)
    got = fit_trimmed(x, 3, n_trim=0, init=c0, tol=1e-10, max_iter=30,
                      config=cfg, device=CPU)
    want = fit_lloyd(x, 3, init=c0, tol=1e-10, max_iter=30, config=cfg,
                     device=CPU)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels.numpy())
    np.testing.assert_allclose(got.centroids.numpy(), want.centroids.numpy(),
                               rtol=1e-6)
    assert not bool(got.outlier_mask.any())
    ref, got = _both(x, 3, trim_fraction=0.0, init=c0, tol=1e-10,
                     max_iter=30)
    _same(ref, got)


@pytest.mark.parametrize("weighted", [False, True])
def test_zero_budget_folds_nothing_on_the_kernels_route(monkeypatch,
                                                        weighted):
    """m = 0 (``n_trim=0``, or a fraction that rounds to 0) launches no
    fold: ``trim_correction`` on the kernels' route (``backend="cuda"``;
    on CPU tensors K6's wrapper runs its plain version), with the wrapper
    replaced by one that raises on an empty input as the card's does,
    returns the reference's correction at m = 0: no rows, and sums,
    counts and inertia all zero, bit for bit."""
    import kmeans_tpu_torch.models.trimmed as trimmed_mod

    fold = trimmed_mod.tiled_fold_cuda

    def fold_refusing_empty(x, *args, **kw):
        if x.shape[0] == 0:
            raise ValueError("tiled_fold_cuda: empty shape n=0")
        return fold(x, *args, **kw)

    monkeypatch.setattr(trimmed_mod, "tiled_fold_cuda", fold_refusing_empty)
    x, c0 = _blobs(12, 120, 4, 3)
    labels = np.argmin(((x[:, None] - c0[None]) ** 2).sum(-1), 1).astype(
        np.int32)
    mind = ((x - c0[labels]) ** 2).sum(-1).astype(np.float32)
    w = np.ones(120, np.float32) if weighted else None
    m = resolve_n_trim(120, trim_fraction=0.004, n_trim=None)
    assert m == 0
    want = ref_trim_correction(
        jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mind),
        None if w is None else jnp.asarray(w), 3, m)
    got = trim_correction(
        torch.from_numpy(x), torch.from_numpy(labels),
        torch.from_numpy(mind), None if w is None else torch.from_numpy(w),
        3, m, backend="cuda")
    assert got[0].shape == (0,)
    for g, r in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_outliers_do_not_drag_centroids():
    """Far-away junk rows land in the trim set and leave the centroids
    where the clean blobs are, as in the reference."""
    x, c0 = _blobs(0, 300, 4, 3, std=0.3)
    junk = (np.full((6, 4), 500.0) * np.sign(
        np.random.default_rng(1).normal(size=(6, 4)))).astype(np.float32)
    xj = np.concatenate([x, junk])
    cfg = KMeansConfig(k=3, init="given", chunk_size=64)
    clean = fit_lloyd(x, 3, init=c0, config=cfg, max_iter=50, device=CPU)
    ref, robust = _both(xj, 3, n_trim=6, init=c0, max_iter=50)
    _same(ref, robust)
    mask = robust.outlier_mask.numpy()
    assert mask[-6:].all() and mask.sum() == 6
    got = np.sort(robust.centroids.numpy(), axis=0)
    want = np.sort(clean.centroids.numpy(), axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(trim_fraction=0.05, n_trim=7), dict(trim_fraction=None,
                                             n_trim=None),
    dict(trim_fraction=1.0, n_trim=None), dict(trim_fraction=-0.1,
                                               n_trim=None),
    dict(trim_fraction=None, n_trim=200), dict(trim_fraction=None,
                                               n_trim=-1),
])
def test_trim_budget_errors_equal_the_references(kw):
    assert resolve_n_trim(200, trim_fraction=0.05, n_trim=None) == 10
    assert resolve_n_trim(200, trim_fraction=None, n_trim=7) == 7
    with pytest.raises(ValueError) as want:
        ref_resolve_n_trim(200, **kw)
    with pytest.raises(ValueError) as got:
        resolve_n_trim(200, **kw)
    assert str(got.value) == str(want.value)


def test_zero_weight_rows_never_trimmed(rng):
    """Weight-0 rows (the padding idiom) must not eat the trim budget."""
    x = rng.normal(size=(100, 3)).astype(np.float32)
    x[:5] = 1e6  # would top any distance ranking
    w = np.ones(100, np.float32)
    w[:5] = 0.0
    c0 = init_centroids(generator_for(0, torch.device(CPU)),
                        torch.from_numpy(x), 3, weights=torch.from_numpy(w))
    state = fit_trimmed(x, 3, n_trim=4, init=c0, weights=w,
                        config=KMeansConfig(k=3, chunk_size=64), max_iter=20,
                        device=CPU)
    assert not bool(state.outlier_mask[:5].any())
    assert int(state.outlier_mask.sum()) == 4
    ref, got = _both(x, 3, n_trim=4, init=c0.numpy(), weights=w,
                     max_iter=20)
    _same(ref, got)


def test_fractional_weights_and_m_above_the_positive_rows():
    """Fractional weights, and m above the positive-weight rows: the
    zero-weight rows fill the rest of the budget, lowest index first (the
    reference's big-m sharded case, on one device)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(97, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 97).astype(np.float32)
    c0 = x[:3].copy()
    ref, got = _both(x, 3, n_trim=40, init=c0, weights=w, tol=1e-10,
                     max_iter=15, cfg=dict(init="given", chunk_size=32))
    _same(ref, got)
    w[::2] = 0.0                      # 48 positive rows, m = 60
    ref, got = _both(x, 3, n_trim=60, init=c0, weights=w, tol=1e-10,
                     max_iter=15, cfg=dict(init="given", chunk_size=32))
    _same(ref, got)
    mask = got.outlier_mask.numpy()
    assert mask[1::2].all() and mask.sum() == 60
    assert np.flatnonzero(mask[::2]).tolist() == list(range(12))


def test_planted_ties_trim_the_lowest_indices():
    """Exact-duplicate far rows straddle the trim threshold: only the
    lowest-index duplicates are trimmed, as in the reference."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(331, 6)).astype(np.float32) + \
        np.repeat(np.arange(4), 83)[:331, None].astype(np.float32) * 9
    x[7] = x[130] = x[260] = 300.0
    c0 = x[[0, 90, 180, 270]].copy()
    ref, got = _both(x, 4, n_trim=2, init=c0, tol=1e-10, max_iter=25)
    _same(ref, got)
    mask = got.outlier_mask.numpy()
    assert mask[7] and mask[130] and not mask[260]


@pytest.mark.parametrize("m", [1, 5, 13, 40, 59])
def test_selection_equals_lax_top_k_on_adversarial_ties(m):
    """Many equal min_d2 across the top-m boundary, exact zeros (a -0.0
    among them) and zero-weight rows: the port's stable sort picks the
    same rows, in the same order, as ``lax.top_k``."""
    rng = np.random.default_rng(m)
    mind = rng.choice(np.array([0.0, 1.0, 4.0, 9.0], np.float32), size=64)
    mind[3] = -0.0
    w = np.ones(64, np.float32)
    w[rng.choice(64, 20, replace=False)] = 0.0
    for weights in (None, w):
        d2m = mind if weights is None else np.where(weights > 0, mind,
                                                    -np.inf)
        want_v, want_i = jax.lax.top_k(jnp.asarray(d2m, jnp.float32), m)
        got_v, got_i = trim_select(
            torch.from_numpy(mind),
            None if weights is None else torch.from_numpy(weights), m)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_ties_at_the_boundary_through_the_fit():
    """Integer data whose rows sit at equal distances from fixed centroids:
    the final view's mask cuts through a tied group exactly as the
    reference's (max_iter=0: the selection at the given centroids), and the
    correction equals the reference's ``trim_correction``."""
    ring = np.array([[3, 0], [0, 3], [-3, 0], [0, -3], [1, 0], [0, 1],
                     [-1, 0], [0, -1]], np.float32)
    x = np.concatenate([ring, ring + 100, ring[:4] - 50]).astype(np.float32)
    c0 = np.array([[0, 0], [100, 100], [-50, -50]], np.float32)
    for m in (2, 6, 9):
        ref, got = _both(x, 3, n_trim=m, init=c0, max_iter=0)
        _same(ref, got)
    labels = np.array([0] * 8 + [1] * 8 + [2] * 4, np.int32)
    mind = np.array([9, 9, 9, 9, 1, 1, 1, 1] * 2 + [9] * 4, np.float32)
    w = np.ones(20, np.float32)
    w[[0, 8]] = 0.0
    for weights in (None, w):
        want = ref_trim_correction(
            jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mind),
            None if weights is None else jnp.asarray(weights), 3, 7)
        got = trim_correction(
            torch.from_numpy(x), torch.from_numpy(labels),
            torch.from_numpy(mind),
            None if weights is None else torch.from_numpy(weights), 3, 7,
            backend="plain")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, r in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_empty_farthest_reseeds_from_inliers():
    """``empty="farthest"``: a cluster left empty reseeds to the farthest
    INLIER (the trimmed rows rank -inf), as in the reference."""
    x, _ = _blobs(3, 150, 3, 3, far=4)
    c0 = np.stack([x[0], x[0] + 1e-3, np.full(3, 1e4, np.float32)])
    cfg = dict(init="given", chunk_size=64, empty="farthest")
    ref, got = _both(x, 3, n_trim=4, init=c0, tol=1e-10, max_iter=20,
                     cfg=cfg)
    _same(ref, got)
    assert got.outlier_mask.numpy()[-4:].all()


def test_zero_trim_matches_the_reference():
    """The reference's sharded zero-trim case, on one device: m = 0 gives
    the reference's plain-Lloyd labels and an empty mask."""
    x, c0 = _blobs(6, 64, 3, 3)
    ref, got = _both(x, 3, n_trim=0, init=c0, tol=1e-10, max_iter=10,
                     cfg=dict(init="given", chunk_size=32))
    _same(ref, got)
    assert not bool(got.outlier_mask.any())


def test_estimator_surface_against_the_reference(rng):
    """``TrimmedKMeans``: ``labels_``, ``outlier_mask_``, ``predict`` (never
    -1), ``transform`` and ``score`` on the port's k-means++ start, replayed
    through the reference as its ``init``."""
    x, _ = _blobs(7, 90, 4, 3)
    tk = TrimmedKMeans(n_clusters=3, trim_fraction=0.1, seed=0,
                       chunk_size=64, device=CPU).fit(x)
    labels = tk.labels_.numpy()
    assert (labels == -1).sum() == 9 and int(tk.outlier_mask_.sum()) == 9
    assert tk.cluster_centers_.shape == (3, 4) and tk.inertia_ > 0
    pred = tk.predict(x).numpy()
    assert pred.min() >= 0 and pred.max() < 3
    assert tuple(tk.transform(x[:5]).shape) == (5, 3)
    assert tk.score(x) <= -tk.inertia_ * (1 - 1e-6)
    c0 = init_centroids(generator_for(0, torch.device(CPU)),
                        torch.from_numpy(x), 3).numpy()
    ref = RefTrimmedKMeans(n_clusters=3, trim_fraction=0.1, init=c0,
                           chunk_size=64).fit(x)
    np.testing.assert_array_equal(labels, np.asarray(ref.labels_))
    np.testing.assert_array_equal(pred, np.asarray(ref.predict(x)))
    _close(tk.inertia_, ref.inertia_)
    _close(tk.score(x), ref.score(x))
    assert tk.n_iter_ == ref.n_iter_


def test_n_init_keeps_the_best_restart():
    """``n_init`` restarts with independently seeded generators and keeps
    the lowest inertia; restart 0 is the plain fit seeded with ``seed``."""
    x, _ = _blobs(8, 120, 3, 4)
    one = TrimmedKMeans(n_clusters=4, trim_fraction=0.05, seed=3,
                        device=CPU).fit(x)
    many = TrimmedKMeans(n_clusters=4, trim_fraction=0.05, seed=3, n_init=4,
                         device=CPU).fit(x)
    assert many.inertia_ <= one.inertia_
    given = TrimmedKMeans(n_clusters=4, trim_fraction=0.05, n_init=4,
                          init=one.cluster_centers_.numpy(),
                          device=CPU).fit(x)
    np.testing.assert_array_equal(given.labels_.numpy(), one.labels_.numpy())


def test_state_carries_between_the_packages(rng):
    """``convert.trimmed_from_numpy`` / ``trimmed_to_numpy`` carry a
    reference ``TrimmedState`` into the port's and back, field for field."""
    x = rng.normal(size=(80, 3)).astype(np.float32)
    ref, _ = _both(x, 3, n_trim=5, init=x[:3].copy(), max_iter=10)
    port = trimmed_from_numpy(ref, device=CPU)
    back = trimmed_to_numpy(port)
    assert list(back) == list(RefTrimmedState._fields)
    for name in RefTrimmedState._fields:
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(ref, name)))
        assert back[name].dtype == np.asarray(getattr(ref, name)).dtype
    RefTrimmedState(**back)
    assert port.outlier_mask.dtype == torch.bool


def test_fit_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    x = np.zeros((10, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_trimmed(x, 2, n_trim=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrimmedKMeans(n_clusters=2).fit(x)
