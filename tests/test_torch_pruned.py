"""The port's bound-pruned sweeps (hamerly, yinyang) and the adaptive
``update="auto"`` loop against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages: the
port with ``device="cpu"`` (the Hamerly kernel's plain version, and the
yinyang masked scorer), the reference through its XLA route and its Pallas
kernel in interpret mode, as ``tests/test_hamerly.py`` and
``tests/test_yinyang.py`` run them.

Tolerances, and why:

* Labels, recompute counts, group-pruned counts, sweep counts and the fit's
  ``diag`` counters must be equal.  The trajectories use integer-valued
  data, so every fold sums integers exactly in f32 and both packages carry
  bit-identical centroids; their scores then differ only in the f32
  accumulation order of one product, which decides no label and no bound
  test on these inputs (the margin covers it).
* Scores and bounds (``sb``, ``slb``, ``glb``) agree to rtol 1e-5 and atol
  1e-5·max|want|: the same f32 products summed in another order.
* Sums and centroids agree to rtol 1e-5 and atol 1e-4·max|want| where the
  data are not integers.
* ``row_norms``, ``centroid_groups`` and the port's t = 1 yinyang against
  its own hamerly are compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu.ops.yinyang as ref_yy
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.ops import hamerly as ref_h
from kmeans_tpu.ops.pallas_lloyd import lloyd_hamerly_pallas
from kmeans_tpu.ops.update import apply_update as ref_apply_update
from kmeans_tpu_torch import KMeans, KMeansConfig, fit_lloyd
from kmeans_tpu_torch.models.lloyd import fit_plan
from kmeans_tpu_torch.ops import cuda_lloyd as K
from kmeans_tpu_torch.ops import hamerly as H
from kmeans_tpu_torch.ops import yinyang as Y
from kmeans_tpu_torch.ops.delta import DELTA_REFRESH
from kmeans_tpu_torch.ops.update import apply_update

CPU = "cpu"


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=1e-5, atol_rel=1e-5, what=""):
    got = _np(got).astype(np.float64)
    want = _np(want).astype(np.float64)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    atol = atol_rel * max(float(np.abs(want[finite]).max(initial=0.0)),
                          1e-30)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol, err_msg=what)


def _blobs(seed, n, d, k, sep=3.0, scale=None):
    """Blobs; with ``scale`` the points are rounded to integers after
    scaling, so folds sum exactly in f32."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * sep
    x = centres[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    if scale is not None:
        x = np.round(x * scale)
    return x.astype(np.float32), rng


def _near_ties(seed, n, d, scale=8.0):
    """Uniform-noise rows (tiny first/second gaps), integer-valued."""
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(size=(n, d)) * scale).astype(np.float32), rng


# ---------------------------------------------------------------------------
# The Hamerly kernel's plain version and the helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lloyd_hamerly_plain_matches_pallas(cd):
    """Sentinels (always needed), zero weights, an exact duplicate centroid
    with rows on it, a first group over the 256-slot budget (the TPU
    kernel's dense branch) and a ragged second group (its compacted
    branch).  Rows not needed carry their dense label as ``prev``, as sound
    bounds guarantee in a fit.

    The TPU kernel's dense branch scores every row of its tile and writes
    fresh sb/slb for rows not needed too; its docstring, its k-tiled path,
    the XLA route and the port pass those bounds through.  So there the
    reference holds the fresh scores and the port the inputs."""
    n, d, k = 1100, 128, 6
    x, rng = _blobs(0, n, d, k)
    c = x[rng.integers(0, n, k)].copy()
    c[5] = c[4]
    x[:30] = c[4]
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    w = (rng.random(n) > 0.2).astype(np.float32)
    need = rng.random(n) < 0.35
    need[:30] = True
    prev = _np(H._scores_chunked(xt, ct, chunk_size=4096,
                                 compute_dtype=cd)[0]).copy()
    prev[need] = rng.integers(-1, k, int(need.sum()))
    sb_in = rng.normal(size=n).astype(np.float32)
    slb_in = rng.normal(size=n).astype(np.float32)
    port = K.lloyd_hamerly_plain(
        xt, ct, torch.from_numpy(prev), torch.from_numpy(need),
        torch.from_numpy(sb_in), torch.from_numpy(slb_in),
        weights=torch.from_numpy(w), compute_dtype=cd)
    ref = lloyd_hamerly_pallas(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(prev), jnp.asarray(need),
        jnp.asarray(sb_in), jnp.asarray(slb_in), weights=jnp.asarray(w),
        compute_dtype=cd, interpret=True)
    np.testing.assert_array_equal(_np(port[0]), np.asarray(ref[0]))
    assert (_np(port[0])[:30] == 4).all()          # the lowest index wins
    np.testing.assert_array_equal(_np(port[2])[:30], _np(port[1])[:30])
    _, best, second = H._scores_chunked(xt, ct, chunk_size=4096,
                                        compute_dtype=cd)
    dense_tile = np.arange(n) < 1024
    for i, fresh, given in ((1, best, sb_in), (2, second, slb_in)):
        _close(_np(port[i])[need], np.asarray(ref[i])[need])
        np.testing.assert_array_equal(_np(port[i])[~need], given[~need])
        np.testing.assert_array_equal(
            np.asarray(ref[i])[~need & ~dense_tile],
            given[~need & ~dense_tile])
        _close(np.asarray(ref[i])[~need & dense_tile],
               _np(fresh)[~need & dense_tile])
    _close(port[3], ref[3], atol_rel=1e-4, what="dsums")
    np.testing.assert_array_equal(_np(port[4]), np.asarray(ref[4]))
    assert int(port[5]) == int(ref[5]) == int(need.sum())
    assert int(port[6]) == int(ref[6]) == 1


def test_scores_chunked_matches_reference():
    x, rng = _blobs(1, 700, 40, 9)
    c = x[rng.integers(0, 700, 9)].copy()
    c[3] = c[1]
    lab, best, second = H._scores_chunked(torch.from_numpy(x),
                                          torch.from_numpy(c), chunk_size=256,
                                          compute_dtype="bfloat16")
    ref = ref_h._scores_chunked(jnp.asarray(x), jnp.asarray(c),
                                jnp.sum(jnp.asarray(c) ** 2, axis=1),
                                chunk_size=256, compute_dtype="bfloat16")
    np.testing.assert_array_equal(_np(lab), np.asarray(ref[0]))
    _close(best, ref[1], what="best")
    _close(second, ref[2], what="second")


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_row_norms_are_the_references_bit_for_bit(cd):
    """Integer rows, some beyond bf16's exact integers (|v| > 256): the
    norm is taken after the cast, and the sums are exact."""
    x = np.random.default_rng(2).integers(-300, 301, (333, 64)).astype(
        np.float32)
    got = H.row_norms(torch.from_numpy(x), compute_dtype=cd, chunk_size=100)
    want = ref_h.row_norms(jnp.asarray(x), compute_dtype=cd, chunk_size=100)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_centroid_groups_and_drift_match_reference():
    rng = np.random.default_rng(3)
    for k, d, t in ((23, 8, None), (200, 16, 20), (50, 4, 1), (12, 3, 40)):
        c = rng.normal(size=(k, d)).astype(np.float32)
        got, got_t = Y.centroid_groups(c, t, seed=5)
        want, want_t = ref_yy.centroid_groups(c, t, seed=5)
        assert got_t == want_t
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        for a, b in zip(H.centroid_mini_kmeans(c, 7, seed=1),
                        ref_h.centroid_mini_kmeans(c, 7, seed=1)):
            np.testing.assert_array_equal(a, b)
    # Per-group drift, with group 2 of 4 empty: (+inf, 0) there.
    group_of = np.array([0, 1, 3, 3, 0, 1], np.int32)
    big_d = rng.normal(size=6).astype(np.float32)
    delta_c = np.abs(rng.normal(size=6)).astype(np.float32)
    got = Y._group_drift(torch.from_numpy(big_d), torch.from_numpy(delta_c),
                         torch.from_numpy(group_of), 4)
    want = ref_yy._group_drift(jnp.asarray(big_d), jnp.asarray(delta_c),
                               jnp.asarray(group_of), 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert np.isinf(_np(got[0])[2]) and _np(got[1])[2] == 0.0


def test_pruned_plans_are_the_classic_plan():
    """K4 takes every input the classic kernel takes, and the yinyang route
    is K4 plus PyTorch: their plans and routes are the classic ones."""
    x = np.zeros((10, 4), np.float32)
    for kw in (dict(device="cuda"), dict(device="cpu"),
               dict(device="cuda", weights=np.full(10, 0.5),
                    compute_dtype="bfloat16")):
        assert (H.hamerly_kernel_plan(x, 3, **kw)
                == Y.yinyang_kernel_plan(x, 3, groups=2, **kw)
                == K.kernel_plan(x, 3, **kw))
    assert H.resolve_hamerly_backend("auto", x, 3, device="cpu") == (
        "auto", "plain")
    assert Y.resolve_yinyang_backend("auto", x, 3, device="cuda") == (
        "auto", "cuda")
    assert Y.resolve_yinyang_backend("plain", x, 3, device="cuda") == (
        "plain", "plain")


def test_constants_match_reference():
    assert H.HAMERLY_MARGIN_REL == ref_h.HAMERLY_MARGIN_REL == 1e-3
    assert H._NORM_INFLATE == ref_h._NORM_INFLATE
    assert (Y.AUTO_SWITCH_HIGH, Y.AUTO_REPROBE_PERIODS, Y.AUTO_MIN_ROWS) == (
        ref_yy.AUTO_SWITCH_HIGH, ref_yy.AUTO_REPROBE_PERIODS,
        ref_yy.AUTO_MIN_ROWS)
    for k in (1, 9, 10, 11, 1000):
        assert Y.default_groups(k) == ref_yy.default_groups(k)


# ---------------------------------------------------------------------------
# Trajectories: hand-driven sweeps through both packages
# ---------------------------------------------------------------------------

def _port_traj(x, c0, iters, *, weights=None, cap=None,
               group_of=None, chunk=512):
    """Per-sweep (labels, n_rec, n_gp, sb, lower) and the final centroids
    of the port's pruned loop, driven by hand: hamerly, or yinyang with
    ``group_of``."""
    n, d = x.shape
    k = c0.shape[0]
    xt = torch.from_numpy(x)
    w = None if weights is None else torch.from_numpy(weights)
    rno = H.row_norms(xt, chunk_size=chunk)
    c = torch.from_numpy(c0)
    sb = torch.zeros(n)
    lower = torch.zeros(n) if group_of is None else torch.zeros(
        n, int(group_of.max()) + 1)
    c_cd, csq = c, torch.zeros(k)
    out = []
    for i in range(iters):
        if i % DELTA_REFRESH == 0:
            lab = torch.full((n,), -1, dtype=torch.int32)
            sums, counts = torch.zeros(k, d), torch.zeros(k)
        args = (xt, c, lab, sums, counts, sb, lower, c_cd, csq, rno)
        kw = dict(weights=w, cap=cap, chunk_size=chunk, device=CPU)
        if group_of is None:
            lab, sums, counts, sb, lower, c_cd, csq, nrec = H.hamerly_pass(
                *args, **kw)
            ngp = 0
        else:
            (lab, sums, counts, sb, lower, c_cd, csq, nrec,
             ngp) = Y.yinyang_pass(*args, torch.from_numpy(group_of), **kw)
        out.append((_np(lab).copy(), int(nrec), int(ngp), _np(sb).copy(),
                    _np(lower).copy()))
        c = apply_update(c, sums, counts)
    return out, _np(c)


def _ref_traj(x, c0, iters, backend, *, weights=None, cap=None,
              group_of=None, chunk=512):
    n, d = x.shape
    k = c0.shape[0]
    jx = jnp.asarray(x)
    w = None if weights is None else jnp.asarray(weights)
    rno = ref_h.row_norms(jx, chunk_size=chunk)
    c = jnp.asarray(c0)
    sb = jnp.zeros((n,), jnp.float32)
    lower = jnp.zeros((n,), jnp.float32) if group_of is None else jnp.zeros(
        (n, int(group_of.max()) + 1), jnp.float32)
    c_cd, csq = c, jnp.zeros((k,), jnp.float32)
    out = []
    for i in range(iters):
        if i % DELTA_REFRESH == 0:
            lab = jnp.full((n,), -1, jnp.int32)
            sums = jnp.zeros((k, d), jnp.float32)
            counts = jnp.zeros((k,), jnp.float32)
        args = (jx, c, lab, sums, counts, sb, lower, c_cd, csq, rno)
        kw = dict(weights=w, cap=cap if cap is not None else n,
                  chunk_size=chunk, backend=backend)
        if group_of is None:
            lab, sums, counts, sb, lower, c_cd, csq, nrec = \
                ref_h.hamerly_pass(*args, **kw)
            ngp = 0
        else:
            (lab, sums, counts, sb, lower, c_cd, csq, nrec,
             ngp) = ref_yy.yinyang_pass(*args, jnp.asarray(group_of), **kw)
        out.append((np.asarray(lab), int(nrec), int(ngp), np.asarray(sb),
                    np.asarray(lower)))
        c = ref_apply_update(c, sums, counts)
    return out, np.asarray(c)


def _same_trajectory(port, ref, *, counters=True):
    """Labels per sweep and final centroids equal; with ``counters`` also
    (n_rec, n_gp) equal and the bounds close.  Returns the port's n_rec."""
    (p_sweeps, p_c), (r_sweeps, r_c) = port, ref
    for i, (p, r) in enumerate(zip(p_sweeps, r_sweeps)):
        np.testing.assert_array_equal(p[0], r[0], err_msg=f"sweep {i}")
        if counters:
            assert p[1:3] == r[1:3], f"sweep {i}: {p[1:3]} != {r[1:3]}"
            _close(p[3], r[3], what=f"sb sweep {i}")
            _close(p[4], r[4], what=f"lower bounds sweep {i}")
    np.testing.assert_array_equal(p_c, r_c)
    return [p[1] for p in p_sweeps]


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_hamerly_trajectory_matches_reference(backend):
    """Against the XLA route everything; against the Pallas route labels
    and centroids (its dense branch refreshes bounds of rows not needed,
    see test_lloyd_hamerly_plain_matches_pallas)."""
    n, d, k = 3000, 128, 10
    x, rng = _blobs(4, n, d, k, scale=4.0)
    c0 = x[rng.integers(0, n, k)]
    recs = _same_trajectory(_port_traj(x, c0, 10),
                            _ref_traj(x, c0, 10, backend),
                            counters=backend == "xla")
    assert recs[0] == n and recs[-1] < n // 4, recs     # pruning engages


def test_hamerly_near_ties_weights_and_cap_fallback_match_reference():
    """Uniform noise with k=24 (tiny gaps: the margins force recomputes),
    binary weights, and a cap of 8 (the reference's full-fallback branch;
    the port's values do not depend on cap)."""
    n, d, k = 2500, 32, 24
    x, rng = _near_ties(5, n, d)
    c0 = x[rng.integers(0, n, k)]
    w = (rng.random(n) > 0.3).astype(np.float32)
    recs = _same_trajectory(
        _port_traj(x, c0, 8, weights=w, cap=8),
        _ref_traj(x, c0, 8, "xla", weights=w, cap=8))
    assert recs[-1] > n // 2, recs             # honest cost of exactness


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_yinyang_trajectory_matches_reference(backend):
    """As the hamerly trajectory test.  The reference's own two routes
    count differently here (its Pallas route's dense branch tightens sb of
    rows not needed); the port counts as its XLA route does."""
    n, d, k = 2400, 128, 24                   # t = 3
    x, rng = _blobs(6, n, d, k, scale=4.0)
    c0 = x[rng.integers(0, n, k)]
    group_of, t = Y.centroid_groups(c0)
    assert t == 3
    port = _port_traj(x, c0, 8, group_of=group_of)
    recs = _same_trajectory(port, _ref_traj(x, c0, 8, backend,
                                            group_of=group_of),
                            counters=backend == "xla")
    assert recs[-1] < n // 4, recs
    assert sum(s[2] for s in port[0]) > 0     # the group filter engages


def test_yinyang_near_ties_weights_cap_and_odd_groups_match_reference():
    n, d, k = 2000, 32, 10
    x, rng = _near_ties(7, n, d)
    c0 = x[rng.integers(0, n, k)]
    w = (rng.random(n) > 0.3).astype(np.float32)
    group_of, t = Y.centroid_groups(c0, 3)    # 3 groups over 10 centroids
    _same_trajectory(
        _port_traj(x, c0, 7, weights=w, cap=8, group_of=group_of),
        _ref_traj(x, c0, 7, "xla", weights=w, cap=8,
                  group_of=group_of))


def test_yinyang_with_one_group_is_hamerly_bit_for_bit():
    """Inside the port: group_of = zeros gives hamerly's labels, counts,
    sb, bound (glb[:, 0] == slb) and centroids exactly."""
    n, d, k = 1500, 32, 8
    x, rng = _blobs(8, n, d, k)
    c0 = x[rng.integers(0, n, k)]
    (hs, hc), (ys, yc) = (
        _port_traj(x, c0, 18),
        _port_traj(x, c0, 18, group_of=np.zeros(k, np.int32)))
    for h, y in zip(hs, ys):
        np.testing.assert_array_equal(h[0], y[0])
        assert h[1] == y[1] and y[2] == 0
        np.testing.assert_array_equal(h[3], y[3])
        np.testing.assert_array_equal(h[4], y[4][:, 0])
    np.testing.assert_array_equal(hc, yc)


def test_pruned_trajectory_matches_the_dense_sweep():
    """Inside the port: every pruned sweep labels as the classic sweep at
    the same centroids does (the soundness the chip smoke checks)."""
    n, d, k = 2000, 48, 12
    x, rng = _blobs(9, n, d, k)
    c0 = x[rng.integers(0, n, k)]
    group_of, _ = Y.centroid_groups(c0)
    for flavour, groups in (("hamerly", None), ("yinyang", group_of)):
        sweeps, _ = _port_traj(x, c0, 8, group_of=groups)
        c = torch.from_numpy(c0)
        for i, s in enumerate(sweeps):
            lab, _, sums, counts, _ = K.lloyd_pass_plain(
                torch.from_numpy(x), c)
            np.testing.assert_array_equal(s[0], _np(lab),
                                          err_msg=f"{flavour} sweep {i}")
            c = apply_update(c, sums, counts)


# ---------------------------------------------------------------------------
# Fits: hamerly, yinyang and the adaptive "auto" loop
# ---------------------------------------------------------------------------

def _fit_pair(x, c0, k, *, max_iter, tol, **cfg):
    port, pd = fit_lloyd(x, k, init=c0, device=CPU, max_iter=max_iter,
                         tol=tol, config=KMeansConfig(k=k, **cfg), diag=True)
    ref, rd = kmeans_tpu.fit_lloyd(jnp.asarray(x), k, init=jnp.asarray(c0),
                                   max_iter=max_iter, tol=tol,
                                   config=RefConfig(k=k, **cfg), diag=True)
    np.testing.assert_array_equal(_np(port.labels), np.asarray(ref.labels))
    assert int(port.n_iter) == int(ref.n_iter)
    assert bool(port.converged) == bool(ref.converged)
    assert pd == rd
    np.testing.assert_array_equal(_np(port.centroids),
                                  np.asarray(ref.centroids))
    return pd


@pytest.mark.parametrize("update", ["hamerly", "yinyang"])
def test_fit_pruned_matches_reference(update):
    n, d, k = 2500, 64, 12
    x, rng = _blobs(10, n, d, k, scale=4.0)
    c0 = x[rng.integers(0, n, k)]
    diag = _fit_pair(x, c0, k, max_iter=30, tol=1e-10, update=update)
    assert diag["final_flavor"] == {"hamerly": 2, "yinyang": 1}[update]
    assert 0 < diag["recompute_rows"] < diag["rows_seen"]
    plan = fit_plan(x, k, config=KMeansConfig(k=k, update=update),
                    device=CPU)
    assert plan["update"] == update and plan["delta_backend"] == "plain"


def test_auto_adaptive_promotes_and_demotes_as_the_reference(monkeypatch):
    """With AUTO_MIN_ROWS lowered in both packages: clustered data promote
    to yinyang at the first judgment (sweep 16) and stay; an impossible
    threshold on uniform noise demotes back to delta at sweep 32 (and the
    8-period re-probe is beyond max_iter)."""
    for mod in (Y, ref_yy):
        monkeypatch.setattr(mod, "AUTO_MIN_ROWS", 256)
    n, d, k = 3000, 32, 12
    x, rng = _blobs(11, n, d, k, scale=4.0)
    c0 = x[rng.integers(0, n, k)]
    assert fit_plan(x, k, device=CPU)["adaptive"]
    promoted = _fit_pair(x, c0, k, max_iter=40, tol=-1.0, update="auto")
    assert promoted["final_flavor"] == 1, promoted
    for mod in (Y, ref_yy):
        monkeypatch.setattr(mod, "AUTO_SWITCH_HIGH", 0.05)
    xu, rng = _near_ties(12, 2000, 16)
    cu = xu[rng.integers(0, 2000, 24)]
    demoted = _fit_pair(xu, cu, 24, max_iter=50, tol=-1.0, update="auto")
    assert demoted["final_flavor"] == 0, demoted
    assert demoted["group_pairs_seen"] > 0          # yinyang ran a period


def test_kmeans_estimator_runs_the_adaptive_loop_and_keeps_its_diag():
    n = Y.AUTO_MIN_ROWS
    x, rng = _blobs(13, n, 8, 6)
    c0 = x[rng.integers(0, n, 6)]
    km = KMeans(n_clusters=6, init=c0, max_iter=20, tol=-1.0,
                device=CPU).fit(x)
    ref = kmeans_tpu.KMeans(n_clusters=6, init=jnp.asarray(c0), max_iter=20,
                            tol=-1.0).fit(jnp.asarray(x))
    np.testing.assert_array_equal(_np(km.labels_), np.asarray(ref.labels_))
    assert km.n_iter_ == ref.n_iter_ == 20
    assert km.diag_["final_flavor"] == 1.0            # promoted at sweep 16
    assert km.diag_["rows_seen"] == 20.0 * n
