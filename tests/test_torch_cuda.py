"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``; it
skips without a card.  On the machine with the card, run from the root of a
checkout (that machine may have no JAX, which ``tests/conftest.py`` imports):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs are tie-free blobs, so labels must be equal.  Sums agree to rtol
1e-4 and atol 1e-4·max|want|: K2 and K4 fold with f32 atomics, in an order
that changes from run to run, and K1, K3 and K6 sum each label's rows in
row order on the fold core, another order than the plain version's (and
exactly ``fold_core_plain``'s: equal bit for bit).  Counts of binary
weights are exact.
Scores (the Hamerly kernel's bounds) agree to rtol 1e-5 and atol
1e-5·max|want|: the kernel and the plain version sum the same f32 products
in another order.
"""

import contextlib

import numpy as np
import pytest
import torch

from kmeans_tpu_torch import KMeans, KMeansConfig, fit_lloyd
from kmeans_tpu_torch.ops import cuda_lloyd as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _blobs(seed, n, d, k, device):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 4
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    c = (centres + 0.1 * rng.normal(size=(k, d))).astype(np.float32)
    w = (rng.random(n) > 0.2).astype(np.float32)
    prev = rng.integers(-1, k, size=n).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (x, c, w, prev)]


def _close(got, want):
    atol = 1e-4 * float(want.abs().max().clamp_min(1e-30))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


def _close_scores(got, want):
    atol = 1e-5 * float(want.abs().max().clamp_min(1e-30))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("x_dtype,cd", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("n,d,k", [(1031, 64, 5), (2053, 100, 130)])
def test_kernels_match_plain_versions(card, n, d, k, x_dtype, cd):
    x, c, w, prev = _blobs(0, n, d, k, card)
    x = x.to(x_dtype)
    K.reset_launch_counts()
    got = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
    want = K.lloyd_pass_plain(x, c, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        _close(g, e)
    got = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd)
    want = K.lloyd_delta_plain(x, c, prev, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:5], want[1:5]):
        _close(g, e)
    assert int(got[5]) == int(want[5]) and int(got[6]) == int(want[6])
    labels = torch.from_numpy(
        np.random.default_rng(1).integers(-2, k + 2, size=n).astype(np.int32)
    ).to(card)
    got = K.accumulate_cuda(x, labels, k, weights=w, compute_dtype=cd)
    want = K.accumulate_plain(x, labels, k, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    for g, e in zip(got, want):
        _close(g, e)
    # K4 with about a third of the rows needed, every sentinel among them.
    gen = torch.Generator(device=card).manual_seed(3)
    need = (torch.rand(n, generator=gen, device=card) < 0.3) | (prev < 0)
    sb_in = torch.randn(n, generator=gen, device=card)
    slb_in = torch.randn(n, generator=gen, device=card)
    got = K.lloyd_hamerly_cuda(x, c, prev, need, sb_in, slb_in, weights=w,
                               compute_dtype=cd)
    want = K.lloyd_hamerly_plain(x, c, prev, need, sb_in, slb_in, weights=w,
                                 compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:3], want[1:3]):
        _close_scores(g, e)
        assert torch.equal(g[~need], e[~need])
    for g, e in zip(got[3:5], want[3:5]):
        _close(g, e)
    assert int(got[5]) == int(want[5]) == int(need.sum())
    assert int(got[6]) == int(want[6])
    assert K.launch_counts() == {"lloyd_pass_cuda": 1, "lloyd_delta_cuda": 1,
                                 "accumulate_cuda": 1,
                                 "lloyd_hamerly_cuda": 1,
                                 "tiled_argmin_cuda": 0,
                                 "tiled_fold_cuda": 0}


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_hamerly_kernel_scores_rows_as_the_delta_kernel_does(card, cd):
    """With every row needed, K4 labels and scores each row exactly as K2
    does: the same score loop, on rows gathered instead of contiguous."""
    x, c, w, prev = _blobs(4, 3001, 96, 130, card)
    need = torch.ones(3001, dtype=torch.bool, device=card)
    zeros = torch.zeros(3001, device=card)
    got = K.lloyd_hamerly_cuda(x, c, prev, need, zeros, zeros, weights=w,
                               compute_dtype=cd)
    lab, raw = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd,
                                  with_mind=False)[:2]
    torch.cuda.synchronize()
    assert torch.equal(got[0], lab) and torch.equal(got[1], raw)
    assert int(got[5]) == 3001 and int(got[6]) == 3   # 3 groups over 256


def test_fit_on_the_card_matches_the_plain_backend(card):
    x, c, _, _ = _blobs(2, 4099, 48, 7, card)
    states = {}
    for backend in ("auto", "plain"):
        cfg = KMeansConfig(k=7, update="delta", backend=backend)
        states[backend] = fit_lloyd(x, 7, init=c, config=cfg, max_iter=20,
                                    tol=-1.0)
    a, b = states["auto"], states["plain"]
    assert torch.equal(a.labels, b.labels)
    _close(a.centroids, b.centroids)
    _close(a.inertia, b.inertia)
    km = KMeans(n_clusters=7, update="delta", compute_dtype="bfloat16").fit(x)
    assert km.cluster_centers_.is_cuda and np.isfinite(km.inertia_)


def _labels_up_to_ties(x, c, got, want):
    """Labels equal but on rows whose two choices both score within 1e-5
    of the row scale of the f64 minimum (the f32 route's tolerance)."""
    rows = (got != want).nonzero()[:, 0]
    s, scale = _scores64(x[rows], c)
    best = s.min(dim=1).values
    for lab in (got, want):
        pick = lab[rows].long()[:, None]
        gap = s.gather(1, pick)[:, 0] - best
        assert bool((gap <= 1e-5 * scale.gather(1, pick)[:, 0]).all())


@pytest.mark.parametrize("accel,update", [
    ("beta", "auto"), ("anderson", "matmul"), ("anderson", "auto")])
def test_accelerated_fits_on_the_card_match_the_plain_backend(
        card, accel, update):
    """The beta loop (K1 every sweep) and the Anderson loop (K1, and K2 on
    its delta sweeps under "auto") against the same loops on the plain
    versions: the first 8 sweeps from data rows on overlapping blobs
    (plain Lloyd takes 17 sweeps to a 1e-6 shift there, so each of the 8
    moves the objective far more than the f32 sums' rounding and every
    decision is clear): the same outcome sequence, and labels up to
    ties."""
    from kmeans_tpu_torch import fit_lloyd_accelerated

    rng = np.random.default_rng(6)
    centres = rng.normal(size=(20, 32)).astype(np.float32)
    x = centres[rng.integers(0, 20, size=8192)] + rng.normal(size=(8192, 32))
    x = torch.from_numpy(x.astype(np.float32)).to(card)
    fits = {}
    for backend in ("cuda", "plain"):
        cfg = KMeansConfig(k=20, update=update, backend=backend)
        K.reset_launch_counts()
        fits[backend] = fit_lloyd_accelerated(
            x, 20, init=x[:20], config=cfg, tol=-1.0, max_iter=8,
            accel=accel, diag=True)
        launches = K.launch_counts()
        if backend == "cuda":
            assert launches["lloyd_pass_cuda"] >= 2
            if accel == "anderson" and update == "auto":
                assert launches["lloyd_delta_cuda"] >= 1
        else:
            assert not any(launches.values())
    (a, da), (b, db) = fits["cuda"], fits["plain"]
    assert da["outcomes"] == db["outcomes"] and len(da["outcomes"]) == 8
    _labels_up_to_ties(x, a.centroids, a.labels, b.labels)
    _close(a.centroids, b.centroids)


def test_minibatch_fits_on_the_card_match_the_plain_backend(card):
    """The Sculley steps are the same PyTorch code on either backend, so
    with one seed the centroids are equal bit for bit; the final sweep (K1)
    gives the plain version's labels up to ties.  The nested ladder (K1 on
    every rung) and its finish (K1, K2) match the plain route."""
    from kmeans_tpu_torch import MiniBatchKMeans, fit_minibatch

    x = _blobs(7, 6000, 48, 7, card)[0]
    ests = {}
    for backend in ("cuda", "plain"):
        K.reset_launch_counts()
        ests[backend] = MiniBatchKMeans(
            n_clusters=7, batch_size=512, steps=40, seed=3,
            backend=backend).fit(x)
        assert K.launch_counts()["lloyd_pass_cuda"] == (backend == "cuda")
    a, b = ests["cuda"].state, ests["plain"].state
    assert torch.equal(a.centroids, b.centroids)
    _labels_up_to_ties(x, a.centroids, a.labels, b.labels)
    nested = {}
    for backend in ("cuda", "plain"):
        cfg = KMeansConfig(k=7, nested_start=512, backend=backend)
        nested[backend] = fit_minibatch(x, 7, init=x[:7], config=cfg,
                                        tol=1e-4, schedule="nested",
                                        return_ladder=True)
    (a, ra), (b, rb) = nested["cuda"], nested["plain"]
    assert ra == rb and len(ra) >= 2
    assert int(a.n_iter) == int(b.n_iter)
    _labels_up_to_ties(x, a.centroids, a.labels, b.labels)
    _close(a.centroids, b.centroids)


@pytest.mark.parametrize("update", ["auto", "hamerly", "yinyang"])
def test_pruned_fit_on_the_card_matches_the_plain_backend(card, update):
    """The bound-pruned loops through K4 against the same loops on the
    plain versions.  Labels and sweeps must be equal (tie-free blobs); the
    recompute counts may differ on rows whose bound test sits within the f32
    accumulation order of the scores, so they agree to 1%.  At n = 20000
    (>= AUTO_MIN_ROWS) "auto" runs the adaptive loop."""
    x, c, _, _ = _blobs(5, 20000, 48, 40, card)
    fits = {}
    for backend in ("auto", "plain"):
        cfg = KMeansConfig(k=40, update=update, backend=backend)
        fits[backend] = fit_lloyd(x, 40, init=c, config=cfg, max_iter=40,
                                  tol=-1.0, diag=True, device=card)
    (a, da), (b, db) = fits["auto"], fits["plain"]
    assert torch.equal(a.labels, b.labels)
    assert int(a.n_iter) == int(b.n_iter) == 40
    _close(a.centroids, b.centroids)
    assert da["final_flavor"] == db["final_flavor"]
    assert da["rows_seen"] == db["rows_seen"] == 40 * 20000
    assert abs(da["recompute_rows"] - db["recompute_rows"]) <= (
        0.01 * db["recompute_rows"])


@pytest.mark.parametrize("x_dtype,cd", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("n,d,k", [(2053, 100, 300), (1031, 64, 130)])
def test_tiled_kernels_match_plain_versions_and_the_untiled_kernels(
        card, n, d, k, x_dtype, cd):
    """K5 against its plain version and, bit for bit, against K2's labels
    and raw scores and K4's second-min; K6 against its plain version, and
    two K6 launches bit for bit."""
    x, c, w, prev = _blobs(6, n, d, k, card)
    x = x.to(x_dtype)
    neg2c, csq = K._score_operands(c, cd)
    K.reset_launch_counts()
    lab, raw, second = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=128,
                                           raw_scores=True, with_second=True)
    want = K.tiled_argmin_plain(x, neg2c, csq, k_tile=128, raw_scores=True,
                                with_second=True)
    torch.cuda.synchronize()
    assert torch.equal(lab, want[0])
    _close_scores(raw, want[1])
    _close_scores(second, want[2])
    k2 = K.lloyd_delta_cuda(x, c, prev, compute_dtype=cd, with_mind=False)
    need = torch.ones(n, dtype=torch.bool, device=card)
    zeros = torch.zeros(n, device=card)
    k4 = K.lloyd_hamerly_cuda(x, c, prev, need, zeros, zeros,
                              compute_dtype=cd)
    assert torch.equal(lab, k2[0]) and torch.equal(raw, k2[1])
    assert torch.equal(second, k4[2])
    # K1's merge norms a row as K5's does; with the fold, the fold core
    # adds ||x||^2 in its own order, within the score tolerance.
    normed = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=256)[1]
    assert torch.equal(normed, K.lloyd_pass_cuda(x, c, compute_dtype=cd,
                                                 with_update=False)[1])
    _close_scores(K.lloyd_pass_cuda(x, c, compute_dtype=cd)[1], normed)
    for lab2 in (None, prev):
        got = K.tiled_fold_cuda(x, w, lab, lab2, k, compute_dtype=cd)
        again = K.tiled_fold_cuda(x, w, lab, lab2, k, compute_dtype=cd)
        want = K.tiled_fold_plain(x, w, lab, lab2, k, compute_dtype=cd)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        _close(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert K.launch_counts()["tiled_argmin_cuda"] == 2
    assert K.launch_counts()["tiled_fold_cuda"] == 4


def test_tiled_sweeps_on_the_card_match_their_plain_versions(card):
    """The four sweep wrappers with k_tile against their plain versions
    with k_tile, and the labeled fold with half the rows on one label."""
    n, d, k = 3001, 96, 300
    x, c, w, prev = _blobs(7, n, d, k, card)
    got = K.lloyd_pass_cuda(x, c, weights=w, k_tile=128)
    want = K.lloyd_pass_plain(x, c, weights=w, k_tile=128)
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        _close(g, e)
    got = K.lloyd_delta_cuda(x, c, prev, weights=w, k_tile=128)
    want = K.lloyd_delta_plain(x, c, prev, weights=w, k_tile=128)
    assert torch.equal(got[0], want[0]) and int(got[5]) == int(want[5])
    for g, e in zip(got[1:5], want[1:5]):
        _close(g, e)
    gen = torch.Generator(device=card).manual_seed(5)
    need = (torch.rand(n, generator=gen, device=card) < 0.4) | (prev < 0)
    sb_in = torch.randn(n, generator=gen, device=card)
    got = K.lloyd_hamerly_cuda(x, c, prev, need, sb_in, sb_in + 1,
                               weights=w, k_tile=128)
    want = K.lloyd_hamerly_plain(x, c, prev, need, sb_in, sb_in + 1,
                                 weights=w, k_tile=128)
    assert torch.equal(got[0], want[0]) and int(got[5]) == int(need.sum())
    for g, e in zip(got[1:5], want[1:5]):
        _close(g, e)
    lab = prev.clone()
    lab[::2] = 3
    got = K.accumulate_cuda(x, lab, k, weights=w, k_tile=128)
    want = K.accumulate_plain(x, lab, k, weights=w, k_tile=128)
    for g, e in zip(got, want):
        _close(g, e)


@contextlib.contextmanager
def _score_block():
    """Every wrapper scores with score_block inside: they read
    ``cuda_lloyd.scoring_core`` at each call."""
    rule = K.scoring_core
    K.scoring_core = lambda *args: "score_block"
    try:
        yield
    finally:
        K.scoring_core = rule


@pytest.mark.parametrize("n,d,k", [(2053, 8, 3), (2053, 200, 257),
                                   (1031, 2048, 1000), (4099, 64, 256)])
def test_hopper_core_matches_plain_versions_and_score_block(card, n, d, k):
    """bf16 x in bf16 compute with d % 8 == 0: K1 and K2 take the Hopper
    core at ragged n, ragged d and ragged or single-column last slices.
    Labels equal the plain version's (tie-free blobs) and, with the scores,
    ``score_block``'s bit for bit; sums to the fold tolerance."""
    x, c, w, prev = _blobs(8, n, d, k, card)
    x = x.to(torch.bfloat16)
    bf16 = torch.bfloat16
    assert K.scoring_core(x, bf16, c.to(bf16)) == "wgmma"
    got1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=bf16)
    want1 = K.lloyd_pass_plain(x, c, weights=w, compute_dtype=bf16)
    got2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=bf16,
                              with_mind=False)
    want2 = K.lloyd_delta_plain(x, c, prev, weights=w, compute_dtype=bf16,
                                with_mind=False)
    torch.cuda.synchronize()
    assert torch.equal(got1[0], want1[0]) and torch.equal(got2[0], want2[0])
    for g, e in zip(got1[1:], want1[1:]):
        _close(g, e)
    _close_scores(got2[1], want2[1])
    for g, e in zip(got2[2:5], want2[2:5]):
        _close(g, e)
    assert int(got2[5]) == int(want2[5]) and int(got2[6]) == int(want2[6])
    with _score_block():
        sb1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=bf16)
        sb2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=bf16,
                                 with_mind=False)
    torch.cuda.synchronize()
    assert torch.equal(got1[0], sb1[0]) and torch.equal(got1[1], sb1[1])
    assert torch.equal(got2[0], sb2[0]) and torch.equal(got2[1], sb2[1])


@pytest.mark.parametrize("x_dtype,cd,d", [
    (torch.bfloat16, torch.bfloat16, 2048), (torch.float32, torch.float32, 64),
    (torch.float32, torch.bfloat16, 64), (torch.bfloat16, torch.bfloat16, 100)])
def test_classic_kernel_sums_repeat_bit_for_bit(card, x_dtype, cd, d):
    """K1 folds with K6's bucketed fold on either core: two launches give
    the same sums and counts bit for bit."""
    x, c, w, _ = _blobs(9, 3001, d, 300, card)
    x = x.to(x_dtype)
    a = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
    b = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    for g, e in zip(a[:4], b[:4]):
        assert torch.equal(g, e)


@pytest.mark.parametrize("k", [257, 512])
def test_hopper_core_tie_at_its_slice_edge_goes_to_the_lower_index(card, k):
    """Centroids 255 and 256 are equal, on either side of the core's
    256-column slice edge; rows on them take label 255 in K1 and K2."""
    x, c, w, prev = _blobs(10, 1031, 96, k, card)
    c[256] = c[255]
    x[:40] = c[255]
    x = x.to(torch.bfloat16)
    bf16 = torch.bfloat16
    lab1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=bf16)[0]
    lab2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=bf16)[0]
    torch.cuda.synchronize()
    assert bool((lab1[:40] == 255).all()) and bool((lab2[:40] == 255).all())


@pytest.mark.parametrize("frac", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("n,d,k", [(2053, 8, 3), (2053, 200, 257),
                                   (1031, 2048, 1000), (4099, 64, 256)])
def test_hamerly_kernel_on_the_core_matches_score_block(card, n, d, k, frac):
    """K4 on the Hopper core (its needed rows listed on the card, gathered
    with cp.async) against score_block's K4 on the same input: labels, sb,
    slb, n_recomputed and dense_tiles bit for bit; against the plain
    version: labels (tie-free blobs), bounds to the score tolerance, sums
    to the fold tolerance; two launches equal bit for bit.  −1 sentinels
    are always needed (none at need fraction 0)."""
    x, c, w, prev = _blobs(11, n, d, k, card)
    x = x.to(torch.bfloat16)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(12)
    if frac == 0.0:
        prev = prev.clamp_min(0)
    need = (torch.rand(n, generator=gen, device=card) < frac) | (prev < 0)
    sb_in = torch.randn(n, generator=gen, device=card)
    slb_in = sb_in + 1
    assert K.scoring_core(x, bf16, c.to(bf16)) == "wgmma"
    args = (x, c, prev, need, sb_in, slb_in)
    kw = dict(weights=w, compute_dtype=bf16)
    got = K.lloyd_hamerly_cuda(*args, **kw)
    again = K.lloyd_hamerly_cuda(*args, **kw)
    with _score_block():
        ref = K.lloyd_hamerly_cuda(*args, **kw)
    want = K.lloyd_hamerly_plain(*args, **kw)
    torch.cuda.synchronize()
    for i in (0, 1, 2, 5, 6):
        assert torch.equal(got[i], again[i]) and torch.equal(got[i], ref[i])
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:3], want[1:3]):
        _close_scores(g, e)
    for g, e in zip(got[3:5], want[3:5]):
        _close(g, e)
    assert int(got[5]) == int(need.sum()) and int(got[6]) == int(want[6])


@pytest.mark.parametrize("k_tile", [128, 384, 1024])
@pytest.mark.parametrize("n,d,k", [(2053, 8, 3), (2053, 200, 257),
                                   (1031, 2048, 1000), (2053, 96, 1100)])
def test_tiled_argmin_on_the_core_matches_score_block(card, n, d, k, k_tile):
    """K5 on the Hopper core over k_tile-wide column ranges against
    score_block's K5 bit for bit (labels, raw min, normed min, second-min),
    two launches bit for bit, against K2's labels and raw scores and K4's
    second-min bit for bit, and against its plain version (labels where the
    winner is clear, scores to the score tolerance); exact ties at a
    256-column sub-slice edge inside a range and at range edges go to the
    lower index, with second-min == min."""
    x, c, _, prev = _blobs(13, n, d, k, card)
    pairs = [(lo, lo + 1) for lo in (127, 255, 383, 1023) if lo + 1 < k]
    for i, (lo, hi) in enumerate(pairs):
        c[hi] = c[lo]
        x[8 * i:8 * (i + 1)] = c[lo]
    x = x.to(torch.bfloat16)
    bf16 = torch.bfloat16
    neg2c, csq = K._score_operands(c, bf16)
    assert K.scoring_core(x, bf16, neg2c) == "wgmma"
    with _score_block():
        ref = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                  raw_scores=True, with_second=True)
        ref_normed = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1]
    for _ in range(2):
        got = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                  raw_scores=True, with_second=True)
        normed = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1]
        torch.cuda.synchronize()
        for g, e in zip(got, ref):
            assert torch.equal(g, e)
        assert torch.equal(normed, ref_normed)
    k2 = K.lloyd_delta_cuda(x, c, prev, compute_dtype=bf16, with_mind=False)
    ones = torch.ones(n, dtype=torch.bool, device=card)
    zeros = torch.zeros(n, device=card)
    k4 = K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                              compute_dtype=bf16)
    want = K.tiled_argmin_plain(x, neg2c, csq, k_tile=k_tile,
                                raw_scores=True, with_second=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1])
    assert torch.equal(got[2], k4[2])
    # Rows with a clear winner (second-min above the min by more than the
    # score tolerance) take the plain version's label; the others -- the
    # planted ties, and the rows of the blobs whose centroids the copies
    # replaced -- may take either of their near-equal scores.
    clear = (want[2] - want[1]) > 1e-5 * float(want[1].abs().max())
    assert torch.equal(got[0][clear], want[0][clear])
    _close_scores(got[1], want[1])
    _close_scores(got[2], want[2])
    for i, (lo, _) in enumerate(pairs):
        rows = slice(8 * i, 8 * (i + 1))
        assert bool((got[0][rows] == lo).all())
        assert torch.equal(got[2][rows], got[1][rows])


def _scores64(x, c):
    """f64 scores csq − 2x·c and their scale ||x||² + ||c||²."""
    x64, c64 = x.double(), c.double()
    csq = (c64 * c64).sum(1)
    return (csq - 2.0 * x64 @ c64.T,
            (x64 * x64).sum(1)[:, None] + csq[None, :])


@pytest.mark.parametrize("n,d,k", [(2053, 4, 3), (2053, 100, 257),
                                   (1031, 2048, 1000), (4099, 64, 256)])
def test_f32_core_matches_plain_versions_and_the_six_pass_model(card, n, d,
                                                               k):
    """f32 x in f32 compute on the core's f32 route (six bf16 passes):
    K1's and K2's labels equal the plain version's (tie-free blobs), the
    raw scores agree with the plain IEEE f32 and the six-pass model to the
    score tolerance and stay within 1e-5 and γ_d = d·2⁻²⁴ of the row scale
    of the f64 product; K4 with every row needed and K5 at k_tile 128 and
    384 give K2's labels and raw scores, K1's normed min and each other's
    second-min bit for bit; two launches are equal bit for bit."""
    x, c, w, prev = _blobs(14, n, d, k, card)
    f32 = torch.float32
    neg2c, csq = K._score_operands(c, f32)
    assert K.scoring_core(x, f32, neg2c) == "wgmma"
    k1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=f32)
    k1n = K.lloyd_pass_cuda(x, c, compute_dtype=f32, with_update=False)
    k2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=f32,
                            with_mind=False)
    again = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=f32,
                               with_mind=False)
    ones = torch.ones(n, dtype=torch.bool, device=card)
    zeros = torch.zeros(n, device=card)
    k4 = K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                              compute_dtype=f32)
    want1 = K.lloyd_pass_plain(x, c, weights=w, compute_dtype=f32)
    want2 = K.lloyd_delta_plain(x, c, prev, weights=w, compute_dtype=f32,
                                with_mind=False)
    torch.cuda.synchronize()
    assert torch.equal(k1[0], want1[0]) and torch.equal(k2[0], want2[0])
    assert torch.equal(k1[0], k2[0])
    for g, e in zip(k1[1:], want1[1:]):
        _close(g, e)
    _close_scores(k2[1], want2[1])
    for g, e in zip(k2[2:5], want2[2:5]):
        _close(g, e)
    assert all(torch.equal(a, b) for a, b in zip(k2[:2], again[:2]))
    assert torch.equal(k4[0], k2[0]) and torch.equal(k4[1], k2[1])
    model = K.six_pass_scores_plain(x, K.neg2c_pieces(neg2c), csq)
    lab = k2[0].long()[:, None]
    s64, scale = _scores64(x, c)
    at = scale.gather(1, lab)[:, 0]
    err = (k2[1].double() - s64.gather(1, lab)[:, 0]).abs() / at
    assert float(err.max()) <= min(1e-5, d * 2.0 ** -24)
    mod = (k2[1].double() - model.gather(1, lab)[:, 0].double()).abs() / at
    assert float(mod.max()) <= 1e-5
    for k_tile in (128, 384):
        lab5, raw5, sec5 = K.tiled_argmin_cuda(
            x, neg2c, csq, k_tile=k_tile, raw_scores=True, with_second=True)
        normed = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1]
        torch.cuda.synchronize()
        assert torch.equal(lab5, k2[0]) and torch.equal(raw5, k2[1])
        assert torch.equal(sec5, k4[2]) and torch.equal(normed, k1n[1])


def test_f32_core_ties_at_sub_slice_and_range_edges(card):
    """Exact duplicate centroids tie exactly on the f32 route too (equal
    pieces): at the 128-column sub-slice edge inside a 256-column range
    (127 | 128, K1 and K2), and for K4 and K5 at range edges (255 | 256,
    383 | 384 at k_tile 128 and 384), the lower index wins with second-min
    == min."""
    n, d, k = 2053, 96, 520
    x, c, _, prev = _blobs(15, n, d, k, card)
    pairs = ((127, 128), (255, 256), (383, 384))
    for i, (lo, hi) in enumerate(pairs):
        c[hi] = c[lo]
        x[8 * i:8 * (i + 1)] = c[lo]
    f32 = torch.float32
    neg2c, csq = K._score_operands(c, f32)
    ones = torch.ones(n, dtype=torch.bool, device=card)
    zeros = torch.zeros(n, device=card)
    outs = [K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                                 compute_dtype=f32)[:3]]
    outs += [K.tiled_argmin_cuda(x, neg2c, csq, k_tile=kt, raw_scores=True,
                                 with_second=True) for kt in (128, 384)]
    lab1 = K.lloyd_pass_cuda(x, c, compute_dtype=f32)[0]
    lab2 = K.lloyd_delta_cuda(x, c, prev, compute_dtype=f32)[0]
    torch.cuda.synchronize()
    for i, (lo, _) in enumerate(pairs):
        rows = slice(8 * i, 8 * (i + 1))
        assert bool((lab1[rows] == lo).all() and (lab2[rows] == lo).all())
        for lab, best, second in outs:
            assert bool((lab[rows] == lo).all())
            assert torch.equal(second[rows], best[rows])


def test_k5_takes_held_pieces(card):
    """K5's ``neg2c_pieces=`` (the serving engine's, split once a
    generation) gives the bits of pieces split per call; pieces that are
    not ``neg2c_pieces(neg2c)``'s shape raise before any launch."""
    x, c, _, _ = _blobs(16, 1031, 300, 130, card)
    neg2c, csq = K._score_operands(c, torch.float32)
    held = K.neg2c_pieces(neg2c)
    K.reset_launch_counts()
    a = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=128, raw_scores=True)
    b = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=128, raw_scores=True,
                            neg2c_pieces=held)
    torch.cuda.synchronize()
    assert all(torch.equal(g, e) for g, e in zip(a, b))
    with pytest.raises(ValueError, match="neg2c_pieces"):
        K.tiled_argmin_cuda(x, neg2c, csq, k_tile=128,
                            neg2c_pieces=held[:, :, :296].contiguous())
    assert K.launch_counts()["tiled_argmin_cuda"] == 2


FOLD_CORE_CASES = [
    # n, d, k, x dtype, compute dtype, every row on one label
    (2053, 2048, 1000, torch.bfloat16, torch.bfloat16, False),
    (2053, 300, 1000, torch.bfloat16, torch.bfloat16, False),
    (1031, 100, 130, torch.float32, torch.float32, False),
    (1031, 4104, 7, torch.bfloat16, torch.bfloat16, False),
    (1031, 64, 1, torch.bfloat16, torch.bfloat16, False),
    (3001, 96, 300, torch.float32, torch.bfloat16, True),
]


@pytest.mark.parametrize("n,d,k,x_dtype,cd,one_label", FOLD_CORE_CASES)
def test_fold_core_gives_one_set_of_bits(card, n, d, k, x_dtype, cd,
                                         one_label):
    """K6's single and dual folds, K3 and K1's fold on the fold core: each
    equal to ``fold_core_plain`` (the core's order, op by op) and to a
    second launch bit for bit, K3's and K1's sums and counts equal to K6's
    single fold's at the same labels, and each within the tolerances of
    its plain version (min_d2 at rtol 1e-5).  Labels outside [0, k),
    zero weights and, in the dual fold, rows with equal labels fold
    nothing; d = 300 takes the column-strided loads, d = 4104 three column
    spans."""
    x, c, w, prev = _blobs(11, n, d, k, card)
    x = x.to(x_dtype)
    gen = torch.Generator(device=card).manual_seed(12)
    lab = torch.randint(-2, k + 2, (n,), generator=gen, device=card,
                        dtype=torch.int32)
    if one_label:
        lab[3:] = k // 2
    lab2 = torch.where(torch.rand(n, generator=gen, device=card) < 0.3, lab,
                       prev)
    scores = torch.randn(n, generator=gen, device=card)
    for l2 in (None, lab2):
        got = K.tiled_fold_cuda(x, w, lab, l2, k, compute_dtype=cd)
        again = K.tiled_fold_cuda(x, w, lab, l2, k, compute_dtype=cd)
        model = K.fold_core_plain(x, w, lab, l2, k, compute_dtype=cd)
        plain = K.tiled_fold_plain(x, w, lab, l2, k, compute_dtype=cd)
        torch.cuda.synchronize()
        for g, a, m in zip(got, again, model):
            assert torch.equal(g, a) and torch.equal(g, m)
        _close(got[0], plain[0])
        assert torch.equal(got[1], plain[1])
        if l2 is None:
            single = got
    k3 = K.accumulate_cuda(x, lab, k, scores=scores, weights=w,
                           compute_dtype=cd)
    k3b = K.accumulate_cuda(x, lab, k, scores=scores, weights=w,
                            compute_dtype=cd)
    plain = K.accumulate_plain(x, lab, k, scores=scores, weights=w,
                               compute_dtype=cd)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k3, k3b))
    assert torch.equal(k3[0], single[0]) and torch.equal(k3[1], single[1])
    _close_scores(k3[2], plain[2])
    k1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
    at = K.tiled_fold_cuda(x, w, k1[0], None, k, compute_dtype=cd)
    want = K.lloyd_pass_plain(x, c, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(k1[2], at[0]) and torch.equal(k1[3], at[1])
    assert torch.equal(k1[0], want[0])
    # K1's min_d2 is its raw score (the scoring core's, unchanged) plus the
    # fold core's ||x||^2: held to rtol 1e-5 of ||x||^2, the sum of the
    # terms it adds up, against the raw score plus the plain ||x||^2.
    raw = K.lloyd_pass_cuda(x, c, compute_dtype=cd, with_update=False,
                            raw_scores=True)[1]
    sq = x.float().pow(2).sum(1)
    assert bool(((k1[1] - (raw + sq).clamp_min(0)).abs() <= 1e-5 * sq).all())


def _serve_problem(seed, k, d, n):
    """Centroids in meta-clusters and queries near their own centroid (tie
    free), plus far rows whose certificates fail."""
    rng = np.random.default_rng(seed)
    g = max(2, int(round(k ** 0.5)))
    meta = rng.normal(size=(g, d)) * 10
    c = meta[rng.integers(0, g, size=k)] + rng.normal(size=(k, d))
    x = c[rng.integers(0, k, size=n)] + 0.1 * rng.normal(size=(n, d))
    x[: n // 10] = rng.normal(size=(n // 10, d)) * 30
    return c.astype(np.float32), x.astype(np.float32)


SERVE_ROUTES = {
    "dense": dict(assign_prune_min_k=0),
    "pruned": {},
    "quant int8": dict(assign_quant="int8", assign_quant_min_rows=1),
    "quant bf16": dict(assign_quant="bf16", assign_quant_min_rows=1),
}


@pytest.mark.parametrize("route", sorted(SERVE_ROUTES))
def test_engine_routes_on_the_card_match_the_cpu_engine(card, route):
    """The engine on the card (``auto``: the device routes) against the
    engine on the CPU: equal labels on tie-free data.  The dense route
    launches K5 once a batch; the others launch it once for each batch
    whose certificates fail (the rows far from every centroid)."""
    import dataclasses

    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.continuous.registry import Generation
    from kmeans_tpu_torch.serve.assign import AssignEngine

    c, x = _serve_problem(5, 1000, 200, 3000)
    gen = Generation(c, 1)
    cfg = dataclasses.replace(ServeConfig(), **SERVE_ROUTES[route])
    engines = [AssignEngine(lambda: gen, cfg), AssignEngine(
        lambda: gen, cfg, device="cpu")]
    got, rescored = [], 0
    try:
        assert engines[0]._pruned_route() == "device"
        K.reset_launch_counts()
        for s in range(0, 3000, 700):
            before = engines[0].stats()
            got.append(engines[0].submit(x[s:s + 700])[0])
            after = engines[0].stats()
            rescored += any(after[key] > before[key] for key in (
                "fallback_rows", "quant_rescore_rows"))
        counts = K.launch_counts()
        got += [engines[1].submit(x[s:s + 700])[0]
                for s in range(0, 3000, 700)]
    finally:
        for e in engines:
            e.stop()
    np.testing.assert_array_equal(np.concatenate(got[:5]),
                                  np.concatenate(got[5:]))
    want_k5 = 5 if route == "dense" else rescored
    assert route == "dense" or rescored >= 1
    assert counts == {**{name: 0 for name in counts},
                      "tiled_argmin_cuda": want_k5}


def test_engine_dense_route_fails_the_batch_where_k5_refuses(card,
                                                             monkeypatch):
    """A refused launch fails the batch's requests; nothing gives way to
    the plain version on the card."""
    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.continuous.registry import Generation
    from kmeans_tpu_torch.serve import assign as A

    monkeypatch.setattr(A, "dense_k_tile", lambda k, d: 100)
    gen = Generation(np.eye(4, dtype=np.float32), 1)
    eng = A.AssignEngine(lambda: gen, ServeConfig(assign_prune_min_k=0))
    K.reset_launch_counts()
    try:
        with pytest.raises(ValueError, match="multiple of 128"):
            eng.submit(np.ones((3, 4), np.float32))
    finally:
        eng.stop()
    assert K.launch_counts()["tiled_argmin_cuda"] == 0
