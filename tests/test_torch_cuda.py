"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``; it
skips without a card.  On the machine with the card, run from the root of a
checkout (that machine may have no JAX, which ``tests/conftest.py`` imports):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs are tie-free blobs, so labels must be equal.  Sums agree to rtol
1e-4 and atol 1e-4·max|want|: every kernel that folds rows (K1, K3 and
K6's single fold; K2, K4 and K6's dual fold over the changed rows) sums
each label's rows in row order on the fold core, another order than the
plain version's ``segment_sum`` (and exactly ``fold_core_plain``'s: equal
bit for bit, the same bits every launch).  Counts of binary weights are
exact.  The plain route, the families and the metrics (ROADMAP C11) run
twice at thousands of rows a cluster and must repeat bit for bit.  The
selections by value (ROADMAP C13) run on values tied on purpose and must
pick the CPU's rows, bit for bit, on two runs.
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


@pytest.mark.parametrize("x_dtype,cd,d", [
    (torch.bfloat16, torch.bfloat16, 2048), (torch.float32, torch.float32, 64),
    (torch.float32, torch.bfloat16, 64), (torch.bfloat16, torch.bfloat16, 100)])
def test_delta_kernels_fold_on_the_fold_core(card, x_dtype, cd, d):
    """K2 (``with_mind`` both ways) and K4 (need 10% and 100%) on either
    scoring core, bf16 and the f32 route: ``dsums`` and ``dcounts`` equal
    ``fold_core_plain`` over ``delta_fold_weights`` bit for bit, and a
    second launch equals the first in every output."""
    x, c, w, prev = _blobs(13, 3001, d, 300, card)
    x = x.to(x_dtype)
    gen = torch.Generator(device=card).manual_seed(14)
    core = K.scoring_core(x, cd, c.to(cd))
    assert core == ("score_block" if x_dtype != cd or d == 100 else "wgmma")
    runs = [(K.lloyd_delta_cuda, (x, c, prev),
             dict(weights=w, compute_dtype=cd, with_mind=m), 2)
            for m in (True, False)]
    for frac in (0.1, 1.0):
        need = (torch.rand(3001, generator=gen, device=card) < frac) \
            | (prev < 0)
        sb_in = torch.randn(3001, generator=gen, device=card)
        runs.append((K.lloyd_hamerly_cuda, (x, c, prev, need, sb_in,
                                            sb_in + 1),
                     dict(weights=w, compute_dtype=cd), 3))
    for fn, args, kw, at in runs:
        got, again = fn(*args, **kw), fn(*args, **kw)
        fold_w = K.delta_fold_weights(got[0], prev, w)
        model = K.fold_core_plain(x, fold_w, got[0], prev, 300,
                                  compute_dtype=cd)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert torch.equal(got[at], model[0])
        assert torch.equal(got[at + 1], model[1])


def test_default_fit_repeats_bit_for_bit(card):
    """The default fit (``update="auto"``: delta sweeps, then the bound
    flavours) run twice from one init gives the same centroids, labels,
    sweeps and counters: no kernel on its path sums floats with
    atomics."""
    x, c, _, _ = _blobs(15, 20_000, 64, 40, card)
    x = x.to(torch.bfloat16)
    fits = [KMeans(n_clusters=40, compute_dtype="bfloat16", init=c,
                   max_iter=40, tol=-1.0).fit(x) for _ in range(2)]
    a, b = fits
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    assert torch.equal(a.labels_, b.labels_)
    assert a.n_iter_ == b.n_iter_ == 40 and a.diag_ == b.diag_


def test_coreset_draws_repeat_on_the_card(card):
    """``lightweight_coreset`` on the card: one seed gives the same points
    and weights on every call (its CDF is summed in fixed point; a float
    cumsum on the card varies in its last bits from run to run)."""
    from kmeans_tpu_torch.data.coreset import lightweight_coreset

    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(36864, 256)).astype(np.float32))
    w = torch.from_numpy(rng.random(36864).astype(np.float32))
    x, w = x.to(card), w.to(card)
    runs = [lightweight_coreset(5, x, 4096, weights=w) for _ in range(10)]
    torch.cuda.synchronize()
    for p, cw in runs[1:]:
        assert torch.equal(p, runs[0][0]) and torch.equal(cw, runs[0][1])


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


def test_server_on_the_card_answers_with_k5_labels(card, tmp_path):
    """``KMeansServer`` with no ``device`` serves on the card: one binary
    request over HTTP gets K5's labels, from one K5 launch (the dense
    route)."""
    import urllib.request

    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.continuous.registry import ModelRegistry
    from kmeans_tpu_torch.serve import assign as A
    from kmeans_tpu_torch.serve.server import KMeansServer

    c, x = _serve_problem(6, 300, 128, 256)
    path = str(tmp_path / "model")
    ModelRegistry(path=path).publish(c)
    s = KMeansServer(ServeConfig(port=0, model_dir=path,
                                 assign_prune_min_k=0))
    assert s.device.type == "cuda"
    httpd = s.start()
    try:
        K.reset_launch_counts()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/assign",
            data=A.encode_points(x),
            headers={"Content-Type": A.WIRE_POINTS_CONTENT_TYPE},
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            labels, _, generation, k = A.decode_labels(r.read())
        counts = K.launch_counts()
    finally:
        s.stop()
    ct = torch.from_numpy(c).to(card)
    want = K.tiled_argmin_cuda(
        torch.from_numpy(x).to(card), (ct * -2).contiguous(),
        (ct * ct).sum(1), k_tile=A.dense_k_tile(*c.shape),
        raw_scores=True)[0]
    np.testing.assert_array_equal(labels, want.cpu().numpy())
    assert (generation, k) == (1, 300)
    assert counts["tiled_argmin_cuda"] == 1


def test_cli_fleet_on_the_card_answers_reloads_and_drains(card, tmp_path):
    """``python -m kmeans_tpu_torch.cli serve --workers 2`` with no
    ``--device`` serves on the card: binary requests over fresh
    connections (spread over both workers) get K5's labels, a generation
    published to the directory reaches every worker, and SIGTERM drains
    the fleet with exit 0."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from kmeans_tpu_torch.continuous.registry import ModelRegistry
    from kmeans_tpu_torch.serve import assign as A

    c, x = _serve_problem(6, 300, 128, 256)
    path = str(tmp_path / "model")
    ModelRegistry(path=path).publish(c)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("KMEANS_TPU_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmeans_tpu_torch.cli", "serve", "--workers",
         "2", "--port", str(port), "--model-dir", path, "--persist-dir",
         str(tmp_path / "rooms")],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = f"http://127.0.0.1:{port}"

    def labels_of():
        req = urllib.request.Request(
            base + "/api/assign", data=A.encode_points(x),
            headers={"Content-Type": A.WIRE_POINTS_CONTENT_TYPE},
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            lab, _, gen, _ = A.decode_labels(r.read())
        return lab, gen

    def k5(cc):
        ct = torch.from_numpy(cc).to(card)
        return K.tiled_argmin_cuda(
            torch.from_numpy(x).to(card), (ct * -2).contiguous(),
            (ct * ct).sum(1), k_tile=A.dense_k_tile(*cc.shape),
            raw_scores=True)[0].cpu().numpy()

    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.communicate(timeout=30)[0]
            try:
                with urllib.request.urlopen(base + "/readyz", timeout=5):
                    break
            except OSError:
                assert time.monotonic() < deadline, "fleet never ready"
                time.sleep(0.2)
        for _ in range(8):
            lab, gen = labels_of()
            assert gen == 1
            np.testing.assert_array_equal(lab, k5(c))
        reg = ModelRegistry(path=path)
        reg.load_latest()
        c2 = c[::-1].copy()
        reg.publish(c2)
        deadline = time.monotonic() + 60
        while sum(labels_of()[1] == 2 for _ in range(8)) < 8:
            assert time.monotonic() < deadline, "generation 2 never served"
            time.sleep(0.1)
        lab, gen = labels_of()
        np.testing.assert_array_equal(lab, k5(c2))
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0, out
        assert "Traceback" not in out and "CUDA error" not in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("update", ["delta", "yinyang"])
def test_runner_on_the_card_matches_the_plain_backend(card, update):
    """Five step-paced iterations on the card's kernels against the same
    runner on ``backend="plain"``: the same labels, per-iteration inertia
    and centroids to the sums' tolerance, and the kernels launched."""
    from kmeans_tpu_torch.models import LloydRunner

    x, c, _, _ = _blobs(5, 4099, 48, 7, card)
    runs = {}
    for backend in ("auto", "plain"):
        r = LloydRunner(x, 7, config=KMeansConfig(k=7, update=update,
                                                  backend=backend))
        r.init(c)
        infos = []
        K.reset_launch_counts()
        state = r.run(max_iter=5, tol=-1.0, callback=infos.append)
        runs[backend] = (state, infos, K.launch_counts())
    (a, ia, launches), (b, ib, plain_launches) = runs["auto"], runs["plain"]
    assert int(a.n_iter) == int(b.n_iter) == 5
    assert torch.equal(a.labels, b.labels)
    _close(a.centroids, b.centroids)
    np.testing.assert_allclose([i.inertia for i in ia],
                               [i.inertia for i in ib], rtol=1e-4)
    # K1 runs the delta loop's refresh sweep and, for both, the final view.
    # The yinyang loop refreshes on K4 with every row needed (a sentinel
    # state, as the reference's runner does), so its one K1 is the view.
    assert launches["lloyd_pass_cuda"] == (2 if update == "delta" else 1)
    kernel = "lloyd_delta_cuda" if update == "delta" else "lloyd_hamerly_cuda"
    assert launches[kernel] >= 4
    assert sum(plain_launches.values()) == 0


@pytest.mark.parametrize("budget", [dict(n_trim=150), dict(n_trim=0),
                                    dict(trim_fraction=1e-4)])
@pytest.mark.parametrize("k", [5, 300])
def test_trimmed_fit_on_the_card_matches_the_plain_backend(card, k, budget):
    """``fit_trimmed`` on the kernels (K1, and K6 for the correction's
    fold) gives the plain backend's labels and mask on the card from one
    init, zero-weight rows included; sums to the fold's tolerance.  With
    no row trimmed (``n_trim=0``, or a fraction of 3000 rows that rounds
    to 0) nothing is folded: K6 is not launched."""
    from kmeans_tpu_torch import fit_trimmed

    x, c, w, _ = _blobs(17, 3000, 64, k, card)
    cfg = dict(init="given", max_iter=8, tol=-1.0)
    folds = 9 if budget.get("n_trim") == 150 else 0
    states = []
    for backend in ("cuda", "plain"):
        K.reset_launch_counts()
        states.append(fit_trimmed(
            x, k, init=c, weights=w, device=card,
            config=KMeansConfig(k=k, backend=backend, **cfg), **budget))
        counts = K.launch_counts()
        if backend == "cuda":
            assert counts["lloyd_pass_cuda"] == 9
            assert counts["tiled_fold_cuda"] == folds
        else:
            assert sum(counts.values()) == 0
    got, want = states
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.outlier_mask, want.outlier_mask)
    assert not bool(got.outlier_mask[w == 0].any())
    _close(got.centroids, want.centroids)
    _close(got.counts, want.counts)


def _host_blobs(seed, n, d, k):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 6
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    pick = [int(np.flatnonzero(lab == j)[0]) for j in range(k)]
    return x, x[pick].copy()


@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("to_bf16", [False, True])
def test_pinned_prefetch_on_the_card_keeps_order_and_values(card, background,
                                                            to_bf16):
    """Batches gathered into the pinned ring and copied on the side stream
    arrive on the card in order, equal to a fresh host gather, with the
    native gather only."""
    from kmeans_tpu_torch.data import stream
    from kmeans_tpu_torch.native import loader

    x, _ = _host_blobs(3, 20_000, 256, 4)
    dtype = torch.bfloat16 if to_bf16 else torch.float32
    ring = stream.staging_ring(card, 2, 512, 256, dtype)
    assert all(b.is_pinned() for b in ring.bufs) and len(ring.bufs) == 3
    loader.reset_gather_counts()
    got = [b.clone() for b in stream.prefetch_to_device(
        stream.sample_batches(x, 512, 12, seed=5, to_bf16=to_bf16,
                              ring=ring),
        depth=2, device=card, background=background, ring=ring)]
    assert loader.gather_counts() == {"native": 12, "numpy": 0}
    want = list(stream.sample_batches(x, 512, 12, seed=5, to_bf16=to_bf16))
    assert len(got) == 12
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == dtype
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("transfer,cd", [(None, None), ("auto", "bfloat16")])
def test_streamed_fit_on_the_card_matches_a_replay(card, transfer, cd):
    """``fit_minibatch_stream`` on the card equals, bit for bit, the same
    batches through ``batch_update`` on card-resident copies; its final
    pass is K1 and gives the plain backend's labels."""
    from kmeans_tpu_torch.data.stream import sample_batches
    from kmeans_tpu_torch.models.minibatch import batch_update
    from kmeans_tpu_torch.models.streaming import (assign_stream,
                                                   fit_minibatch_stream)

    x, c0 = _host_blobs(4, 30_000, 128, 6)
    to_bf16 = transfer == "auto"
    K.reset_launch_counts()
    st = fit_minibatch_stream(
        x, 6, init=c0, transfer_dtype=transfer, device=card,
        config=KMeansConfig(k=6, steps=40, batch_size=1024,
                            compute_dtype=cd))
    assert K.launch_counts()["lloyd_pass_cuda"] >= 1
    c = torch.from_numpy(c0).to(card)
    n_seen = torch.zeros(6, device=card)
    for xb in sample_batches(x, 1024, 40, to_bf16=to_bf16):
        c, n_seen, _, _ = batch_update(c, n_seen, xb.to(card),
                                       compute_dtype=cd)
    assert torch.equal(st.centroids, c)
    lab, inertia = assign_stream(x, st.centroids, chunk_size=8192,
                                 compute_dtype=cd, backend="plain",
                                 device=card)
    assert np.array_equal(st.labels.cpu().numpy(), lab)
    np.testing.assert_allclose(float(st.inertia), inertia, rtol=1e-4)


def test_continuous_pipeline_on_the_card_matches_the_cpu(card):
    """The pipeline on the card (K1 for the batch inertia and the
    coresets, K1 and K2 in the refits) against the same pipeline on the
    CPU, with no compaction (the two devices' generators draw differently):
    the same triggers and generations, per-point inertia to 1e-3."""
    import functools

    from kmeans_tpu_torch.continuous import (ContinuousConfig,
                                             ContinuousPipeline,
                                             ModelRegistry, drift_batch)

    src = functools.partial(drift_batch, n=512, d=16, k=4, seed=2,
                            drift_at=8, drift=12.0)
    runs = {}
    for dev in (card, torch.device("cpu")):
        infos = []
        K.reset_launch_counts()
        pipe = ContinuousPipeline(
            src, ContinuousConfig(k=4, refit_every=5), device=dev,
            registry=ModelRegistry())
        pipe.run(20, callback=infos.append)
        runs[dev.type] = (infos, K.launch_counts())
    (a, launches), (b, cpu_launches) = runs["cuda"], runs["cpu"]
    assert [(i.refit, i.generation) for i in a] == \
        [(i.refit, i.generation) for i in b]
    assert "drift" in {i.refit for i in a}
    np.testing.assert_allclose([i.inertia_pp or 0.0 for i in a],
                               [i.inertia_pp or 0.0 for i in b], rtol=1e-3)
    assert launches["lloyd_pass_cuda"] > 0 and launches["lloyd_delta_cuda"] > 0
    assert sum(cpu_launches.values()) == 0


@pytest.mark.parametrize("update", ["delta", "matmul"])
def test_nccl_mesh_of_one_matches_fit_lloyd(card, update):
    """The sharded engine on an NCCL mesh of one card (a process group of
    one, made by ``make_mesh``) gives ``fit_lloyd``'s fit from the same c0:
    labels equal, centroids and inertia to the sums' tolerance."""
    import torch.distributed as dist

    from kmeans_tpu_torch.parallel import fit_lloyd_sharded, make_mesh

    x, c, _, _ = _blobs(21, 20_000, 64, 12, card)
    cfg = KMeansConfig(k=12, update=update)
    want = fit_lloyd(x, 12, config=cfg, init=c, max_iter=20, tol=-1.0)
    mesh = make_mesh((1, 1))
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        got = fit_lloyd_sharded(x, 12, mesh=mesh, config=cfg, init=c,
                                max_iter=20, tol=-1.0)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.labels, want.labels)
    assert int(got.n_iter) == int(want.n_iter)
    _close(got.centroids, want.centroids)
    _close(got.inertia, want.inertia)
    _close(got.counts, want.counts)


def test_row_block_owns_its_rows_on_the_card(card):
    """A rank's block of a card tensor is a copy of its rows, not a view
    that keeps all of x alive on the card: its storage is n_loc rows."""
    from kmeans_tpu_torch.parallel.engine import _row_block

    x = torch.randn(40, 3, device=card)
    view = torch.randn(80, 3, device=card)[:40]
    for xin in (x, view):
        for rank in range(4):
            block = _row_block(xin, 40, 11, rank, card)
            assert block.untyped_storage().nbytes() == 11 * 3 * 4
            rows = xin[11 * rank:11 * rank + 11]
            assert torch.equal(block[:rows.shape[0]], rows)


@pytest.mark.parametrize("k_tile", [None, 128])
@pytest.mark.parametrize("x_dtype,cd", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)])
def test_tp_hooks_match_plain(card, x_dtype, cd, k_tile):
    """The TP body's hooks: K1 (or K5) in raw-score mode with the last
    columns masked by ``valid_cols``, and K3 (or K6) with given scores and
    relative labels, some outside the slice, against the plain versions."""
    x, c, w, _ = _blobs(11, 3001, 256, 300, card)
    x = x.to(x_dtype)
    valid = torch.arange(300, device=card) < 297
    kw = dict(valid_cols=valid, with_update=False, raw_scores=True,
              compute_dtype=cd, k_tile=k_tile)
    lab, raw, _, _, _ = K.lloyd_pass_cuda(x, c, **kw)
    plab, praw, _, _, _ = K.lloyd_pass_plain(x, c, **kw)
    torch.testing.assert_close(lab, plab, rtol=0, atol=0)
    assert int(lab.max()) < 297
    _close_scores(raw, praw)
    rel = (lab - 100).to(torch.int32)         # a slice of [100, 200)
    fkw = dict(scores=raw, weights=w, compute_dtype=cd, k_tile=k_tile)
    got = K.accumulate_cuda(x, rel, 100, **fkw)
    want = K.accumulate_plain(x, rel, 100, **fkw)
    _close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    _close_scores(got[2], want[2])


# ---------------------------------------------------------------------------
# C11: the plain route, the families' and the metrics' float sums give the
# same bits on every run (thousands of rows a cluster, so that an atomic
# scatter would reorder its adds).
# ---------------------------------------------------------------------------

def _c11_problem(card, n=200_000, d=64, k=64):
    """Tie-free blobs, their generating labels, centres near the blobs'
    and fractional weights, on the card."""
    rng = np.random.default_rng(21)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 4
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    c = (centres + 0.1 * rng.normal(size=(k, d))).astype(np.float32)
    w = (rng.random(n) + 0.25).astype(np.float32)
    return [torch.from_numpy(a).to(card) for a in (x, lab, c, w)]


def _same_bits(what, got, again):
    """Two runs' outputs equal bit for bit; the message says by how much
    each differing one moved."""
    torch.cuda.synchronize()
    moved = []
    for i, (a, b) in enumerate(zip(got, again)):
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs()
            moved.append(f"output {i}: {int((diff > 0).sum())} of "
                         f"{a.numel()} differ, by at most "
                         f"{float(diff.max())!r}")
    assert not moved, f"{what}: " + "; ".join(moved)


@pytest.mark.parametrize("form", ["pass", "delta", "tiled"])
def test_plain_route_folds_repeat_on_the_card(card, form):
    """The plain versions on the card (the route the weights veto takes)
    fold fractional weights in bf16 to the same bits on every call."""
    x, lab, c, w = _c11_problem(card)
    x = x.to(torch.bfloat16)
    prev = torch.roll(lab, 1).to(torch.int32)
    calls = {
        "pass": lambda: K.lloyd_pass_plain(x, c, weights=w,
                                           compute_dtype=torch.bfloat16,
                                           update="segment"),
        "delta": lambda: K.lloyd_delta_plain(x, c, prev, weights=w,
                                             compute_dtype=torch.bfloat16),
        "tiled": lambda: K.tiled_fold_plain(x, w, lab.to(torch.int32), prev,
                                            64, compute_dtype=torch.bfloat16,
                                            k_tile=None),
    }
    _same_bits(f"the plain {form} fold", calls[form](), calls[form]())


@pytest.mark.parametrize("init", ["given", "k-means||"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_fits_on_the_plain_route_repeat(card, init, weighted):
    """A bf16 fit with fractional weights (the weights veto's plain route,
    ``update="segment"``) and a bf16 fit seeded with k-means|| (its refine
    fit over the candidates' counts takes that route too) give the same
    centroids and labels on every run."""
    x, _, c, w = _c11_problem(card)
    x = x.to(torch.bfloat16)
    kw = dict(weights=w) if weighted else {}

    def fit():
        km = KMeans(n_clusters=64, compute_dtype="bfloat16",
                    init=c if init == "given" else init, seed=3,
                    max_iter=10, tol=-1.0).fit(x, **kw)
        return km.cluster_centers_, km.labels_, torch.tensor(km.inertia_)
    _same_bits(f"bf16 fit init={init} weighted={weighted}", fit(), fit())


@pytest.mark.parametrize("family", ["bisecting", "xmeans"])
def test_bf16_splitting_families_repeat(card, family):
    """bf16 bisecting and x-means (their inner 2-means fits take 0/1 masks
    as weights, so the plain route; x-means' split test sums each
    cluster's SSE) give the same splits, centroids and labels on every
    run."""
    import kmeans_tpu_torch as kt

    x, _, _, _ = _c11_problem(card, k=16)
    x = x.to(torch.bfloat16)
    cfg = KMeansConfig(k=8, seed=0, compute_dtype="bfloat16")

    def fit():
        st = (kt.fit_bisecting(x, 8, config=cfg) if family == "bisecting"
              else kt.fit_xmeans(x, 16, config=cfg))
        return st.centroids, st.labels, st.counts, st.n_iter
    _same_bits(f"bf16 {family}", fit(), fit())


def test_scores_repeat_on_the_card(card):
    """``silhouette_score`` (a sample against every row) and
    ``davies_bouldin_score`` give the same bits on every call."""
    from kmeans_tpu_torch.metrics import (davies_bouldin_score,
                                          silhouette_score)

    x, lab, c, _ = _c11_problem(card)

    def scores():
        gen = torch.Generator(device=card).manual_seed(5)
        return (silhouette_score(x, lab, k=64, sample_size=2000,
                                 generator=gen),
                davies_bouldin_score(x, lab, c))
    _same_bits("silhouette and Davies-Bouldin", scores(), scores())


def test_balanced_counts_repeat_under_weights(card):
    """``fit_balanced``'s reported counts under fractional weights are the
    same bits on every run."""
    import kmeans_tpu_torch as kt

    x, _, c, w = _c11_problem(card)

    def fit():
        st = kt.fit_balanced(x, 64, init=c, weights=w, max_iter=3,
                             sinkhorn_sweeps=50)
        return st.counts, st.centroids, st.labels
    _same_bits("balanced counts", fit(), fit())


def test_gmm_sample_repeats_on_the_card(card):
    """``gmm_sample`` draws the same components and rows from one seed on
    every call."""
    from kmeans_tpu_torch.models.gmm import GMMParams, gmm_sample

    rng = np.random.default_rng(22)
    pi = rng.random(64) + 0.1
    params = GMMParams(*(torch.from_numpy(a.astype(np.float32)).to(card)
                         for a in (rng.normal(size=(64, 8)) * 4,
                                   rng.random((64, 8)) + 0.5,
                                   np.log(pi / pi.sum()))))

    def draw():
        gen = torch.Generator(device=card).manual_seed(7)
        return gmm_sample(gen, params, 200_000)
    _same_bits("gmm_sample", draw(), draw())


def _bits(t):
    t = t.cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("what", ["top_stable", "reseed"])
def test_tied_selection_on_the_card_picks_the_cpu_rows(card, what):
    """ROADMAP C13: 200,000 values in blocks of ties (about 4,000 rows a
    value, signed zeros in the lowest block): ``top_stable`` (m = 1,000
    and m = n) and the farthest reseed (k = 1,000, 40 empty slots) pick on
    the card the rows they pick on the CPU, bit for bit, on two runs."""
    from kmeans_tpu_torch.ops.update import reseed_empty_farthest

    rng = np.random.default_rng(13)
    n, d, k = 200_000, 64, 1000
    v = rng.integers(0, 50, size=n).astype(np.float32)
    zero = v == 0
    v[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    if what == "top_stable":
        from kmeans_tpu_torch.ops.select import top_stable

        def run(dev):
            t = torch.from_numpy(v).to(dev)
            return [r for m in (k, n) for r in top_stable(t, m)]
    else:
        x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
        c = rng.normal(size=(k, d)).astype(np.float32)
        counts = np.ones(k, np.float32)
        counts[rng.choice(k, 40, replace=False)] = 0

        def run(dev):
            return [reseed_empty_farthest(*(torch.from_numpy(a).to(dev)
                                            for a in (c, counts, x, v)))]
    want = [_bits(t) for t in run("cpu")]
    for _ in range(2):
        got = run(card)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), w)
