"""The port's k-tiled route (K5 / K6 and the planner) against the JAX package,
on the CPU.

The reference's tiled wrappers run as ``tests/test_pallas_tiled.py`` runs
them: ``lloyd_pass_pallas`` / ``lloyd_delta_pallas`` /
``lloyd_hamerly_pallas`` / ``accumulate_pallas`` with ``k_tile=128`` in
interpret mode.  The port runs its wrappers with ``k_tile=128`` on CPU
tensors, where they take their plain versions (``tiled_argmin_plain``,
``tiled_fold_plain``).  Inputs are made with numpy from a seed.

Tolerances: the data are small integers, so every score, norm and sum is an
exact f32 (and bf16) value whatever the summation order: labels, second-min,
min_d2, sums, counts and inertia are compared with ``assert_array_equal``.
The many exact ties of integer data pin the lowest-index rule on both
sides.  The whole fit runs real-valued centroids after its first update and
compares them at rtol 1e-5, atol 1e-4·max|want| (the two packages sum the
same f32 terms in different orders), labels and sweep counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.ops.pallas_lloyd import (_tiled_argmin, accumulate_pallas,
                                         lloyd_delta_pallas,
                                         lloyd_hamerly_pallas,
                                         lloyd_pass_pallas)
from kmeans_tpu_torch import KMeansConfig, fit_lloyd
from kmeans_tpu_torch.models.lloyd import fit_plan
from kmeans_tpu_torch.ops import cuda_lloyd as K
from kmeans_tpu_torch.ops import plan as P
from kmeans_tpu_torch.ops.delta import delta_kernel_plan
from kmeans_tpu_torch.ops.hamerly import hamerly_kernel_plan
from kmeans_tpu_torch.ops.yinyang import yinyang_kernel_plan

CD = ["float32", "bfloat16"]
#: Integer data: n rows, d = 100 (not a multiple of 8), values in [-4, 4].
N, D = 520, 100


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _ints(seed, n, d, k):
    """Integer rows and centroids (exact in bf16), binary weights, and a
    previous labelling with −1 sentinels."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    c = rng.integers(-4, 5, size=(k, d)).astype(np.float32)
    w = (rng.random(n) > 0.25).astype(np.float32)
    prev = rng.integers(-1, k, size=n).astype(np.int32)
    return x, c, w, prev, rng


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _equal(got, want, names):
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)


PASS = ("labels", "min_d2", "sums", "counts", "inertia")


@pytest.mark.parametrize("cd", CD)
@pytest.mark.parametrize("k", [100, 128, 130, 256, 300])
def test_classic_tiled_matches_pallas_tiled(k, cd):
    """k below one slice, exactly one, just past one, two, and a ragged
    third slice."""
    x, c, w, _, _ = _ints(k, N, D, k)
    got = K.lloyd_pass_cuda(*_t(x, c), weights=torch.from_numpy(w),
                            compute_dtype=cd, k_tile=128)
    want = lloyd_pass_pallas(*_j(x, c), weights=jnp.asarray(w),
                             compute_dtype=cd, k_tile=128, interpret=True)
    _equal(got, want, PASS)
    untiled = K.lloyd_pass_plain(*_t(x, c), weights=torch.from_numpy(w),
                                 compute_dtype=cd)
    _equal(got, untiled, PASS)


@pytest.mark.parametrize("cd", CD)
def test_tie_straddling_the_slice_edge_keeps_the_lower_index(cd):
    x, c, _, _, _ = _ints(1, N, D, 256)
    c[128] = c[127]
    x[:16] = c[127]
    got = K.lloyd_pass_cuda(*_t(x, c), compute_dtype=cd, k_tile=128)
    want = lloyd_pass_pallas(*_j(x, c), compute_dtype=cd, k_tile=128,
                             interpret=True)
    _equal(got, want, PASS)
    lab = _np(got[0])
    assert (lab[:16] == 127).all() and not (lab == 128).any()
    second = K.lloyd_hamerly_cuda(
        *_t(x, c), torch.full((N,), -1, dtype=torch.int32),
        torch.ones(N, dtype=torch.bool), torch.zeros(N), torch.zeros(N),
        compute_dtype=cd, k_tile=128)
    # An exact duplicate of the best centroid: second-min == min.
    assert torch.equal(second[2][:16], second[1][:16])


DELTA = ("labels", "min_d2", "dsums", "dcounts", "inertia", "n_changed",
         "dense_tiles")


@pytest.mark.parametrize("cd", CD)
@pytest.mark.parametrize("with_mind", [True, False])
def test_delta_tiled_sentinel_then_incremental_sweep(cd, with_mind):
    k = 200
    x, c, w, _, rng = _ints(2, N, D, k)
    sentinel = np.full(N, -1, np.int32)
    kw = dict(compute_dtype=cd, with_mind=with_mind, k_tile=128)
    first = K.lloyd_delta_cuda(*_t(x, c, sentinel),
                               weights=torch.from_numpy(w), **kw)
    want = lloyd_delta_pallas(*_j(x, c, sentinel), weights=jnp.asarray(w),
                              interpret=True, **kw)
    _equal(first, want, DELTA)
    assert int(first[5]) == int((w > 0).sum()) and int(first[6]) == 0
    # Incremental: a third of the labels perturbed, some to sentinels.
    prev = _np(first[0]).copy()
    pert = rng.random(N) < 0.33
    prev[pert] = rng.integers(-1, k, pert.sum())
    got = K.lloyd_delta_cuda(*_t(x, c, prev), weights=torch.from_numpy(w),
                             **kw)
    want = lloyd_delta_pallas(*_j(x, c, prev), weights=jnp.asarray(w),
                              interpret=True, **kw)
    _equal(got, want, DELTA)
    assert int(got[5]) > 0
    untiled = K.lloyd_delta_plain(*_t(x, c, prev),
                                  weights=torch.from_numpy(w),
                                  compute_dtype=cd, with_mind=with_mind)
    _equal(got[:6], untiled[:6], DELTA)


HAMERLY = ("labels", "sb", "slb", "dsums", "dcounts", "n_recomputed",
           "dense_tiles")


@pytest.mark.parametrize("cd", CD)
@pytest.mark.parametrize("need_all", [True, False])
def test_hamerly_tiled_matches_pallas_tiled(cd, need_all):
    k = 256
    x, c, w, prev, rng = _ints(3, N, D, k)
    need = (np.ones(N, bool) if need_all else
            (rng.random(N) < 0.5) | (prev < 0))
    sb = rng.normal(size=N).astype(np.float32) * 100
    slb = rng.normal(size=N).astype(np.float32) * 100
    got = K.lloyd_hamerly_cuda(*_t(x, c, prev, need, sb, slb),
                               weights=torch.from_numpy(w), compute_dtype=cd,
                               k_tile=128)
    want = lloyd_hamerly_pallas(*_j(x, c, prev, need, sb, slb),
                                weights=jnp.asarray(w), compute_dtype=cd,
                                k_tile=128, interpret=True)
    _equal(got, want, HAMERLY)
    assert int(got[5]) == int(need.sum()) and int(got[6]) == 0
    untiled = K.lloyd_hamerly_plain(*_t(x, c, prev, need, sb, slb),
                                    weights=torch.from_numpy(w),
                                    compute_dtype=cd)
    _equal(got[:6], untiled[:6], HAMERLY)


@pytest.mark.parametrize("cd", CD)
def test_accumulate_tiled_with_sentinel_labels(cd):
    k = 300
    x, _, _, _, rng = _ints(4, N, D, k)
    lab = rng.integers(-3, k + 3, size=N).astype(np.int32)
    lab[:200] = 5                          # a skewed bucket
    g = rng.integers(-50, 50, size=N).astype(np.float32)
    w = (rng.random(N) > 0.3).astype(np.float32)
    got = K.accumulate_cuda(*_t(x, lab), k, scores=torch.from_numpy(g),
                            weights=torch.from_numpy(w), compute_dtype=cd,
                            k_tile=128)
    want = accumulate_pallas(*_j(x, lab), k, scores=jnp.asarray(g),
                             weights=jnp.asarray(w), compute_dtype=cd,
                             k_tile=128, interpret=True)
    _equal(got, want, ("sums", "counts", "min_d2"))


@pytest.mark.parametrize("cd", CD)
@pytest.mark.parametrize("k_tile", [None, 128])
def test_classic_sharded_caller_hooks(cd, k_tile):
    """``valid_cols`` masks columns out of the argmin (+inf csq) and
    ``raw_scores`` returns the raw min score, untiled and tiled."""
    k = 300
    x, c, w, _, rng = _ints(5, N, D, k)
    valid = rng.random(k) > 0.3
    valid[127] = False                     # a masked slice-edge column
    c[128] = c[127]
    kw = dict(compute_dtype=cd, raw_scores=True, k_tile=k_tile)
    got = K.lloyd_pass_cuda(*_t(x, c), weights=torch.from_numpy(w),
                            valid_cols=torch.from_numpy(valid), **kw)
    want = lloyd_pass_pallas(*_j(x, c), weights=jnp.asarray(w),
                             valid_cols=jnp.asarray(valid), interpret=True,
                             **kw)
    _equal(got, want, PASS)
    assert valid[_np(got[0])].all()
    normed = K.lloyd_pass_cuda(*_t(x, c), valid_cols=torch.from_numpy(valid),
                               compute_dtype=cd, k_tile=k_tile)[1]
    np.testing.assert_array_equal(      # raw scores: no norm, no clamp
        _np(normed), np.maximum(_np(got[1]) + (x * x).sum(1), 0.0))


@pytest.mark.parametrize("cd", CD)
def test_tiled_argmin_plain_against_the_untiled_scorer(cd):
    """Labels, raw min and second-min of the slice-merged scorer equal the
    one-shot scorer's for every slice width, exact ties included."""
    k = 300
    x, c, _, _, _ = _ints(6, N, D, k)
    c[256] = c[255]
    xt, ct = _t(x, c)
    cdt = getattr(torch, cd)
    lab, best, second = K._argmin_plain(xt, ct, cdt, 4096, with_second=True)
    neg2c, csq = K._score_operands(ct, cdt)
    for k_tile in (128, 256, 384):
        got = K.tiled_argmin_plain(xt, neg2c, csq, k_tile=k_tile,
                                   raw_scores=True, with_second=True,
                                   chunk_size=97)
        _equal(got, (lab, best, second), ("labels", "min", "second"))
        normed = K.tiled_argmin_plain(xt, neg2c, csq, k_tile=k_tile)[1]
        np.testing.assert_array_equal(
            _np(normed), _np((best + K._row_sq_plain(xt, 4096)).clamp_min(0)))
    with pytest.raises(ValueError, match="k_tile"):
        K.tiled_argmin_plain(xt, neg2c, csq, k_tile=100)


def _merge(a, b):
    """(best, index, second) of two groups of columns: the lower (value,
    index) wins, the second-min on the lattice min(s_a, s_b, max(b_a,
    b_b))."""
    (ba, ia, sa), (bb, ib, sb) = a, b
    take = (bb < ba) | ((bb == ba) & (ib < ia))
    return (torch.where(take, bb, ba), torch.where(take, ib, ia),
            torch.minimum(torch.minimum(sa, sb), torch.maximum(ba, bb)))


def _carry(run, part):
    """``part`` merged into ``run``, which holds the lower columns: strict
    ``<`` on the best, the same lattice on the second-min."""
    (rb, ri, rs), (b, i, sc) = run, part
    take = b < rb
    return (torch.where(take, b, rb), torch.where(take, i, ri),
            torch.minimum(torch.minimum(rs, sc), torch.maximum(rb, b)))


def _core_model(x, neg2c, csq, k_tile):
    """A plain model of the Hopper core's merge order (``core_score_kernel``
    then ``tiled_merge_kernel`` in ``csrc/lloyd.cu``).  In each 256-column
    sub-slice, lane l of the 4 that share a row scans columns 8j + 2l + e
    in increasing order (strict ``<``; a new best pushes the old into the
    second-min), columns at or past the range's end scoring +inf; the lanes
    merge in a butterfly (xor 1, then xor 2); the row's (best, index,
    second) is carried across the range's sub-slices, then the ranges are
    merged in order.  Returns (labels, raw min, second-min)."""
    n, k = x.shape[0], neg2c.shape[0]
    scores = csq + x.to(neg2c.dtype).float() @ neg2c.float().T
    inf = torch.full((n,), torch.inf)
    out = None
    for lo in range(0, k, k_tile):
        hi = min(k, lo + k_tile)
        run = (inf, torch.full((n,), lo), inf)
        for c0 in range(lo, hi, 256):
            lanes = []
            for lane in range(4):
                best, idx, sec = inf, torch.full((n,), c0), inf
                for col in (c0 + 8 * j + 2 * lane + e
                            for j in range(32) for e in range(2)):
                    v = scores[:, col] if col < hi else inf
                    take = v < best
                    sec = torch.where(take, best, torch.minimum(sec, v))
                    best = torch.where(take, v, best)
                    idx = torch.where(take, col, idx)
                lanes.append((best, idx, sec))
            for o in (1, 2):
                lanes = [_merge(lanes[i], lanes[i ^ o]) for i in range(4)]
            run = _carry(run, lanes[0])
        out = run if out is None else _carry(out, run)
    return out[1].int(), out[0], out[2]


@pytest.mark.parametrize("cd", CD)
@pytest.mark.parametrize("k_tile,k", [(128, 300), (384, 600), (384, 384)])
def test_core_merge_order_matches_tiled_argmin_bit_for_bit(cd, k_tile, k):
    """The Hopper core's grouping of the columns (lanes, 256-column
    sub-slices carried within k_tile ranges, ranges merged in order) gives
    the labels, raw min and second-min of the slice-merged plain scorer and
    of the reference's ``_tiled_argmin`` (interpret mode) bit for bit, with
    exact ties at a sub-slice edge inside a range (255 | 256 at k_tile =
    384) and at range edges (127 | 128, 383 | 384)."""
    x, c, _, _, _ = _ints(9, N, D, k)
    pairs = [(127, 128), (255, 256), (383, 384)]
    for i, (lo, hi) in enumerate(p for p in pairs if p[1] < k):
        c[hi] = c[lo]
        x[16 * i:16 * (i + 1)] = c[lo]
    xt, ct = _t(x, c)
    neg2c, csq = K._score_operands(ct, getattr(torch, cd))
    got = _core_model(xt, neg2c, csq, k_tile)
    want = K.tiled_argmin_plain(xt, neg2c, csq, k_tile=k_tile,
                                raw_scores=True, with_second=True)
    _equal(got, want, ("labels", "min", "second"))
    k_pad = -(-k // k_tile) * k_tile
    c_t = np.zeros((D, k_pad), np.float32)
    c_t[:, :k] = _np(neg2c.float()).T
    c_sq = np.full(k_pad, np.inf, np.float32)
    c_sq[:k] = _np(csq)
    ref = _tiled_argmin(jnp.asarray(x), jnp.asarray(c_t, dtype=cd),
                        jnp.asarray(c_sq), t=N, k_tile=k_tile,
                        cd=jnp.dtype(cd), raw_scores=True, with_second=True,
                        interpret=True)
    _equal(got, [r[:, 0] for r in ref], ("labels", "min", "second"))
    lab = _np(got[0])
    for i, (lo, hi) in enumerate(p for p in pairs if p[1] < k):
        rows = slice(16 * i, 16 * (i + 1))
        assert (lab[rows] == lo).all()
        # An exact duplicate of the best column: second-min == min.
        np.testing.assert_array_equal(_np(got[2])[rows], _np(got[1])[rows])


@pytest.mark.parametrize("frac", [0.0, 0.1, 1.0])
def test_hamerly_compaction_matches_the_reference_dense_tiles(frac):
    """The plain version of K4's compaction lists ``need.nonzero()`` and
    counts the 1024-row groups; those over 256 needed rows are the
    reference kernel's dense tiles (``lloyd_hamerly_pallas``, interpret
    mode, 1024-row tiles with mc = 256 slots).  A −1 sentinel is always
    needed."""
    n, d, k = 2600, D, 16
    x, c, w, prev, rng = _ints(10, n, d, k)
    need = (rng.random(n) < frac) | (prev < 0)
    need[1024:1024 + 300] |= frac > 0     # one group over the slots
    rows, count, groups = K.hamerly_compaction_plain(torch.from_numpy(need))
    np.testing.assert_array_equal(_np(rows), np.flatnonzero(need))
    assert int(count) == int(need.sum())
    np.testing.assert_array_equal(
        _np(groups), [need[g:g + 1024].sum() for g in range(0, n, 1024)])
    sb = rng.normal(size=n).astype(np.float32)
    want = lloyd_hamerly_pallas(*_j(x, c, prev, need, sb, sb + 1),
                                weights=jnp.asarray(w), interpret=True)
    got = K.lloyd_hamerly_cuda(*_t(x, c, prev, need, sb, sb + 1),
                               weights=torch.from_numpy(w))
    assert int(got[6]) == int(want[6]) == int((groups > K.HAMERLY_SLOTS).sum())
    assert int(got[5]) == int(want[5]) == int(count)


def _np_fold(x, w, lab, lab2, k):
    """The fold as the reference defines it, row by row in f64."""
    sums = np.zeros((k, x.shape[1]))
    counts = np.zeros(k)
    for i in range(x.shape[0]):
        if lab2 is not None and lab[i] == lab2[i]:
            continue
        for lab_i, sign in ((lab[i], 1.0),
                            (None if lab2 is None else lab2[i], -1.0)):
            if lab_i is not None and 0 <= lab_i < k:
                sums[lab_i] += sign * w[i] * x[i]
                counts[lab_i] += sign * w[i]
    return sums, counts


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("k_tile", [None, 128])
def test_tiled_fold_plain_single_dual_skewed_and_sentinels(dual, k_tile):
    k = 300
    x, _, _, _, rng = _ints(7, N, D, k)
    lab = rng.integers(-1, k + 2, size=N).astype(np.int32)
    lab[::2] = 7                           # half the rows on one label
    lab2 = rng.integers(-1, k, size=N).astype(np.int32) if dual else None
    if dual:
        lab2[:30] = lab[:30]               # equal labels fold nothing
    w = rng.integers(0, 3, size=N).astype(np.float32)   # zeros included
    got = K.tiled_fold_plain(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(lab),
                             None if lab2 is None else torch.from_numpy(lab2),
                             k, k_tile=k_tile, chunk_size=64)
    want = _np_fold(x, w, lab, lab2, k)
    _equal(got, want, ("sums", "counts"))
    # On CPU tensors the K6 wrapper is its plain version.
    again = K.tiled_fold_cuda(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(lab),
                              None if lab2 is None else torch.from_numpy(lab2),
                              k)
    _equal(again, want, ("sums", "counts"))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("n,k", [(1500, 300), (1500, 1), (1500, 40)])
def test_fold_core_order_covers_each_entry_once_in_row_order(dual, n, k):
    """The fold core's plan (``fold_order_plain``: the list its radix sort
    makes; ``fold_core_plain``: its sums in its order) lists every entry
    that folds exactly once, each bucket in increasing row order and the
    excluded entries (zero weight, out-of-range labels, equal dual labels)
    last under the key k; a skewed bucket crosses several 256-entry fold
    chunks.  On integer data its sums and counts equal the reference's
    interpret-mode fold and the numpy fold exactly."""
    x, _, _, _, rng = _ints(8, n, D, k)
    lab = rng.integers(-1, k + 2, size=n).astype(np.int32)
    lab[::2] = k // 2                      # half the rows on one label
    lab2 = rng.integers(-1, k, size=n).astype(np.int32) if dual else None
    if dual:
        lab2[:30] = lab[:30]               # equal labels fold nothing
    w = rng.integers(0, 3, size=n).astype(np.float32)   # zeros included
    tw, tl = torch.from_numpy(w), torch.from_numpy(lab)
    tl2 = None if lab2 is None else torch.from_numpy(lab2)
    keys, entries = K.fold_order_plain(tw, tl, tl2, k)
    side = 2 if dual else 1
    row, half = entries // side, entries % side
    label = tl.long()[row]
    if dual:
        label = torch.where(half == 1, tl2.long()[row], label)
    folds = ((tw[row] != 0) & (label >= 0) & (label < k)
             & ((tl[row] != tl2[row]) if dual else True))
    assert torch.equal(torch.sort(entries).values,
                       torch.arange(n * side))          # each entry once
    assert bool((keys[:-1] <= keys[1:]).all())
    assert torch.equal(keys, torch.where(folds, label, k))
    same = keys[:-1] == keys[1:]
    assert bool((entries[:-1][same] < entries[1:][same]).all())
    assert int((keys == k // 2).sum()) > 256               # crosses chunks
    got = K.fold_core_plain(torch.from_numpy(x), tw, tl, tl2, k)
    want = _np_fold(x, w, lab, lab2, k)
    _equal(got, want, ("sums", "counts"))
    if not dual:
        ref = accumulate_pallas(jnp.asarray(x), jnp.asarray(lab), k,
                                weights=jnp.asarray(w), interpret=True)
        _equal(got, ref[:2], ("sums", "counts"))


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

SHAPES = {"headline": (2048, 1000), "glove": (300, 1000),
          "codebook": (2048, 65536)}


@pytest.mark.parametrize("kind", P.KINDS)
def test_planner_modes_at_the_bench_shapes(kind):
    """No card here: the H100's constants (3/4 of 50 MiB of L2)."""
    budget = P.card_budget()
    assert budget.l2_bytes == 3 * 50 * 2 ** 20 // 4
    for name, (d, k) in SHAPES.items():
        for cd_itemsize in (2, 4):
            plan = P.kernel_plan(kind, d, k, x_itemsize=2,
                                 cd_itemsize=cd_itemsize)
            if name == "codebook":
                assert plan.mode == "tiled", plan
                assert plan.k_tile % 128 == 0 and plan.k_tile < k
                assert plan.k_tile == P.max_k_tile(
                    kind, d, k, cd_itemsize=cd_itemsize)
                assert "overflow" in plan.why
            else:
                assert plan == ("untiled", None, plan.why), plan
                assert "fit" in plan.why
    # bf16 codebook: 7 slices of 9472 columns (9600 less the csq slice).
    if kind != "accumulate":
        assert P.kernel_plan(kind, 2048, 65536).k_tile == 9472


def test_planner_slices_and_refusals():
    budget = P.card_budget()
    sl = P.l2_breakdown("classic", 2048, 65536, k_tile=9472)
    assert sl == {"neg2c_slice": 9472 * 2048 * 2, "csq_slice": 9472 * 4}
    assert sum(sl.values()) <= budget.l2_bytes
    assert sum(P.l2_breakdown("classic", 2048, 65536,
                              k_tile=9600).values()) > budget.l2_bytes
    # Yinyang's group map only narrows the slice; one slice covers a small k.
    assert (P.kernel_plan("yinyang", 2048, 65536, groups=6554).k_tile
            <= P.kernel_plan("hamerly", 2048, 65536).k_tile)
    small = P.Budget(1 << 20, budget.smem_per_block, "test")
    assert P.kernel_plan("delta", 16, 300, budget=small).mode == "untiled"
    wide = P.kernel_plan("classic", 4096, 200, budget=P.Budget(
        3 * 2 ** 20, budget.smem_per_block, "test"))
    assert wide.mode == "tiled" and wide.k_tile == 256 > 200
    assert P.kernel_plan("classic", 10 ** 6, 8).mode == "refuse"
    assert P.kernel_plan("classic", 64, 8, x_itemsize=8).mode == "refuse"
    assert P.kernel_plan("classic", 64, 8, budget=P.Budget(
        budget.l2_bytes, 1024, "test")).mode == "refuse"
    assert P.kernel_plan("accumulate", 64, 8, budget=P.Budget(
        budget.l2_bytes, 1024, "test")).mode == "untiled"
    with pytest.raises(ValueError, match="kind"):
        P.kernel_plan("minibatch", 64, 8)


def test_planner_vetoes_in_order():
    """Weights first, then the device, then dtypes, then the shape."""
    x = np.zeros((10, 2048), np.float32)
    frac = np.full(10, 0.5)
    for plan_fn in (lambda **kw: P.device_plan("classic", x, 65536, **kw),
                    lambda **kw: delta_kernel_plan(x, 65536, **kw),
                    lambda **kw: hamerly_kernel_plan(x, 65536, **kw),
                    lambda **kw: yinyang_kernel_plan(x, 65536, groups=6554,
                                                     **kw)):
        p = plan_fn(weights=frac, compute_dtype="bfloat16", device="cpu")
        assert p.mode == "refuse" and "fractional" in p.why
        p = plan_fn(device="cpu")
        assert p.mode == "refuse" and "CUDA" in p.why
        on_card = plan_fn(device="cuda", compute_dtype="bfloat16")
        assert on_card.mode == "tiled" and on_card.k_tile % 128 == 0
        assert plan_fn(device="cuda", compute_dtype="float16").mode == \
            "refuse"
    assert P.device_plan("delta", x[:, :300], 1000, device="cuda").mode == \
        "untiled"
    assert P.shape_plan("delta", x, 65536).k_tile == P.kernel_plan(
        "delta", 2048, 65536, x_itemsize=4, cd_itemsize=4).k_tile


# ---------------------------------------------------------------------------
# A whole fit on the tiled route
# ---------------------------------------------------------------------------

def test_fit_delta_on_the_tiled_route_matches_the_reference(monkeypatch):
    """With the no-card L2 made small enough that k = 200 tiles at 128
    columns, ``fit_lloyd(update="delta")`` runs the tiled plain route (its
    refresh and final view K5 + K6's single fold, its delta sweeps the dual
    fold) and matches the reference's fit from the same init: the reference
    never tiles off a TPU, so its XLA route is the yardstick."""
    rng = np.random.default_rng(8)
    n, d, k = 3000, 16, 200
    centres = rng.normal(size=(k, d)) * 8
    x = np.round((centres[rng.integers(0, k, n)] + rng.normal(size=(n, d)))
                 * 4).astype(np.float32)
    c0 = x[rng.choice(n, k, replace=False)].copy()
    cfg = dict(k=k, update="delta")
    untiled = fit_lloyd(x, k, init=c0, device="cpu", max_iter=20, tol=-1.0,
                        config=KMeansConfig(**cfg))
    monkeypatch.setattr(P, "L2_FALLBACK_BYTES", 16_000)
    plan = fit_plan(x, k, config=KMeansConfig(**cfg), device="cpu")
    assert plan["mode"] == "tiled" and plan["k_tile"] == 128, plan
    port = fit_lloyd(x, k, init=c0, device="cpu", max_iter=20, tol=-1.0,
                     config=KMeansConfig(**cfg))
    ref = kmeans_tpu.fit_lloyd(jnp.asarray(x), k, init=jnp.asarray(c0),
                               max_iter=20, tol=-1.0, config=RefConfig(**cfg))
    np.testing.assert_array_equal(_np(port.labels), np.asarray(ref.labels))
    assert int(port.n_iter) == int(ref.n_iter) == 20
    want = np.asarray(ref.centroids)
    np.testing.assert_allclose(_np(port.centroids), want, rtol=1e-5,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(_np(port.counts), np.asarray(ref.counts))
    assert torch.equal(port.labels, untiled.labels)
    assert torch.equal(port.counts, untiled.counts)
