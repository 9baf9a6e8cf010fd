"""The Hopper core's f32 route on the CPU: the exact three-piece bf16 split,
the plain model of the six-pass product (``six_pass_scores_plain``) against
an f64 product and against the JAX package's f32 labels, and the planner's
and the scoring-core rule's f32 cases.

The route runs the reference's ``Precision.HIGHEST`` algorithm as the
reference's own chip runs it (six bf16 passes, ``BF16_BF16_F32_X6``): each
f32 operand split exactly into three bf16 pieces, the six products that
matter summed in f32.  The kernel runs only on the card
(``tests/test_torch_cuda.py``); here its model and the Python around it.

Tolerances: the split is exact (compared bit for bit).  The model's scores
are held to the f64 product at 1e-5 of ``||x||² + ||c||²`` (the kernels'
``SCORE_RTOL``, which bounds ``|csq − 2x·c|``) and at γ_d = d·2⁻²⁴ of it,
the f32 dot-accumulation bound that ``HAMERLY_MARGIN_REL`` covers.  Labels
are compared exactly on tie-free blobs (every row's two best f64 scores
far apart) and on exact duplicate centroids, where the lowest index wins.
Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops.lloyd import lloyd_pass as ref_lloyd_pass
from kmeans_tpu.ops.pallas_lloyd import _tiled_argmin
from kmeans_tpu_torch.ops import cuda_lloyd as K
from kmeans_tpu_torch.ops import plan as P
from kmeans_tpu_torch.ops.distance import cd_product
from kmeans_tpu_torch.ops.hamerly import HAMERLY_MARGIN_REL
from kmeans_tpu_torch.serve import assign as A

F32, BF16 = torch.float32, torch.bfloat16
SCORE_RTOL = 1e-5


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(-100, -40), (-40, 40), (40, 101)])
def test_split_is_exact_bit_for_bit(lo, hi):
    """Three bf16 pieces whose sum is the f32 input bit for bit, over
    exponents 2⁻¹⁰⁰ .. 2¹⁰⁰ of both signs: exactly in f64, and in f32
    summed in the order the pieces come."""
    rng = np.random.default_rng(lo + 200)
    e = rng.integers(lo, hi, size=50_000)
    m = rng.uniform(1.0, 2.0, size=e.size) * rng.choice([-1.0, 1.0], e.size)
    v = torch.from_numpy((m * 2.0 ** e).astype(np.float32))
    p = K.split_bf16x3(v)
    assert p.dtype == BF16 and tuple(p.shape) == (3, e.size)
    assert torch.equal(p[0].double() + p[1].double() + p[2].double(),
                       v.double())
    assert torch.equal(_bits(p[0].float() + p[1].float() + p[2].float()),
                       _bits(v))
    # Each piece is what round-to-nearest leaves for it: the leading piece
    # is v's own bf16 rounding, and each later one is at most half a bf16
    # ulp of the one before.
    assert torch.equal(p[0], v.to(BF16))
    for a, b in ((p[0], p[1]), (p[1], p[2])):
        nz = a != 0
        assert bool((b[nz].float().abs() <= a[nz].float().abs() * 2.0 ** -8)
                    .all())


def test_split_at_zero_and_the_subnormal_edge():
    """Zeros split into zeros (−0 sums to +0, equal in value).  Down to
    2⁻¹¹⁰ the split is exact; below it the third piece would need bits under
    bf16's least subnormal 2⁻¹³³, so the sum may miss v by at most half of
    it, 2⁻¹³⁴ -- far below any score's f32 rounding -- and f32's own
    subnormals likewise."""
    z = torch.tensor([0.0, -0.0])
    p = K.split_bf16x3(z)
    assert not p.float().any()
    assert torch.equal(p[0].float() + p[1].float() + p[2].float(), z)
    rng = np.random.default_rng(3)
    for lo, hi, exact in ((-110, -100, True), (-126, -110, False),
                          (-149, -126, False)):
        e = rng.integers(lo, hi, size=20_000)
        v = torch.from_numpy((rng.uniform(1.0, 2.0, e.size)
                              * 2.0 ** e).astype(np.float32))
        p = K.split_bf16x3(v)
        err = (p[0].double() + p[1].double() + p[2].double()
               - v.double()).abs()
        assert float(err.max()) <= 2.0 ** -134
        assert bool((err == 0).all()) == exact


def test_split_overflows_only_within_half_a_bf16_ulp_of_the_f32_max():
    """The leading piece of a value within half a bf16 ulp of f32's largest
    finite value rounds to inf (bf16 has f32's exponent range, 8 bits of
    significand); a centroid that large squares to inf in csq anyway."""
    big = torch.tensor([2.0 ** 127 * 1.99, 3.39e38, 3.4028235e38])
    p = K.split_bf16x3(big)
    assert bool(torch.isfinite(p[:, :2]).all())
    assert torch.equal(p[0, :2].double() + p[1, :2].double()
                       + p[2, :2].double(), big[:2].double())
    assert bool(torch.isinf(p[0, 2]))


@pytest.mark.parametrize("d", [4, 8, 100, 300, 2048])
def test_neg2c_pieces_pad_to_eight_columns_with_zeros(d):
    """(3, k, d rounded up to 8) bf16: TMA's 16-byte row stride in bf16;
    the pad columns are zero, so they add 0 to every product, and the
    pieces of −2C are −2 times C's (an exponent shift)."""
    rng = np.random.default_rng(d)
    c = torch.from_numpy(rng.normal(size=(7, d)).astype(np.float32))
    pieces = K.neg2c_pieces((c * -2).contiguous())
    d8 = -(-d // 8) * 8
    assert pieces.dtype == BF16 and tuple(pieces.shape) == (3, 7, d8)
    assert pieces.is_contiguous()
    assert not pieces[:, :, d:].float().any()
    assert torch.equal(pieces[:, :, :d], -2 * K.split_bf16x3(c).float()
                       .to(BF16))
    assert torch.equal(pieces[:, :, :d].double().sum(0), -2 * c.double())


def test_core_operand_takes_held_pieces_and_checks_them():
    """K5's ``neg2c_pieces=``: held pieces pass through on the f32 route;
    anything else raises (no fallback to splitting or to score_block); the
    bf16 core and score_block read −2C itself."""
    c = torch.randn(5, 12)
    neg2c = (c * -2).contiguous()
    held = K.neg2c_pieces(neg2c)
    assert K._core_operand(neg2c, "wgmma", held) is held
    assert torch.equal(K._core_operand(neg2c, "wgmma"), held)
    assert K._core_operand(neg2c, "score_block", held) is neg2c
    nb = neg2c.to(BF16)
    assert K._core_operand(nb, "wgmma") is nb
    for bad in (held[:, :, :12].contiguous(), held.float(), held[:2]):
        with pytest.raises(ValueError, match="neg2c_pieces"):
            K._core_operand(neg2c, "wgmma", bad)
    # On the CPU K5 runs its plain version, which reads −2C itself.
    x = torch.randn(9, 12)
    got = K.tiled_argmin_cuda(x, neg2c, (c * c).sum(1), k_tile=128,
                              neg2c_pieces=held)
    want = K.tiled_argmin_plain(x, neg2c, (c * c).sum(1), k_tile=128)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The six-pass model
# ---------------------------------------------------------------------------

def _scores64(x, c):
    x64, c64 = x.double(), c.double()
    s = (c64 * c64).sum(1) - 2.0 * x64 @ c64.T
    scale = (x64 * x64).sum(1)[:, None] + (c64 * c64).sum(1)[None, :]
    return s, scale


def _six_pass(x, c):
    neg2c = (c * -2).contiguous()
    return K.six_pass_scores_plain(x, K.neg2c_pieces(neg2c),
                                   (c * c).sum(1), chunk_size=97)


@pytest.mark.parametrize("d", [8, 100, 2048])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_six_pass_model_against_f64(d, scale):
    """max |six-pass − f64| / (||x||² + ||c||²) ≤ 1e-5, and ≤ γ_d = d·2⁻²⁴,
    the f32 dot-accumulation bound: four times the error (twice per score,
    twice per comparison) stays inside the Hamerly margin
    ``HAMERLY_MARGIN_REL·(||x||·max||c|| + 1)``.  Blob-like data (rows
    near their centroid, so x·c is of the order of ||x||², the case where
    a truncating accumulator drifts most) and signed noise."""
    rng = np.random.default_rng(d)
    k = 96
    c = rng.normal(size=(k, d)) * 3 + 1.0
    x = c[rng.integers(0, k, 200)] + rng.normal(size=(200, d))
    x = torch.from_numpy((x * scale).astype(np.float32))
    c = torch.from_numpy((c * scale).astype(np.float32))
    got = _six_pass(x, c)
    s, sc = _scores64(x, c)
    rel = float(((got.double() - s).abs() / sc).max())
    gamma = d * 2.0 ** -24
    assert rel <= min(SCORE_RTOL, gamma), rel
    err = (got.double() - s).abs().max(1).values
    margin = HAMERLY_MARGIN_REL * (x.double().norm(dim=1)
                                   * c.double().norm(dim=1).max() + 1.0)
    assert bool((4 * err <= margin).all())
    # The IEEE f32 product (score_block's and the plain versions') holds
    # the same bound: the route agrees with it to the f32 tolerance.
    plain = (c * c).sum(1) + cd_product(x, c * -2, F32)
    assert float(((plain.double() - s).abs() / sc).max()) <= min(
        SCORE_RTOL, gamma)


def test_six_pass_model_sums_what_highest_drops():
    """Against the bf16 product alone (the leading pass) the model recovers
    the f32 digits: its error is thousands of times smaller, and it equals
    the f64 score to about one f32 ulp of the scale."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(40, 256)).astype(np.float32))
    s, sc = _scores64(x, c)
    six = ((_six_pass(x, c).double() - s).abs() / sc).max()
    one = (((c * c).sum(1) + x.to(BF16).float() @ (c * -2).to(BF16)
            .float().T).double() - s).abs().div(sc).max()
    assert float(six) * 1000 < float(one)
    assert float(six) <= 4 * 2.0 ** -24


def _blobs(seed, n, d, k):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 4
    x = (centres[rng.integers(0, k, n)] + rng.normal(size=(n, d))
         ).astype(np.float32)
    c = (centres + 0.1 * rng.normal(size=(k, d))).astype(np.float32)
    return x, c


def _tie_free(x, c, labels_tol=1e-4):
    """Every row's two best f64 scores more than ``labels_tol`` of the row
    scale apart: the labels cannot depend on the summation order."""
    s, sc = _scores64(torch.from_numpy(x), torch.from_numpy(c))
    two = s.topk(2, dim=1, largest=False)
    gap = (two.values[:, 1] - two.values[:, 0]) / sc.gather(
        1, two.indices[:, :1])[:, 0]
    return bool((gap > labels_tol).all())


@pytest.mark.parametrize("n,d,k", [(520, 64, 130), (520, 100, 300),
                                   (257, 300, 40)])
def test_six_pass_labels_equal_the_reference_f32_labels(n, d, k):
    """The model's lowest-index argmin equals the JAX package's f32 labels
    (``lloyd_pass(backend="xla")``, ``Precision.HIGHEST``) on tie-free
    blobs, d % 8 == 4 (the padded pieces) included, and its raw min is the
    reference's min_d2 less ||x||² to the score tolerance."""
    x, c = _blobs(n + d, n, d, k)
    assert _tie_free(x, c)
    ref = ref_lloyd_pass(jnp.asarray(x), jnp.asarray(c),
                         compute_dtype=jnp.float32, with_update=False,
                         backend="xla")
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    scores = _six_pass(xt, ct)
    labels = scores.argmin(dim=1)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[0]))
    best = scores.gather(1, labels[:, None])[:, 0].double()
    _, sc = _scores64(xt, ct)
    want = np.asarray(ref[1]).astype(np.float64) - (x.astype(np.float64)
                                                     ** 2).sum(1)
    tol = SCORE_RTOL * sc.gather(1, labels[:, None])[:, 0]
    assert bool(((best - torch.from_numpy(want)).abs() <= tol).all())


def _carry_ranges(scores, k_tile):
    """K5's tile contract on given scores: each ``k_tile`` range's
    lowest-index argmin and second-min, the ranges merged in increasing
    order with strict ``<`` and the second-min lattice (the kernel's
    finishing launch)."""
    run = None
    for lo in range(0, scores.shape[1], k_tile):
        part = scores[:, lo:lo + k_tile]
        i = part.argmin(dim=1, keepdim=True)
        b = part.gather(1, i)[:, 0]
        sec = part.scatter(1, i, torch.inf).amin(dim=1)
        if run is None:
            run = [b, i[:, 0] + lo, sec]
            continue
        run[2] = torch.minimum(torch.minimum(run[2], sec),
                               torch.maximum(run[0], b))
        take = b < run[0]
        run[0] = torch.where(take, b, run[0])
        run[1] = torch.where(take, i[:, 0] + lo, run[1])
    return run[1].int(), run[0], run[2]


@pytest.mark.parametrize("k_tile,k", [(128, 300), (384, 600)])
def test_six_pass_tile_contract_matches_the_reference_tiled_argmin(k_tile,
                                                                   k):
    """K5's contract on six-pass scores against the reference's
    ``_tiled_argmin`` in f32 (interpret mode, as
    ``tests/test_pallas_tiled.py`` runs it): equal labels on tie-free
    blobs, min and second-min to the score tolerance; the result does not
    depend on the range width (128-column sub-slices, ``k_tile`` ranges),
    bit for bit.  Exact duplicate centroids at a range edge and inside a
    range tie exactly in the six-pass sum too (their pieces are equal), and
    the lowest index wins, second-min == min, on both sides."""
    n, d = 520, 64
    x, c = _blobs(k_tile + k, n, d, k)
    pairs = [(127, 128), (255, 256), (383, 384)]
    for i, (lo, hi) in enumerate(p for p in pairs if p[1] < k):
        c[hi] = c[lo]
        x[16 * i:16 * (i + 1)] = c[lo]
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    scores = _six_pass(xt, ct)
    got = _carry_ranges(scores, k_tile)
    for other in (128, 256, 1024):
        assert all(torch.equal(a, b) for a, b in
                   zip(got, _carry_ranges(scores, other)))
    k_pad = -(-k // k_tile) * k_tile
    c_t = np.zeros((d, k_pad), np.float32)
    c_t[:, :k] = -2.0 * c.T
    c_sq = np.full(k_pad, np.inf, np.float32)
    c_sq[:k] = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    ref = _tiled_argmin(jnp.asarray(x), jnp.asarray(c_t), jnp.asarray(c_sq),
                        t=n, k_tile=k_tile, cd=jnp.dtype("float32"),
                        raw_scores=True, with_second=True, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0])[:, 0])
    _, sc = _scores64(xt, ct)
    tol = SCORE_RTOL * sc.max(dim=1).values
    for g, r in ((got[1], ref[1]), (got[2], ref[2])):
        diff = g.double() - torch.from_numpy(np.array(r)[:, 0]).double()
        assert bool((diff.abs() <= tol).all())
    lab = got[0].numpy()
    for i, (lo, hi) in enumerate(p for p in pairs if p[1] < k):
        rows = slice(16 * i, 16 * (i + 1))
        assert (lab[rows] == lo).all()
        assert torch.equal(got[2][rows], got[1][rows])


# ---------------------------------------------------------------------------
# The rules around the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype,cd,d,core", [
    (F32, F32, 2048, "wgmma"),        # the headline and codebook data in f32
    (F32, F32, 4, "wgmma"),           # one 16-byte row of f32
    (F32, F32, 100, "wgmma"),         # d % 8 == 4: the pieces pad to 104
    (F32, F32, 300, "wgmma"),         # glove in f32: padded to 304, free
    (F32, F32, 2, "score_block"),     # TMA's 16-byte stride rule fails
    (F32, F32, 2050, "score_block"),
    (F32, BF16, 2048, "score_block"),  # f32 x in bf16 compute: cast on load
    (BF16, F32, 2048, "score_block"),  # bf16 x in f32 compute
])
def test_scoring_core_f32_rule(x_dtype, cd, d, core):
    x = torch.zeros(5, d, dtype=x_dtype)
    c = torch.zeros(3, d, dtype=cd)
    assert K.scoring_core(x, cd, c) == core
    for kind in P.KINDS:
        assert P.core_takes(kind, d, x_dtype.itemsize, cd.itemsize) == (
            core == "wgmma" and kind != "accumulate"), kind
        assert P.kernel_smem_bytes(kind, d, x_itemsize=x_dtype.itemsize,
                                   cd_itemsize=cd.itemsize) == (
            0 if kind == "accumulate" else P.CORE_F32_SMEM_BYTES
            if core == "wgmma" else P.SCORE_BLOCK_SMEM_BYTES)


def test_scoring_core_f32_needs_aligned_bases():
    """f32 x or −2C off a 16-byte boundary takes score_block (a fixed rule:
    nothing falls back at launch)."""
    buf = torch.zeros(5 * 64 + 1)
    assert K.scoring_core(buf[1:].view(5, 64), F32) == "score_block"
    assert K.scoring_core(buf[:-1].view(5, 64), F32) == "wgmma"
    c = torch.zeros(3 * 64 + 1)[1:].view(3, 64)
    assert K.scoring_core(buf[:-1].view(5, 64), F32, c) == "score_block"


@pytest.mark.parametrize("kind", ["classic", "delta", "hamerly", "yinyang"])
def test_planner_prices_the_f32_pieces(kind):
    """On the core's f32 route −2C sits in L2 as three bf16 pieces of
    round_up(d, 8) columns (6 bytes an element); f32 x in bf16 compute and
    a d off the stride rule keep the compute dtype's 4 bytes."""
    for d in (2048, 300):
        d8 = -(-d // 8) * 8
        f32 = P.l2_breakdown(kind, d, 1000, cd_itemsize=4, x_itemsize=4)
        assert f32["neg2c"] == 1000 * d8 * 6
        assert P.neg2c_bytes(kind, d, 1000, x_itemsize=4,
                             cd_itemsize=4) == 1000 * d8 * 6
        sl = P.l2_breakdown(kind, d, 65536, cd_itemsize=4, x_itemsize=4,
                            k_tile=1024)
        assert sl["neg2c_slice"] == 1024 * d8 * 6
    assert P.l2_breakdown(kind, 2048, 1000, cd_itemsize=4,
                          x_itemsize=2)["neg2c"] == 1000 * 2048 * 4
    assert P.l2_breakdown(kind, 2050, 1000, cd_itemsize=4,
                          x_itemsize=4)["neg2c"] == 1000 * 2050 * 4
    # The headline stays untiled; the codebook slice narrows from 4736
    # (4-byte pricing) to the widest 128-multiple whose pieces fit.
    assert P.kernel_plan(kind, 2048, 1000, x_itemsize=4,
                         cd_itemsize=4).mode == "untiled"
    plan = P.kernel_plan(kind, 2048, 65536, x_itemsize=4, cd_itemsize=4)
    assert plan.mode == "tiled" and plan.k_tile == P.max_k_tile(
        kind, 2048, 65536, cd_itemsize=4, x_itemsize=4)
    budget = P.card_budget().l2_bytes
    used = sum(P.l2_breakdown(kind, 2048, 65536, cd_itemsize=4, x_itemsize=4,
                              k_tile=plan.k_tile).values())
    wider = sum(P.l2_breakdown(kind, 2048, 65536, cd_itemsize=4,
                               x_itemsize=4,
                               k_tile=plan.k_tile + 128).values())
    assert used <= budget < wider
    if kind != "yinyang":
        assert plan.k_tile == 3072


def test_dense_k_tile_reads_the_f32_pricing():
    """The serving dense route's K5 ranges: the planner's f32 slice at the
    codebook-serve shape (the core's pieces priced), 128 columns where the
    plan is untiled."""
    tiled = A.dense_k_tile(65536, 2048)
    assert tiled == P.kernel_plan("classic", 2048, 65536, x_itemsize=4,
                                  cd_itemsize=4).k_tile == 3072
    assert A.dense_k_tile(1000, 2048) == 128
