"""The scoring-core rule of K1, K2, K4 and K5, the planner's shared-memory
pricing of the core (bf16 and its f32 route) on either route, the plain
version of K4's compaction, and K6's fold scratch shared by K1 and
``tiled_fold_cuda``.

All of it is Python that runs without a card: the rule and the sizes are
what the wrappers hand the kernels, so they are checked here at the shapes
the card sees.
"""

import pytest
import torch

from kmeans_tpu_torch.ops import cuda_lloyd as K
from kmeans_tpu_torch.ops import plan as P

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("x_dtype,cd,d,core", [
    (BF16, BF16, 2048, "wgmma"),            # the headline and codebook data
    (BF16, BF16, 8, "wgmma"),               # one 16-byte row
    (BF16, BF16, 200, "wgmma"),             # a multiple of 8, not of 64
    (BF16, BF16, 300, "score_block"),       # glove: TMA's stride rule fails
    (F32, F32, 2048, "wgmma"),              # the f32 route: six bf16 passes
    (F32, BF16, 2048, "score_block"),       # cast on load: TMA cannot
    (BF16, F32, 2048, "score_block"),
])
def test_scoring_core_rule(x_dtype, cd, d, core):
    x = torch.zeros(5, d, dtype=x_dtype)
    c = torch.zeros(3, d, dtype=cd)
    assert K.scoring_core(x, cd, c) == core
    # Every scoring kind reads the same rule: K1, K2, K4 (hamerly and
    # yinyang) and, on the tiled route, K5; the labeled fold scores nothing.
    for kind in P.KINDS:
        assert P.core_takes(kind, d, x_dtype.itemsize, cd.itemsize) == (
            core == "wgmma" and kind != "accumulate"), kind


def test_scoring_core_needs_aligned_bases():
    """A base off a 16-byte boundary takes score_block, as the vector loads'
    rule does."""
    buf = torch.zeros(5 * 64 + 1, dtype=BF16)
    x = buf[1:].view(5, 64)
    assert x.data_ptr() % 16 != 0
    assert K.scoring_core(x, BF16) == "score_block"
    assert K.scoring_core(buf[:-1].view(5, 64), BF16) == "wgmma"
    c = torch.zeros(3 * 64 + 1, dtype=BF16)[1:].view(3, 64)
    assert K.scoring_core(buf[:-1].view(5, 64), BF16, c) == "score_block"


@pytest.mark.parametrize("kind", P.KINDS)
@pytest.mark.parametrize("d,x_itemsize,cd_itemsize", [
    (2048, 2, 2), (300, 2, 2), (2048, 4, 4), (2048, 4, 2)])
def test_kernel_smem_bytes_prices_the_core_a_shape_runs(kind, d, x_itemsize,
                                                         cd_itemsize):
    got = P.kernel_smem_bytes(kind, d, x_itemsize=x_itemsize,
                              cd_itemsize=cd_itemsize)
    core = kind != "accumulate" and x_itemsize == cd_itemsize and (
        d % 8 == 0 if x_itemsize == 2 else d % 4 == 0)
    want = (0 if kind == "accumulate" else P.SCORE_BLOCK_SMEM_BYTES
            if not core else P.CORE_SMEM_BYTES if x_itemsize == 2
            else P.CORE_F32_SMEM_BYTES)
    assert got == want
    # The tiled route's K5 scores on the same core: a budget one byte short
    # of it refuses the codebook shape where the core takes the input.
    short = P.Budget(P.card_budget().l2_bytes, P.CORE_SMEM_BYTES - 1, "test")
    plan = P.kernel_plan(kind, d, 65536, x_itemsize=x_itemsize,
                         cd_itemsize=cd_itemsize, budget=short)
    assert plan.mode == ("refuse" if core else "tiled"), plan


def test_core_smem_fits_the_h100_and_matches_the_kernel_ring():
    # 4 stages of a 128 x 64 and a 256 x 64 bf16 tile, 1024 B of alignment
    # slack (CORE_SMEM in csrc/lloyd.cu) and 8 mbarriers.
    assert P.CORE_SMEM_BYTES == 4 * 49152 + 1024 + 64 == 197_696
    assert P.SCORE_BLOCK_SMEM_BYTES == 67_584
    assert P.SCORE_BLOCK_SMEM_BYTES < P.CORE_SMEM_BYTES <= \
        P.SMEM_FALLBACK_BYTES
    # The f32 route (CORE32_SMEM): 3 stages of six 128 x 32 bf16 pieces, 4
    # f32 x tiles of 128 x 32, the slack, and 14 mbarriers.
    assert P.CORE_F32_SMEM_BYTES == 3 * 49152 + 4 * 16384 + 1024 + 112 \
        == 214_128
    assert P.CORE_SMEM_BYTES < P.CORE_F32_SMEM_BYTES <= P.SMEM_FALLBACK_BYTES


@pytest.mark.parametrize("kind,d,cd_itemsize,mode", [
    ("classic", 2048, 2, "refuse"),     # needs the core, which does not fit
    ("delta", 2048, 2, "refuse"),
    ("delta", 300, 2, "untiled"),       # score_block fits
    ("classic", 2048, 4, "refuse"),     # the core's f32 route needs more
    ("delta", 2050, 4, "untiled"),      # f32, d % 4 != 0: score_block
    ("hamerly", 2048, 2, "refuse"),     # K4 scores on the core too
    ("yinyang", 2048, 2, "refuse"),
    ("accumulate", 2048, 2, "untiled"),
])
def test_planner_refuses_when_the_core_does_not_fit(kind, d, cd_itemsize,
                                                    mode):
    budget = P.card_budget()
    small = P.Budget(budget.l2_bytes, P.CORE_SMEM_BYTES - 1, "test")
    plan = P.kernel_plan(kind, d, 1000, x_itemsize=cd_itemsize,
                         cd_itemsize=cd_itemsize, budget=small)
    assert plan.mode == mode, plan
    if mode == "refuse":
        assert "Hopper core" in plan.why and str(
            P.CORE_SMEM_BYTES if cd_itemsize == 2
            else P.CORE_F32_SMEM_BYTES) in plan.why
    # With the H100's budget every one of them runs untiled; at the
    # codebook width the tiled route's K5 takes the same core, so the small
    # budget refuses it where it refused the untiled route.
    assert P.kernel_plan(kind, d, 1000, x_itemsize=cd_itemsize,
                         cd_itemsize=cd_itemsize).mode == "untiled"
    assert P.kernel_plan(kind, d, 65536, x_itemsize=cd_itemsize,
                         cd_itemsize=cd_itemsize, budget=small).mode == (
        "refuse" if mode == "refuse" else "tiled")


def _fold_scratch_sizes(n, d, k, dual, norms):
    """The fold core's scratch as ``csrc/lloyd.cu`` indexes it: two key and
    two value buffers of the entries, the sort tiles' 256 digit counts
    (scanned in place) and the 256 digit totals, a start per bucket (+ the folded count), two
    partial rows a 256-entry fold chunk, and the per-span ||x||² with the
    norms over more than one 2048-column span."""
    entries = n * (2 if dual else 1)
    tiles = -(-entries // 4096)
    chunks = -(-entries // 256)
    spans = -(-d // 2048)
    return dict(sort=4 * entries, hist=256 * (tiles + 1), start=k + 1,
                part=(2 * chunks, d), part_counts=2 * chunks,
                sq_part=spans * n if norms and spans > 1 else 0)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("n,d,k", [(1, 8, 1), (3001, 96, 300),
                                   (1_280_000, 4, 1000), (5000, 3, 65536)])
def test_fold_scratch_sizes(n, d, k, dual):
    x = torch.zeros(n, d, dtype=BF16)
    s = K._fold_scratch(x, k, dual)
    want = _fold_scratch_sizes(n, d, k, dual, False)
    for name in ("sort", "hist", "start", "part_counts", "sq_part"):
        assert getattr(s, name).numel() == want[name], name
        assert getattr(s, name).dtype == (
            torch.int32 if name in ("sort", "hist", "start")
            else torch.float32), name
    assert tuple(s.part.shape) == want["part"]
    assert s.vec == int(d % 8 == 0)
    assert len(s.args()) == 7
    # Nothing is zeroed on the host: every cell is written before it is
    # read, and k's histogram is gone (nothing grows with chunks x k).
    assert s.hist.numel() <= 256 * (2 * n // 4096 + 2)


@pytest.mark.parametrize("d,norms", [(2048, True), (4104, True),
                                     (4104, False), (300, True)])
def test_fold_scratch_holds_the_span_norms(d, norms):
    """K3 and K1's fold keep each 2048-column span's ||x||² only where d
    needs more than one span."""
    s = K._fold_scratch(torch.zeros(10, d), 7, False, norms=norms)
    assert s.sq_part.numel() == _fold_scratch_sizes(10, d, 7, False,
                                                   norms)["sq_part"]
    assert s.vec == int(d % 8 == 0)


@pytest.mark.parametrize("k,passes", [(1, 1), (255, 1), (256, 2),
                                      (1000, 2), (65535, 2), (65536, 3)])
def test_fold_sort_passes_and_launches(k, passes):
    """Keys run over [0, k] (k for entries that fold nothing): 8 bits a
    radix pass, as few passes as cover the key k.  Each pass is three
    launches (hist, digit scan, scatter); ``chip_smoke.py`` phase 7 counts
    them by kernel name in a profile of one fold on the card."""
    assert K.fold_sort_passes(k) == passes
    assert k < 2 ** (8 * passes)
    assert passes == 1 or k >= 2 ** (8 * (passes - 1))


@pytest.mark.parametrize("kind", ["hamerly", "yinyang", "classic"])
def test_planner_prices_the_core_for_k4_and_the_tiled_route(kind):
    """K4 (hamerly, yinyang) and the tiled route's K5 need the core's ring,
    in bf16 and on its f32 route; glove's d = 300 in bf16 stays on
    score_block, whose block fits a budget the core does not."""
    budget = P.card_budget()
    short = P.Budget(budget.l2_bytes, P.CORE_SMEM_BYTES - 1, "test")
    for k in (1000, 65536):
        plan = P.kernel_plan(kind, 2048, k, budget=short)
        assert plan.mode == "refuse" and "Hopper core" in plan.why, plan
        assert P.kernel_plan(kind, 2048, k).mode == (
            "untiled" if k == 1000 else "tiled")
        assert P.kernel_plan(kind, 300, k, budget=short).mode == (
            "untiled" if k == 1000 else "tiled")
        assert P.kernel_plan(kind, 2048, k, x_itemsize=4, cd_itemsize=4,
                             budget=short).mode == "refuse"
        assert P.kernel_plan(kind, 2048, k, x_itemsize=4,
                             cd_itemsize=4).mode == (
            "untiled" if k == 1000 else "tiled")


@pytest.mark.parametrize("n,frac", [(1, 1.0), (1023, 0.0), (1024, 0.1),
                                    (5000, 0.1), (5000, 0.3), (5000, 1.0)])
def test_hamerly_compaction_plain_lists_needed_rows_in_order(n, frac):
    """The plain version of K4's compaction: the needed rows in increasing
    order (``need.nonzero()``), their count, and one count per 1024-row
    group, the last group ragged."""
    gen = torch.Generator().manual_seed(n)
    need = torch.rand(n, generator=gen) < frac
    need[n // 2] |= frac > 0
    rows, count, groups = K.hamerly_compaction_plain(need)
    assert rows.dtype == count.dtype == groups.dtype == torch.int32
    assert torch.equal(rows.long(), need.nonzero()[:, 0])
    assert int(count) == int(need.sum()) == rows.numel()
    assert groups.numel() == -(-n // 1024)
    for g in range(groups.numel()):
        assert int(groups[g]) == int(need[g * 1024:(g + 1) * 1024].sum())
    assert int(groups.sum()) == int(count)
    # Each group's rows start where the counts of the groups before it end:
    # the list the core path builds with a scan of the group counts.
    starts = torch.cumsum(groups, 0) - groups
    for g in range(groups.numel()):
        part = rows[int(starts[g]):int(starts[g]) + int(groups[g])]
        assert bool(((part >= g * 1024) & (part < (g + 1) * 1024)).all())


def test_hamerly_plain_reports_dense_tiles_from_the_group_counts():
    """Groups with more than HAMERLY_SLOTS needed rows count as dense, the
    reference kernel's meaning (1024-row tiles over mc = 256 slots)."""
    n, d, k = 3000, 8, 5
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, d, generator=gen)
    c = torch.randn(k, d, generator=gen)
    need = torch.zeros(n, dtype=torch.bool)
    need[:257] = True                  # group 0: one over the slots
    need[1024:1024 + 256] = True       # group 1: exactly at the slots
    need[2048:] = True                 # group 2 (ragged): 952 rows
    prev = torch.zeros(n, dtype=torch.int32)
    out = K.lloyd_hamerly_plain(x, c, prev, need, torch.zeros(n),
                                torch.zeros(n))
    assert int(out[5]) == 257 + 256 + (n - 2048)
    assert int(out[6]) == 2
    assert int(out[6]) == int(K._dense_tiles(need, K.HAMERLY_SLOTS))
