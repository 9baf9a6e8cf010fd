"""The scoring-core rule of K1 and K2, the planner's shared-memory pricing of
the core, and K6's fold scratch shared by K1 and ``tiled_fold_cuda``.

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
    (F32, F32, 2048, "score_block"),        # real f32 on the CUDA cores
    (F32, BF16, 2048, "score_block"),       # cast on load: TMA cannot
    (BF16, F32, 2048, "score_block"),
])
def test_scoring_core_rule(x_dtype, cd, d, core):
    x = torch.zeros(5, d, dtype=x_dtype)
    c = torch.zeros(3, d, dtype=cd)
    assert K.scoring_core(x, cd, c) == core
    assert P.core_takes("classic", d, x_dtype.itemsize, cd.itemsize) == (
        core == "wgmma")


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
    core = (kind in ("classic", "delta") and d % 8 == 0 and x_itemsize == 2
            and cd_itemsize == 2)
    want = (0 if kind == "accumulate" else P.CORE_SMEM_BYTES if core
            else P.SCORE_BLOCK_SMEM_BYTES)
    assert got == want
    # The tiled route runs K5, which scores with score_block.
    assert P.kernel_smem_bytes(kind, d, x_itemsize=x_itemsize,
                               cd_itemsize=cd_itemsize, tiled=True) == (
        0 if kind == "accumulate" else P.SCORE_BLOCK_SMEM_BYTES)


def test_core_smem_fits_the_h100_and_matches_the_kernel_ring():
    # 4 stages of a 128 x 64 and a 256 x 64 bf16 tile, 1024 B of alignment
    # slack (CORE_SMEM in csrc/lloyd.cu) and 8 mbarriers.
    assert P.CORE_SMEM_BYTES == 4 * 49152 + 1024 + 64 == 197_696
    assert P.SCORE_BLOCK_SMEM_BYTES == 67_584
    assert P.SCORE_BLOCK_SMEM_BYTES < P.CORE_SMEM_BYTES <= \
        P.SMEM_FALLBACK_BYTES


@pytest.mark.parametrize("kind,d,cd_itemsize,mode", [
    ("classic", 2048, 2, "refuse"),     # needs the core, which does not fit
    ("delta", 2048, 2, "refuse"),
    ("delta", 300, 2, "untiled"),       # score_block fits
    ("classic", 2048, 4, "untiled"),
    ("hamerly", 2048, 2, "untiled"),
    ("yinyang", 2048, 2, "untiled"),
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
        assert "Hopper core" in plan.why and str(P.CORE_SMEM_BYTES) in \
            plan.why
    # With the H100's budget every one of them runs untiled; at the
    # codebook width the tiled route's score_block fits the small budget.
    assert P.kernel_plan(kind, d, 1000, x_itemsize=cd_itemsize,
                         cd_itemsize=cd_itemsize).mode == "untiled"
    assert P.kernel_plan(kind, d, 65536, x_itemsize=cd_itemsize,
                         cd_itemsize=cd_itemsize, budget=small).mode == "tiled"


def _scratch_as_before(n, d, k, dual):
    """The sizes ``tiled_fold_cuda`` allocated before the helper existed."""
    entries = n * (2 if dual else 1)
    chunks = max(1, min(-(-n // 1024), (1 << 24) // k))
    chunk_entries = -(-entries // chunks)
    chunks = -(-entries // chunk_entries)
    part_rows = 2 * -(-entries // 512) + 1
    return dict(chunk_entries=chunk_entries, chunks=chunks, hist=chunks * k,
                total=k, start=k + 1, cstart=k + 1, pstart=k + 1,
                order=entries, part=(part_rows, d), part_counts=part_rows)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("n,d,k", [(1, 8, 1), (3001, 96, 300),
                                   (1_280_000, 4, 1000), (5000, 3, 65536)])
def test_fold_scratch_sizes(n, d, k, dual):
    x = torch.zeros(n, d, dtype=BF16)
    s = K._fold_scratch(x, k, dual)
    want = _scratch_as_before(n, d, k, dual)
    assert (s.chunk_entries, s.chunks) == (want["chunk_entries"],
                                           want["chunks"])
    for name in ("hist", "total", "start", "cstart", "pstart", "order",
                 "part_counts"):
        assert getattr(s, name).numel() == want[name], name
        assert getattr(s, name).dtype == (torch.float32 if name ==
                                          "part_counts" else torch.int32)
    assert tuple(s.part.shape) == want["part"]
    assert not s.hist.any()
    assert s.vec == int(d % 8 == 0)
    assert len(s.args()) == 11
