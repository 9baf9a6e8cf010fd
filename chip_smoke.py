#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (kmeans_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
``kmeans_tpu_torch/csrc/lloyd.cu`` and runs seven phases, exiting non-zero
if any fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` for sm_90a, with its seconds, register report, and the
   registers and spills of each variant of the Hopper core;
3. each kernel against its plain PyTorch version on the card: ragged n,
   d in {2, 100, 2048}, k in {3, 1000}, float32 and bfloat16, zero-weight
   rows, a −1 sentinel ``prev``, out-of-range labels, and exact ties; the
   Hopper core (bf16, d % 8 == 0) also at d in {8, 200} and k in
   {3, 257, 1000}: K1's labels and min_d2, K2's labels and raw scores,
   K4's labels, sb, slb, n_recomputed and dense_tiles (need fractions 0,
   about 10% and 100%) and K5's labels, raw and normed min and second-min
   (k_tile in {128, 384, 1024}) equal to
   ``score_block``'s bit for bit, two launches of each equal bit for bit,
   duplicate centroids at columns 255 and 256 (the core's slice edge) and,
   for K4 and K5, at a sub-slice edge inside a range and at range edges;
   the Hamerly kernel (K4) at need fractions 0, about 10% and 100%, and
   with every row needed against the delta kernel (K2), bit for bit; the
   k-tiled pair at 128-column slices (K5's labels, raw scores and
   second-min against K2's and K4's bit for bit, K6's single and dual
   folds with −1 sentinels and a skewed bucket, two K6 launches bit for
   bit), and ties on either side of a slice edge; the fold core (K6 single
   and dual, K3, K1's fold) at d in {64, 100, 300, 2048, 4104}, k in
   {1, 3, 7, 1000}, f32 and bf16, every row on one label: equal bit for
   bit to ``fold_core_plain``, to a second launch and to each other;
4. the slice at full width, at n = 1,280,000, d = 2048, k = 1000 in bf16:
   the main path in three runs, each with the launch counts set to 0 just
   before it and read just after -- ``fit_lloyd(update="delta")`` (20
   sweeps, so the refresh at sweep 16 and the final view run), the public
   delta sweep's refresh branch (``delta_pass(force_full=True)``) and the
   default entry point ``KMeans(compute_dtype="bfloat16")`` with
   ``update="auto"`` (48 sweeps, so the yinyang probe at sweep 16 and its
   judgment at sweep 32 run); 20 hand-driven ``hamerly_pass`` and 20
   ``yinyang_pass`` sweeps, each held against K1 at the same centroids
   (every label that differs must be a tie); then each kernel at that
   shape against its plain version, its time beside its bound, the plain
   version's and a library call's (K4's also on ``score_block``), K1's
   time split into scoring and the fold with ||x||², the SM clock and
   power under K2, K5 + K6 forced tiled there, one steady sweep of each
   flavour, and the time of k-means++ there;
5. whole ``KMeans(compute_dtype="bfloat16")`` fits with k-means++ at the
   ``glove`` shape, ``update="delta"`` and the default ``"auto"`` (the
   adaptive loop: n >= 16384), each held against a plain-backend fit,
   with the counts set to 0 before each fit and read after (K1 and K2
   must launch, and K4 on the adaptive loop); and a small bf16 fit with
   fractional weights, which the weights veto sends on the plain route on
   the card under ``backend="auto"``, held against the CPU;
6. the ``codebook`` shape, n = 1,280,000, d = 2048, k = 65536 in bf16, where
   the planner tiles: its decision for every kind there and at the headline
   and glove shapes, then the main path in three runs, counts set to 0
   before each and read after -- ``KMeans(update="delta", max_iter=4,
   tol=-1)`` (the refresh, three delta sweeps and the final view: K5 and K6
   only), ``delta_pass(force_full=True)`` and three hand-driven
   ``hamerly_pass`` sweeps, each held against K5's full scoring; the fit's
   labels against the plain route's; then K5 and K6 beside their bounds,
   plain versions and library calls, K5 with the second-min and on
   ``score_block`` (bit for bit against each other), and the same sweeps
   untiled (K1, K2);
7. K6's device time split by kernel (a ``torch.profiler`` trace of
   ordinary calls) on seeded inputs at the full width: the single fold at
   k = 1000 and at k = 65536, and the dual fold at k = 65536 with 2% of
   the rows changed;
8. a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --fold-split`` runs phases 1 and 7 only (the
kernels build at their first call), so it also splits an older tree's K6.

The bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of memory, 989
TFLOP/s bf16 on the tensor cores and 67 TFLOP/s f32 outside them.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

HEADLINE = dict(n=1_280_000, d=2048, k=1000)
CODEBOOK = dict(n=1_280_000, d=2048, k=65536)
MEM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
#: Tolerances of the kernel-vs-plain checks.  The kernel and the plain
#: version sum the same f32 products in another order, so their labels may
#: differ on a row whose two best scores tie to within that order: each
#: one's chosen score may exceed the f64 minimum by this fraction of
#: ||x_cd||² + ||c||² (which bounds |csq − 2x·c|), and no more.
SCORE_RTOL = 1e-5
#: Sums: f32 sums of the same terms, in another order on the card (K2-K4's
#: atomics, K1's and K6's buckets in row order).
SUMS_RTOL = 1e-4
#: Phase 5: final inertia of the kernel fit vs the plain-backend fit.  Both
#: start from the same k-means++ draw; rows whose two best bf16 scores tie
#: to within the accumulation order may move, nothing else.
FIT_INERTIA_RTOL = 1e-4
SOURCE = "kmeans_tpu_torch/csrc/lloyd.cu"
REPLACES = {
    "lloyd_pass_cuda": "kmeans_tpu/ops/pallas_lloyd.py:458",
    "lloyd_delta_cuda": "kmeans_tpu/ops/pallas_lloyd.py:677",
    "accumulate_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1583",
    "lloyd_hamerly_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1058",
    "tiled_argmin_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1388",
    "tiled_fold_cuda": "kmeans_tpu/ops/pallas_lloyd.py:1484",
}
#: Hand-driven sweeps of each pruned flavour in the soundness check.
SOUND_SWEEPS = 20
#: Sweeps of the default-entry-point fit: the yinyang probe at sweep 16 and
#: its judgment at sweep 32 both run.
AUTO_SWEEPS = 48
#: The codebook fit's sweeps (the refresh and three delta sweeps) and the
#: hand-driven tiled Hamerly sweeps there.
CODEBOOK_SWEEPS = 4
CODEBOOK_HAMERLY_SWEEPS = 3


class SmokeFailure(RuntimeError):
    pass


def _check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def _sync():
    import torch

    torch.cuda.synchronize()


def _time_auto(fn):
    """CUDA-event milliseconds of ``fn()`` and its output: one timed launch
    when it takes a second or more, else the median of 3 more after it."""
    import torch

    _sync()
    times = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if times[0] >= 1000.0:
            break
    return (times[0] if len(times) == 1 else statistics.median(times[1:]),
            out)


def _time_ms(fn, reps):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` runs after
    one warm-up run."""
    import torch

    fn()
    _sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------

def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = out.stdout.strip().splitlines()[0]
    print(card)
    return card


#: The Hopper core's template arguments as ptxas names them (the mangled
#: ``core_score_kernel<GATHER, SECOND>``), and what runs each.
CORE_VARIANTS = {"ILb0ELb0E": "dense (K1, K2, K5)",
                 "ILb0ELb1E": "dense with second-min (K5 for Hamerly)",
                 "ILb1ELb1E": "gathered with second-min (K4)"}


def phase_build():
    from kmeans_tpu_torch.ops import _build

    info = _build.build()
    print(f"build: {info['seconds']:.1f} s (built now: {info['built']}) "
          f"-> {info['path']}")
    lines = info["ptxas"].splitlines()
    regs = [int(w.split()[0]) for line in lines
            for w in line.split("Used ")[1:] if "registers" in w]
    spills = [line.strip() for line in lines
              if "spill" in line and " 0 bytes spill stores" not in line]
    if regs:
        print(f"  ptxas: {len(regs)} kernels, at most {max(regs)} registers "
              f"a thread, {len(spills)} with spills")
    # Each core variant: the registers ptxas allocates a thread at launch
    # (setmaxnreg then moves them from the producer warpgroup to the
    # consumers) and its spills.
    name = None
    fold_regs, fold_spills = [], 0
    for line in lines:
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
        variant = next((v for key, v in CORE_VARIANTS.items()
                        if name and "core_score_kernel" + key in name), None)
        if variant and ("spill" in line or "Used" in line):
            print(f"  core {variant}: {line.strip()}")
        if name and "fold_kernel" in name:
            fold_regs += [int(w.split()[0]) for w in line.split("Used ")[1:]
                          if "registers" in w]
            fold_spills += ("spill" in line
                            and " 0 bytes spill stores" not in line)
    if fold_regs:
        print(f"  fold core: {len(fold_regs)} fold_kernel variants, "
              f"{min(fold_regs)}-{max(fold_regs)} registers a thread, "
              f"{fold_spills} with spills")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _scores64(x, c, cd):
    """f64 scores ``||c||² + x_cd·(−2·c_cd)ᵀ`` and their scale
    ``||x_cd||² + ||c_cd||²``, which bounds the magnitude of the terms the
    f32 accumulation sums."""
    from kmeans_tpu_torch.ops.distance import sq_norms

    xc = x.to(cd).double()
    cc = c.to(cd).double()
    csq = sq_norms(c).double()
    s = csq + xc @ (-2.0 * cc).T
    scale = (xc * xc).sum(1)[:, None] + (cc * cc).sum(1)[None, :]
    return s, scale


def _near_min(name, s, scale, labels):
    """Each row's score at ``labels`` is within SCORE_RTOL of the row's
    scale above the row's f64 minimum.  Returns the chosen f64 scores and
    that tolerance per row."""
    lab = labels.long()
    _check(bool((lab >= 0).all() and (lab < s.shape[1]).all()),
           f"{name}: label out of range")
    chosen = s.gather(1, lab[:, None])[:, 0]
    tol = SCORE_RTOL * scale.gather(1, lab[:, None])[:, 0]
    gap = chosen - s.min(dim=1).values
    _check(bool((gap <= tol).all()),
           f"{name}: {int((gap > tol).sum())} rows chose a score above the "
           f"minimum by more than {SCORE_RTOL} of the row scale")
    return chosen, tol


def _check_labels(name, x, c, cd, labels, plain_labels, ties=False):
    """Kernel labels against the plain version's: they agree except on rows
    whose two choices both score within SCORE_RTOL of the f64 minimum (a
    tie to within the f32 accumulation order); with ``ties`` (every odd
    centroid a copy of the even one before it) every label is even, the
    lowest index of its exact tie.  Returns ``(f64 score at the kernel's
    label per row, its tolerance, rows where the labels differ)``."""
    if ties:
        _check(bool((labels % 2 == 0).all()),
               f"{name}: an exact tie went to the higher index")
    s, scale = _scores64(x, c, cd)
    chosen, tol = _near_min(name, s, scale, labels)
    _near_min(f"{name} (plain)", s, scale, plain_labels)
    return chosen, tol, int((labels != plain_labels).sum())


def _check_labels_rows(name, x, c, cd, labels, plain_labels):
    """:func:`_check_labels` for a large n: only the rows where the kernel
    and the plain version disagree are scored in f64, 1024 at a time."""
    rows = (labels != plain_labels).nonzero()[:, 0]
    for part in rows.split(1024):
        s, scale = _scores64(x[part], c, cd)
        _near_min(name, s, scale, labels[part])
        _near_min(f"{name} (plain)", s, scale, plain_labels[part])
    return int(rows.numel())


def _close(name, got, want, rtol=SUMS_RTOL):
    import torch

    atol = rtol * float(want.abs().max().clamp_min(1e-30))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    _check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
           f"{name}: max abs error {err} beyond rtol={rtol}, atol={atol}")
    return err


def _within(name, got, want, tol):
    """Per-row scores (or min_d2) that may differ only by the f32
    accumulation order of the score: ``|got − want| <= tol`` row by row,
    ``tol`` being SCORE_RTOL of each row's ``||x_cd||² + ||c||²``."""
    err = (got.double() - want.double()).abs()
    _check(bool((err <= tol).all()),
           f"{name}: {int((err > tol).sum())} rows differ by more than "
           f"{SCORE_RTOL} of their row scale (max abs error "
           f"{float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def _row_scale(x, c, cd, labels):
    """SCORE_RTOL·(||x_cd||² + ||c_cd[label]||²) per row, without an f32
    copy of x."""
    import torch

    from kmeans_tpu_torch.ops.distance import sq_norms

    x_sq = torch.cat([sq_norms(x[s:s + 65536].to(cd))
                      for s in range(0, x.shape[0], 65536)])
    return SCORE_RTOL * (x_sq + sq_norms(c.to(cd))[labels.long()])


def _case_inputs(gen, n, d, k, x_dtype, ties):
    import torch

    dev = "cuda"
    x = torch.randn(n, d, generator=gen, device=dev) * 2.0
    c = x[torch.randperm(n, generator=gen, device=dev)[:k]].clone()
    c += 0.3 * torch.randn(k, d, generator=gen, device=dev)
    if ties:
        # Exact duplicate centroids, and rows that sit on them: every
        # duplicate pair ties exactly, and the lower index must win.
        c[1::2] = c[0::2][: c[1::2].shape[0]]
        x[: k // 2] = c[0::2][: k // 2]
    w = (torch.rand(n, generator=gen, device=dev) > 0.2).float()
    prev = torch.randint(-1, k, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    return x.to(x_dtype).contiguous(), c, w, prev


def _second64(s, labels):
    """f64 least score over the columns other than ``labels``, and the
    column it sits at."""
    import torch

    masked = s.scatter(1, labels.long()[:, None], torch.inf)
    best = masked.min(dim=1)
    return best.values, best.indices


def _check_hamerly(name, x, c, cd, w, prev, gen, ties, k2):
    """K4 against its plain version at need fractions 0, about 10% and
    100% (−1 sentinels always needed).  Needed rows: labels near the f64
    minimum, sb within the score tolerance of the f64 score at the label,
    slb of the f64 least score over the other columns; other rows: prev,
    sb_in and slb_in passed through bit for bit; the signed fold against
    the plain fold at the kernel's labels; the counts exact.  With every
    row needed, labels and sb equal K2's labels and raw scores bit for bit
    (``k2``).  Returns the rows labelled differently from the plain
    version."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, k = x.shape[0], c.shape[0]
    s, scale = _scores64(x, c, cd)
    sb_in = torch.randn(n, generator=gen, device="cuda") * 100
    slb_in = torch.randn(n, generator=gen, device="cuda") * 100
    moved = 0
    for frac in (0.0, 0.1, 1.0):
        p = prev.clamp_min(0) if frac == 0.0 else prev
        need = ((torch.rand(n, generator=gen, device="cuda") < frac)
                | (p < 0))
        what = f"K4 need={frac:.0%} {name}"
        lab, sb, slb, dsums, dcounts, n_rec, dense = K.lloyd_hamerly_cuda(
            x, c, p, need, sb_in, slb_in, weights=w, compute_dtype=cd)
        _sync()
        plain = K.lloyd_hamerly_plain(x, c, p, need, sb_in, slb_in,
                                      weights=w, compute_dtype=cd)
        keep = ~need
        _check(bool(torch.equal(lab[keep], p[keep])
                    and torch.equal(sb[keep], sb_in[keep])
                    and torch.equal(slb[keep], slb_in[keep])),
               f"{what}: rows not needed were not passed through")
        if bool(need.any()):
            if ties:
                _check(bool((lab[need] % 2 == 0).all()),
                       f"{what}: an exact tie went to the higher index")
            sn, scn = s[need], scale[need]
            chosen, tol = _near_min(what, sn, scn, lab[need])
            _near_min(f"{what} (plain)", sn, scn, plain[0][need])
            _within(f"{what} sb", sb[need], chosen, tol)
            second, col = _second64(sn, lab[need])
            _within(f"{what} slb", slb[need], second,
                    SCORE_RTOL * scn.gather(1, col[:, None])[:, 0])
            moved = max(moved, int((lab != plain[0]).sum()))
        changed = need & (lab != p) & (w > 0)
        add = K.accumulate_plain(x, torch.where(changed, lab, -1), k,
                                 weights=w, compute_dtype=cd)
        sub = K.accumulate_plain(x, torch.where(changed, p, -1), k,
                                 weights=w, compute_dtype=cd)
        _close(f"{what} dsums", dsums, add[0] - sub[0])
        _check(bool(torch.equal(dcounts, add[1] - sub[1])),
               f"{what} dcounts")
        _check(int(n_rec) == int(need.sum()) == int(plain[5]),
               f"{what} n_recomputed")
        _check(int(dense) == int(K._dense_tiles(need, K.HAMERLY_SLOTS))
               == int(plain[6]), f"{what} dense_tiles")
        if frac == 1.0:
            _check(bool(torch.equal(lab, k2[0]) and torch.equal(sb, k2[1])),
                   f"{what}: labels or sb differ from K2's raw scores")
    return moved


def _check_tiled(name, x, c, cd, w, prev, ties, k_tile=128):
    """K5 and K6 against their plain versions at ``k_tile``-wide slices.
    K5: labels near the f64 minimum (the lower index of an exact tie), raw
    scores and second-min within the score tolerance, and labels, raw
    scores, normed min and second-min equal to K2's, K1's and K4's bit for
    bit (the same score loop).  K6: the single fold at K5's labels with half
    the rows moved to one label and some to −1, and the dual fold against
    ``prev``: sums within SUMS_RTOL of the plain version's, counts exact,
    and a second launch equal bit for bit.  Returns the rows labelled
    differently from the plain version."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, k = x.shape[0], c.shape[0]
    what = f"K5 k_tile={k_tile} {name}"
    neg2c, csq = K._score_operands(c, cd)
    lab, raw, sec = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                        raw_scores=True, with_second=True)
    normed = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1]
    k1 = K.lloyd_pass_cuda(x, c, compute_dtype=cd, with_update=False)
    k2 = K.lloyd_delta_cuda(x, c, prev, compute_dtype=cd, with_mind=False)
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    zeros = torch.zeros(n, device="cuda")
    k4 = K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                              compute_dtype=cd)
    _sync()
    plain = K.tiled_argmin_plain(x, neg2c, csq, k_tile=k_tile,
                                 raw_scores=True, with_second=True)
    chosen, tol, moved = _check_labels(what, x, c, cd, lab, plain[0], ties)
    _within(f"{what} raw", raw, chosen, tol)
    s, scale = _scores64(x, c, cd)
    second, col = _second64(s, lab)
    _within(f"{what} second", sec, second,
            SCORE_RTOL * scale.gather(1, col[:, None])[:, 0])
    _check(bool(torch.equal(lab, k2[0]) and torch.equal(raw, k2[1])
                and torch.equal(normed, k1[1]) and torch.equal(sec, k4[2])),
           f"{what}: labels, scores or second-min differ from K1/K2/K4's")
    lab3 = lab.clone()
    lab3[::2] = k // 2
    lab3[1::7] = -1
    for lab2 in (None, prev):
        fold = f"K6 {'dual' if lab2 is not None else 'single'} {name}"
        got = K.tiled_fold_cuda(x, w, lab3, lab2, k, compute_dtype=cd)
        again = K.tiled_fold_cuda(x, w, lab3, lab2, k, compute_dtype=cd)
        _sync()
        want = K.tiled_fold_plain(x, w, lab3, lab2, k, compute_dtype=cd,
                                  k_tile=k_tile)
        _check(bool(torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])),
               f"{fold}: two launches differ")
        _close(f"{fold} sums", got[0], want[0])
        _check(bool(torch.equal(got[1], want[1])), f"{fold} counts")
    return moved


def _straddling_tie_cases(gen):
    """Duplicate centroids at columns 127 and 128, on either side of a
    128-column slice edge, and rows that sit on them: K5 must give 127."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    for xd, cd in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16)):
        x, c, w, prev = _case_inputs(gen, 2053, 2048, 256, xd, False)
        c[128] = c[127]
        x[:64] = c[127].to(xd)
        name = f"n=2053 d=2048 k=256 x={str(xd)[6:]} tie at the slice edge"
        _check_tiled(name, x, c, cd, w, prev, False)
        lab = K.tiled_argmin_cuda(x, *K._score_operands(c, cd), k_tile=128)[0]
        _check(bool((lab[:64] == 127).all()),
               f"K5 {name}: the tie did not go to column 127")
        print(f"  ok {name}")


class _ForcedScoreBlock:
    """Within it, K1, K2, K4 and K5 score every input with
    ``score_block``: the wrappers read ``cuda_lloyd.scoring_core`` at each
    call."""

    def __enter__(self):
        from kmeans_tpu_torch.ops import cuda_lloyd as K

        self._rule = K.scoring_core
        K.scoring_core = lambda *args: "score_block"

    def __exit__(self, *exc):
        from kmeans_tpu_torch.ops import cuda_lloyd as K

        K.scoring_core = self._rule


def _check_k1_repeats(name, x, c, cd, w, k1):
    """A second K1 launch equals the first ``k1`` bit for bit, sums and
    counts included (the fold core)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    again = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
    _sync()
    _check(all(torch.equal(a, b) for a, b in zip(k1[:4], again[:4])),
           f"K1 {name}: two launches differ")


def _check_cores_agree(name, x, c, cd, w, prev, k1, k2):
    """On an input the Hopper core takes: K1's labels and min_d2 and K2's
    labels and raw scores (``k1``, ``k2``) equal ``score_block``'s on the
    same input bit for bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    with _ForcedScoreBlock():
        sb1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
        sb2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd,
                                 with_mind=False)
    _sync()
    _check(torch.equal(k1[0], sb1[0]) and torch.equal(k1[1], sb1[1]),
           f"K1 {name}: the Hopper core's labels or min_d2 differ from "
           "score_block's")
    _check(torch.equal(k2[0], sb2[0]) and torch.equal(k2[1], sb2[1]),
           f"K2 {name}: the Hopper core's labels or raw scores differ from "
           "score_block's")


def _check_core_k4_k5(name, x, c, cd, w, prev, gen):
    """On an input the Hopper core takes: K4 at need fractions 0, about 10%
    and 100% (−1 sentinels needed) and K5 at k_tile 128, 384 and 1024,
    with the second-min, against ``score_block``'s on the
    same input bit for bit -- K4's labels, sb, slb, n_recomputed and
    dense_tiles, K5's labels, raw min, second-min and normed min -- and two
    launches of each equal bit for bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n = x.shape[0]
    sb_in = torch.randn(n, generator=gen, device="cuda")
    k4_out = ("labels", "sb", "slb", None, None, "n_recomputed", "dense_tiles")
    for frac in (0.0, 0.1, 1.0):
        p = prev.clamp_min(0) if frac == 0.0 else prev
        need = ((torch.rand(n, generator=gen, device="cuda") < frac)
                | (p < 0))
        args = (x, c, p, need, sb_in, sb_in + 1)
        with _ForcedScoreBlock():
            ref = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        for launch in ("first", "second"):
            got = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
            _sync()
            for g, e, what in zip(got, ref, k4_out):
                _check(what is None or torch.equal(g, e),
                       f"K4 need={frac:.0%} {name} ({launch} launch): the "
                       f"core's {what} differ from score_block's")
    neg2c, csq = K._score_operands(c, cd)

    def k5(k_tile):
        return (*K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                     raw_scores=True, with_second=True),
                K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1])

    for k_tile in (128, 384, 1024):
        with _ForcedScoreBlock():
            ref = k5(k_tile)
        for launch in ("first", "second"):
            got = k5(k_tile)
            _sync()
            for g, e, what in zip(got, ref, ("labels", "raw min",
                                             "second-min", "normed min")):
                _check(torch.equal(g, e),
                       f"K5 k_tile={k_tile} {name} ({launch} launch): the "
                       f"core's {what} differ from score_block's")


def _core_range_edge_ties(gen):
    """Duplicate centroids on either side of 256-column sub-slice edges
    inside a range (255 | 256 at k_tile 384 and 1024, 511 | 512 at 1024)
    and of range edges (127 | 128 at every k_tile, 383 | 384 at 128 and
    384, 1023 | 1024 at 128 and 1024), at k = 1100, and rows that sit on
    them: K4 with every row needed and K5 at each k_tile give the lower
    index with second-min == min, and the core equals score_block bit for
    bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    bf16 = torch.bfloat16
    x, c, w, prev = _case_inputs(gen, 2053, 2048, 1100, bf16, False)
    pairs = ((127, 128), (255, 256), (383, 384), (511, 512), (1023, 1024))
    for i, (lo, hi) in enumerate(pairs):
        c[hi] = c[lo]
        x[16 * i:16 * (i + 1)] = c[lo].to(bf16)
    name = ("n=2053 d=2048 k=1100 x=bfloat16 ties at sub-slice and range "
            "edges")
    _check(K.scoring_core(x, bf16, c.to(bf16)) == "wgmma",
           f"{name}: not on the Hopper core")
    _check_core_k4_k5(name, x, c, bf16, w, prev, gen)
    n = x.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    zeros = torch.zeros(n, device="cuda")
    k4 = K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                              compute_dtype=bf16)
    outs = [("K4", k4[:3])]
    neg2c, csq = K._score_operands(c, bf16)
    for k_tile in (128, 384, 1024):
        outs.append((f"K5 k_tile={k_tile}",
                     K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                         raw_scores=True, with_second=True)))
    _sync()
    for what, (lab, best, second) in outs:
        for i, (lo, hi) in enumerate(pairs):
            rows = slice(16 * i, 16 * (i + 1))
            _check(bool((lab[rows] == lo).all()),
                   f"{what} {name}: the tie at {lo} | {hi} did not go to {lo}")
            _check(torch.equal(second[rows], best[rows]),
                   f"{what} {name}: second-min != min on the tie at {lo}")
    print(f"  ok {name} (core wgmma)")


def _slice_edge_core_ties(gen):
    """Duplicate centroids at columns 255 and 256, on either side of the
    Hopper core's 256-column slice edge, and rows that sit on them: K1 and
    K2 must give 255.  k = 257 leaves the second slice one column; k = 1000
    is the headline's width."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    bf16 = torch.bfloat16
    for k in (257, 1000):
        x, c, w, prev = _case_inputs(gen, 2053, 2048, k, bf16, False)
        c[256] = c[255]
        x[:64] = c[255].to(bf16)
        name = f"n=2053 d=2048 k={k} x=bfloat16 tie at the core's slice edge"
        _check(K.scoring_core(x, bf16, c.to(bf16)) == "wgmma",
               f"{name}: not on the Hopper core")
        k1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=bf16)
        k2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=bf16,
                                with_mind=False)
        _sync()
        _check(bool((k1[0][:64] == 255).all() and (k2[0][:64] == 255).all()),
               f"{name}: the tie did not go to column 255")
        _check_labels(f"K1 {name}", x, c, bf16, k1[0],
                      K.lloyd_pass_plain(x, c, compute_dtype=bf16)[0])
        _check_k1_repeats(name, x, c, bf16, w, k1)
        _check_cores_agree(name, x, c, bf16, w, prev, k1, k2)
        print(f"  ok {name} (core wgmma)")


#: The fold core's cases: (n, d, k, x dtype, compute dtype, every row on
#: one label).  d = 300 takes the column-strided loads, d = 4104 three
#: 2048-column spans, k = 1 one bucket.
FOLD_CORE_CASES = (
    (2053, 2048, 1000, "bfloat16", "bfloat16", False),
    (2053, 2048, 1000, "bfloat16", "bfloat16", True),
    (2053, 300, 1000, "bfloat16", "bfloat16", False),
    (2053, 100, 1000, "float32", "float32", False),
    (2053, 100, 3, "float32", "bfloat16", False),
    (1031, 4104, 7, "bfloat16", "bfloat16", False),
    (1031, 64, 1, "bfloat16", "bfloat16", False),
)


def _fold_core_cases(gen):
    """K6's single and dual folds, K3 and K1's fold on the fold core, with
    labels outside [0, k), zero weights and (dual) rows with equal labels:
    each equal bit for bit to ``fold_core_plain`` (the core's order, op by
    op) and to a second launch; K3's and K1's sums and counts equal to K6's
    single fold's at the same labels bit for bit; each within SUMS_RTOL of
    its plain version, counts exact, K3's min_d2 within rtol 1e-5 and
    K1's within 1e-5 of ||x||² of its own raw score plus the plain
    ||x||² (the raw score is the scoring core's, which the fold does not
    touch)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    for n, d, k, xd, cdn, one_label in FOLD_CORE_CASES:
        xd, cd = getattr(torch, xd), getattr(torch, cdn)
        x, c, w, prev = _case_inputs(gen, n, d, k, xd, False)
        lab = torch.randint(-2, k + 2, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if one_label:
            lab[3:] = k // 2
        lab2 = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.3,
                           lab, prev)
        scores = torch.randn(n, generator=gen, device="cuda")
        name = (f"n={n} d={d} k={k} x={str(xd)[6:]} cd={cdn}"
                f"{' one label' if one_label else ''}")
        outs = {}
        for mode, l2 in (("single", None), ("dual", lab2)):
            what = f"fold core K6 {mode} {name}"
            got = K.tiled_fold_cuda(x, w, lab, l2, k, compute_dtype=cd)
            again = K.tiled_fold_cuda(x, w, lab, l2, k, compute_dtype=cd)
            _sync()
            model = K.fold_core_plain(x, w, lab, l2, k, compute_dtype=cd)
            plain = K.tiled_fold_plain(x, w, lab, l2, k, compute_dtype=cd)
            _check(all(torch.equal(g, a) for g, a in zip(got, again)),
                   f"{what}: two launches differ")
            _check(all(torch.equal(g, m) for g, m in zip(got, model)),
                   f"{what}: differs from fold_core_plain's order")
            _close(f"{what} sums", got[0], plain[0])
            _check(bool(torch.equal(got[1], plain[1])), f"{what} counts")
            outs[mode] = got
        what = f"fold core K3 {name}"
        k3 = K.accumulate_cuda(x, lab, k, scores=scores, weights=w,
                               compute_dtype=cd)
        k3b = K.accumulate_cuda(x, lab, k, scores=scores, weights=w,
                                compute_dtype=cd)
        _sync()
        plain = K.accumulate_plain(x, lab, k, scores=scores, weights=w,
                                   compute_dtype=cd)
        _check(all(torch.equal(a, b) for a, b in zip(k3, k3b)),
               f"{what}: two launches differ")
        _check(bool(torch.equal(k3[0], outs["single"][0])
                    and torch.equal(k3[1], outs["single"][1])),
               f"{what}: sums or counts differ from K6's single fold")
        _close(f"{what} min_d2", k3[2], plain[2], rtol=1e-5)
        what = f"fold core K1 {name}"
        k1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
        at = K.tiled_fold_cuda(x, w, k1[0], None, k, compute_dtype=cd)
        _sync()
        _check(bool(torch.equal(k1[2], at[0]) and torch.equal(k1[3], at[1])),
               f"{what}: sums or counts differ from K6's single fold at its "
               "labels")
        raw = K.lloyd_pass_cuda(x, c, compute_dtype=cd, with_update=False,
                                raw_scores=True)[1]
        sq = x.float().pow(2).sum(1)
        _within(f"{what} min_d2", k1[1], (raw + sq).clamp_min(0), 1e-5 * sq)
        print(f"  ok {what}: K6 single and dual, K3 and K1 equal "
              "fold_core_plain and each other bit for bit")


def phase_kernels():
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(n, d, k, xd, cd, False)
             for d in (2, 100, 2048) for k in (3, 1000)
             for (xd, cd) in ((f32, f32), (bf16, bf16), (f32, bf16))
             for n in (2053,)]
    cases += [(1531, 64, 10, f32, f32, True), (1531, 64, 10, bf16, bf16, True),
              (2053, 2048, 1000, bf16, bf16, True)]
    # The Hopper core's ragged shapes: n % 128 != 0; d a multiple of 8 but
    # not of 64; k = 257 (a last slice of one column), k = 3 (one ragged
    # slice).
    cases += [(2053, d, k, bf16, bf16, False)
              for d in (8, 200) for k in (3, 257, 1000)]
    cases += [(2053, 2048, 257, bf16, bf16, False)]
    cores = {}
    for n, d, k, xd, cd, ties in cases:
        x, c, w, prev = _case_inputs(gen, n, d, k, xd, ties)
        core = K.scoring_core(x, cd, c.to(cd))
        cores[core] = cores.get(core, 0) + 1
        name = (f"n={n} d={d} k={k} x={str(xd)[6:]} cd={str(cd)[6:]}"
                f"{' ties' if ties else ''}")
        xf = x.float()
        # K1
        lab, mind, sums, counts, _ = k1 = K.lloyd_pass_cuda(
            x, c, weights=w, compute_dtype=cd)
        _sync()
        plain = K.lloyd_pass_plain(x, c, weights=w, compute_dtype=cd)
        chosen, tol, moved = _check_labels(f"K1 {name}", x, c, cd, lab,
                                           plain[0], ties)
        row_sq = (xf.double() ** 2).sum(1)
        _within(f"K1 min_d2 {name}", mind, (chosen + row_sq).clamp_min(0),
                tol)
        ps, pc, _ = K.accumulate_plain(x, lab, k, weights=w, compute_dtype=cd)
        _close(f"K1 sums {name}", sums, ps)
        _check(bool(torch.equal(counts, pc)), f"K1 counts {name}")
        lab0, _, s0, c0, _ = K.lloyd_pass_cuda(x, c, compute_dtype=cd,
                                               with_update=False)
        _sync()
        _check(bool(torch.equal(lab0, lab)) and not s0.any()
               and not c0.any(), f"K1 with_update=False {name}")
        # K2, with_mind both ways; prev holds −1 sentinels.
        for with_mind in (True, False):
            lab2, mind2, dsums, dcounts, _, n_ch, dense = K.lloyd_delta_cuda(
                x, c, prev, weights=w, compute_dtype=cd, with_mind=with_mind)
            k2 = (lab2, mind2)
            _sync()
            plain2 = K.lloyd_delta_plain(x, c, prev, weights=w,
                                         compute_dtype=cd,
                                         with_mind=with_mind)
            chosen2, tol2, moved2 = _check_labels(f"K2 {name}", x, c, cd,
                                                  lab2, plain2[0], ties)
            moved = max(moved, moved2)
            want_mind = (chosen2 + row_sq).clamp_min(0) if with_mind \
                else chosen2
            _within(f"K2 min_d2 {name}", mind2, want_mind, tol2)
            changed = (lab2 != prev) & (w > 0)
            _check(int(n_ch) == int(changed.sum()), f"K2 n_changed {name}")
            _check(int(dense) == int(K._dense_tiles(changed)),
                   f"K2 dense_tiles {name}")
            add = K.accumulate_plain(
                x, torch.where(changed, lab2, -1), k, weights=w,
                compute_dtype=cd)
            sub = K.accumulate_plain(
                x, torch.where(changed, prev, -1), k, weights=w,
                compute_dtype=cd)
            _close(f"K2 dsums {name}", dsums, add[0] - sub[0])
            _check(bool(torch.equal(dcounts, add[1] - sub[1])),
                   f"K2 dcounts {name}")
        _check_k1_repeats(name, x, c, cd, w, k1)
        if core == "wgmma":
            _check_cores_agree(name, x, c, cd, w, prev, k1, k2)
            _check_core_k4_k5(name, x, c, cd, w, prev, gen)
        # K3 with out-of-range labels and scores.
        lab3 = torch.randint(-2, k + 3, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
        scores = torch.randn(n, generator=gen, device="cuda")
        s3, c3, m3 = K.accumulate_cuda(x, lab3, k, scores=scores, weights=w,
                                       compute_dtype=cd)
        _sync()
        ps3, pc3, pm3 = K.accumulate_plain(x, lab3, k, scores=scores,
                                           weights=w, compute_dtype=cd)
        _close(f"K3 sums {name}", s3, ps3)
        _check(bool(torch.equal(c3, pc3)), f"K3 counts {name}")
        _close(f"K3 min_d2 {name}", m3, pm3, rtol=1e-5)
        # K4 at three need fractions; k2 holds K2's with_mind=False run.
        moved = max(moved, _check_hamerly(name, x, c, cd, w, prev, gen,
                                          ties, k2))
        # K5 and K6 at 128-column slices: k = 1000 leaves a ragged last
        # slice of 104 columns, k = 3 one ragged slice.
        moved = max(moved, _check_tiled(name, x, c, cd, w, prev, ties))
        print(f"  ok {name}, core {core} ({moved} rows labelled differently "
              "from the plain version, each a tie within the tolerance)")
    _straddling_tie_cases(gen)
    _slice_edge_core_ties(gen)
    _core_range_edge_ties(gen)
    _fold_core_cases(gen)
    print(f"scoring cores over the cases: {cores}; the Hopper core's labels, "
          "min_d2, raw scores, sb, slb and second-min (K1, K2, K4, K5 at "
          "k_tile 128, 384, 1024) equal score_block's bit for bit, and two "
          "launches of K1, K4 and K5 equal each other bit for bit")
    print(f"kernels vs plain: {len(cases) + 5 + len(FOLD_CORE_CASES)} "
          "cases agree (score rtol "
          f"{SCORE_RTOL}, sums rtol {SUMS_RTOL}, counts exact; K5 equal to "
          "K1, K2 and K4 bit for bit; K6 equal to itself bit for bit)")


# ---------------------------------------------------------------------------
# Phase 4: the slice at full width
# ---------------------------------------------------------------------------

def _bound_ms(bytes_moved, tensor_ops=0.0, f32_ops=0.0):
    """(least ms for the work, "bytes" | "operations")."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = max(tensor_ops / BF16_TENSOR_OPS_PER_S, f32_ops / F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kernel_row(name, launches, ms, plain_ms, library_ms, err, bytes_moved,
                tensor_ops, f32_ops):
    """One entry of the ``{"kernels": [...]}`` line, printed as it is
    made; ``library_ms`` may be None."""
    bound, by = _bound_ms(bytes_moved, tensor_ops, f32_ops)
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    print(f"{name}: {ms:.3f} ms (bound {bound:.3f} ms by {by}), plain "
          f"{plain_ms:.3f} ms, library {lib}, max abs err vs plain "
          f"{err:.3e}")
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def phase_headline():
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.update import apply_update

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    c0 = random_init(gen, x, k)
    _sync()
    print(f"headline data: n={n} d={d} k={k} bf16, "
          f"{time.perf_counter() - t0:.2f} s to make")
    core = K.scoring_core(x, bf16, c0.to(bf16))
    print(f"scoring core of K1 and K2 at the headline shape: {core}")
    _check(core == "wgmma", "the headline shape does not take the Hopper core")

    # The main path, in three runs, each with the counts set to 0 just
    # before it and read just after: the delta fit (K1 and K2 only), the
    # public delta sweep's refresh branch (K2, then K3) and the default
    # entry point (the adaptive loop: K1, K2 and K4).
    torch.cuda.reset_peak_memory_stats()
    cfg = kt.KMeansConfig(k=k, update="delta", compute_dtype="bfloat16")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=20, tol=-1.0)
    _sync()
    fit_s = time.perf_counter() - t0
    fit_launches = K.launch_counts()
    K.reset_launch_counts()
    refresh = kt.delta_pass(x, state.centroids, state.labels,
                            torch.zeros(k, d, device="cuda"),
                            torch.zeros(k, device="cuda"),
                            compute_dtype="bfloat16", force_full=True)
    _sync()
    refresh_launches = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_iter = int(state.n_iter)
    print(f"fit_lloyd(update='delta', max_iter=20, tol=-1): {n_iter} sweeps "
          f"+ final view in {fit_s:.3f} s = {n_iter / fit_s:.3f} iter/s "
          f"(final view included); inertia {float(state.inertia):.6e}")
    print(f"launches in fit_lloyd: {fit_launches}")
    print(f"launches in delta_pass(force_full=True): {refresh_launches}")
    print(f"peak device memory: {peak_gb:.3f} GB")
    _check(fit_launches["lloyd_pass_cuda"] >= 3,
           "K1 launched fewer than 3 times in the fit")
    _check(fit_launches["lloyd_delta_cuda"] >= 17,
           "K2 launched fewer than 17 times in the fit")
    _check(fit_launches["accumulate_cuda"] == 0,
           "the fit's sweeps launched K3")
    _check(refresh_launches["accumulate_cuda"] >= 1
           and refresh_launches["lloyd_delta_cuda"] >= 1,
           "delta_pass(force_full=True) did not launch K2 and K3")
    _check(not any(fit_launches[t] or refresh_launches[t]
                   for t in ("tiled_argmin_cuda", "tiled_fold_cuda")),
           "the headline shape planned untiled, but K5 or K6 launched")
    _check(n_iter == 20 and bool(torch.isfinite(state.centroids).all())
           and bool(torch.isfinite(state.inertia)),
           "headline fit: wrong sweep count or non-finite result")
    _check(int(refresh[3].sum()) == n
           and bool(torch.isfinite(refresh[2]).all()),
           "delta_pass(force_full=True): counts do not sum to n")
    auto_launches = _auto_fit(x, c0)
    launches = {name: fit_launches[name] + refresh_launches[name]
                + auto_launches[name] for name in fit_launches}
    states, rno = _soundness(x, c0)

    # Steady-state inputs of one more sweep, for the per-kernel timings.
    lab, _, sums, counts, _ = K.lloyd_pass_cuda(x, state.centroids,
                                                compute_dtype=bf16)
    c1 = apply_update(state.centroids, sums, counts)
    w = torch.ones(n, device="cuda")
    kernels = []

    def record(name, *args):
        kernels.append(_kernel_row(name, launches[name], *args))

    xb, x_row, cb = n * d * 2, n * 4, k * d * 2 + k * 4
    dist_ops = 2.0 * n * d * k
    library_ms = _time_ms(
        lambda: torch.matmul(x, c1.to(bf16).T).argmin(dim=1), 3)

    # K1 at the headline shape: labels and min_d2 against the plain sweep,
    # sums against the plain fold at the kernel's labels.
    got = K.lloyd_pass_cuda(x, c1, compute_dtype=bf16)
    plain = K.lloyd_pass_plain(x, c1, compute_dtype=bf16)
    moved = _check_labels_rows("K1 headline", x, c1, bf16, got[0], plain[0])
    same = got[0] == plain[0]
    want = K.accumulate_plain(x, got[0], k, compute_dtype=bf16)
    err = max(_close("K1 headline sums", got[2], want[0]),
              _within("K1 headline min_d2", got[1][same], plain[1][same],
                      _row_scale(x, c1, bf16, got[0])[same]))
    print(f"K1 headline: {moved} rows labelled differently from the plain "
          "version, each a tie within the tolerance")
    record("lloyd_pass_cuda",
           _time_ms(lambda: K.lloyd_pass_cuda(x, c1, compute_dtype=bf16), 5),
           _time_ms(lambda: K.lloyd_pass_plain(x, c1, compute_dtype=bf16), 2),
           library_ms, err, xb + x_row + cb + 2 * x_row + k * d * 4 + k * 4,
           dist_ops, 4.0 * n * d)

    # K2 from the previous sweep's labels (this run's churn).
    got = K.lloyd_delta_cuda(x, c1, lab, compute_dtype=bf16, with_mind=False)
    plain = K.lloyd_delta_plain(x, c1, lab, compute_dtype=bf16,
                                with_mind=False)
    moved = _check_labels_rows("K2 headline", x, c1, bf16, got[0], plain[0])
    same = got[0] == plain[0]
    changed = got[0] != lab
    n_changed = int(got[5])
    add = K.accumulate_plain(x, torch.where(changed, got[0], -1), k,
                             compute_dtype=bf16)
    sub = K.accumulate_plain(x, torch.where(changed, lab, -1), k,
                             compute_dtype=bf16)
    err = max(_close("K2 headline dsums", got[2], add[0] - sub[0]),
              _within("K2 headline raw scores", got[1][same], plain[1][same],
                      _row_scale(x, c1, bf16, got[0])[same]))
    print(f"K2 headline churn: {n_changed} of {n} rows changed, "
          f"dense_tiles {int(got[6])}; {moved} rows labelled differently "
          "from the plain version, each a tie within the tolerance")
    record("lloyd_delta_cuda",
           _time_ms(lambda: K.lloyd_delta_cuda(x, c1, lab, compute_dtype=bf16,
                                               with_mind=False), 5),
           _time_ms(lambda: K.lloyd_delta_plain(x, c1, lab, compute_dtype=bf16,
                                                with_mind=False), 2),
           library_ms, err,
           xb + 2 * x_row + cb + 2 * x_row + k * d * 4 + k * 4,
           dist_ops, 4.0 * n_changed * d)
    _core_breakdown(x, c1, lab, kernels[0]["ms"], kernels[1]["ms"], dist_ops)

    # K3 with the sweep's labels.
    got = K.accumulate_cuda(x, lab, k, weights=w, compute_dtype=bf16)
    want = K.accumulate_plain(x, lab, k, weights=w, compute_dtype=bf16)
    err = max(_close("K3 headline sums", got[0], want[0]),
              _close("K3 headline min_d2", got[2], want[2], rtol=1e-5))
    lab_long = lab.long()
    record("accumulate_cuda",
           _time_ms(lambda: K.accumulate_cuda(x, lab, k, weights=w,
                                              compute_dtype=bf16), 5),
           _time_ms(lambda: K.accumulate_plain(x, lab, k, weights=w,
                                               compute_dtype=bf16), 2),
           _time_ms(lambda: torch.zeros(k, d, dtype=bf16, device="cuda")
                    .index_add_(0, lab_long, x), 3),
           err, xb + 3 * x_row + k * d * 4 + k * 4, 0.0, 4.0 * n * d)

    _forced_tiled(x, c1, lab, kernels[0]["ms"], kernels[1]["ms"])
    _hamerly_timings(x, states, rno, record)
    _flavour_sweeps(x, states, rno)

    t0 = time.perf_counter()
    seeds = kt.kmeans_plus_plus(gen, x, k, compute_dtype="bfloat16")
    _sync()
    print(f"kmeans_plus_plus at the headline shape: "
          f"{time.perf_counter() - t0:.3f} s")
    _check(bool(torch.isfinite(seeds).all()), "k-means++ seeds not finite")
    return kernels, launches


def _clock_under(fn, seconds=3.0):
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 100 ms while ``fn`` runs back to back, the first second of samples
    left out; None where it reports none."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            _sync()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = []
    for line in out.splitlines()[10:]:
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return None, None
    return (statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows))


def _core_breakdown(x, c, prev, k1_ms, k2_ms, dist_ops):
    """K1's time split by what it does at the headline shape (scoring + the
    raw slice merge, + the fold core's fold with ||x||²), both kernels'
    product rate, and
    the SM clock and power under K2, with the tensor cores' bf16 peak at
    that clock (4096 operations a clock on each SM)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    bf16 = torch.bfloat16
    raw_ms = _time_ms(lambda: K.lloyd_pass_cuda(
        x, c, compute_dtype=bf16, with_update=False, raw_scores=True), 5)
    norm_ms = _time_ms(lambda: K.lloyd_pass_cuda(
        x, c, compute_dtype=bf16, with_update=False), 5)
    print(f"K1 {k1_ms:.3f} ms = scoring and raw merge {raw_ms:.3f} + the "
          f"fold core's fold with ||x||² {k1_ms - raw_ms:.3f} (without the "
          f"fold the merge reads x for ||x||²: {norm_ms - raw_ms:.3f}); "
          f"product "
          f"rate K1 {dist_ops / k1_ms / 1e9:.1f}, K2 "
          f"{dist_ops / k2_ms / 1e9:.1f}, scoring alone "
          f"{dist_ops / raw_ms / 1e9:.1f} TFLOP/s")
    clock, power = _clock_under(lambda: K.lloyd_delta_cuda(
        x, c, prev, compute_dtype=bf16, with_mind=False))
    if clock is None:
        print("SM clock under K2: not reported by nvidia-smi")
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * 4096 * clock * 1e6 / 1e12
    print(f"SM clock under K2: {clock:.0f} MHz, power {power:.1f} W; the "
          f"tensor cores' bf16 peak at that clock {peak:.1f} TFLOP/s, K2 at "
          f"{dist_ops / k2_ms / 1e9 / peak:.1%} of it")


def _forced_tiled(x, c, prev, k1_ms, k2_ms):
    """The tiled route forced at the headline shape, where the planner keeps
    it untiled: K5 + K6 against K1 (the classic sweep) and K2 (the delta
    sweep from ``prev``), at the planner's widest slice (all 1000 columns
    in one) and at 128-column slices.  K5 must give K2's labels and raw
    scores bit for bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.plan import max_k_tile

    n, d = x.shape
    k = c.shape[0]
    bf16 = torch.bfloat16
    neg2c, csq = K._score_operands(c, bf16)
    k2 = K.lloyd_delta_cuda(x, c, prev, compute_dtype=bf16, with_mind=False)
    for k_tile in (max_k_tile("classic", d, k), 128):
        lab, raw = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                       raw_scores=True)
        _check(bool(torch.equal(lab, k2[0]) and torch.equal(raw, k2[1])),
               f"K5 k_tile={k_tile} headline: differs from K2")
        wch = (lab != prev).float()
        normed_ms = _time_ms(lambda: K.tiled_argmin_cuda(
            x, neg2c, csq, k_tile=k_tile), 5)
        raw_ms = _time_ms(lambda: K.tiled_argmin_cuda(
            x, neg2c, csq, k_tile=k_tile, raw_scores=True), 5)
        single_ms = _time_ms(lambda: K.tiled_fold_cuda(
            x, None, lab, None, k, compute_dtype=bf16), 5)
        dual_ms = _time_ms(lambda: K.tiled_fold_cuda(
            x, wch, lab, prev, k, compute_dtype=bf16), 5)
        print(f"forced tiled at the headline shape, k_tile={k_tile} "
              f"({-(-k // k_tile)} slices; a sweep's bound "
              f"{_bound_ms(n * d * 2, 2.0 * n * d * k)[0]:.3f} ms): classic "
              f"K5 {normed_ms:.3f} + K6 "
              f"single {single_ms:.3f} = {normed_ms + single_ms:.3f} ms "
              f"against K1 {k1_ms:.3f} ms; delta K5 raw {raw_ms:.3f} + K6 "
              f"dual {dual_ms:.3f} ({int(wch.sum())} changed rows) = "
              f"{raw_ms + dual_ms:.3f} ms against K2 {k2_ms:.3f} ms")


def _auto_fit(x, c0):
    """The default entry point at full width: ``KMeans`` with
    ``update="auto"`` from the fixed init, AUTO_SWEEPS sweeps.  Period 0 is
    delta, the first judgment (sweep 16) promotes yinyang, and the second
    (sweep 32) keeps it or demotes it: ``diag_["final_flavor"]`` says which,
    and the launch counts must agree.  Returns the launch counts."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.delta import DELTA_REFRESH

    k = c0.shape[0]
    plan = kt.fit_plan(x, k, config=kt.KMeansConfig(
        k=k, compute_dtype="bfloat16"))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    km = kt.KMeans(n_clusters=k, compute_dtype="bfloat16", init=c0,
                   max_iter=AUTO_SWEEPS, tol=-1.0).fit(x)
    _sync()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    dg = km.diag_
    periods = ["delta", "yinyang", "yinyang" if dg["final_flavor"] == 1
               else "delta"]
    n_yin = periods.count("yinyang")
    print(f"fit_plan (update='auto'): {plan}")
    print(f"KMeans(compute_dtype='bfloat16', update='auto', "
          f"max_iter={AUTO_SWEEPS}, tol=-1): {km.n_iter_} sweeps + final "
          f"view in {seconds:.3f} s = {km.n_iter_ / seconds:.3f} iter/s "
          f"(final view, row norms and group formation included); inertia "
          f"{km.inertia_:.6e}")
    print(f"  diag: {dg}")
    print(f"  recompute fraction over the fit: "
          f"{dg['recompute_rows'] / dg['rows_seen']:.4f}; flavour of each "
          f"{DELTA_REFRESH}-sweep period: {periods}")
    print(f"  launches: {launches}")
    print(f"  peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    _check(km.n_iter_ == AUTO_SWEEPS and _finite(km.cluster_centers_)
           and math.isfinite(km.inertia_),
           "auto fit: wrong sweep count or non-finite result")
    _check(plan["adaptive"], "fit_plan does not report the adaptive loop")
    _check(launches["lloyd_hamerly_cuda"] >= 1,
           "the default fit never launched the Hamerly kernel")
    _check(launches["lloyd_hamerly_cuda"] == DELTA_REFRESH * n_yin
           and launches["lloyd_delta_cuda"]
           == (DELTA_REFRESH - 1) * (3 - n_yin)
           and launches["lloyd_pass_cuda"] == (3 - n_yin) + 1
           and launches["accumulate_cuda"] == 0,
           f"auto fit: launches {launches} disagree with periods {periods}")
    # The same fit again in this process: the difference is what the first
    # fit spent once (library kernels loaded and planned at first use).
    t0 = time.perf_counter()
    again = kt.KMeans(n_clusters=k, compute_dtype="bfloat16", init=c0,
                      max_iter=AUTO_SWEEPS, tol=-1.0).fit(x)
    _sync()
    seconds = time.perf_counter() - t0
    # Its counters may differ a little: K2's and K4's atomic folds sum in
    # another order each run, which moves the centroids at the f32
    # rounding level and with them bound tests on the margin.
    print(f"  the same fit again: {seconds:.3f} s = "
          f"{again.n_iter_ / seconds:.3f} iter/s; recompute_rows "
          f"{again.diag_['recompute_rows']:.0f}, final_flavor "
          f"{again.diag_['final_flavor']:.0f}")
    return launches


def _finite(t):
    import torch

    return bool(torch.isfinite(t).all())


def _soundness(x, c0):
    """SOUND_SWEEPS hand-driven ``hamerly_pass`` sweeps, then as many
    ``yinyang_pass`` sweeps, from the fixed init (refresh at sweep 0 and
    16).  After each, K1 at the same centroids: every label that differs
    from K1's must be a tie within SCORE_RTOL.  Returns each flavour's
    state entering the next sweep, and the row norms."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.delta import DELTA_REFRESH
    from kmeans_tpu_torch.ops.hamerly import hamerly_pass, row_norms
    from kmeans_tpu_torch.ops.update import apply_update
    from kmeans_tpu_torch.ops.yinyang import centroid_groups, yinyang_pass

    n = x.shape[0]
    k, d = c0.shape
    bf16 = torch.bfloat16
    rno = row_norms(x, compute_dtype=bf16)
    group_np, t = centroid_groups(c0.cpu().numpy())
    group_of = torch.from_numpy(group_np).cuda()
    states = {}
    for flavour in ("hamerly", "yinyang"):
        torch.cuda.reset_peak_memory_stats()
        c = c0.clone()
        lab = torch.full((n,), -1, dtype=torch.int32, device="cuda")
        sb = torch.zeros(n, device="cuda")
        lower = torch.zeros((n,) if flavour == "hamerly" else (n, t),
                            device="cuda")
        c_cd, csq = c0.to(bf16), torch.zeros(k, device="cuda")
        recs, diffs = [], []
        for i in range(SOUND_SWEEPS):
            if i % DELTA_REFRESH == 0:
                lab = torch.full_like(lab, -1)
                sums = torch.zeros(k, d, device="cuda")
                counts = torch.zeros(k, device="cuda")
            args = (x, c, lab, sums, counts, sb, lower, c_cd, csq, rno)
            if flavour == "hamerly":
                out = hamerly_pass(*args, compute_dtype="bfloat16")
            else:
                out = yinyang_pass(*args, group_of, compute_dtype="bfloat16")
            lab, sums, counts, sb, lower, c_cd, csq, n_rec = out[:8]
            ref = K.lloyd_pass_cuda(x, c, compute_dtype=bf16,
                                    with_update=False)[0]
            diffs.append(_check_labels_rows(f"{flavour} sweep {i}", x, c,
                                            bf16, lab, ref))
            recs.append(int(n_rec))
            c = apply_update(c, sums, counts)
        print(f"{flavour} ({SOUND_SWEEPS} sweeps{f', t={t}' if flavour == 'yinyang' else ''}): "
              f"rows recomputed per sweep {recs}")
        print(f"  recompute fraction per sweep "
              f"{[round(r / n, 4) for r in recs]}")
        print(f"  rows labelled differently from K1 per sweep {diffs} "
              f"(each a tie within {SCORE_RTOL}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        states[flavour] = (c, lab, sums, counts, sb, lower, c_cd, csq)
    states["group_of"] = group_of
    return states, rno


def _hamerly_timings(x, states, rno, record):
    """K4 at the hamerly state entering sweep SOUND_SWEEPS (the fit's
    steady state), with every row needed, and with about 10% needed: its
    time beside the bound (2·n_rec·d·k), the plain version's, the library
    yardstick's (``torch.mm`` of the gathered rows, then the two least
    scores with ``topk``) and ``score_block``'s, whose labels, sb and slb
    must equal the core's bit for bit.  The steady case is checked against
    the plain version and recorded."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.hamerly import hamerly_bounds

    n, d = x.shape
    bf16 = torch.bfloat16
    c, lab, _, _, sb, slb, c_cd, csq = states["hamerly"]
    k = c.shape[0]
    sb2, slb2, need_steady, _, _ = hamerly_bounds(c, lab, sb, slb, c_cd, csq,
                                                  rno, bf16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = {"steady": need_steady,
             "100%": torch.ones(n, dtype=torch.bool, device="cuda"),
             "10%": torch.rand(n, generator=gen, device="cuda") < 0.1}
    cb = c.to(bf16)
    for what, need in cases.items():
        n_rec = int(need.sum())
        rows = need.nonzero()[:, 0]

        def kernel():
            return K.lloyd_hamerly_cuda(x, c, lab, need, sb2, slb2,
                                        compute_dtype=bf16)

        def plain():
            return K.lloyd_hamerly_plain(x, c, lab, need, sb2, slb2,
                                         compute_dtype=bf16)

        ms = _time_ms(kernel, 5)
        plain_ms = _time_ms(plain, 1)
        library_ms = _time_ms(
            lambda: torch.mm(x[rows], cb.T, out_dtype=torch.float32).topk(
                2, dim=1, largest=False), 3)
        with _ForcedScoreBlock():
            sb_ms = _time_ms(kernel, 3)
            ref = kernel()
        got = kernel()
        _check(all(torch.equal(got[i], ref[i]) for i in (0, 1, 2, 5, 6)),
               f"K4 at need {what}: the core's labels, sb or slb differ from "
               "score_block's")
        del ref
        n_changed = int(((got[0] != lab) & need).sum())
        bytes_moved = (n_rec * d * 2 + n * (4 + 1 + 4 + 4 + 4) + k * d * 2
                       + k * 4 + n * 12 + k * d * 4 + k * 4)
        bound, by = _bound_ms(bytes_moved, 2.0 * n_rec * d * k,
                              4.0 * n_changed * d)
        print(f"K4 at need {what}: {n_rec} of {n} rows "
              f"({n_rec / n:.4f}), {n_changed} changed: {ms:.3f} ms (bound "
              f"{bound:.3f} ms by {by}), plain {plain_ms:.3f} ms, library "
              f"{library_ms:.3f} ms, on score_block {sb_ms:.3f} ms (bit for "
              "bit equal)")
        if what != "steady":
            continue
        want = plain()
        moved = _check_labels_rows("K4 headline", x, c, bf16, got[0],
                                   want[0])
        same = (got[0] == want[0]) & need
        changed = (got[0] != lab) & need
        add = K.accumulate_plain(x, torch.where(changed, got[0], -1), k,
                                 compute_dtype=bf16)
        sub = K.accumulate_plain(x, torch.where(changed, lab, -1), k,
                                 compute_dtype=bf16)
        err = max(_close("K4 headline dsums", got[3], add[0] - sub[0]),
                  _within("K4 headline sb", got[1][same], want[1][same],
                          _row_scale(x, c, bf16, got[0])[same]))
        _check(bool(torch.equal(got[1][~need], sb2[~need])
                    and torch.equal(got[2][~need], slb2[~need])
                    and torch.equal(got[0][~need], lab[~need])),
               "K4 headline: rows not needed were not passed through")
        _check(int(got[5]) == n_rec, "K4 headline n_recomputed")
        print(f"K4 headline: {moved} rows labelled differently from the "
              "plain version, each a tie within the tolerance")
        record("lloyd_hamerly_cuda", ms, plain_ms, library_ms, err,
               bytes_moved, 2.0 * n_rec * d * k, 4.0 * n_changed * d)


def _flavour_sweeps(x, states, rno):
    """One steady sweep of each flavour, from the states entering sweep
    SOUND_SWEEPS: delta (K2, from the hamerly state's labels and sums),
    hamerly (bounds and K4) and yinyang (bounds, K4 and the glb refresh);
    then a yinyang refresh sweep (−1 labels: every row scored) and the
    pruned fits' set-up (row norms, centroid groups)."""
    import torch

    from kmeans_tpu_torch.ops.delta import delta_pass
    from kmeans_tpu_torch.ops.hamerly import hamerly_pass, row_norms
    from kmeans_tpu_torch.ops.yinyang import centroid_groups, yinyang_pass

    c, lab, sums, counts, sb, slb, c_cd, csq = states["hamerly"]
    ms = {
        "delta": _time_ms(lambda: delta_pass(
            x, c, lab, sums, counts, compute_dtype="bfloat16",
            with_mind=False), 3),
        "hamerly": _time_ms(lambda: hamerly_pass(
            x, c, lab, sums, counts, sb, slb, c_cd, csq, rno,
            compute_dtype="bfloat16"), 3),
    }
    c, lab, sums, counts, sb, glb, c_cd, csq = states["yinyang"]
    ms["yinyang"] = _time_ms(lambda: yinyang_pass(
        x, c, lab, sums, counts, sb, glb, c_cd, csq, rno, states["group_of"],
        compute_dtype="bfloat16"), 3)
    print("one steady sweep (CUDA events, median of 3): "
          + ", ".join(f"{name} {t:.3f} ms" for name, t in ms.items()))
    sentinel = torch.full_like(lab, -1)
    refresh_ms = _time_ms(lambda: yinyang_pass(
        x, c, sentinel, torch.zeros_like(sums), torch.zeros_like(counts), sb,
        glb, c_cd, csq, rno, states["group_of"], compute_dtype="bfloat16"), 3)
    norms_ms = _time_ms(lambda: row_norms(x, compute_dtype=torch.bfloat16), 3)
    t0 = time.perf_counter()
    centroid_groups(c.cpu().numpy())
    groups_s = time.perf_counter() - t0
    print(f"yinyang refresh sweep {refresh_ms:.3f} ms; row_norms "
          f"{norms_ms:.3f} ms; centroid_groups (host, numpy) "
          f"{1e3 * groups_s:.3f} ms")


# ---------------------------------------------------------------------------
# Phase 5: whole fits against the plain backend
# ---------------------------------------------------------------------------

def phase_whole_fit():
    import kmeans_tpu_torch as kt

    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.cuda_lloyd import scoring_core

    n, d, k = 400_000, 300, 1000
    x, _, _ = kt.make_blobs(5, n, d, k)
    core = scoring_core(x.to(torch.bfloat16), torch.bfloat16)
    print(f"scoring core of K1 and K2 at the glove shape (d = {d}): {core}")
    _check(core == "score_block", "the glove shape took the Hopper core")
    # The kernels each fit must launch: K1 and K2 on the delta loop, and
    # K4 too on the adaptive loop's yinyang periods.
    expect = {"delta": ("lloyd_pass_cuda", "lloyd_delta_cuda"),
              "auto": ("lloyd_pass_cuda", "lloyd_delta_cuda",
                       "lloyd_hamerly_cuda")}
    for update in ("delta", "auto"):
        fits = {}
        for backend in ("auto", "plain"):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            km = kt.KMeans(n_clusters=k, update=update,
                           compute_dtype="bfloat16", seed=0, backend=backend)
            km.fit(x)
            _sync()
            counts = K.launch_counts()
            fits[backend] = km
            print(f"KMeans glove shape update={update} backend={backend}: "
                  f"{km.n_iter_} sweeps, converged "
                  f"{bool(km.state.converged)}, inertia {km.inertia_:.6e}, "
                  f"{time.perf_counter() - t0:.3f} s; diag {km.diag_}; "
                  f"launches {counts}")
            if backend == "auto":
                missing = [name for name in expect[update]
                           if not counts.get(name)]
                _check(not missing, f"whole fit update={update} "
                       f"backend=auto launched none of {missing}")
            else:
                _check(not any(counts.values()), f"whole fit update="
                       f"{update} backend=plain launched kernels: {counts}")
        a, b = fits["auto"].inertia_, fits["plain"].inertia_
        _check(abs(a - b) <= FIT_INERTIA_RTOL * abs(b),
               f"whole fit update={update}: kernel inertia {a} vs plain {b} "
               f"beyond rtol {FIT_INERTIA_RTOL}")
        _check(_finite(fits["auto"].cluster_centers_),
               f"whole fit update={update}: non-finite centroids")
    _fractional_weights_fit()


def _fractional_weights_fit():
    """``KMeans(compute_dtype="bfloat16").fit`` with fractional weights on
    the card: the kernel plan's weights veto refuses it (the reference's
    exactness policy: bf16 would round the weights in its fold), so
    ``backend="auto"`` takes the plain route on the card, as the
    reference's ``"auto"`` takes XLA, with the ``"segment"`` update, and
    ``fit_plan`` says why; no kernel launches, and the fit agrees with the
    same fit on the CPU.  Both start from the same centres: k-means++
    draws from each device's own generator, so the two fits would start
    apart and could settle in different partitions."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.plan import WEIGHTS_VETO

    n, d, k = 20_000, 64, 16
    x, _, centres = kt.make_blobs(4, n, d, k)
    gen = torch.Generator(device="cuda").manual_seed(4)
    w = torch.rand(n, generator=gen, device="cuda") + 0.25
    # Started near the blob centres, both fits find the same partition:
    # no label is left to a tie within the two devices' summation orders.
    c0 = centres + 0.1 * torch.randn(k, d, generator=gen, device="cuda")
    plan = kt.fit_plan(x, k, config=kt.KMeansConfig(
        k=k, compute_dtype="bfloat16"), weights=w)
    _check(plan["backend"] == "plain" and plan["update"] == "segment"
           and plan["why"] == WEIGHTS_VETO,
           f"fractional weights in bf16 on the card: plan {plan}")
    fits = {}
    for dev in ("cuda", "cpu"):
        K.reset_launch_counts()
        km = kt.KMeans(n_clusters=k, compute_dtype="bfloat16",
                       init=c0.to(dev), max_iter=20, tol=-1.0,
                       device=dev).fit(x.to(dev), weights=w.to(dev))
        _sync()
        fits[dev] = (km, K.launch_counts())
    (card, counts), (cpu, _) = fits["cuda"], fits["cpu"]
    _check(not any(counts.values()),
           f"the plain route on the card launched kernels: {counts}")
    a, b = card.inertia_, cpu.inertia_
    moved = int((card.labels_.cpu() != cpu.labels_).sum())
    _check(abs(a - b) <= FIT_INERTIA_RTOL * abs(b) and _finite(
        card.cluster_centers_), f"fractional-weights fit: card inertia {a} "
           f"vs CPU {b} beyond rtol {FIT_INERTIA_RTOL}")
    print(f"KMeans(compute_dtype='bfloat16') with fractional weights, n={n} "
          f"d={d} k={k}: plan {plan['backend']} / {plan['update']}, no "
          f"kernel launched; inertia {a:.6e} on the card, {b:.6e} on the "
          f"CPU; {moved} labels differ")


# ---------------------------------------------------------------------------
# Phase 6: the codebook shape, where the planner tiles
# ---------------------------------------------------------------------------

def _plans():
    """The planner's decision for every kind at the headline, glove and
    codebook shapes (bf16), on this card's budget."""
    from kmeans_tpu_torch.ops import plan as P

    budget = P.card_budget()
    print(f"planner budget: {budget.l2_bytes} B of L2 (3/4), "
          f"{budget.smem_per_block} B of shared memory a block "
          f"({budget.source})")
    shapes = {"headline": (HEADLINE["d"], HEADLINE["k"]), "glove": (300, 1000),
              "codebook": (CODEBOOK["d"], CODEBOOK["k"])}
    for name, (d, k) in shapes.items():
        for kind in P.KINDS:
            plan = P.kernel_plan(kind, d, k, budget=budget)
            print(f"  plan {name} {kind}: {plan.mode}, k_tile {plan.k_tile}: "
                  f"{plan.why}")
            want = "tiled" if name == "codebook" else "untiled"
            _check(plan.mode == want, f"plan {name} {kind}: {plan.mode}, "
                   f"not {want}")


def _counted_run(fn):
    """``(fn(), launch counts of that run)``: counts set to 0 just before
    and read just after."""
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    K.reset_launch_counts()
    out = fn()
    _sync()
    return out, K.launch_counts()


def _add_counts(total, counts):
    for name, v in counts.items():
        total[name] = total.get(name, 0) + v


def _k5_variants(x, neg2c, csq, k_tile, lab5, raw5, k5_ms, dist_ops):
    """K5 at the codebook shape beside the main path's launch (``k5_ms``,
    raw scores): with the second-min (the tiled Hamerly sweep's call) and
    on ``score_block``, each with labels and raw min equal bit for bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    def k5(**kw):
        return K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                   raw_scores=True, **kw)

    second_ms, got2 = _time_auto(lambda: k5(with_second=True))
    with _ForcedScoreBlock():
        sb_ms, got3 = _time_auto(k5)
    for what, out in (("with_second", got2), ("score_block", got3)):
        _check(bool(torch.equal(out[0], lab5) and torch.equal(out[1], raw5)),
               f"K5 codebook {what}: labels or raw min differ")
    print(f"K5 codebook raw {k5_ms:.3f} ms ({dist_ops / k5_ms / 1e9:.1f} "
          f"TFLOP/s); with the second-min {second_ms:.3f} ms; on score_block "
          f"{sb_ms:.3f} ms; labels and raw min bit for bit equal")


def phase_codebook(headline_launches):
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.hamerly import hamerly_pass, row_norms
    from kmeans_tpu_torch.ops.update import apply_update

    n, d, k = CODEBOOK["n"], CODEBOOK["d"], CODEBOOK["k"]
    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    _plans()
    t0 = time.perf_counter()
    x, _, _ = kt.make_blobs(11, n, d, k, dtype=bf16)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(2), x, k)
    _sync()
    print(f"codebook data: n={n} d={d} k={k} bf16 ({k} generator blobs, "
          f"init {k} random rows), {time.perf_counter() - t0:.2f} s to make")
    plan = kt.fit_plan(x, k, config=kt.KMeansConfig(
        k=k, update="delta", compute_dtype="bfloat16"))
    print(f"fit_plan (update='delta'): {plan}")
    _check(plan["mode"] == "tiled" and plan["k_tile"] % 128 == 0,
           "the codebook delta fit is not planned tiled")
    k_tile = plan["k_tile"]
    launches = {}

    # The main path, in three runs.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    km, counts = _counted_run(lambda: kt.KMeans(
        n_clusters=k, update="delta", compute_dtype="bfloat16", init=c0,
        max_iter=CODEBOOK_SWEEPS, tol=-1.0).fit(x))
    fit_s = time.perf_counter() - t0
    _add_counts(launches, counts)
    c = km.cluster_centers_
    print(f"KMeans(update='delta', max_iter={CODEBOOK_SWEEPS}, tol=-1): "
          f"{km.n_iter_} sweeps + final view in {fit_s:.3f} s = "
          f"{km.n_iter_ / fit_s:.4f} iter/s (final view included); inertia "
          f"{km.inertia_:.6e}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    print(f"  launches: {counts}")
    _check(counts["tiled_argmin_cuda"] == CODEBOOK_SWEEPS + 1
           and counts["tiled_fold_cuda"] == CODEBOOK_SWEEPS + 1
           and sum(counts.values()) == 2 * (CODEBOOK_SWEEPS + 1),
           "the codebook fit launched other kernels than K5 and K6")
    _check(km.n_iter_ == CODEBOOK_SWEEPS and _finite(c)
           and math.isfinite(km.inertia_),
           "codebook fit: wrong sweep count or non-finite result")
    t0 = time.perf_counter()
    plain = K.lloyd_pass_plain(x, c, compute_dtype=bf16, with_update=False)
    _sync()
    plain_s = time.perf_counter() - t0
    moved = _check_labels_rows("codebook fit", x, c, bf16, km.labels_,
                               plain[0])
    print(f"  labels against the plain route at the final centroids: {moved} "
          f"rows differ, each a tie within {SCORE_RTOL} (plain sweep "
          f"{plain_s:.3f} s)")

    zeros_s = torch.zeros(k, d, device="cuda")
    zeros_c = torch.zeros(k, device="cuda")
    refresh, counts = _counted_run(lambda: kt.delta_pass(
        x, c, km.labels_, zeros_s, zeros_c, compute_dtype="bfloat16",
        force_full=True))
    _add_counts(launches, counts)
    print(f"delta_pass(force_full=True): {int(refresh[5])} rows changed; "
          f"launches {counts}")
    _check(counts["tiled_argmin_cuda"] == 1 and counts["tiled_fold_cuda"] == 2
           and sum(counts.values()) == 3,
           "delta_pass(force_full=True) did not run K5 and K6 only")
    _check(int(refresh[3].sum()) == n and _finite(refresh[2]),
           "delta_pass(force_full=True): counts do not sum to n")

    rno = row_norms(x, compute_dtype=bf16)
    hc = c0.clone()
    lab = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    sb = torch.zeros(n, device="cuda")
    slb = torch.zeros(n, device="cuda")
    c_cd, csq = c0.to(bf16), torch.zeros(k, device="cuda")
    sums, hcounts = zeros_s, zeros_c
    recs, diffs = [], []
    for i in range(CODEBOOK_HAMERLY_SWEEPS):
        out, counts = _counted_run(lambda: hamerly_pass(
            x, hc, lab, sums, hcounts, sb, slb, c_cd, csq, rno,
            compute_dtype="bfloat16"))
        _add_counts(launches, counts)
        _check(counts["tiled_argmin_cuda"] == 1
               and counts["tiled_fold_cuda"] == 1
               and sum(counts.values()) == 2,
               f"tiled hamerly sweep {i}: launches {counts}")
        lab, sums, hcounts, sb, slb, c_cd, csq, n_rec = out
        full = K.tiled_argmin_cuda(x, *K._score_operands(hc, bf16),
                                   k_tile=k_tile, raw_scores=True)[0]
        diffs.append(_check_labels_rows(f"tiled hamerly sweep {i}", x, hc,
                                        bf16, lab, full))
        recs.append(int(n_rec))
        hc = apply_update(hc, sums, hcounts)
    print(f"hamerly on the tiled route ({CODEBOOK_HAMERLY_SWEEPS} sweeps): "
          f"rows needed per sweep {recs}; rows labelled differently from K5's "
          f"full scoring {diffs} (each a tie within {SCORE_RTOL})")
    print(f"codebook main path launches: {launches}")
    del rno, sb, slb, lab, sums

    # Timings at the state after the refresh: K5 and K6 against their
    # plain versions and library calls, then the same sweeps untiled.
    c1 = apply_update(c, refresh[2], refresh[3])
    prev = refresh[0]
    neg2c, csq = K._score_operands(c1, bf16)
    total = {name: headline_launches.get(name, 0) + launches.get(name, 0)
             for name in launches}
    rows = []
    xb, x_row = n * d * 2, n * 4
    dist_ops = 2.0 * n * d * k
    k5_ms, (lab5, raw5) = _time_auto(lambda: K.tiled_argmin_cuda(
        x, neg2c, csq, k_tile=k_tile, raw_scores=True))
    plain_ms, plain5 = _time_auto(lambda: K.tiled_argmin_plain(
        x, neg2c, csq, k_tile=k_tile, raw_scores=True))
    moved = _check_labels_rows("K5 codebook", x, c1, bf16, lab5, plain5[0])
    same = lab5 == plain5[0]
    err = _within("K5 codebook raw scores", raw5[same], plain5[1][same],
                  _row_scale(x, c1, bf16, lab5)[same])
    del plain5

    def library_argmin():
        out = torch.empty(n, dtype=torch.float32, device="cuda")
        idx = torch.empty(n, dtype=torch.int64, device="cuda")
        for s in range(0, n, 16384):
            part = torch.mm(x[s:s + 16384], neg2c.T, out_dtype=torch.float32)
            torch.min(part.add_(csq), dim=1, out=(out[s:s + 16384],
                                                  idx[s:s + 16384]))
        return out, idx

    library_ms, _ = _time_auto(library_argmin)
    print(f"K5 codebook (k_tile={k_tile}, {-(-k // k_tile)} slices): {moved} "
          "rows labelled differently from the plain version, each a tie "
          "within the tolerance")
    rows.append(_kernel_row(
        "tiled_argmin_cuda", total["tiled_argmin_cuda"], k5_ms, plain_ms,
        library_ms, err, xb + k * d * 2 + k * 4 + 2 * x_row, dist_ops, 0.0))
    _k5_variants(x, neg2c, csq, k_tile, lab5, raw5, k5_ms, dist_ops)

    # K6: the full single fold at K5's labels, then the dual fold at this
    # sweep's churn.
    got, again = (K.tiled_fold_cuda(x, None, lab5, None, k, compute_dtype=bf16)
                  for _ in range(2))
    _check(bool(torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                              again[1])),
           "K6 codebook: two launches differ")
    del again
    k6_ms, _ = _time_auto(lambda: K.tiled_fold_cuda(
        x, None, lab5, None, k, compute_dtype=bf16))
    k6_plain_ms, want = _time_auto(lambda: K.tiled_fold_plain(
        x, None, lab5, None, k, compute_dtype=bf16, k_tile=k_tile))
    err = _close("K6 codebook sums", got[0], want[0])
    _check(bool(torch.equal(got[1], want[1])), "K6 codebook counts")
    del got, want
    xf = x.float()
    lab_long = lab5.long()
    k6_lib_ms, _ = _time_auto(lambda: torch.zeros(k, d, device="cuda")
                              .index_add_(0, lab_long, xf))
    rows.append(_kernel_row(
        "tiled_fold_cuda", total["tiled_fold_cuda"], k6_ms, k6_plain_ms,
        k6_lib_ms, err, xb + 2 * x_row + k * d * 4 + k * 4, 0.0,
        2.0 * n * d))
    changed = lab5 != prev
    n_changed = int(changed.sum())
    wch = changed.float()
    dual_ms, got = _time_auto(lambda: K.tiled_fold_cuda(
        x, wch, lab5, prev, k, compute_dtype=bf16))
    dual_plain_ms, want = _time_auto(lambda: K.tiled_fold_plain(
        x, wch, lab5, prev, k, compute_dtype=bf16, k_tile=k_tile))
    _close("K6 codebook dual sums", got[0], want[0])
    _check(bool(torch.equal(got[1], want[1])), "K6 codebook dual counts")
    rows_ch = changed.nonzero()[:, 0]
    dual_lib_ms, _ = _time_auto(lambda: torch.zeros(k, d, device="cuda")
                                .index_add_(0, lab_long[rows_ch], xf[rows_ch])
                                .index_add_(0, prev[rows_ch].long(),
                                            xf[rows_ch], alpha=-1.0))
    bound, by = _bound_ms(n_changed * d * 2 + 3 * x_row + k * d * 4 + k * 4,
                          0.0, 4.0 * n_changed * d)
    print(f"K6 dual at this sweep's churn ({n_changed} of {n} rows changed): "
          f"{dual_ms:.3f} ms (bound {bound:.3f} ms by {by}), plain "
          f"{dual_plain_ms:.3f} ms, library (two index_add_ of the changed "
          f"f32 rows) {dual_lib_ms:.3f} ms")
    del got, want, xf, lab_long

    # The same sweeps untiled: K1 and K2 at the codebook shape.
    k1_ms, k1 = _time_auto(lambda: K.lloyd_pass_cuda(x, c1,
                                                     compute_dtype=bf16))
    _check(bool(torch.equal(k1[0], lab5)), "K1 codebook labels differ from "
           "K5's")
    del k1
    k2_ms, k2 = _time_auto(lambda: K.lloyd_delta_cuda(
        x, c1, prev, compute_dtype=bf16, with_mind=False))
    _check(bool(torch.equal(k2[0], lab5) and torch.equal(k2[1], raw5)),
           "K2 codebook labels or raw scores differ from K5's")
    del k2
    k5n_ms, _ = _time_auto(lambda: K.tiled_argmin_cuda(
        x, neg2c, csq, k_tile=k_tile))
    bound = _bound_ms(xb, dist_ops)[0]
    print(f"codebook classic sweep (bound {bound:.3f} ms): untiled K1 "
          f"{k1_ms:.3f} ms; tiled K5 {k5n_ms:.3f} + K6 {k6_ms:.3f} = "
          f"{k5n_ms + k6_ms:.3f} ms")
    print(f"codebook delta sweep (bound {bound:.3f} ms): untiled K2 "
          f"{k2_ms:.3f} ms; tiled K5 raw {k5_ms:.3f} + K6 dual "
          f"{dual_ms:.3f} = {k5_ms + dual_ms:.3f} ms")
    print(f"codebook phase: {time.perf_counter() - t_phase:.1f} s")
    return rows, launches


# ---------------------------------------------------------------------------
# Phase 7: K6's launches one by one
# ---------------------------------------------------------------------------

#: The dual fold's share of changed rows in the split: a steady sweep's
#: churn at the codebook shape is a few percent of the rows.
SPLIT_CHURN = 0.02
#: K6 calls in each profile of the split.
SPLIT_REPS = 5


def _kernel_name(name):
    """A profiled kernel's name without ``void``, the anonymous namespace
    and its argument list (a memset or a copy keeps its name)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i in range(len(name) - 1, 0, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name[i] == "(" and name[i - 1] != " " else name
    return name


def _device_split(fn, reps):
    """``fn()`` run ``reps`` times under ``torch.profiler`` (CUPTI) after
    one warm-up run: ``[(kernel name, launches a call, ms a call)]`` in the
    order the kernels first ran, memsets and copies included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync()
    split = {}
    for evt in sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start):
        name = _kernel_name(evt.name)
        launches, us = split.get(name, (0, 0.0))
        split[name] = (launches + 1,
                       us + evt.time_range.end - evt.time_range.start)
    _check(split, "the profiler recorded no device time")
    return [(name, launches / reps, us / 1e3 / reps)
            for name, (launches, us) in split.items()]


def phase_fold_split():
    """K6's device time split by kernel on seeded inputs at the full width
    (x: n = 1,280,000, d = 2048, bf16, standard normal): (a) the single
    fold at k = 1000 (K1's fold and K3's workload), (b) the single fold at
    k = 65536, (c) the dual fold at k = 65536 with SPLIT_CHURN of the rows
    changed (w = 1 on them, 0 elsewhere).  Each kernel's time is its
    CUPTI duration in a ``torch.profiler`` trace of SPLIT_REPS ordinary
    ``tiled_fold_cuda`` calls; the whole call and the scratch set-up
    (``_fold_scratch``) alone are timed with CUDA events.  Written against
    ``tiled_fold_cuda`` and ``_fold_scratch`` only, so that it also splits
    an older tree's K6."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, d = CODEBOOK["n"], CODEBOOK["d"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(n, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    cases = []
    for case, k, dual in (("a", HEADLINE["k"], False),
                          ("b", CODEBOOK["k"], False),
                          ("c", CODEBOOK["k"], True)):
        lab = torch.randint(0, k, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        w, lab2 = None, None
        if dual:
            changed = torch.rand(n, generator=gen, device="cuda") < SPLIT_CHURN
            step = torch.randint(1, k, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            lab2 = torch.where(changed, (lab + step) % k, lab)
            w = changed.float()
        cases.append((case, k, dual, lab, lab2, w))
    for case, k, dual, lab, lab2, w in cases:
        def call():
            return K.tiled_fold_cuda(x, w, lab, lab2, k,
                                     compute_dtype=torch.bfloat16)

        whole = _time_ms(call, 5)
        scratch_ms = _time_ms(lambda: K._fold_scratch(x, k, dual), 5)
        split = _device_split(call, SPLIT_REPS)
        passes = getattr(K, "fold_sort_passes", None)
        hists = sum(launches for name, launches, _ in split
                    if name.startswith("sort_hist_kernel"))
        _check(passes is None or hists == passes(k),
               f"K6 at k={k} made {hists} radix passes a call, not "
               f"fold_sort_passes' {passes and passes(k)}")
        what = (f"K6 split ({case}) {'dual' if dual else 'single'} fold, "
                f"n={n} d={d} k={k}"
                + (f", {int(w.sum())} rows changed" if dual else ""))
        print(f"{what}: whole K6 {whole:.3f} ms (CUDA events), scratch "
              f"set-up {scratch_ms:.3f} ms; profile of {SPLIT_REPS} calls: "
              f"{sum(c for _, c, _ in split):g} launches and "
              f"{sum(t for _, _, t in split):.3f} ms of device time a call")
        for name, launches, ms in split:
            print(f"  {name}: {launches:g} a call, {ms:.3f} ms a call")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_device()
    if sys.argv[1:] == ["--fold-split"]:
        phase_fold_split()
        return 0
    phase_build()
    phase_kernels()
    kernels, headline_launches = phase_headline()
    phase_whole_fit()
    tiled, codebook_launches = phase_codebook(headline_launches)
    for row in kernels:
        row["launches"] += codebook_launches.get(row["name"], 0)
    kernels += tiled
    phase_fold_split()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
