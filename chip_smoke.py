#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (kmeans_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
``kmeans_tpu_torch/csrc/lloyd.cu`` and runs nine phases, exiting non-zero
if any fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` for sm_90a, with its seconds, register report, and the
   registers and spills of each variant of the Hopper core (bf16 and its
   f32 route);
3. each kernel against its plain PyTorch version on the card: ragged n,
   d in {2, 100, 2048}, k in {3, 1000}, float32 and bfloat16, zero-weight
   rows, a −1 sentinel ``prev``, out-of-range labels, and exact ties; each
   case's scoring core asserted against the rule; the Hopper core (bf16,
   d % 8 == 0; f32, d % 4 == 0) also at d in {8, 200} (bf16), {4, 300}
   (f32) and k in {3, 257, 1000}: K1's labels and min_d2, K2's labels and
   raw scores, K4's labels, sb, slb, n_recomputed and dense_tiles (need
   fractions 0, about 10% and 100%) and K5's labels, raw and normed min
   and second-min (k_tile in {128, 384, 1024}) equal to ``score_block``'s
   bit for bit in bf16 and to SCORE_RTOL on the f32 route (six bf16
   passes against IEEE f32 FMA), two launches of each equal bit for bit,
   duplicate centroids at the core's slice edges (255 | 256; 127 | 128 on
   the f32 route's 128-column sub-slices) and, for K4 and K5, at a
   sub-slice edge inside a range and at range edges, in both dtypes; the
   f32 route's worst score error against an f64 product over the f32
   cases, within SCORE_RTOL and (d + 2)·2⁻²⁴ of ||x||² + ||c||²;
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
   flavour, and the time of k-means++ there; then imagenet-delta-f32, the
   same shape in f32 on the core's f32 route: ``fit_lloyd(update=
   "delta")`` (F32_SWEEPS sweeps) and F32_HAMERLY_SWEEPS hand-driven
   ``hamerly_pass`` sweeps, each run's counts set to 0 before it and read
   after, labels held against K1 and the plain route, then K1, K2 and K4
   held against their plain versions and timed beside both bounds (six
   bf16 passes, f32 FMA), ``torch.mm`` + ``argmin`` with TF32 off and
   ``score_block``, and the route's score error against f64 on sampled
   rows; then K2 in f32 on the route and on ``score_block`` at the glove
   shape (n = 400,000, k = 1000) over d in F32_WIDTHS;
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
8. serving, run after phase 6: the assignment engine
   (``kmeans_tpu_torch.serve.assign.AssignEngine``) on the card serves
   phase 4's delta-fit centroids (imagenet-serve, k = 1000: the default
   closure-pruned route, then the dense route on K5) and phase 6's
   (codebook-serve, k = 65536: the default int8 quant route, then the
   dense route), each run SERVE_SECONDS of SERVE_CLIENTS closed-loop
   clients (64 and 512 points a request, query rows the centroids plus
   unit noise) with a permuted generation published half-way and the
   launch counts set to 0 before and read after; every response is held
   against K5's labels of its own generation (a differing label must be a
   tie within SCORE_RTOL), the routes against each other, no request may
   fail or wait past the default ``assign_timeout_s``, the batcher must
   coalesce, and K5 must launch once a dense batch and once for each
   pruned or quant batch whose certificate failures it rescores; then K5
   in f32 (the core's f32 route) at the serving batch shapes against its
   plain version, both bounds and ``torch.mm`` + ``argmin`` with TF32 off,
   beside its other column range and ``score_block``, with each one's
   score error against f64;
9. the accelerated and minibatch fits, run after phase 8, each run with
   the launch counts set to 0 before it and read after: imagenet-accel
   (``bench.py --accel``'s hard instances at the headline width, bf16,
   seeds ACCEL_SEEDS: plain ``fit_lloyd``, beta, Anderson and
   ``fit_minibatch(schedule="nested")`` from one k-means++ start each,
   each after a warm-up; K1 in every arm, K2 in the Anderson and nested
   arms, the medians of their inertia within ``bench.py``'s one-sided
   gates of plain's; on seed 0, K2 with and without row norms and
   ``anderson_step`` behind queued work, which fails on a host sync, and
   beta and Anderson for ACCEL_CHECK_ITERS sweeps on ``backend="cuda"``
   and ``"plain"`` with equal outcome sequences),
   cifar10-minibatch (f32; the fit, the early-stopping fit and
   ``partial_fit`` calls, the fit's seconds split into seeding, steps and
   the final sweep, cuda and plain centroids equal bit for bit) and
   imagenet-minibatch (bf16; the same split, ``batch_stats`` beside K1 on
   one gathered batch, a step checked for host syncs);
10. a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.  A kernel has a row for each compute dtype its main-path runs
   score in: bf16 (phases 4, 6 and 9) and the f32 route (K1, K2 and K4
   from imagenet-delta-f32 and K1 from phase 9's cifar10 runs, K5 from
   each served model's runs), each row's launches counted in its own runs
   and its times taken at its own shape.

``python3 chip_smoke.py --fold-split`` runs phases 1 and 7 only (the
kernels build at their first call), so it also splits an older tree's K6.
``python3 chip_smoke.py --f32-bench`` runs phase 1 and
:func:`phase_f32_bench` only (the f32-compute kernels at the serving and
headline shapes beside the library), so a copy of this script run in an
older checkout times that tree's f32 route in the same call.
``python3 chip_smoke.py --accel`` runs phases 1 and 9 only (the kernels
build at their first call).

The bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of memory, 989
TFLOP/s bf16 on the tensor cores and 67 TFLOP/s f32 outside them; an f32
row states both the f32 route's bound (six bf16 passes at 989 TFLOP/s)
and the f32 FMA bound.
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
CIFAR10 = dict(n=50_000, d=3072, k=100)
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


#: The Hopper core's variants as ptxas names them (the mangled
#: ``core_score_kernel<GATHER, SECOND>`` and, on the f32 route,
#: ``core32_score_kernel<GATHER, SECOND>``), and what runs each.
CORE_VARIANTS = {
    "core_score_kernelILb0ELb0E": "dense (K1, K2, K5)",
    "core_score_kernelILb0ELb1E": "dense with second-min (K5 for Hamerly)",
    "core_score_kernelILb1ELb1E": "gathered with second-min (K4)",
    "core32_score_kernelILb0ELb0E": "f32 dense (K1, K2, K5)",
    "core32_score_kernelILb0ELb1E":
        "f32 dense with second-min (K5 for Hamerly)",
    "core32_score_kernelILb1ELb1E": "f32 gathered with second-min (K4)",
}


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
                        if name and key in name), None)
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
    worst = float(err.max()) if err.numel() else 0.0
    _check(bool((err <= tol).all()),
           f"{name}: {int((err > tol).sum())} rows differ by more than "
           f"{SCORE_RTOL} of their row scale (max abs error {worst})")
    return worst


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
    """Within it, K1, K2, K4 and K5 score every input with ``score_block``
    (the parent's f32 route): the wrappers read
    ``cuda_lloyd.scoring_core`` at each call."""

    def __enter__(self):
        from kmeans_tpu_torch.ops import cuda_lloyd as K

        self._rule = K.scoring_core
        K.scoring_core = lambda *args: "score_block"

    def __exit__(self, *exc):
        from kmeans_tpu_torch.ops import cuda_lloyd as K

        K.scoring_core = self._rule


#: Worst relative score error against the f64 product, (error / (||x||² +
#: ||c||²), d, case), of the f32 route over phase 3's f32 cases.
F32_ERRORS = []


def _f32_score_error(x, c, lab, raw):
    """max |raw − f64 score at lab| / (||x||² + ||c[lab]||²) over rows."""
    s, scale = _scores64(x, c, x.dtype)
    at = lab.long()[:, None]
    return float(((raw.double() - s.gather(1, at)[:, 0]).abs()
                  / scale.gather(1, at)[:, 0]).max())


def _record_f32_errors(name, x, c, prev):
    """K2's raw scores on the f32 route against the f64 product, into
    F32_ERRORS."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    lab, raw = K.lloyd_delta_cuda(x, c, prev, compute_dtype=torch.float32,
                                  with_mind=False)[:2]
    _sync()
    F32_ERRORS.append((_f32_score_error(x, c, lab, raw), x.shape[1], name))


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
    labels and raw scores (``k1``, ``k2``) against ``score_block``'s on the
    same input -- in bf16 bit for bit; on the f32 route (six bf16 passes
    against IEEE f32 FMA) labels equal except near-ties within SCORE_RTOL
    and scores within SCORE_RTOL of the row scale."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    with _ForcedScoreBlock():
        sb1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
        sb2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd,
                                 with_mind=False)
    _sync()
    if cd == torch.bfloat16:
        _check(torch.equal(k1[0], sb1[0]) and torch.equal(k1[1], sb1[1]),
               f"K1 {name}: the Hopper core's labels or min_d2 differ from "
               "score_block's")
        _check(torch.equal(k2[0], sb2[0]) and torch.equal(k2[1], sb2[1]),
               f"K2 {name}: the Hopper core's labels or raw scores differ "
               "from score_block's")
        return
    chosen, tol, _ = _check_labels(f"K2 {name} vs score_block", x, c, cd,
                                   k2[0], sb2[0])
    same = k2[0] == sb2[0]
    _within(f"K2 {name} raw scores vs score_block", k2[1][same],
            sb2[1][same], tol[same])
    _check(torch.equal(k1[0], k2[0]), f"K1 {name}: labels differ from K2's "
           "on the core")


def _check_core_k4_k5(name, x, c, cd, w, prev, gen):
    """On an input the Hopper core takes: K4 at need fractions 0, about 10%
    and 100% (−1 sentinels needed) and K5 at k_tile 128, 384 and 1024,
    with the second-min, against ``score_block``'s on the same input --
    K4's labels, sb, slb, n_recomputed and dense_tiles, K5's labels, raw
    min, second-min and normed min: bit for bit in bf16; on the f32 route
    n_recomputed, dense_tiles and the labels of rows that are no near-tie
    equal, the scores within SCORE_RTOL of the row scale -- and two
    launches of each equal bit for bit."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n = x.shape[0]
    exact = cd == torch.bfloat16
    s64, scale = _scores64(x, c, cd)

    def agree(what, got, ref, kinds, rows=None):
        """``got`` against ``ref`` entry by entry, over ``rows`` (a mask;
        all rows when None) where the f32 route compares to a tolerance:
        labels near the f64 minimum, scores of rows whose labels agree
        within SCORE_RTOL of the row's largest scale."""
        for g, e, kind in zip(got, ref, kinds):
            if kind is None:
                continue
            if exact or kind in ("n_recomputed", "dense_tiles"):
                _check(torch.equal(g, e), f"{what}: the core's {kind} "
                       "differ from score_block's")
                continue
            r = torch.ones(n, dtype=torch.bool, device="cuda") \
                if rows is None else rows
            _check(torch.equal(g[~r], e[~r]),
                   f"{what}: rows not scored differ in {kind}")
            if kind == "labels":
                _near_min(what, s64[r], scale[r], g[r])
                continue
            keep = got[0][r] == ref[0][r]
            tol = SCORE_RTOL * scale[r].max(dim=1).values
            _within(f"{what} {kind}", g[r][keep], e[r][keep], tol[keep])

    sb_in = torch.randn(n, generator=gen, device="cuda")
    k4_out = ("labels", "sb", "slb", None, None, "n_recomputed", "dense_tiles")
    for frac in (0.0, 0.1, 1.0):
        p = prev.clamp_min(0) if frac == 0.0 else prev
        need = ((torch.rand(n, generator=gen, device="cuda") < frac)
                | (p < 0))
        args = (x, c, p, need, sb_in, sb_in + 1)
        with _ForcedScoreBlock():
            ref = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        first = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        again = K.lloyd_hamerly_cuda(*args, weights=w, compute_dtype=cd)
        _sync()
        what = f"K4 need={frac:.0%} {name}"
        _check(all(torch.equal(a, b) for a, b, kind in
                   zip(first, again, k4_out) if kind),
               f"{what}: two launches differ")
        agree(what, first, ref, k4_out, need)
    neg2c, csq = K._score_operands(c, cd)

    def k5(k_tile):
        return (*K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                     raw_scores=True, with_second=True),
                K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile)[1])

    for k_tile in (128, 384, 1024):
        with _ForcedScoreBlock():
            ref = k5(k_tile)
        first, again = k5(k_tile), k5(k_tile)
        _sync()
        what = f"K5 k_tile={k_tile} {name}"
        _check(all(torch.equal(a, b) for a, b in zip(first, again)),
               f"{what}: two launches differ")
        agree(what, first, ref, ("labels", "raw min", "second-min",
                                 "normed min"))


def _core_range_edge_ties(gen, cd):
    """Duplicate centroids on either side of the core's sub-slice edges
    inside a range (255 | 256 at k_tile 384 and 1024, 511 | 512 at 1024;
    on the f32 route's 128-column sub-slices also 127 | 128 inside 384 and
    1024) and of range edges (127 | 128 at k_tile 128, 383 | 384 at 128
    and 384, 1023 | 1024 at 128 and 1024), at k = 1100, and rows that sit
    on them: K4 with every row needed and K5 at each k_tile give the lower
    index with second-min == min, and the core agrees with score_block
    (bit for bit in bf16)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    x, c, w, prev = _case_inputs(gen, 2053, 2048, 1100, cd, False)
    pairs = ((127, 128), (255, 256), (383, 384), (511, 512), (1023, 1024))
    for i, (lo, hi) in enumerate(pairs):
        c[hi] = c[lo]
        x[16 * i:16 * (i + 1)] = c[lo].to(cd)
    name = (f"n=2053 d=2048 k=1100 x={str(cd)[6:]} ties at sub-slice and "
            "range edges")
    _check(K.scoring_core(x, cd, c.to(cd)) == "wgmma",
           f"{name}: not on the Hopper core")
    _check_core_k4_k5(name, x, c, cd, w, prev, gen)
    n = x.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    zeros = torch.zeros(n, device="cuda")
    k4 = K.lloyd_hamerly_cuda(x, c, prev, ones, zeros, zeros,
                              compute_dtype=cd)
    outs = [("K4", k4[:3])]
    neg2c, csq = K._score_operands(c, cd)
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


def _slice_edge_core_ties(gen, cd):
    """Duplicate centroids on either side of the core's slice edge (255 |
    256; on the f32 route also its 128-column sub-slice edge 127 | 128),
    and rows that sit on them: K1 and K2 must give the lower index.  k =
    257 leaves the last slice one column; k = 1000 is the headline's
    width."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    pairs = ((255, 256),) if cd == torch.bfloat16 else ((127, 128),
                                                        (255, 256))
    for k in (257, 1000):
        x, c, w, prev = _case_inputs(gen, 2053, 2048, k, cd, False)
        for i, (lo, hi) in enumerate(pairs):
            c[hi] = c[lo]
            x[64 * i:64 * (i + 1)] = c[lo].to(cd)
        name = (f"n=2053 d=2048 k={k} x={str(cd)[6:]} ties at the core's "
                "slice edges")
        _check(K.scoring_core(x, cd, c.to(cd)) == "wgmma",
               f"{name}: not on the Hopper core")
        k1 = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
        k2 = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd,
                                with_mind=False)
        _sync()
        for i, (lo, _) in enumerate(pairs):
            rows = slice(64 * i, 64 * (i + 1))
            _check(bool((k1[0][rows] == lo).all()
                        and (k2[0][rows] == lo).all()),
                   f"{name}: the tie did not go to column {lo}")
        _check_labels(f"K1 {name}", x, c, cd, k1[0],
                      K.lloyd_pass_plain(x, c, compute_dtype=cd)[0])
        _check_k1_repeats(name, x, c, cd, w, k1)
        _check_cores_agree(name, x, c, cd, w, prev, k1, k2)
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
    from kmeans_tpu_torch.ops.plan import core_takes

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(n, d, k, xd, cd, False)
             for d in (2, 100, 2048) for k in (3, 1000)
             for (xd, cd) in ((f32, f32), (bf16, bf16), (f32, bf16))
             for n in (2053,)]
    cases += [(1531, 64, 10, f32, f32, True), (1531, 64, 10, bf16, bf16, True),
              (2053, 2048, 1000, bf16, bf16, True),
              (2053, 2048, 1000, f32, f32, True)]
    # The Hopper core's ragged shapes: n % 128 != 0; d a multiple of 8 (4
    # in f32, whose −2C pieces pad to 8) but not of 64; k = 257 (a last
    # slice of one column), k = 3 (one ragged slice).
    cases += [(2053, d, k, bf16, bf16, False)
              for d in (8, 200) for k in (3, 257, 1000)]
    cases += [(2053, d, k, f32, f32, False)
              for d in (4, 300) for k in (3, 257, 1000)]
    cases += [(2053, 2048, 257, bf16, bf16, False),
              (2053, 2048, 257, f32, f32, False)]
    cores = {}
    for n, d, k, xd, cd, ties in cases:
        x, c, w, prev = _case_inputs(gen, n, d, k, xd, ties)
        core = K.scoring_core(x, cd, c.to(cd))
        cores[core] = cores.get(core, 0) + 1
        _check(core == ("wgmma" if core_takes("classic", d, xd.itemsize,
                                              cd.itemsize)
                        else "score_block"),
               f"n={n} d={d} k={k} x={xd} cd={cd}: scoring core {core} "
               "against the rule")
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
            if cd == f32:
                _record_f32_errors(name, x, c, prev)
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
    for cd in (bf16, f32):
        _slice_edge_core_ties(gen, cd)
        _core_range_edge_ties(gen, cd)
    _fold_core_cases(gen)
    print(f"scoring cores over the cases: {cores}; the Hopper core's labels, "
          "min_d2, raw scores, sb, slb and second-min (K1, K2, K4, K5 at "
          "k_tile 128, 384, 1024) equal score_block's bit for bit in bf16 "
          "and to SCORE_RTOL on the f32 route, K4's and K5's equal K1's and "
          "K2's bit for bit, and two launches of K1, K4 and K5 equal each "
          "other bit for bit")
    _f32_error_summary()
    print(f"kernels vs plain: {len(cases) + 8 + len(FOLD_CORE_CASES)} "
          "cases agree (score rtol "
          f"{SCORE_RTOL}, sums rtol {SUMS_RTOL}, counts exact; K5 equal to "
          "K1, K2 and K4 bit for bit; K6 equal to itself bit for bit)")


def _gamma(d):
    """The f32 accumulation bound of a score at width d, relative to
    ||x||² + ||c||²: γ = (d + 2)·2⁻²⁴ -- the d products and the epilogue's
    two adds (the corrections into x1c1, then csq) -- the bound
    HAMERLY_MARGIN_REL covers (γ_d ≈ d·2⁻²⁴ in ``ops/hamerly.py``)."""
    return (d + 2) * 2.0 ** -24


def _f32_error_summary():
    """The worst f32-route error over phase 3's f32 cases; it must stay
    within SCORE_RTOL and :func:`_gamma` of the row scale."""
    errs = F32_ERRORS
    worst = max(errs)
    print(f"f32 route: worst |score − f64| / (||x||² + ||c||²) over "
          f"{len(errs)} cases {worst[0]:.3e} (d={worst[1]}: {worst[2]}); "
          "per d: " + ", ".join(
              f"d={d} {max(e for e, dd, _ in errs if dd == d):.3e}"
              for d in sorted({dd for _, dd, _ in errs})))
    for rel, d, name in errs:
        _check(rel <= min(SCORE_RTOL, _gamma(d)),
               f"f32 route {name}: score error {rel:.3e} of the row scale "
               f"beyond min(SCORE_RTOL, γ = {_gamma(d):.3e})")


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
                tensor_ops, f32_ops, what=""):
    """One entry of the ``{"kernels": [...]}`` line, printed as it is
    made; ``library_ms`` may be None.  ``what`` names the row's compute
    (and shape) where the wrapper ``name`` has more than one row."""
    bound, by = _bound_ms(bytes_moved, tensor_ops, f32_ops)
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    label = f"{name} ({what})" if what else name
    print(f"{label}: {launches} launches, {ms:.3f} ms (bound {bound:.3f} ms "
          f"by {by}), plain {plain_ms:.3f} ms, library {lib}, max abs err "
          f"vs plain {err:.3e}")
    return {"name": label, "route": "cuda", "source": SOURCE,
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
    return kernels, launches, state.centroids.float().cpu().numpy()


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
# Phase 4, f32: imagenet-delta-f32 on the core's f32 route
# ---------------------------------------------------------------------------

#: Sweeps of the f32 headline delta fit (the refresh at sweep 16 and the
#: final view run), and the hand-driven Hamerly sweeps after it (a refresh,
#: then steady sweeps).
F32_SWEEPS = 20
F32_HAMERLY_SWEEPS = 4
#: Rows of the f32 error sample against the f64 product.
F32_ERROR_ROWS = 4096
#: Widths at which K2 in f32 is timed on the core's f32 route and on
#: ``score_block``, at the glove shape's n and k: the narrowest the rule
#: admits, the 32-feature stage's multiples, glove's d = 300 (d % 8 == 4,
#: −2C's pieces padded to 304 columns) between its neighbours, and wider.
F32_WIDTHS = (4, 8, 16, 32, 64, 128, 296, 300, 304, 512)


def _f32_bounds(n, d, k):
    """(the f32 route's bound: six bf16 passes at 989 TFLOP/s, the FFMA
    bound any f32 kernel is held to: one f32 product at 67 TFLOP/s), ms."""
    ops = 2.0 * n * d * k
    return 1e3 * 6 * ops / BF16_TENSOR_OPS_PER_S, 1e3 * ops / F32_OPS_PER_S


def _f32_library(x, neg2c, csq, chunk=None):
    """``torch.mm`` + ``argmin`` in full f32 (TF32 off), the library
    yardstick of the f32 scoring kernels; ``chunk`` rows at a time."""
    import torch

    from kmeans_tpu_torch.ops.distance import full_f32

    def run():
        with full_f32():
            if chunk is None:
                return torch.mm(x, neg2c.T).add_(csq).argmin(dim=1)
            return torch.cat([torch.mm(x[s:s + chunk], neg2c.T).add_(csq)
                              .argmin(dim=1)
                              for s in range(0, x.shape[0], chunk)])
    return run


def _f32_sweep_times(x, c, prev, need, reps=5):
    """CUDA-event ms of K1 (with its fold), K2 (raw, from ``prev``) and K4
    (the rows of ``need``) in f32 at ``x``'s shape, of their plain
    versions (one timed run each), of ``torch.mm`` + ``argmin`` with TF32
    off; with the scoring core."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    n = x.shape[0]
    zeros = torch.zeros(n, device="cuda")
    neg2c, csq = K._score_operands(c, f32)
    out = {"core": K.scoring_core(x, f32, neg2c)}

    def k2():
        return K.lloyd_delta_cuda(x, c, prev, compute_dtype=f32,
                                  with_mind=False)

    out["K1"] = _time_ms(lambda: K.lloyd_pass_cuda(x, c, compute_dtype=f32),
                         reps)
    out["K2"] = _time_ms(k2, reps)
    out["K4"] = _time_ms(lambda: K.lloyd_hamerly_cuda(
        x, c, prev, need, zeros, zeros, compute_dtype=f32), reps)
    out["K1 plain"] = _time_ms(lambda: K.lloyd_pass_plain(
        x, c, compute_dtype=f32), 1)
    out["K2 plain"] = _time_ms(lambda: K.lloyd_delta_plain(
        x, c, prev, compute_dtype=f32, with_mind=False), 1)
    out["K4 plain"] = _time_ms(lambda: K.lloyd_hamerly_plain(
        x, c, prev, need, zeros, zeros, compute_dtype=f32), 1)
    out["library"] = _time_ms(_f32_library(x, neg2c, csq, 262144), 3)
    return out


def _print_f32_times(what, times, n, d, k, n_need):
    route, ffma = _f32_bounds(n, d, k)
    route4, ffma4 = _f32_bounds(n_need, d, k)
    print(f"{what} f32 (core {times['core']}): K1 {times['K1']:.3f} ms, K2 "
          f"{times['K2']:.3f} ms, K4 at {n_need} needed rows {times['K4']:.3f} ms (bounds "
          f"{route4:.3f}, {ffma4:.3f} ms); plain "
          f"K1 {times['K1 plain']:.3f}, K2 {times['K2 plain']:.3f}, K4 "
          f"{times['K4 plain']:.3f} ms; "
          f"torch.mm+argmin (TF32 off) {times['library']:.3f} ms; bounds "
          f"{route:.3f} ms (six bf16 passes at 989 TFLOP/s), {ffma:.3f} ms "
          f"(f32 FMA at 67 TFLOP/s); K2 at "
          f"{2.0 * n * d * k / times['K2'] / 1e9:.1f} TFLOP/s of f32 "
          "product")


def _f32_row_errors(name, x, c, prev, rows=F32_ERROR_ROWS):
    """K2's raw scores on ``rows`` sampled rows against the f64 product at
    each row's label, relative to ||x||² + ||c||²: printed, and on the f32
    route held to SCORE_RTOL and :func:`_gamma`.  Returns the error."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(17)
    pick = torch.randperm(x.shape[0], generator=gen, device="cuda")[:rows]
    xs, ps = x[pick].contiguous(), prev[pick].contiguous()
    core = K.scoring_core(xs, f32, c)
    lab, raw = K.lloyd_delta_cuda(xs, c, ps, compute_dtype=f32,
                                  with_mind=False)[:2]
    _sync()
    err = _f32_score_error(xs, c, lab, raw)
    d = x.shape[1]
    print(f"{name} f32 score error against f64 on {rows} rows (core "
          f"{core}): {err:.3e} of ||x||² + ||c||² (SCORE_RTOL {SCORE_RTOL}, "
          f"γ {_gamma(d):.3e})")
    if core == "wgmma":
        _check(err <= min(SCORE_RTOL, _gamma(d)),
               f"{name}: f32 score error {err:.3e} beyond min(SCORE_RTOL, γ)")
    return err


def phase_headline_f32():
    """imagenet-delta-f32: n = 1,280,000, d = 2048, k = 1000, f32
    ``make_blobs`` on the card and a fixed init, computed in f32 (the
    default for f32 data) on the core's f32 route: the main path in two
    runs, each with the counts set to 0 just before and read just after --
    ``fit_lloyd(update="delta")`` (F32_SWEEPS sweeps: K1 and K2) and
    F32_HAMERLY_SWEEPS hand-driven ``hamerly_pass`` sweeps (K4) -- each
    held against K1, and the fit's labels against the plain route's; then
    K1, K2 and K4 against their plain versions, timed beside their bounds,
    the library and ``score_block``, and the route's score error against
    f64; then :func:`_f32_widths`.  Nothing is cut but the sweep depth.
    Returns the three kernels' ``kernels`` rows, with the runs' launches."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import random_init
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.hamerly import (hamerly_bounds, hamerly_pass,
                                              row_norms)
    from kmeans_tpu_torch.ops.update import apply_update

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    f32 = torch.float32
    t0 = time.perf_counter()
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=f32)
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    _sync()
    print(f"imagenet-delta-f32 data: n={n} d={d} k={k} f32, "
          f"{time.perf_counter() - t0:.2f} s to make")
    core = K.scoring_core(x, f32, c0)
    print(f"scoring core of K1, K2 and K4 at the headline shape in f32: "
          f"{core}")
    _check(core == "wgmma", "f32 at the headline shape is not on the core")
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    cfg = kt.KMeansConfig(k=k, update="delta")
    t0 = time.perf_counter()
    state, counts = _counted_run(lambda: kt.fit_lloyd(
        x, k, config=cfg, init=c0, max_iter=F32_SWEEPS, tol=-1.0))
    fit_s = time.perf_counter() - t0
    _add_counts(launches, counts)
    print(f"f32 fit_lloyd(update='delta', max_iter={F32_SWEEPS}, tol=-1): "
          f"{int(state.n_iter)} sweeps + final view in {fit_s:.3f} s = "
          f"{int(state.n_iter) / fit_s:.3f} iter/s; inertia "
          f"{float(state.inertia):.6e}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
          f"{counts}")
    _check(counts["lloyd_pass_cuda"] >= 3
           and counts["lloyd_delta_cuda"] >= F32_SWEEPS - 3
           and not counts["tiled_argmin_cuda"] and not counts["tiled_fold_cuda"],
           f"f32 fit: launches {counts}")
    _check(int(state.n_iter) == F32_SWEEPS and _finite(state.centroids)
           and bool(torch.isfinite(state.inertia)),
           "f32 fit: wrong sweep count or non-finite result")
    c = state.centroids
    lab1 = K.lloyd_pass_cuda(x, c, compute_dtype=f32, with_update=False)[0]
    plain = K.lloyd_pass_plain(x, c, compute_dtype=f32, with_update=False)
    moved = _check_labels_rows("f32 fit vs plain", x, c, f32, lab1, plain[0])
    print(f"  K1 at the fit's centroids against the plain f32 route: "
          f"{moved} rows differ, each a tie within {SCORE_RTOL}")
    del plain

    # Hand-driven Hamerly sweeps from the fit's centroids: a refresh (every
    # row needed), then steady sweeps, each held against K1.
    rno = row_norms(x, compute_dtype=f32)
    hc = c.clone()
    lab = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    sb = torch.zeros(n, device="cuda")
    slb = torch.zeros(n, device="cuda")
    c_cd, csq = hc.clone(), torch.zeros(k, device="cuda")
    sums, hcounts = torch.zeros(k, d, device="cuda"), torch.zeros(
        k, device="cuda")
    recs, diffs = [], []
    for i in range(F32_HAMERLY_SWEEPS):
        out, counts = _counted_run(lambda: hamerly_pass(
            x, hc, lab, sums, hcounts, sb, slb, c_cd, csq, rno,
            compute_dtype="float32"))
        _add_counts(launches, counts)
        _check(counts["lloyd_hamerly_cuda"] == 1,
               f"f32 hamerly sweep {i}: launches {counts}")
        lab, sums, hcounts, sb, slb, c_cd, csq, n_rec = out[:8]
        ref = K.lloyd_pass_cuda(x, hc, compute_dtype=f32,
                                with_update=False)[0]
        diffs.append(_check_labels_rows(f"f32 hamerly sweep {i}", x, hc, f32,
                                        lab, ref))
        recs.append(int(n_rec))
        hc = apply_update(hc, sums, hcounts)
    print(f"f32 hamerly ({F32_HAMERLY_SWEEPS} sweeps): rows recomputed "
          f"{recs}; rows labelled differently from K1 {diffs} (each a tie "
          f"within {SCORE_RTOL})")
    print(f"imagenet-delta-f32 main path launches: {launches}")

    # Timings at the steady state: K2 from one more sweep's labels at the
    # next centroids (this run's churn), K4 at the Hamerly sweeps' steady
    # need.
    _, _, need, _, _ = hamerly_bounds(hc, lab, sb, slb, c_cd, csq, rno, f32)
    del rno, sb, slb, sums
    prev, _, sums1, counts1, _ = K.lloyd_pass_cuda(x, c, compute_dtype=f32)
    c = apply_update(c, sums1, counts1)
    times = _f32_sweep_times(x, c, prev, need)
    _print_f32_times("imagenet-delta-f32", times, n, d, k, int(need.sum()))
    with _ForcedScoreBlock():
        sb_ms = _time_ms(lambda: K.lloyd_delta_cuda(
            x, c, prev, compute_dtype=f32, with_mind=False), 2)
    print(f"imagenet-delta-f32 K2 on score_block (the parent's f32 route): "
          f"{sb_ms:.3f} ms")
    rows = _f32_kernel_rows(x, c, prev, need, times, launches)
    _f32_row_errors("imagenet-delta-f32", x, c, prev)
    del x, c, prev, need
    _f32_widths()
    return rows


def _f32_widths(n=400_000, k=1000, reps=5):
    """K2 in f32 at n rows and k centroids over d in F32_WIDTHS: the
    scoring core the rule picks, K2's CUDA-event ms there and on
    ``score_block`` (labels equal but for near-ties within SCORE_RTOL), and
    the route's share of the f32 product it computes (a stage of 32
    features: ⌈d/32⌉·32 of them).  Seeded Gaussian data, centroids drawn
    from the rows, ``prev`` the labels at centroids one small step away."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(29)
    for d in F32_WIDTHS:
        x = torch.randn(n, d, generator=gen, device="cuda")
        c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].clone()
        prev = K.lloyd_pass_cuda(x, c, compute_dtype=f32,
                                 with_update=False)[0]
        c += 0.05 * torch.randn(k, d, generator=gen, device="cuda")
        core = K.scoring_core(x, f32, c)

        def k2():
            return K.lloyd_delta_cuda(x, c, prev, compute_dtype=f32,
                                      with_mind=False)

        ms = _time_ms(k2, reps)
        lab = k2()[0]
        with _ForcedScoreBlock():
            sb_ms = _time_ms(k2, reps)
            lab_sb = k2()[0]
        moved = _check_labels_rows(f"K2 f32 d={d}", x, c, f32, lab, lab_sb)
        print(f"f32 width n={n} d={d} k={k}: K2 on {core} {ms:.3f} ms, on "
              f"score_block {sb_ms:.3f} ms (x{sb_ms / ms:.2f}); the route "
              f"computes {d / (-(-d // 32) * 32):.3f} useful of its "
              f"products; {moved} labels differ (ties)")
        del x, c, prev


def _f32_kernel_rows(x, c, prev, need, times, launches):
    """The ``kernels`` rows of K1, K2 and K4 on the f32 route at the
    headline shape: each against its plain version (labels up to ties,
    scores within SCORE_RTOL of the row scale, sums within SUMS_RTOL),
    with ``times`` from :func:`_f32_sweep_times`, the launches of
    imagenet-delta-f32's runs and the route's bound: ``x`` read once in
    f32, −2C's three bf16 pieces, six bf16 products on the tensor cores.
    K4's library call is ``torch.mm`` of the needed rows with TF32 off,
    then the two least scores with ``topk``."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.ops.distance import full_f32

    f32 = torch.float32
    n, d = x.shape
    k = c.shape[0]
    zeros = torch.zeros(n, device="cuda")
    neg2c, csq = K._score_operands(c, f32)
    xb, x_row = n * d * 4, n * 4
    cb = 3 * k * (-(-d // 8) * 8) * 2 + k * 4
    fold = k * d * 4 + k * 4
    dist_ops = 2.0 * n * d * k
    rows = []

    def dsums_err(name, got_lab, dsums, mask):
        changed = (got_lab != prev) & mask
        add = K.accumulate_plain(x, torch.where(changed, got_lab, -1), k,
                                 compute_dtype=f32)
        sub = K.accumulate_plain(x, torch.where(changed, prev, -1), k,
                                 compute_dtype=f32)
        return _close(name, dsums, add[0] - sub[0]), int(changed.sum())

    got = K.lloyd_pass_cuda(x, c, compute_dtype=f32)
    plain = K.lloyd_pass_plain(x, c, compute_dtype=f32)
    _check_labels_rows("K1 f32 headline", x, c, f32, got[0], plain[0])
    same = got[0] == plain[0]
    want = K.accumulate_plain(x, got[0], k, compute_dtype=f32)
    err = max(_close("K1 f32 headline sums", got[2], want[0]),
              _within("K1 f32 headline min_d2", got[1][same], plain[1][same],
                      _row_scale(x, c, f32, got[0])[same]))
    del got, plain, want
    rows.append(_kernel_row(
        "lloyd_pass_cuda", launches.get("lloyd_pass_cuda", 0), times["K1"],
        times["K1 plain"], times["library"], err,
        xb + x_row + cb + 2 * x_row + fold, 6 * dist_ops, 4.0 * n * d,
        "f32 route"))

    got = K.lloyd_delta_cuda(x, c, prev, compute_dtype=f32, with_mind=False)
    plain = K.lloyd_delta_plain(x, c, prev, compute_dtype=f32,
                                with_mind=False)
    moved = _check_labels_rows("K2 f32 headline", x, c, f32, got[0],
                               plain[0])
    same = got[0] == plain[0]
    all_rows = torch.ones(n, dtype=torch.bool, device="cuda")
    sums_err, n_changed = dsums_err("K2 f32 headline dsums", got[0], got[2],
                                    all_rows)
    err = max(sums_err, _within("K2 f32 headline raw scores", got[1][same],
                                plain[1][same],
                                _row_scale(x, c, f32, got[0])[same]))
    print(f"K2 f32 headline: {n_changed} of {n} rows changed; {moved} rows "
          f"labelled differently from the plain version (ties)")
    del got, plain
    rows.append(_kernel_row(
        "lloyd_delta_cuda", launches.get("lloyd_delta_cuda", 0), times["K2"],
        times["K2 plain"], times["library"], err,
        xb + 2 * x_row + cb + 2 * x_row + fold, 6 * dist_ops,
        4.0 * n_changed * d, "f32 route"))

    got = K.lloyd_hamerly_cuda(x, c, prev, need, zeros, zeros,
                               compute_dtype=f32)
    plain = K.lloyd_hamerly_plain(x, c, prev, need, zeros, zeros,
                                  compute_dtype=f32)
    _check_labels_rows("K4 f32 headline", x[need], c, f32, got[0][need],
                       plain[0][need])
    same = (got[0] == plain[0]) & need
    sums_err, n_changed = dsums_err("K4 f32 headline dsums", got[0], got[3],
                                    need)
    err = max(sums_err, _within("K4 f32 headline sb", got[1][same],
                                plain[1][same],
                                _row_scale(x, c, f32, got[0])[same]))
    _check(bool(torch.equal(got[0][~need], prev[~need])),
           "K4 f32 headline: a row not needed changed its label")
    del got, plain
    picked = need.nonzero()[:, 0]
    n_rec = int(picked.numel())

    def library():
        with full_f32():
            return torch.mm(x[picked], neg2c.T).add_(csq).topk(
                2, dim=1, largest=False)

    rows.append(_kernel_row(
        "lloyd_hamerly_cuda", launches.get("lloyd_hamerly_cuda", 0),
        times["K4"], times["K4 plain"], _time_ms(library, 3), err,
        n_rec * d * 4 + n * (4 + 1 + 4 + 4 + 4) + cb + n * 12 + fold,
        6 * 2.0 * n_rec * d * k, 4.0 * n_changed * d, "f32 route"))
    return rows


def phase_f32_bench():
    """The f32-compute kernels of the tree this script runs in, so that two
    commits can be compared in one call (copy this script over an older
    checkout's and run each with ``--f32-bench``, in turns): K5 (raw
    scores, as the serving engine calls it) at the serving batch shapes --
    1536 and 3072 x 1000 (a mean and a full imagenet-serve batch) and
    8192 x 65536 at d = 2048, at the engine's column range and at 128 and
    256 columns for the first two --, the imagenet-delta-f32 fit (phase
    4's data, init and depth, twice), and K1, K2
    and K4 (13.4% of the rows needed, the headline's steady Hamerly
    share) at the headline shape, each beside ``torch.mm`` + ``argmin``
    with TF32 off and both bounds, and the route's score error against f64
    on sampled rows; then K2 at the glove shape over d in F32_WIDTHS on
    the tree's f32 rule and on ``score_block``.
    Blob data from a seed, f32.  Written against the APIs every tree since
    the serving engine has."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.serve.assign import dense_k_tile

    from kmeans_tpu_torch.models.init import random_init

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(23)
    d = HEADLINE["d"]
    for rows, k, reps in ((1536, HEADLINE["k"], 50),
                          (3072, HEADLINE["k"], 50),
                          (8192, CODEBOOK["k"], 10)):
        c = torch.randn(k, d, generator=gen, device="cuda") * 4
        x = (c[torch.randint(0, k, (rows,), generator=gen, device="cuda")]
             + torch.randn(rows, d, generator=gen, device="cuda"))
        neg2c, csq = (c * -2).contiguous(), (c * c).sum(dim=1).contiguous()
        core = K.scoring_core(x, f32, neg2c)
        kw = {}
        if hasattr(K, "neg2c_pieces") and core == "wgmma":
            kw["neg2c_pieces"] = K.neg2c_pieces(neg2c)
        tiles = [dense_k_tile(k, d)] + ([128, 256] if k < 4096 else [])
        times = {}
        for k_tile in dict.fromkeys(tiles):
            times[k_tile] = _time_ms(lambda: K.tiled_argmin_cuda(
                x, neg2c, csq, k_tile=k_tile, raw_scores=True, **kw), reps)
        lib = _time_ms(_f32_library(x, neg2c, csq), reps)
        route, ffma = _f32_bounds(rows, d, k)
        print(f"f32-bench K5 {rows} x {k} x {d} (core {core}): "
              + ", ".join(f"k_tile {kt_} {ms:.3f} ms"
                          for kt_, ms in times.items())
              + f"; torch.mm+argmin (TF32 off) {lib:.3f} ms; bounds "
              f"{route:.3f} ms (six passes), {ffma:.3f} ms (f32 FMA)")
        prev = K.tiled_argmin_cuda(x, neg2c, csq, k_tile=tiles[0],
                                   raw_scores=True)[0]
        _f32_row_errors(f"f32-bench {rows} x {k}", x, c, prev, rows=512)
        del x, c, neg2c, csq, kw
    n, k = HEADLINE["n"], HEADLINE["k"]
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=f32)
    # The imagenet-delta-f32 fit: the same data and init as phase 4's.
    c0 = random_init(torch.Generator(device="cuda").manual_seed(1), x, k)
    cfg = kt.KMeansConfig(k=k, update="delta")
    for run in ("first", "again"):
        _sync()
        t0 = time.perf_counter()
        state = kt.fit_lloyd(x, k, config=cfg, init=c0, max_iter=F32_SWEEPS,
                             tol=-1.0)
        _sync()
        fit_s = time.perf_counter() - t0
        print(f"f32-bench imagenet-delta-f32 fit ({run}): "
              f"{int(state.n_iter)} sweeps + final view in {fit_s:.3f} s = "
              f"{int(state.n_iter) / fit_s:.3f} iter/s; inertia "
              f"{float(state.inertia):.6e}")
    del state
    c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].clone()
    prev = K.lloyd_pass_cuda(x, c, compute_dtype=f32, with_update=False)[0]
    c += 0.05 * torch.randn(k, d, generator=gen, device="cuda")
    need = torch.rand(n, generator=gen, device="cuda") < 0.134
    times = _f32_sweep_times(x, c, prev, need)
    _print_f32_times("f32-bench headline", times, n, d, k, int(need.sum()))
    _f32_row_errors("f32-bench headline", x, c, prev)
    del x, c, prev, need
    _f32_widths()


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
    codebook shapes (bf16, then f32), on this card's budget; in f32 the
    scoring core at each shape (the core's f32 route: d % 4 == 0)."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K
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
    for name, (d, k) in shapes.items():
        x = torch.empty(2, d, device="cuda")
        core = K.scoring_core(x, torch.float32, torch.empty(3, d,
                                                            device="cuda"))
        plans = {kind: P.kernel_plan(kind, d, k, x_itemsize=4,
                                     cd_itemsize=4, budget=budget)
                 for kind in P.CORE_KINDS}
        print(f"  plan {name} in f32 (core {core}): " + "; ".join(
            f"{kind} {p.mode}, k_tile {p.k_tile}" for kind, p in
            plans.items()))
        want = "tiled" if name == "codebook" else "untiled"
        _check(core == "wgmma" and all(p.mode == want
                                       for p in plans.values()),
               f"plan {name} in f32: core {core}, plans {plans}")


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
    return rows, launches, c.float().cpu().numpy()


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
    order the kernels first ran, memsets and copies included.  The
    profiler's own warm-up step takes one more call, whose records are
    dropped: tracing starts with it, so no measured call loses the
    launches that ran while CUPTI was being enabled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        for _ in range(1 + reps):
            fn()
            _sync()
            prof.step()
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


# ---------------------------------------------------------------------------
# Phase 8: serving the fitted models through the assignment engine
# ---------------------------------------------------------------------------

#: Closed-loop client threads and seconds of load a run (tools/loadgen.py
#: --bench's shape); the new generation is published half-way.
SERVE_CLIENTS = 48
SERVE_SECONDS = 3.0
#: Query rows each model's requests draw slices from, made once a model
#: (its centroids plus unit noise) and labelled by K5 per generation.
SERVE_POOL = 16384
#: The longest a run waits past SERVE_SECONDS for a response from the new
#: generation (its prepared model is built on the dispatcher, as in the
#: reference: at k = 65536 tens of seconds).
SERVE_SWAP_WAIT_S = 240.0


def _serve_load(eng, registry, pool, points, new_centroids):
    """SERVE_CLIENTS closed-loop clients submitting ``points``-row slices
    of ``pool`` for SERVE_SECONDS, the registry publishing
    ``new_centroids`` as generation 2 half-way; the load runs on until a
    response from generation 2 arrives.  Returns ``(responses, errors,
    seconds, publish_s, publish_to_first_s)``; a response is ``(first row,
    labels, generation, latency s, completion s)``, times from the start
    of the load."""
    import threading

    rows = pool.shape[0]
    slots = rows // points
    responses, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()
    counter = iter(range(10 ** 12))
    first_new = []

    def client():
        while not stop.is_set():
            with lock:
                i = next(counter)
            lo = (i % slots) * points
            t0 = time.perf_counter()
            try:
                labels, gen = eng.submit(pool[lo:lo + points])
            except Exception as e:      # a dropped request fails the run
                with lock:
                    errors.append(repr(e))
                continue
            t1 = time.perf_counter()
            with lock:
                responses.append((lo, labels, gen.generation, t1 - t0,
                                  t1 - t_start))
                if gen.generation == 2 and not first_new:
                    first_new.append(t1)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(SERVE_CLIENTS)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(SERVE_SECONDS / 2)
    t_pub = time.perf_counter()
    registry.publish(new_centroids, generation=2)
    deadline = t_pub + SERVE_SWAP_WAIT_S
    while (time.perf_counter() < t_start + SERVE_SECONDS or not first_new) \
            and time.perf_counter() < deadline and not errors:
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=60.0)
    seconds = time.perf_counter() - t_start
    _check(not any(t.is_alive() for t in threads), "a serving client hung")
    return (responses, errors, seconds, t_pub - t_start,
            (first_new[0] - t_pub) if first_new else None)


def _percentiles(seconds):
    """(p50, p99, max) in ms of a list of latencies in seconds."""
    lat = sorted(seconds) or [float("nan")]
    return (1e3 * lat[len(lat) // 2],
            1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            1e3 * lat[-1])


def _pool_labels(pool_t, centroids, k_tile):
    """K5's labels (f32, raw scores) of every pool row against
    ``centroids``: what every response of that generation must equal."""
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    c = centroids.cuda()
    return K.tiled_argmin_cuda(pool_t, (c * -2).contiguous(),
                               (c * c).sum(dim=1).contiguous(),
                               k_tile=k_tile, raw_scores=True)[0]


def _serve_run(name, route, card, centroids, pool, points, perm, cfg_kw):
    """One engine run of phase 8: the prepared model's build timed, then
    the load with its counts set to 0 before and read after, each response
    held against K5's labels of its own generation."""
    import dataclasses

    import numpy as np
    import torch

    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.continuous.registry import ModelRegistry
    from kmeans_tpu_torch.ops import cuda_lloyd as K
    from kmeans_tpu_torch.serve.assign import AssignEngine

    registry = ModelRegistry()
    gen1 = registry.publish(centroids, generation=1)
    cfg = dataclasses.replace(ServeConfig(), **cfg_kw)
    eng = AssignEngine(registry.current, cfg)
    try:
        t0 = time.perf_counter()
        prep = eng._prepared(gen1)
        t_tables = time.perf_counter() - t0
        qmode = eng._quant_mode(prep, points)
        kind = "quant" if qmode else "pruned" if prep.pruned else "dense"
        t0 = time.perf_counter()
        if qmode:
            prep.quant_tier(qmode)
        t_tier = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.submit(pool[:points])
        t_first = time.perf_counter() - t0
        print(f"serve {name} {route} ({card}): prepared model "
              f"{t_tables:.3f} s (closure tables: {prep.pruned}, G={prep.g_n}"
              f", m={prep.m}), {qmode or 'no'} quant tier {t_tier:.3f} s, "
              f"first request (device tensors, first batch) {t_first:.3f} s")
        _check(kind == route.split()[0],
               f"serve {name}: the engine took the {kind} route, not {route}")
        K.reset_launch_counts()
        before = eng.stats()
        responses, errors, seconds, pub_s, swap_s = _serve_load(
            eng, registry, pool, points, centroids[perm])
        counts = K.launch_counts()
        after = eng.stats()
    finally:
        eng.stop()
    st = {key: after[key] - before[key] for key in (
        "batches", "requests", "rows", "fallback_rows", "quant_batches",
        "quant_rescore_rows")}
    gens = {r[2] for r in responses}
    n_req, n_pts = len(responses), len(responses) * points
    p50, p99, top = _percentiles([r[3] for r in responses])
    early = [r[3] for r in responses if r[4] <= pub_s]
    e50, e99, _ = _percentiles(early)
    print(f"serve {name} {route} ({card}): {n_req} requests in "
          f"{seconds:.3f} s = {n_req / seconds:.1f} QPS, "
          f"{n_pts / seconds:.0f} points/s; p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, max {top:.3f} ms; before the publish "
          f"({pub_s:.3f} s): {len(early)} requests = "
          f"{len(early) / pub_s:.1f} QPS, {len(early) * points / pub_s:.0f} "
          f"points/s, p50 {e50:.3f} ms, p99 {e99:.3f} ms; {st['batches']} "
          f"batches, mean {st['rows'] / max(st['batches'], 1):.1f} rows; "
          f"fallback rows {st['fallback_rows']}, quant batches "
          f"{st['quant_batches']}, quant rescore rows "
          f"{st['quant_rescore_rows']}; publish to first generation-2 "
          f"response {swap_s if swap_s is None else round(swap_s, 3)} s; "
          f"launches {counts}")
    _check(not errors, f"serve {name} {route}: {len(errors)} requests "
           f"failed, first {errors[:1]}")
    _check(st["requests"] == n_req and gens == {1, 2},
           f"serve {name} {route}: responses {n_req} vs engine requests "
           f"{st['requests']}, generations {sorted(gens)}")
    _check(st["batches"] < st["requests"],
           f"serve {name} {route}: the batcher did not coalesce")
    # Under the default request timeout every request must be answered,
    # the publish's rebuild on the dispatcher included.
    limit_s = ServeConfig().assign_timeout_s
    _check(top <= 1e3 * limit_s,
           f"serve {name} {route}: the slowest request took {top:.3f} ms, "
           f"past the default assign_timeout_s of {limit_s} s")
    # K5: once a dense batch; once for each pruned or quant batch with
    # certificate failures, which it rescores on the card.
    k5 = counts["tiled_argmin_cuda"]
    rescored = st["fallback_rows"] + st["quant_rescore_rows"]
    _check(sum(counts.values()) == k5 and (
        k5 == st["batches"] if kind == "dense"
        else (rescored > 0) <= k5 <= min(st["batches"], rescored)),
           f"serve {name} {route}: launches {counts}, K5 expected one a "
           f"dense batch, one a batch with rescored rows")
    return responses, counts, prep


def _check_responses(name, route, responses, pool_t, labels, gen_c, points):
    """Every response against K5's labels of its own generation; a label
    that differs must be a near-tie within SCORE_RTOL.  Returns the
    per-generation labels of every answered pool row (-1 unanswered)."""
    import numpy as np
    import torch

    answered = {g: np.full(pool_t.shape[0], -1, np.int64) for g in labels}
    moved = 0
    for lo, got, g, *_ in responses:
        answered[g][lo:lo + points] = got
    for g, lab in answered.items():
        seen = lab >= 0
        want = labels[g].cpu().numpy()
        diff = np.flatnonzero(seen & (lab != want))
        moved += diff.size
        if diff.size:
            rows = torch.from_numpy(diff).cuda()
            _check_labels_rows(
                f"serve {name} {route} generation {g}", pool_t[rows],
                gen_c[g].cuda(), torch.float32,
                torch.from_numpy(lab[diff]).cuda(), labels[g][rows])
    print(f"serve {name} {route}: {len(responses)} responses checked "
          f"against K5 of their own generation, {moved} rows differ (each "
          "a tie within the tolerance)")
    return answered


def _route_scan_ms(name, route, card, prep, x):
    """The device scan of a pruned or quant run at a serving batch of
    ``x``'s rows, on the run's first generation: CUDA-event ms and its f32
    product's rate."""
    from kmeans_tpu_torch.ops.hamerly import closure_assign_device
    from kmeans_tpu_torch.quant import quant_assign_device
    from kmeans_tpu_torch.serve.assign import pruned_m_tile, quant_k_tile

    rows, d = x.shape
    if route == "pruned":
        m_tile = pruned_m_tile(rows, d, prep.m)
        ms, _ = _time_auto(lambda: closure_assign_device(
            x, *prep.pruned_dev(), m_tile=m_tile, margin_rel=1e-3))
        ops, what = 2.0 * rows * (prep.g_n + prep.m) * d, (
            f"closure_assign_device (G={prep.g_n}, m={prep.m}, "
            f"m_tile={m_tile})")
    elif route == "quant":
        tier = prep.quant_tier("int8")
        k_tile = quant_k_tile(rows, prep.k)
        ms, _ = _time_auto(lambda: quant_assign_device(
            x, *tier.device(x.device), "int8", k_tile=k_tile))
        ops, what = 2.0 * rows * prep.k * d, (
            f"quant_assign_device (int8, k_tile={k_tile})")
    else:
        return
    print(f"serve {name} {route} scan ({card}): {what} at n={rows}: "
          f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s of f32 product)")


def _k5_serving(name, card, pool_t, centroids, rows, k_tile, launches):
    """K5 in f32 at a serving batch shape on the core's f32 route, called
    as the engine calls it (−2C's pieces held): against its plain version,
    both bounds and ``torch.mm`` + ``argmin`` with TF32 off; beside it, in
    the same call, its other column range (bit for bit) and
    ``score_block`` (the parent's f32 route: labels equal but for near-ties
    within SCORE_RTOL); the score error of each against f64 on 512 rows.
    Returns its ``kernels`` row, with ``launches`` (the model's serving
    runs') and the route's bound."""
    import torch

    from kmeans_tpu_torch.ops import cuda_lloyd as K

    f32 = torch.float32
    x = pool_t[:rows].contiguous()
    c = centroids.cuda()
    k, d = c.shape
    neg2c, csq = (c * -2).contiguous(), (c * c).sum(dim=1).contiguous()
    _check(K.scoring_core(x, f32, neg2c) == "wgmma",
           "K5 in f32 did not take the Hopper core")
    pieces = K.neg2c_pieces(neg2c)

    def k5(k_tile=k_tile):
        return K.tiled_argmin_cuda(x, neg2c, csq, k_tile=k_tile,
                                   raw_scores=True, neg2c_pieces=pieces)

    ms, (lab, raw) = _time_auto(k5)
    plain_ms, (plab, praw) = _time_auto(lambda: K.tiled_argmin_plain(
        x, neg2c, csq, k_tile=k_tile, raw_scores=True))
    moved = _check_labels_rows(f"K5 f32 {name}", x, c, f32, lab, plab)
    same = lab == plab
    err = _within(f"K5 f32 {name} raw scores", raw[same], praw[same],
                  _row_scale(x, c, f32, lab)[same])
    lib_ms, _ = _time_auto(_f32_library(x, neg2c, csq))
    # The other column range beside the route's: 128 where the planner
    # tiles, 256 where it does not.
    other = 128 if k_tile > 128 else 256
    other_ms, out = _time_auto(lambda: k5(other))
    _check(bool(torch.equal(out[0], lab) and torch.equal(out[1], raw)),
           f"K5 f32 {name}: k_tile={other} differs from k_tile={k_tile}")
    with _ForcedScoreBlock():
        sb_ms, (lab_sb, raw_sb) = _time_auto(k5)
    _check_labels_rows(f"K5 f32 {name} vs score_block", x, c, f32, lab,
                       lab_sb)
    sample = slice(0, 512)
    errs = [_f32_score_error(x[sample], c, lb[sample], rw[sample])
            for lb, rw in ((lab, raw), (lab_sb, raw_sb))]
    _check(errs[0] <= min(SCORE_RTOL, _gamma(d)),
           f"K5 f32 {name}: score error {errs[0]:.3e} beyond min("
           "SCORE_RTOL, γ)")
    ops = 2.0 * rows * k * d
    route_b, ffma_b = _f32_bounds(rows, d, k)
    print(f"K5 f32 {name} serving batch ({card}): n={rows} d={d} k={k} "
          f"k_tile={k_tile}: {ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s of "
          f"f32 product; bounds {route_b:.3f} ms six bf16 passes, "
          f"{ffma_b:.3f} ms f32 FMA), plain {plain_ms:.3f} ms, "
          f"torch.mm+argmin (TF32 off) {lib_ms:.3f} ms; {moved} labels "
          f"differ from the plain version (ties), max abs err {err:.3e}; at "
          f"k_tile={other} {other_ms:.3f} ms, bit for bit equal; "
          f"score_block {sb_ms:.3f} ms; score error against f64 on 512 "
          f"rows: route {errs[0]:.3e}, score_block {errs[1]:.3e}")
    return _kernel_row(
        "tiled_argmin_cuda", launches, ms, plain_ms, lib_ms, err,
        rows * d * 4 + pieces.numel() * 2 + k * 4 + rows * 8, 6 * ops, 0.0,
        f"f32 route, {name} batch of {rows}")


def _serve_models(imagenet_c, codebook_c):
    """Phase 8's models: ``(name, centroids, points a request, [(route,
    ServeConfig fields)], seed)``.  The codebook model's requests carry
    512 points, so coalesced batches clear ``assign_quant_min_rows``.  Its
    quant run lets a request wait up to 300 s, so that a publish stall past
    the default timeout (the new generation's prepared model is built on
    the dispatcher mid-load) is measured and then fails the run's check
    rather than the requests."""
    dense = ("dense", {"assign_prune_min_k": 0})
    return [("imagenet-serve", imagenet_c, 64, [("pruned", {}), dense], 21),
            ("codebook-serve", codebook_c, 512,
             [("quant", {"assign_timeout_s": 300.0}), dense], 22)]


def phase_serve(card, models):
    """The assignment engine on the card, serving the two fitted models:
    imagenet-serve (the headline delta fit's centroids, k = 1000: the
    default pruned route, then the dense route on K5) and codebook-serve
    (the codebook fit's, k = 65536: the default int8 quant route, then the
    dense route).  Returns K5's ``kernels`` row for each model, with the
    launches of that model's runs."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.serve.assign import dense_k_tile

    total, rows = {}, []
    t_phase = time.perf_counter()
    for name, centroids, points, routes, seed in models:
        model_counts = {}
        k, d = centroids.shape
        rng = np.random.default_rng(seed)
        pool = centroids[rng.integers(0, k, size=SERVE_POOL)]
        pool += rng.standard_normal(pool.shape, dtype=np.float32)
        perm = rng.permutation(k)
        gen_c = {1: torch.from_numpy(centroids),
                 2: torch.from_numpy(centroids[perm])}
        pool_t = torch.from_numpy(pool).cuda()
        k_tile = dense_k_tile(k, d)
        labels = {g: _pool_labels(pool_t, c, k_tile)
                  for g, c in gen_c.items()}
        _sync()
        answered = {}
        batch = min(SERVE_CLIENTS * points, 8192)
        for route, cfg_kw in routes:
            responses, counts, prep = _serve_run(
                name, route, card, centroids, pool, points, perm, cfg_kw)
            _add_counts(model_counts, counts)
            _route_scan_ms(name, route, card, prep, pool_t[:batch])
            del prep
            answered[route] = _check_responses(name, route, responses,
                                               pool_t, labels, gen_c,
                                               points)
        first, *rest = answered
        for route in rest:
            moved = seen = 0
            for g in (1, 2):
                a, b = answered[first][g], answered[route][g]
                both = (a >= 0) & (b >= 0)
                seen += int(both.sum())
                diff = torch.from_numpy(np.flatnonzero(both & (a != b)))
                moved += _check_labels_rows(
                    f"serve {name} {first} vs {route} generation {g}",
                    pool_t[diff.cuda()], gen_c[g].cuda(), torch.float32,
                    torch.from_numpy(a[diff.numpy()]).cuda(),
                    torch.from_numpy(b[diff.numpy()]).cuda())
            print(f"serve {name}: the {first} and {route} routes label "
                  f"{moved} of the {seen} rows both answered differently "
                  f"(each a tie within {SCORE_RTOL})")
        rows.append(_k5_serving(name, card, pool_t, gen_c[1], batch, k_tile,
                                model_counts.get("tiled_argmin_cuda", 0)))
        _add_counts(total, model_counts)
        del pool_t, labels
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s; serving "
          f"launches {total}")
    return rows


# ---------------------------------------------------------------------------
# Phase 9: the accelerated and minibatch fits
# ---------------------------------------------------------------------------

#: imagenet-accel: ``bench.py --accel``'s hard instance at the headline
#: width (``bench.py:_make_data`` with k_gen = k, its cluster_std and a
#: latent r = 48 geometry), seeded once with k-means++ on the first
#: ACCEL_SEED_ROWS rows, every arm run to ACCEL_TOL_REL × the mean
#: per-feature variance of those rows.
ACCEL_STD = 3.5
ACCEL_LATENT_R = 48
#: ``bench.py --accel``'s instance seeds: data from ``seed``, the start
#: from ``seed + 1``.
ACCEL_SEEDS = (0, 1, 2)
ACCEL_SEED_ROWS = 65536
ACCEL_TOL_REL = 1e-4
ACCEL_MAX_ITER = 500
ACCEL_CHUNK = 65536
#: Sweeps of the cuda-against-plain runs of each accelerated arm.
ACCEL_CHECK_ITERS = 6
#: ``bench.py``'s --accel gates on final inertia against plain Lloyd's
#: (``GATE_ACCEL_REL_INERTIA``, ``GATE_NESTED_REL_INERTIA``), one-sided,
#: on the median over the instances.
GATE_ANDERSON_REL = 1e-3
GATE_NESTED_REL = 1e-2
#: The minibatch runs: BASELINE.json's configs 4 (cifar10) and 5
#: (imagenet, on one card), sklearn's default max_no_improvement.
MB_BATCH = 8192
MB_STEPS = 200
MB_NO_IMPROVEMENT = 10
MB_PARTIAL_FITS = 10


def _accel_data(n, d, k_gen, seed=0, tile=32768):
    """``bench.py:_make_data``'s latent recipe in bf16 on the card, tile by
    tile (no f32 (n, d) tensor): centres and the (r, d) projection from
    ``numpy.random.default_rng(seed)``, each tile's labels and latent noise
    from a ``torch.Generator`` seeded with ``seed``."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.ops.distance import full_f32

    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(ACCEL_LATENT_R, d)).astype(np.float32)
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    centres = (rng.normal(size=(k_gen, ACCEL_LATENT_R)).astype(np.float32)
               * 3) @ proj
    centres = torch.from_numpy(centres).cuda()
    proj = torch.from_numpy(proj).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(n, d, dtype=torch.bfloat16, device="cuda")
    for s in range(0, n, tile):
        e = min(n, s + tile)
        lab = torch.randint(0, k_gen, (e - s,), generator=gen, device="cuda")
        z = torch.randn(e - s, ACCEL_LATENT_R, generator=gen, device="cuda")
        with full_f32():
            noise = z @ proj
        x[s:e] = (centres[lab] + ACCEL_STD * noise).to(torch.bfloat16)
    return x


def _timed_run(warm, fn):
    """``warm()`` (a short call at the same shapes), then ``fn()`` with the
    launch counts set to 0 just before and read just after: ``(out, host
    seconds around the synchronised call, launches)``."""
    warm()
    _sync()
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0, K.launch_counts()


def _accel_instance(seed, card, check):
    """One instance of imagenet-accel (data and start from ``seed``): the
    four arms from one k-means++ start, plain ``fit_lloyd``
    (``update="auto"``), beta, Anderson and the nested ladder with its
    full-batch finish, each after a warm-up at the same shapes; with
    ``check``, the Anderson cost split and each accelerated arm for
    ACCEL_CHECK_ITERS sweeps on ``backend="cuda"`` and ``"plain"``.
    Returns ``({arm: inertia relative to plain's}, launches)``."""
    import dataclasses

    import torch

    import kmeans_tpu_torch as kt

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    t0 = time.perf_counter()
    x = _accel_data(n, d, k, seed=seed)
    sub = x[:ACCEL_SEED_ROWS]
    tol = ACCEL_TOL_REL * float(sub.float().var(dim=0, unbiased=False)
                                .mean())
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    c0 = kt.kmeans_plus_plus(gen, sub, k, compute_dtype="bfloat16")
    _sync()
    name = f"imagenet-accel seed {seed}"
    print(f"{name} data: n={n} d={d} k={k} bf16, std {ACCEL_STD}, latent r "
          f"{ACCEL_LATENT_R}; k-means++ on {ACCEL_SEED_ROWS} rows; tol "
          f"{tol:.6e}; {time.perf_counter() - t0:.2f} s to make")
    cfg = kt.KMeansConfig(k=k, compute_dtype="bfloat16",
                          max_iter=ACCEL_MAX_ITER, chunk_size=ACCEL_CHUNK)
    warm_cfg = dataclasses.replace(cfg, max_iter=2)
    total = {}

    def fit(config, accel=None):
        if accel is None:
            return kt.fit_lloyd(x, k, init=c0, tol=tol, config=config)
        return kt.fit_lloyd_accelerated(x, k, init=c0, tol=tol,
                                        config=config, accel=accel,
                                        diag=True)

    def nested(config):
        return kt.fit_minibatch(x, k, init=c0, tol=tol, config=config,
                                schedule="nested", return_ladder=True)

    arms, rel = {}, {}
    for arm, run in (("plain", lambda c: (fit(c), None)),
                     ("beta", lambda c: fit(c, "beta")),
                     ("anderson", lambda c: fit(c, "anderson")),
                     ("nested", nested)):
        (state, extra), secs, counts = _timed_run(lambda: run(warm_cfg),
                                                  lambda: run(cfg))
        _add_counts(total, counts)
        arms[arm] = state
        inertia = float(state.inertia)
        line = (f"{name} {arm}: {int(state.n_iter)} iterations, converged "
                f"{bool(state.converged)}, {secs:.3f} s, inertia "
                f"{inertia:.6e}")
        if arm != "plain":
            plain = float(arms["plain"].inertia)
            rel[arm] = (inertia - plain) / plain
            line += f" ({rel[arm]:+.3e} of plain's)"
        if arm in ("beta", "anderson"):
            line += (f"; outcomes accepted {extra['accepted']}, rejected "
                     f"{extra['rejected']}, fallback {extra['fallback']}")
        if arm == "nested":
            ladder = sum(it for _, it in extra)
            full = int(state.n_iter) - ladder
            epochs = sum(b * it for b, it in extra) / n + full
            line += (f"; rungs {extra}, full-batch iterations {full}, "
                     f"epochs {epochs:.3f}")
        print(f"{line}; launches {counts} ({card})")
        _check(_finite(state.centroids) and math.isfinite(inertia),
               f"{name} {arm}: non-finite result")
        _check(counts["lloyd_pass_cuda"] >= 1,
               f"{name} {arm}: K1 did not launch")
        if arm in ("anderson", "nested"):
            _check(counts["lloyd_delta_cuda"] >= 1,
                   f"{name} {arm}: K2 did not launch")
    if not check:
        return rel, total
    _anderson_costs(x, arms["plain"].centroids, card)
    del arms
    for accel in ("beta", "anderson"):
        runs = {}
        for backend in ("cuda", "plain"):
            short = dataclasses.replace(cfg, backend=backend,
                                        max_iter=ACCEL_CHECK_ITERS)
            runs[backend] = kt.fit_lloyd_accelerated(
                x, k, init=c0, tol=-1.0, config=short, accel=accel,
                diag=True)
        (a, da), (b, db) = runs["cuda"], runs["plain"]
        fa, fb = float(a.inertia), float(b.inertia)
        print(f"{name} {accel}, {ACCEL_CHECK_ITERS} sweeps: outcomes cuda "
              f"{da['outcomes']}, plain {db['outcomes']}; inertia cuda "
              f"{fa:.6e}, plain {fb:.6e}")
        _check(da["outcomes"] == db["outcomes"],
               f"{name} {accel}: the cuda and plain runs took different "
               "outcome sequences")
        _check(abs(fa - fb) <= FIT_INERTIA_RTOL * abs(fb),
               f"{name} {accel}: cuda inertia {fa} vs plain {fb} beyond "
               f"rtol {FIT_INERTIA_RTOL}")
    return rel, total


def _imagenet_accel(card):
    """``bench.py --accel``'s protocol at the headline width: one instance
    per seed in ACCEL_SEEDS, and its quality gates judged as
    ``bench.py:accel_gates`` judges them, on the median over the instances
    of each arm's inertia relative to plain's: one instance's trajectory
    is chaotic, and K2's and K4's atomics, which move the sums' last bits
    from run to run, can send plain's own fit to another basin.  Returns
    the launches."""
    total, rels = {}, []
    for seed in ACCEL_SEEDS:
        rel, counts = _accel_instance(seed, card, check=seed == 0)
        rels.append(rel)
        _add_counts(total, counts)
    for arm, gate in (("anderson", GATE_ANDERSON_REL),
                      ("nested", GATE_NESTED_REL)):
        each = [r[arm] for r in rels]
        med = statistics.median(each)
        print(f"imagenet-accel {arm}: inertia relative to plain's "
              f"{', '.join(f'{v:+.3e}' for v in each)}, median {med:+.3e} "
              f"(gate {gate})")
        _check(med <= gate, f"imagenet-accel {arm}: the median final "
               f"inertia {med:+.3e} above plain Lloyd's is past the gate "
               f"{gate}")
    return total


def _behind_queue(name, fn, reps=4):
    """``fn()`` enqueued behind ≈ 0.1 s of device work (five 8192² f32
    products), ``reps`` times: a call that reads nothing back returns long
    before that queue drains, and fails the check otherwise; and since the
    host has enqueued all of ``fn`` by the time the device reaches the
    event before it, two events around the call time its device work
    alone.  Returns ``(host ms, queued ms, median device ms after the
    first)``."""
    import torch

    big = torch.ones(8192, 8192, device="cuda")
    device_ms = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        for _ in range(5):
            big @ big
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t1)
        _sync()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        device_ms.append(start.elapsed_time(end))
        _check(host_ms < 0.5 * queued_ms,
               f"{name} waited for the device: a host sync in it")
    return host_ms, queued_ms, statistics.median(device_ms[1:])


def _anderson_costs(x, c, card):
    """What an Anderson sweep adds to K2 at the headline shape, by CUDA
    events: K2 with the row norms (the objective the safeguard reads every
    sweep) and without (the plain delta loop's sweep), and one
    ``anderson_step`` on full m = 5 rings of k·d floats with ``tol`` and
    ``reg`` as the loop passes them (0-d tensors on the card), behind a
    queue (:func:`_behind_queue`)."""
    import torch

    from kmeans_tpu_torch.ops import anderson as A
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    lab = K.lloyd_pass_cuda(x, c, compute_dtype=bf16)[0]
    c1 = c + 0.01 * torch.randn(c.shape, generator=gen, device="cuda")
    k2 = {mind: _time_ms(lambda: K.lloyd_delta_cuda(
        x, c1, lab, compute_dtype=bf16, with_mind=mind), 5)
        for mind in (False, True)}
    tol = torch.tensor(1e-12, device="cuda")
    reg = torch.tensor(1e-8, device="cuda")
    st = A.anderson_state(c, *A.anderson_reset(5, c.numel())[:2])
    f = torch.tensor(1e9, device="cuda")
    cur = c
    for _ in range(6):
        tc = cur + 0.01 * torch.randn(c.shape, generator=gen, device="cuda")
        f = f * 0.99
        cur, st, _ = A.anderson_step(cur, tc, f, ((tc - cur) ** 2).sum(),
                                     st, tol=tol, reg=reg)
    tc = cur + 0.01 * torch.randn(c.shape, generator=gen, device="cuda")
    sh = ((tc - cur) ** 2).sum()
    host_ms, queued_ms, device_ms = _behind_queue(
        "anderson_step", lambda: A.anderson_step(cur, tc, f * 0.99, sh, st,
                                                 tol=tol, reg=reg))
    print(f"imagenet-accel Anderson costs: K2 {k2[False]:.3f} ms without "
          f"the row norms, {k2[True]:.3f} ms with; anderson_step (m = 5, "
          f"k·d = {c.numel()}) device {device_ms:.3f} ms, host "
          f"{host_ms:.3f} ms behind {queued_ms:.1f} ms of queued work "
          f"({card})")


def _minibatch_split(name, x, est_kw, card):
    """One ``MiniBatchKMeans.fit`` after a warm-up fit at the same shapes
    (two steps), and its seconds split: the fit's seeding replayed on its
    own draws (the subsample, then k-means++ on it), the steps from there
    (``fit_minibatch`` from the replayed centroids with the generator where
    the seeding left it, which must give the fit's centroids bit for bit)
    less the final sweep, timed alone.  Returns ``(estimator,
    launches)``."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.init import init_centroids

    n = x.shape[0]
    k = est_kw["n_clusters"]
    cd = est_kw.get("compute_dtype")
    est, secs, counts = _timed_run(
        lambda: kt.MiniBatchKMeans(**dict(est_kw, steps=2)).fit(x),
        lambda: kt.MiniBatchKMeans(**est_kw).fit(x))
    steps = int(est.state.n_iter)
    gen = torch.Generator(device="cuda").manual_seed(est_kw.get("seed", 0))
    t0 = time.perf_counter()
    sub = min(n, max(4 * k * 16, 65536))
    xs = x[torch.randperm(n, generator=gen, device="cuda")[:sub]] \
        if sub < n else x
    c_seed = init_centroids(gen, xs, k, compute_dtype=cd)
    _sync()
    seed_s = time.perf_counter() - t0
    del xs
    cfg = kt.KMeansConfig(k=k, compute_dtype=cd, batch_size=MB_BATCH,
                          steps=MB_STEPS, seed=est_kw.get("seed", 0),
                          backend=est_kw.get("backend", "auto"))
    t0 = time.perf_counter()
    rest = kt.fit_minibatch(x, k, generator=gen, config=cfg, init=c_seed,
                            tol=est_kw.get("tol"),
                            max_no_improvement=est_kw.get(
                                "max_no_improvement"))
    _sync()
    rest_s = time.perf_counter() - t0
    _check(torch.equal(rest.centroids, est.cluster_centers_),
           f"{name}: the seeding replayed and the steps from there do not "
           "give the fit's centroids")
    t0 = time.perf_counter()
    kt.lloyd_pass(x, rest.centroids, compute_dtype=cd)
    _sync()
    final_s = time.perf_counter() - t0
    step_s = rest_s - final_s
    print(f"{name}: {steps} steps, converged {bool(est.state.converged)}, "
          f"{secs:.3f} s; split: seeding {seed_s:.3f} + steps {step_s:.3f} "
          f"({1e3 * step_s / steps:.3f} ms a step, {steps / step_s:.1f} "
          f"steps/s) + final sweep {final_s:.3f}; inertia "
          f"{est.inertia_:.6e}; launches {counts} ({card})")
    _check(_finite(est.cluster_centers_) and math.isfinite(est.inertia_),
           f"{name}: non-finite result")
    _check(counts["lloyd_pass_cuda"] >= 1, f"{name}: K1 did not launch")
    return est, counts


def _cifar10_minibatch(card):
    """BASELINE config 4: the fit, the fit with early stopping, and
    MB_PARTIAL_FITS partial_fit calls; the fit on ``backend="cuda"`` against
    ``"plain"``.  Returns the f32 route's launches."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.ops.cuda_lloyd import scoring_core

    n, d, k = CIFAR10["n"], CIFAR10["d"], CIFAR10["k"]
    x, _, _ = kt.make_blobs(0, n, d, k)
    f32 = torch.float32
    core = scoring_core(x, f32, x[:k])
    print(f"cifar10-minibatch: n={n} d={d} k={k} f32 ({x.numel() * 4 / 1e6:.0f}"
          f" MB), scoring core {core}")
    _check(core == "wgmma", "cifar10 does not take the core's f32 route")
    kw = dict(n_clusters=k, batch_size=MB_BATCH, steps=MB_STEPS, seed=0)
    total = {}
    est, counts = _minibatch_split("cifar10-minibatch fit", x,
                                   dict(kw, backend="cuda"), card)
    _add_counts(total, counts)
    tol = ACCEL_TOL_REL * float(x.var(dim=0, unbiased=False).mean())
    early, counts = _minibatch_split(
        f"cifar10-minibatch fit, tol {tol:.6e}, max_no_improvement "
        f"{MB_NO_IMPROVEMENT}", x,
        dict(kw, tol=tol, max_no_improvement=MB_NO_IMPROVEMENT), card)
    _add_counts(total, counts)
    stream = kt.MiniBatchKMeans(**kw)
    rows = n // MB_PARTIAL_FITS
    stream.partial_fit(x[:rows])              # seeds; the warm-up
    _sync()
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(MB_PARTIAL_FITS):
        stream.partial_fit(x[i * rows:(i + 1) * rows])
    _sync()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    _add_counts(total, counts)
    print(f"cifar10-minibatch partial_fit: {MB_PARTIAL_FITS} calls of {rows} "
          f"rows in {secs:.3f} s ({1e3 * secs / MB_PARTIAL_FITS:.3f} ms a "
          f"call), batch inertia {stream.inertia_:.6e}; launches {counts}")
    _check(counts["lloyd_pass_cuda"] == MB_PARTIAL_FITS,
           "cifar10-minibatch partial_fit: K1 did not launch once a call")
    _check(_finite(stream.cluster_centers_), "partial_fit: non-finite")
    plain = kt.MiniBatchKMeans(**kw, backend="plain").fit(x)
    _check(torch.equal(est.cluster_centers_, plain.cluster_centers_),
           "cifar10-minibatch: the cuda and plain fits' centroids differ: "
           "the steps are the same code on the same draws")
    moved = _check_labels_rows("cifar10-minibatch final labels", x,
                               est.cluster_centers_, f32, est.labels_,
                               plain.labels_)
    print(f"cifar10-minibatch: cuda and plain fits' centroids equal bit for "
          f"bit; {moved} final labels differ, each a tie within "
          f"{SCORE_RTOL}")
    return total


def _imagenet_minibatch(card):
    """BASELINE config 5 on one card, and one step's ``batch_stats`` beside
    K1 on the same gathered rows.  Returns the launches."""
    import torch

    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.models.minibatch import batch_stats, batch_update
    from kmeans_tpu_torch.ops import cuda_lloyd as K

    n, d, k = HEADLINE["n"], HEADLINE["d"], HEADLINE["k"]
    bf16 = torch.bfloat16
    x, _, _ = kt.make_blobs(0, n, d, k, dtype=bf16)
    kw = dict(n_clusters=k, batch_size=MB_BATCH, steps=MB_STEPS,
              compute_dtype="bfloat16")
    est, counts = _minibatch_split("imagenet-minibatch fit", x, kw, card)
    gen = torch.Generator(device="cuda").manual_seed(2)
    xb = x[torch.randint(0, n, (MB_BATCH,), generator=gen, device="cuda")]
    c = est.cluster_centers_
    stats_ms = _time_ms(lambda: batch_stats(c, xb, compute_dtype=bf16), 10)
    k1_ms = _time_ms(lambda: K.lloyd_pass_cuda(xb, c, compute_dtype=bf16),
                     10)
    n_seen = est.state.counts
    host_ms, queued_ms, step_ms = _behind_queue(
        "a minibatch step", lambda: batch_update(
            c, n_seen, x[torch.randint(0, n, (MB_BATCH,), generator=gen,
                                       device="cuda")],
            compute_dtype=bf16))
    print(f"imagenet-minibatch step at {MB_BATCH} gathered rows: batch_stats "
          f"{stats_ms:.3f} ms, K1 (lloyd_pass_cuda) {k1_ms:.3f} ms; a whole "
          f"step (draw, gather, batch_update) device {step_ms:.3f} ms, host "
          f"{host_ms:.3f} ms behind {queued_ms:.1f} ms of queued work "
          f"({card})")
    return counts


def phase_accel_minibatch(card):
    """Phase 9: imagenet-accel, cifar10-minibatch and imagenet-minibatch.
    Returns ``{"bf16": launches, "f32": launches}`` for the kernels line."""
    t_phase = time.perf_counter()
    bf16 = _imagenet_accel(card)
    f32 = _cifar10_minibatch(card)
    _add_counts(bf16, _imagenet_minibatch(card))
    print(f"accelerated and minibatch phase: "
          f"{time.perf_counter() - t_phase:.1f} s; launches bf16 {bf16}, "
          f"f32 {f32}")
    return {"bf16": bf16, "f32": f32}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    if sys.argv[1:] == ["--fold-split"]:
        phase_fold_split()
        return 0
    if sys.argv[1:] == ["--f32-bench"]:
        phase_f32_bench()
        return 0
    if sys.argv[1:] == ["--accel"]:
        phase_accel_minibatch(card)
        return 0
    phase_build()
    phase_kernels()
    kernels, headline_launches, imagenet_c = phase_headline()
    f32_rows = phase_headline_f32()
    phase_whole_fit()
    tiled, codebook_launches, codebook_c = phase_codebook(headline_launches)
    for row in kernels:
        row["launches"] += codebook_launches.get(row["name"], 0)
    kernels += tiled + f32_rows
    serve_rows = phase_serve(card, _serve_models(imagenet_c, codebook_c))
    accel = phase_accel_minibatch(card)
    for row in kernels:
        # Phase 9's launches join the bf16 rows and the f32 route's rows.
        name, _, what = row["name"].partition(" ")
        compute = {"": "bf16", "(f32 route)": "f32"}.get(what)
        if compute:
            row["launches"] += accel[compute].get(name, 0)
    kernels += serve_rows
    phase_fold_split()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
