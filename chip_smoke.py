#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (kmeans_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
``kmeans_tpu_torch/csrc/lloyd.cu`` and runs six phases, exiting non-zero if
any fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` for sm_90a, with its seconds and register report;
3. each kernel against its plain PyTorch version on the card: ragged n,
   d in {2, 100, 2048}, k in {3, 1000}, float32 and bfloat16, zero-weight
   rows, a −1 sentinel ``prev``, out-of-range labels, and exact ties;
4. the slice at full width: ``fit_lloyd(update="delta")`` at n = 1,280,000,
   d = 2048, k = 1000 in bf16 (20 sweeps, so the refresh at sweep 16 and
   the final view run) and the public delta sweep's refresh branch
   (``delta_pass(force_full=True)``), each run with the launch counts set
   to 0 just before it and read just after; then each kernel at that
   shape against its plain version, its time beside its bound, the plain
   version's and a library call's, and the time of k-means++ there;
5. a whole ``KMeans(update="delta", compute_dtype="bfloat16")`` fit with
   k-means++ at the ``glove`` shape, held against a plain-backend fit;
6. a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.

The bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of memory, 989
TFLOP/s bf16 on the tensor cores and 67 TFLOP/s f32 outside them.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HEADLINE = dict(n=1_280_000, d=2048, k=1000)
MEM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
#: Tolerances of the kernel-vs-plain checks.  The kernel and the plain
#: version sum the same f32 products in another order, so their labels may
#: differ on a row whose two best scores tie to within that order: each
#: one's chosen score may exceed the f64 minimum by this fraction of
#: ||x_cd||² + ||c||² (which bounds |csq − 2x·c|), and no more.
SCORE_RTOL = 1e-5
#: Sums: f32 sums of the same terms, in atomic order on the card.
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
}


class SmokeFailure(RuntimeError):
    pass


def _check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def _sync():
    import torch

    torch.cuda.synchronize()


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


def phase_build():
    from kmeans_tpu_torch.ops import _build

    info = _build.build()
    print(f"build: {info['seconds']:.1f} s (built now: {info['built']}) "
          f"-> {info['path']}")
    regs = [int(w.split()[0]) for line in info["ptxas"].splitlines()
            for w in line.split("Used ")[1:] if "registers" in w]
    spills = [line.strip() for line in info["ptxas"].splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    if regs:
        print(f"  ptxas: {len(regs)} kernels, at most {max(regs)} registers "
              f"a thread, {len(spills)} with spills")


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
    and the plain version disagree are scored in f64."""
    rows = (labels != plain_labels).nonzero()[:, 0]
    if rows.numel():
        s, scale = _scores64(x[rows], c, cd)
        _near_min(name, s, scale, labels[rows])
        _near_min(f"{name} (plain)", s, scale, plain_labels[rows])
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
    for n, d, k, xd, cd, ties in cases:
        name = (f"n={n} d={d} k={k} x={str(xd)[6:]} cd={str(cd)[6:]}"
                f"{' ties' if ties else ''}")
        x, c, w, prev = _case_inputs(gen, n, d, k, xd, ties)
        xf = x.float()
        # K1
        lab, mind, sums, counts, _ = K.lloyd_pass_cuda(
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
        print(f"  ok {name} ({moved} rows labelled differently from the "
              "plain version, each a tie within the tolerance)")
    print(f"kernels vs plain: {len(cases)} cases agree (score rtol "
          f"{SCORE_RTOL}, sums rtol {SUMS_RTOL}, counts exact)")


# ---------------------------------------------------------------------------
# Phase 4: the slice at full width
# ---------------------------------------------------------------------------

def _bound_ms(bytes_moved, tensor_ops=0.0, f32_ops=0.0):
    """(least ms for the work, "bytes" | "operations")."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = max(tensor_ops / BF16_TENSOR_OPS_PER_S, f32_ops / F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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

    # The main path, in two runs, each with the counts set to 0 just before
    # it and read just after: the fit (K1 and K2 only) and the public delta
    # sweep's refresh branch (K2, then K3).
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
    launches = {name: fit_launches[name] + refresh_launches[name]
                for name in fit_launches}
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
    _check(n_iter == 20 and bool(torch.isfinite(state.centroids).all())
           and bool(torch.isfinite(state.inertia)),
           "headline fit: wrong sweep count or non-finite result")
    _check(int(refresh[3].sum()) == n
           and bool(torch.isfinite(refresh[2]).all()),
           "delta_pass(force_full=True): counts do not sum to n")

    # Steady-state inputs of one more sweep, for the per-kernel timings.
    lab, _, sums, counts, _ = K.lloyd_pass_cuda(x, state.centroids,
                                                compute_dtype=bf16)
    c1 = apply_update(state.centroids, sums, counts)
    w = torch.ones(n, device="cuda")
    kernels = []

    def record(name, ms, plain_ms, library_ms, err, bytes_moved, tensor_ops,
               f32_ops):
        bound, by = _bound_ms(bytes_moved, tensor_ops, f32_ops)
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": library_ms}
        kernels.append(row)
        print(f"{name}: {ms:.3f} ms (bound {bound:.3f} ms by {by}), plain "
              f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, max abs err "
              f"vs plain {err:.3e}")

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

    t0 = time.perf_counter()
    seeds = kt.kmeans_plus_plus(gen, x, k, compute_dtype="bfloat16")
    _sync()
    print(f"kmeans_plus_plus at the headline shape: "
          f"{time.perf_counter() - t0:.3f} s")
    _check(bool(torch.isfinite(seeds).all()), "k-means++ seeds not finite")
    return kernels


# ---------------------------------------------------------------------------
# Phase 5: a whole fit against the plain backend
# ---------------------------------------------------------------------------

def phase_whole_fit():
    import torch

    import kmeans_tpu_torch as kt

    n, d, k = 400_000, 300, 1000
    x, _, _ = kt.make_blobs(5, n, d, k)
    fits = {}
    for backend in ("auto", "plain"):
        t0 = time.perf_counter()
        km = kt.KMeans(n_clusters=k, update="delta",
                       compute_dtype="bfloat16", seed=0, backend=backend)
        km.fit(x)
        _sync()
        fits[backend] = km
        print(f"KMeans glove shape backend={backend}: {km.n_iter_} sweeps, "
              f"converged {bool(km.state.converged)}, inertia "
              f"{km.inertia_:.6e}, {time.perf_counter() - t0:.3f} s")
    a, b = fits["auto"].inertia_, fits["plain"].inertia_
    _check(abs(a - b) <= FIT_INERTIA_RTOL * abs(b),
           f"whole fit: kernel inertia {a} vs plain {b} beyond rtol "
           f"{FIT_INERTIA_RTOL}")
    _check(bool(torch.isfinite(fits["auto"].cluster_centers_).all()),
           "whole fit: non-finite centroids")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_kernels()
    kernels = phase_headline()
    phase_whole_fit()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
