"""The plain reference of a Lloyd k-means fit seeded by k-means++.

Plain PyTorch; it imports nothing of the program under test.  It does
three things:

* :func:`judge_seeding` replays k-means++'s draws and judges each centre a
  fit chose against the exact D² distribution at that round;
* :func:`judge_final` judges a fit's final labels, centroids and inertia
  against exact distances to its final centroids, and its last sweep
  against one exact Lloyd step from the centroids that sweep began at;
* :func:`fit` runs the whole fit itself, in a precision of its choosing
  (the control of the comparison).

**Scores.** A configuration's compute dtype says in what precision the
product ``x·c`` is taken: the score of centroid j for row x is
``||c_j||² − 2·p(x)·p(c_j)`` with ``p`` the rounding to that precision, the
norm ``||c_j||²`` of the f32 centroid and ``||x||²`` of the row as stored;
``d² = ||x||² + score``.  Here every such product is exact (f64 on
operands already rounded), so the reference differs from a sound program
only by the program's own f32 accumulation.

**k-means++.** Round 0 draws a row by Gumbel-max over the weights (all 1);
round i >= 1 draws by ``argmax(log D²_i + G_i)`` with D²_i the exact
squared distance to the nearest of the centres chosen before it, and G_i n
standard Gumbel draws, ``−log(E)`` with E ~ Exp(1) from
``Tensor.exponential_`` on the run's device, floored at f32's least
normal, from a :class:`torch.Generator` seeded with the fit's seed: the
categorical draw the k-means++ paper defines, in the draw order a seeded
fit promises.  That stream is part of the yardstick: a program whose
sampler draws its noise otherwise (fused into a kernel, rounds drawn in a
batch) reads not correct here, however sound, until a change to the
benchmark judges its stream.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch

__all__ = ["round_operand", "judge_seeding", "judge_final", "fit",
           "PRECISIONS", "MAX_TIED"]

#: Precisions a product can be taken in: the stated ones (``exact``,
#: ``bfloat16``) and the controls below them (``tf32`` below f32 with TF32
#: off, ``fp8_e4m3`` below bfloat16).
PRECISIONS = ("exact", "bfloat16", "tf32", "fp8_e4m3")
#: Rows a pass takes at a time (a 65,536-row f64 block of d = 2048 is 1 GB).
CHUNK_ROWS = 65536
_E4M3_MAX = 448.0
_TINY = torch.finfo(torch.float32).tiny


def round_operand(t: torch.Tensor, precision: str):
    """``(values, scale)``: ``t`` rounded to ``precision`` (round to
    nearest), as values whose products are exact in f32, and the factor
    that multiplies a product of them back (fp8 takes one scale for the
    whole tensor, from its largest magnitude)."""
    if precision == "exact":
        return t, 1.0
    if precision == "bfloat16":
        return t.to(torch.bfloat16), 1.0
    if precision == "tf32":
        bits = t.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32), 1.0
    if precision == "fp8_e4m3":
        amax = float(t.float().abs().max())
        scale = amax / _E4M3_MAX if amax > 0 else 1.0
        v = (t.float() / scale).to(torch.float8_e4m3fn).to(torch.bfloat16)
        return v, scale
    raise ValueError(f"unknown precision {precision!r}")


def _cross(xr, xs, cr, cs, accumulate: str) -> torch.Tensor:
    """``p(x)·p(c)ᵀ`` of rounded operands (``round_operand``'s pairs): in
    f64 (``"f64"``), or with f32 accumulation (``"f32"``; products of the
    rounded operands are exact in f32)."""
    if accumulate == "f64":
        out = xr.double() @ cr.double().T
    elif xr.is_cuda and xr.dtype == torch.bfloat16 == cr.dtype:
        out = torch.mm(xr, cr.T, out_dtype=torch.float32)
    else:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = xr.float() @ cr.float().T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return out if xs * cs == 1.0 else out * (xs * cs)


def _chunks(n: int):
    for s in range(0, n, CHUNK_ROWS):
        yield s, min(n, s + CHUNK_ROWS)


def _gumbel(n: int, gen: torch.Generator, device) -> torch.Tensor:
    e = torch.empty(n, dtype=torch.float32, device=device)
    e.exponential_(generator=gen)
    return -torch.log(e.clamp_min_(_TINY))


def _exact_d2(xc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact squared distances of rows ``xc`` to rows ``c`` (f64)."""
    x64, c64 = xc.double(), c.double()
    d2 = ((x64 * x64).sum(1, keepdim=True) - 2.0 * (x64 @ c64.T)
          + (c64 * c64).sum(1)[None, :])
    return d2.clamp_min_(0.0)


def judge_seeding(x: torch.Tensor, seeds: torch.Tensor, seed: int) -> dict:
    """Judge a k-means++ seeding: the centres ``seeds`` (k, d) a fit seeded
    with ``seed`` chose from rows ``x``.

    Each round is judged from the fit's own earlier centres (the replay
    follows the fit round by round).  The round's gap is how far, in
    log-score, the row the fit chose lies below the best row of the exact
    distribution with the same Gumbel draws (0 where it is the best); a
    centre that is no row of ``x`` has an infinite gap.  A fit whose D²
    carries the rounding of f32 sums (products exact, or rounded to f32)
    can pick a row below the best by no more than the two rows' rounding
    bounds: ``(d + 3)·u·(||x_r|| + R)² / D²_r + 4u·(|log D²_r| + |G_r|)``
    for each of the two rows r, u = 2⁻²⁴, R the largest row norm.  So
    ``seed_gap`` is the largest gap over that sum of bounds (0 where every
    pick is the best; at most 1 where the picks are the exact draw to the
    rounding the configuration states).  Also ``seed_gap_raw``, the
    largest gap itself, ``rounds_off`` and ``not_rows``."""
    n, d = x.shape
    k = seeds.shape[0]
    dev = x.device
    u = 2.0 ** -24
    running = torch.empty(k, n, dtype=torch.float64, device=dev)
    norms = torch.empty(n, dtype=torch.float64, device=dev)
    best = torch.full((k,), math.inf, dtype=torch.float64, device=dev)
    pick = torch.zeros(k, dtype=torch.int64, device=dev)
    for s, e in _chunks(n):
        d2 = _exact_d2(x[s:e], seeds)
        m, i = d2.min(0)
        take = m < best
        best = torch.where(take, m, best)
        pick = torch.where(take, i + s, pick)
        running[:, s:e] = d2.cummin(1).values.T
        norms[s:e] = x[s:e].double().norm(dim=1)
        del d2
    same = (x[pick].float() == seeds.float()).all(1)
    big = norms.max()
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    gaps = torch.empty(k, dtype=torch.float64, device=dev)
    ratios = torch.empty(k, dtype=torch.float64, device=dev)
    for i in range(k):
        g = _gumbel(n, gen, dev).double()
        rows = torch.stack([torch.argmax(g if not i else
                                         g + torch.log(running[i - 1])),
                            pick[i]])
        bound = 4 * u * g[rows].abs()
        if i:
            d2r = running[i - 1][rows]
            bound = bound + ((d + 3) * u * (norms[rows] + big) ** 2 / d2r
                             + 4 * u * torch.log(d2r).abs())
            score = g[rows] + torch.log(d2r)
        else:
            score = g[rows]
        gaps[i] = score[0] - score[1]
        ratios[i] = gaps[i] / bound.sum()
    gaps = torch.where(same, gaps, math.inf)
    ratios = torch.where(same, ratios, math.inf)
    del running
    return {"seed_gap": float(ratios.max()),
            "seed_gap_raw": float(gaps.max()),
            "rounds_off": int((gaps > 0).sum()),
            "not_rows": int((~same).sum())}


def judge_final(x: torch.Tensor, centroids: torch.Tensor,
                labels: torch.Tensor, inertia: float, precision: str,
                tie: float = 0.0,
                prev: Optional[torch.Tensor] = None) -> dict:
    """Judge a fit's final state against exact scores at its own final
    centroids, with the products in ``precision`` (the configuration's).

    * ``label_gap``: the widest gap by which a row's label scores above the
      row's best, over ``||x||² + ||c_best||²``;
    * ``next_shift_sq``: the squared shift, summed over the centroids, of
      one more Lloyd step from the final centroids: each centroid to the
      mean of its rows (a centroid with no rows keeps its place), the sum a
      fit's convergence test holds to ``tol``.  A row counts for the
      fit's label where that label's gap is at most ``tie`` (the rounding
      a label is allowed, on ``label_gap``'s scale), else for its best:
      a row tied to the rounding must not read as a wrong step;
    * ``inertia_rel``: the inertia's relative error against the sum of the
      rows' best ``d²``;
    * with ``prev``, the centroids the fit's last sweep began at,
      ``last_step_sq``: the squared gap, summed over the centroids, between
      ``centroids`` and one Lloyd step from ``prev`` (every row at its best
      centroid of ``prev``, each centroid the mean of its rows, one with no
      rows kept): what the last sweep should have made, whether or not the
      fit converged.  A row whose two best centroids of ``prev`` lie within
      ``tie`` (on ``label_gap``'s scale) may count for either: each
      centroid's gap is the least over the ways its tied rows can fall
      (up to :data:`MAX_TIED` of them; beyond, they fall as exact).
    Also ``labels_off``, the rows whose label is not their best."""
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    c = centroids.float()
    cr, cs = round_operand(c, precision)
    c_sq = (c.double() ** 2).sum(1)
    sums = torch.zeros(k, d, dtype=torch.float64, device=dev)
    counts = torch.zeros(k, dtype=torch.float64, device=dev)
    gap = torch.zeros((), dtype=torch.float64, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    lab = labels.long()
    if prev is not None:
        p = prev.float()
        pr, ps = round_operand(p, precision)
        p_sq = (p.double() ** 2).sum(1)
        p_sums = torch.zeros(k, d, dtype=torch.float64, device=dev)
        p_counts = torch.zeros(k, dtype=torch.float64, device=dev)
        tied = []
    for s, e in _chunks(n):
        xc = x[s:e]
        x64 = xc.double()
        x_sq = (x64 * x64).sum(1)
        xr, xs = round_operand(xc, precision)
        d2 = (x_sq[:, None] + c_sq[None, :]
              - 2.0 * _cross(xr, xs, cr, cs, "f64")).clamp_min_(0.0)
        m, best = d2.min(1)
        mine = d2.gather(1, lab[s:e, None])[:, 0]
        rel = (mine - m) / (x_sq + c_sq[best])
        gap = torch.maximum(gap, rel.max())
        off += (lab[s:e] != best).sum()
        total += m.sum()
        use = torch.where(rel <= tie, lab[s:e], best)
        sums.index_add_(0, use, x64)
        counts += torch.bincount(use, minlength=k).double()
        del d2
        if prev is not None:
            score = p_sq[None, :] - 2.0 * _cross(xr, xs, pr, ps, "f64")
            two = score.topk(min(2, k), dim=1, largest=False)
            near = two.indices[:, 0]
            p_sums.index_add_(0, near, x64)
            p_counts += torch.bincount(near, minlength=k).double()
            if k > 1 and tie > 0:
                rel2 = ((two.values[:, 1] - two.values[:, 0])
                        / (x_sq + p_sq[near]))
                t = (rel2 <= tie).nonzero()[:, 0]
                if t.numel():
                    tied.append((x64[t], near[t], two.indices[t, 1]))
            del score
        del x64
    means = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1.0)[:, None], c.double())
    tot = float(total)
    out = {"label_gap": float(gap),
           "next_shift_sq": float(((means - c.double()) ** 2).sum()),
           "inertia_rel": (abs(float(inertia) - tot) / tot if tot > 0
                           else math.inf),
           "labels_off": int(off)}
    if prev is not None:
        step = torch.where(p_counts[:, None] > 0,
                           p_sums / p_counts.clamp_min(1.0)[:, None],
                           p.double())
        per = ((step - c.double()) ** 2).sum(1)
        _excuse_ties(per, tied, p_sums, p_counts, p.double(), c.double())
        out["last_step_sq"] = float(per.sum())
    return out


#: Tied rows a centroid's last-step gap is searched over (2**MAX_TIED ways).
MAX_TIED = 6


def _excuse_ties(per, tied, sums, counts, prev, c):
    """Lower ``per[j]``, centroid j's squared gap to its exact step, to the
    least over the ways its tied rows can fall: each may leave its best
    centroid for its second, or join the second from the best."""
    moves = {}
    for rows, best, second in tied:
        for r in range(rows.shape[0]):
            b, s2 = int(best[r]), int(second[r])
            moves.setdefault(b, []).append((-1.0, rows[r]))
            moves.setdefault(s2, []).append((1.0, rows[r]))
    for j, mv in moves.items():
        if len(mv) > MAX_TIED:
            continue
        for ways in itertools.product((0, 1), repeat=len(mv)):
            tot, cnt = sums[j].clone(), float(counts[j])
            for on, (sign, row) in zip(ways, mv):
                if on:
                    tot += sign * row
                    cnt += sign
            mean = tot / cnt if cnt > 0 else prev[j]
            per[j] = torch.minimum(per[j], ((mean - c[j]) ** 2).sum())


def _assign(x, xr_chunks, c, precision, accumulate):
    """Labels and best d² of every row at centroids ``c``."""
    n = x.shape[0]
    cr, cs = round_operand(c, precision)
    c_sq = (c.double() ** 2).sum(1)
    labels = torch.empty(n, dtype=torch.int64, device=x.device)
    mind = torch.empty(n, dtype=torch.float64, device=x.device)
    for (s, e), (xr, xs) in zip(_chunks(n), xr_chunks):
        x64 = x[s:e].double()
        x_sq = (x64 * x64).sum(1)
        d2 = (x_sq[:, None] + c_sq[None, :]
              - 2.0 * _cross(xr, xs, cr, cs, accumulate).double())
        m, lab = d2.clamp_min_(0.0).min(1)
        labels[s:e], mind[s:e] = lab, m
    return labels, mind


def fit(x: torch.Tensor, k: int, *, seed: int,
        init: Optional[torch.Tensor] = None, precision: str = "exact",
        max_iter: int = 100, tol: float = 1e-4) -> dict:
    """A whole plain fit: k-means++ from ``seed`` (or ``init``), then Lloyd
    sweeps (labels at the nearest centroid, each centroid the mean of its
    rows, an empty one kept) until the squared shift of all centroids is
    at most ``tol`` or ``max_iter`` sweeps ran, then the final labels and
    inertia.  Products in ``precision``, accumulated in f32 on the card
    (products of the rounded operands are exact there, and a fit at the
    cells' sizes stays short) and in f64 elsewhere.  Returns ``{"seeds",
    "prev", "centroids", "labels", "inertia", "n_iter", "converged"}``
    (``prev``: the centroids the last sweep began at)."""
    n, d = x.shape
    dev = x.device
    accumulate = "f32" if x.is_cuda else "f64"
    rounded = [round_operand(x[s:e], precision) for s, e in _chunks(n)]
    seeds = None
    if init is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        x_sq = torch.cat([(x[s:e].double() ** 2).sum(1)
                          for s, e in _chunks(n)])
        seeds = torch.zeros(k, d, dtype=torch.float32, device=dev)
        d2 = None
        for i in range(k):
            g = _gumbel(n, gen, dev).double()
            score = g if d2 is None else torch.log(d2) + g
            idx = torch.argmax(score)
            seeds[i] = x[idx].float()
            cr, cs = round_operand(seeds[i:i + 1], precision)
            cross = torch.cat([_cross(xr, xs, cr, cs, accumulate)[:, 0]
                               for xr, xs in rounded]).double()
            near = (x_sq - 2.0 * cross
                    + (seeds[i].double() ** 2).sum()).clamp_min_(0.0)
            d2 = near if d2 is None else torch.minimum(d2, near)
        c = seeds.clone()
    else:
        c = init.float().clone()
    it, converged, prev = 0, False, None
    while it < max_iter and not converged:
        labels, _ = _assign(x, rounded, c, precision, accumulate)
        sums = torch.zeros(k, d, dtype=torch.float64, device=dev)
        for s, e in _chunks(n):
            sums.index_add_(0, labels[s:e], x[s:e].double())
        counts = torch.bincount(labels, minlength=k).double()
        new_c = torch.where(counts[:, None] > 0,
                            sums / counts.clamp_min(1.0)[:, None],
                            c.double()).float()
        shift = float(((new_c - c).double() ** 2).sum())
        prev, c = c, new_c
        it += 1
        converged = shift <= tol
    labels, mind = _assign(x, rounded, c, precision, accumulate)
    return {"seeds": seeds, "prev": prev, "centroids": c,
            "labels": labels.int(), "inertia": float(mind.sum()),
            "n_iter": it, "converged": converged}
