"""Seeding on a data-parallel mesh: k-means||, k-means++ and random.

Counterpart of ``kmeans_tpu/parallel/init_sharded.py``.  Every O(n·d) step
runs on the rank's own rows, and only candidate-sized data crosses the
mesh:

* each Gumbel-max draw is a local argmax, then one ``all_gather`` of every
  rank's (value, row) pair; the highest value wins, the lowest global row
  on a tie (rows are sharded contiguously, so rank order is row order);
* each k-means|| round keeps the local top ``ell`` scores, gathers the
  (dp, ell) scores and candidate rows, and takes the global top ``ell``
  from them (the global top ``ell`` always lies in the union of the local
  ones), in a stable descending sort;
* the candidate weights are a local fold and one all-reduce.

Draw parity: the port's single-device seeding draws one Gumbel per row from
its ``torch.Generator`` (:mod:`kmeans_tpu_torch.models.init`).  Here every
rank draws the same full n-row stream from its own copy of the generator
and keeps its rows, so the sharded seeding returns the single-device
centroids for the same generator state, on any mesh size, and leaves each
rank's generator where the single-device seeding leaves it.  Padding rows
carry weight 0 (``log w = −inf``) and are never drawn.
"""

from __future__ import annotations

from typing import Optional

import torch

from kmeans_tpu_torch.models.init import _d2_to, _gumbel, _kmpar_plan
from kmeans_tpu_torch.ops.distance import resolve_cd, sq_norms
from kmeans_tpu_torch.ops.segment import segment_sum
from kmeans_tpu_torch.ops.select import top_stable

__all__ = ["kmeans_parallel_sharded", "kmeans_plus_plus_sharded",
           "random_init_sharded", "sharded_init_applicable", "init_on_mesh"]


def sharded_init_applicable(x, k: int, *, mesh, data_axis: str) -> bool:
    """Structural gate: ``x`` is this rank's 2-D row block and the mesh
    shards rows over ``data_axis`` only."""
    if getattr(x, "ndim", 0) != 2 or data_axis not in mesh.axis_sizes:
        return False
    return all(s == 1 for a, s in mesh.axis_sizes.items() if a != data_axis)


def _local_stream(g: torch.Tensor, lo: int, n_loc: int) -> torch.Tensor:
    """Rows ``[lo, lo + n_loc)`` of the full n-row draw ``g``; padding rows
    past n read 0 (their ``log w`` is −inf)."""
    part = g[lo:lo + n_loc]
    if part.shape[0] < n_loc:
        part = torch.cat([part, part.new_zeros(n_loc - part.shape[0])])
    return part


def _local_weights(weights, n: int, lo: int, n_loc: int, dev):
    """The rank's f32 weights: the given ones, or 1 on real rows and 0 on
    padding rows."""
    if weights is not None:
        return weights.to(dev, torch.float32)
    gidx = lo + torch.arange(n_loc, device=dev)
    return (gidx < n).to(torch.float32)


def _global_argmax_row(mesh, score: torch.Tensor, x_loc: torch.Tensor):
    """The row of the global argmax of ``score`` over the mesh, f32 (d,):
    one all-gather of each rank's (best value, its row)."""
    li = torch.argmax(score)
    packed = torch.cat([score[li].view(1).float(),
                        x_loc.index_select(0, li.view(1))[0].float()])
    allp = mesh.all_gather(packed[None])          # (dp, d + 1)
    win = torch.argmax(allp[:, 0])                # first max: lowest rank
    return allp.index_select(0, win.view(1))[0, 1:]


def kmeans_plus_plus_sharded(generator: torch.Generator, x_loc, k: int, *,
                             mesh, n: Optional[int] = None, weights=None,
                             compute_dtype=None) -> torch.Tensor:
    """k-means++ on the rank's rows ``x_loc`` (padded row block; ``n`` real
    rows in all, default every row of every block): the single-device
    :func:`~kmeans_tpu_torch.models.init.kmeans_plus_plus` draws, one
    all-gather of (d + 1) floats a rank per centre."""
    dev = x_loc.device
    n_loc, d = x_loc.shape
    n = n_loc * mesh.size if n is None else n
    lo = mesh.rank * n_loc
    cd = resolve_cd(compute_dtype, x_loc.dtype)
    w = _local_weights(weights, n, lo, n_loc, dev)
    logw = torch.log(w)
    x_sq = sq_norms(x_loc)
    centroids = torch.zeros(k, d, dtype=torch.float32, device=dev)
    centroids[0] = _global_argmax_row(
        mesh, logw + _local_stream(_gumbel(n, generator, dev), lo, n_loc),
        x_loc)
    d2 = _d2_to(x_loc, x_sq, centroids[0], cd)
    for i in range(1, k):
        g = _local_stream(_gumbel(n, generator, dev), lo, n_loc)
        centroids[i] = _global_argmax_row(mesh, torch.log(w * d2) + g, x_loc)
        d2 = torch.minimum(d2, _d2_to(x_loc, x_sq, centroids[i], cd))
    return centroids


def random_init_sharded(generator: torch.Generator, x_loc, k: int, *, mesh,
                        n: Optional[int] = None,
                        weights=None) -> torch.Tensor:
    """:func:`~kmeans_tpu_torch.models.init.random_init`'s rows: the same
    draw over the n global rows, each row sent by its owner (one masked
    all-reduce of (k, d))."""
    dev = x_loc.device
    n_loc, d = x_loc.shape
    n = n_loc * mesh.size if n is None else n
    lo = mesh.rank * n_loc
    if weights is None:
        idx = torch.randperm(n, generator=generator, device=dev)[:k]
    else:
        w_all = mesh.all_gather(weights.to(dev, torch.float32))[:n]
        idx = torch.multinomial(w_all, k, replacement=False,
                                generator=generator)
    mine = (idx >= lo) & (idx < lo + n_loc)
    rows = x_loc[(idx - lo).clamp(0, n_loc - 1)].float()
    return mesh.all_reduce(torch.where(mine[:, None], rows, 0.0))


def kmeans_parallel_sharded(
    generator: torch.Generator,
    x_loc,
    k: int,
    *,
    mesh,
    data_axis: str = "data",
    n: Optional[int] = None,
    weights=None,
    rounds: int = 4,
    oversampling: Optional[int] = None,
    refine_iters: int = 25,
    chunk_size: int = 8192,
    compute_dtype=None,
) -> torch.Tensor:
    """k-means|| on the rank's rows, with the draws and the result of the
    single-device :func:`~kmeans_tpu_torch.models.init.kmeans_parallel`
    for the same generator state (see the module docstring).  ``weights``
    are the rank's (padding rows 0); the refine recluster runs on the
    replicated (m, d) candidate pool on every rank."""
    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.models.lloyd import fit_lloyd
    from kmeans_tpu_torch.ops.distance import assign

    dev = x_loc.device
    n_loc, d = x_loc.shape
    n = n_loc * mesh.size if n is None else n
    lo = mesh.rank * n_loc
    ell, m, fallback = _kmpar_plan(n, k, rounds, oversampling)
    if fallback:
        return kmeans_plus_plus_sharded(generator, x_loc, k, mesh=mesh, n=n,
                                        weights=weights,
                                        compute_dtype=compute_dtype)
    w = _local_weights(weights, n, lo, n_loc, dev)
    logw = torch.log(w)
    kw = dict(chunk_size=chunk_size, compute_dtype=compute_dtype, device=dev)
    c0 = _global_argmax_row(
        mesh, logw + _local_stream(_gumbel(n, generator, dev), lo, n_loc),
        x_loc)[None]
    _, d2 = assign(x_loc, c0, **kw)
    lk = min(ell, n_loc)
    cands = [c0]
    valids = [torch.ones(1, dtype=torch.bool, device=dev)]
    labels = torch.zeros(n_loc, dtype=torch.int64, device=dev)
    for r in range(rounds):
        g = _local_stream(_gumbel(n, generator, dev), lo, n_loc)
        score = logw + torch.log(d2) + g
        lv, lidx = top_stable(score, lk)
        packed = torch.cat([lv[:, None], x_loc[lidx].float()], dim=1)
        allp = mesh.all_gather(packed)                   # (dp·lk, d + 1)
        top, ti = top_stable(allp[:, 0], ell)
        cand = allp[ti, 1:]
        if cand.shape[0] < ell:    # fewer rows in all than ell: −inf picks
            pad = ell - cand.shape[0]
            top = torch.cat([top, top.new_full((pad,), -torch.inf)])
            cand = torch.cat([cand, cand.new_zeros(pad, d)])
        valid = top > -torch.inf
        cand = torch.where(valid[:, None], cand, cand[0])
        lab, mind = assign(x_loc, cand, **kw)
        cands.append(cand)
        valids.append(valid)
        labels = torch.where(mind < d2, 1 + r * ell + lab.long(), labels)
        d2 = torch.minimum(d2, mind)
    candidates = torch.cat(cands)
    cand_w = torch.where(torch.cat(valids),
                         mesh.all_reduce(segment_sum(w, labels, m)), 0.0)
    refine_cfg = KMeansConfig(
        k=k, init="k-means++", max_iter=refine_iters, empty="farthest",
        chunk_size=min(chunk_size, m), compute_dtype=compute_dtype,
    )
    state = fit_lloyd(candidates, k, generator=generator, config=refine_cfg,
                      weights=cand_w, device=dev)
    return state.centroids


def init_on_mesh(generator, x_loc, k: int, *, mesh, n: int, method: str,
                 weights=None, user_weights: bool = False, compute_dtype=None,
                 chunk_size=None) -> torch.Tensor:
    """The sharded fits' seeding router (the reference's
    ``_init_centroids_on_mesh``): ``method`` over the rank's rows.
    ``weights`` are the rank's weights (padding rows 0); ``user_weights``
    says whether the caller gave any (``random`` then draws by weight, as
    :func:`~kmeans_tpu_torch.models.init.random_init` does)."""
    if method == "k-means||":
        kw = {} if chunk_size is None else {"chunk_size": chunk_size}
        return kmeans_parallel_sharded(generator, x_loc, k, mesh=mesh, n=n,
                                       weights=weights,
                                       compute_dtype=compute_dtype, **kw)
    if method == "k-means++":
        return kmeans_plus_plus_sharded(generator, x_loc, k, mesh=mesh, n=n,
                                        weights=weights,
                                        compute_dtype=compute_dtype)
    if method == "random":
        return random_init_sharded(generator, x_loc, k, mesh=mesh, n=n,
                                   weights=weights if user_weights else None)
    raise ValueError(f"unknown init method {method!r}")
