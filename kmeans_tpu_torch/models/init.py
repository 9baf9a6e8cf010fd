"""Centroid initialization: random subset, k-means++ and k-means||.

Counterpart of ``kmeans_tpu/models/init.py``.  Every draw takes an explicit
:class:`torch.Generator` on the data's device.  k-means++ keeps the
reference's Gumbel-max form (``argmax(log(w·D²) + Gumbel)``, an exact
categorical draw); its noise is torch's, not ``jax.random``'s, so a fit is
held against the reference from an explicit ``init`` array.
"""

from __future__ import annotations

from typing import Optional

import torch

from kmeans_tpu_torch.data.synthetic import generator_for
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.ops.distance import full_f32, resolve_cd, sq_norms
from kmeans_tpu_torch.ops.segment import segment_sum
from kmeans_tpu_torch.ops.select import top_stable

__all__ = ["random_init", "kmeans_plus_plus", "kmeans_parallel",
           "init_centroids", "resolve_fit_config", "resolve_fit_inputs",
           "host_subsample_seed"]


def _gumbel(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """n standard Gumbel draws, ``−log(E)`` with E ~ Exp(1) kept above 0."""
    e = torch.empty(n, dtype=torch.float32, device=device)
    e.exponential_(generator=generator)
    return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` (a 0-d device tensor) of x as f32, without a host sync."""
    return x.index_select(0, idx.view(1))[0].float()


def _d2_to(x: torch.Tensor, x_sq: torch.Tensor, c: torch.Tensor,
           cd: torch.dtype) -> torch.Tensor:
    """``max(||x||² − 2·x·c + ||c||², 0)`` with the product in ``cd``
    (exact bf16 products, f32 accumulation and output)."""
    cv = c.to(cd)[:, None]
    if x.is_cuda and cd == torch.bfloat16:
        prod = torch.mm(x.to(cd), cv, out_dtype=torch.float32)[:, 0]
    else:
        with full_f32():
            prod = (x.to(cd).float() @ cv.float())[:, 0]
    return (x_sq - 2.0 * prod + (c * c).sum()).clamp_min(0.0)


def random_init(generator: torch.Generator, x: torch.Tensor, k: int, *,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k distinct rows of x, uniformly (weights bias the draw if given)."""
    n = x.shape[0]
    if weights is None:
        idx = torch.randperm(n, generator=generator, device=x.device)[:k]
    else:
        idx = torch.multinomial(weights.float(), k, replacement=False,
                                generator=generator)
    return x[idx].float()


def kmeans_plus_plus(generator, x, k: int, *,
                     weights: Optional[torch.Tensor] = None,
                     compute_dtype=None, device=None) -> torch.Tensor:
    """k-means++ seeding by exact D²-categorical sampling via Gumbel-max:
    k rounds, each one (n, d)·(d,) product in the compute dtype.
    ``generator`` is a :class:`torch.Generator` on ``device`` (None is the
    card) or a seed."""
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    generator = generator_for(generator, dev)
    n, d = x.shape
    cd = resolve_cd(compute_dtype, x.dtype)
    w = (torch.ones(n, dtype=torch.float32, device=dev) if weights is None
         else weights.float())
    x_sq = sq_norms(x)
    # First centre ∝ weights, so zero-weight rows are never chosen.
    first = torch.argmax(torch.log(w) + _gumbel(n, generator, dev))
    centroids = torch.zeros(k, d, dtype=torch.float32, device=dev)
    centroids[0] = _row(x, first)
    d2 = _d2_to(x, x_sq, centroids[0], cd)
    for i in range(1, k):
        # P(idx) ∝ w·D²; log(0) = −inf excludes already-chosen points.
        idx = torch.argmax(torch.log(w * d2) + _gumbel(n, generator, dev))
        centroids[i] = _row(x, idx)
        d2 = torch.minimum(d2, _d2_to(x, x_sq, centroids[i], cd))
    return centroids


def _kmpar_plan(n: int, k: int, rounds: int, oversampling):
    """``(ell, m, use_fallback)``: the reference's k-means|| sampling plan."""
    ell = int(oversampling) if oversampling is not None else min(k, n)
    m = 1 + rounds * ell
    if not (2 * m >= n) and m < k:
        raise ValueError(
            f"candidate pool 1 + rounds*oversampling = {m} < k = {k}; "
            f"raise rounds/oversampling"
        )
    return ell, m, 2 * m >= n


def kmeans_parallel(generator: torch.Generator, x: torch.Tensor, k: int, *,
                    weights: Optional[torch.Tensor] = None, rounds: int = 4,
                    oversampling: Optional[int] = None,
                    refine_iters: int = 25, chunk_size: int = 8192,
                    compute_dtype=None) -> torch.Tensor:
    """k-means|| seeding (Bahmani et al., VLDB 2012): ``rounds`` rounds each
    draw ``ell`` candidates without replacement with P ∝ w·D² (Gumbel
    top-ell), then the weighted candidate pool is reclustered to k with
    k-means++ and Lloyd (``empty="farthest"``).  Falls back to exact
    :func:`kmeans_plus_plus` when the pool would reach n."""
    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.models.lloyd import fit_lloyd
    from kmeans_tpu_torch.ops.distance import assign

    n, d = x.shape
    dev = x.device
    ell, m, fallback = _kmpar_plan(n, k, rounds, oversampling)
    if fallback:
        return kmeans_plus_plus(generator, x, k, weights=weights,
                                compute_dtype=compute_dtype, device=dev)
    w = (torch.ones(n, dtype=torch.float32, device=dev) if weights is None
         else weights.float())
    logw = torch.log(w)
    kw = dict(chunk_size=chunk_size, compute_dtype=compute_dtype, device=dev)
    first = torch.argmax(logw + _gumbel(n, generator, dev))
    c0 = _row(x, first)[None]
    _, d2 = assign(x, c0, **kw)
    cands = [c0]
    valids = [torch.ones(1, dtype=torch.bool, device=dev)]
    labels = torch.zeros(n, dtype=torch.int64, device=dev)
    for r in range(rounds):
        score = logw + torch.log(d2) + _gumbel(n, generator, dev)
        top, idx = top_stable(score, ell)
        cand = x[idx].float()
        # Picks past the eligible rows come back at −inf: replace them with
        # the round's top pick, which the lowest-index argmin always prefers.
        valid = top > -torch.inf
        cand = torch.where(valid[:, None], cand, cand[0])
        lab, mind = assign(x, cand, **kw)
        cands.append(cand)
        valids.append(valid)
        # Strict < keeps earlier candidates on ties, as one argmin over all
        # m candidates would.
        labels = torch.where(mind < d2, 1 + r * ell + lab.long(), labels)
        d2 = torch.minimum(d2, mind)
    candidates = torch.cat(cands)
    cand_w = torch.where(torch.cat(valids), segment_sum(w, labels, m), 0.0)
    refine_cfg = KMeansConfig(
        k=k, init="k-means++", max_iter=refine_iters, empty="farthest",
        chunk_size=min(chunk_size, m), compute_dtype=compute_dtype,
    )
    state = fit_lloyd(candidates, k, generator=generator, config=refine_cfg,
                      weights=cand_w, device=dev)
    return state.centroids


def init_centroids(generator: torch.Generator, x: torch.Tensor, k: int, *,
                   method: str = "k-means++",
                   weights: Optional[torch.Tensor] = None,
                   compute_dtype=None,
                   chunk_size: Optional[int] = None) -> torch.Tensor:
    if method == "k-means++":
        return kmeans_plus_plus(generator, x, k, weights=weights,
                                compute_dtype=compute_dtype, device=x.device)
    if method == "k-means||":
        kw = {} if chunk_size is None else {"chunk_size": chunk_size}
        return kmeans_parallel(generator, x, k, weights=weights,
                               compute_dtype=compute_dtype, **kw)
    if method == "random":
        return random_init(generator, x, k, weights=weights)
    raise ValueError(f"unknown init method {method!r}")


def resolve_fit_config(k, generator, config, device):
    """Config-vs-k consistency, k >= 1, and a generator on ``device`` from
    the config seed when none is given.  Returns ``(cfg, generator)``."""
    from kmeans_tpu_torch.config import KMeansConfig

    cfg = (config or KMeansConfig(k=k)).validate()
    if config is not None and config.k != k:
        raise ValueError(
            f"k={k} contradicts config.k={config.k}; pass matching values"
        )
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    gen = generator_for(cfg.seed if generator is None else generator, device)
    return cfg, gen


def resolve_fit_inputs(x, k, generator, config, init, weights):
    """Validated config, generator and float32 starting centroids: ``init``
    is a (k, d) array (shape-checked) or a method name.  Returns
    ``(cfg, generator, c0)``."""
    cfg, gen = resolve_fit_config(k, generator, config, x.device)
    if init is not None and not isinstance(init, str):
        c0 = as_tensor(init, x.device, torch.float32)
        if tuple(c0.shape) != (k, x.shape[1]):
            raise ValueError(
                f"init centroids shape {tuple(c0.shape)} != {(k, x.shape[1])}"
            )
    else:
        method = init if isinstance(init, str) else cfg.init
        if method == "given":
            raise ValueError("init='given' needs an explicit (k, d) array")
        c0 = init_centroids(
            gen, x, k, method=method, weights=weights,
            compute_dtype=cfg.compute_dtype, chunk_size=cfg.chunk_size,
        )
    return cfg, gen, c0


def host_subsample_seed(data, k, generator, cfg, init, *, host_seed,
                        device, return_sample=False):
    """The streamed fits' seeding: ``init`` resolved against host-resident
    ``data`` (an ndarray or memmap), as the reference's.

    An explicit (k, d) array is shape-checked before any read; otherwise
    the configured init method runs on ``device`` over a host-gathered
    subsample: ``min(n, max(64·k, 65536))`` distinct rows from
    ``np.random.default_rng(host_seed)``, sorted (a forward scan on a
    memmap), the reference's rows exactly.  The init method's own draws
    come from ``generator``.  Returns ``c0`` (k, d) float32 on ``device``,
    or ``(c0, subsample)`` with ``return_sample`` (the streamed GMM takes
    its starting variances from the subsample).
    """
    import numpy as np

    n, d = data.shape
    c0 = None
    if init is not None and not isinstance(init, str):
        c0 = as_tensor(init, device, torch.float32)
        if tuple(c0.shape) != (k, d):
            raise ValueError(
                f"init centroids shape {tuple(c0.shape)} != {(k, d)}")
        if not return_sample:
            return c0
    sub = min(n, max(4 * k * 16, 65536))
    rng = np.random.default_rng(host_seed)
    sidx = np.sort(rng.choice(n, size=sub, replace=False))
    xs = as_tensor(np.ascontiguousarray(data[sidx]), device)
    if c0 is None:
        method = init if isinstance(init, str) else cfg.init
        c0 = init_centroids(generator, xs, k, method=method,
                            compute_dtype=cfg.compute_dtype,
                            chunk_size=cfg.chunk_size)
    return (c0, xs) if return_sample else c0
