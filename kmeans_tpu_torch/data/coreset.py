"""Lightweight coresets (Bachem, Lucic & Krause, KDD 2018).

Counterpart of ``kmeans_tpu/data/coreset.py``.  One cheap pass over the
data gives a small weighted subset whose weighted k-means cost approximates
the full data's, so a weighted fit (``fit_lloyd``,
``fit_lloyd_accelerated``) runs on m ≪ n points.  A point's sampling
probability is its input weight times the lightweight sensitivity

    q(x) = 1/(2n) + d(x, μ)² / (2 Σᵢ d(xᵢ, μ)²)

(μ the weighted mean); the m draws are i.i.d. with probability q and each
carries w/(m·q), an unbiased cost estimator.  d(x, μ)² is
:func:`~kmeans_tpu_torch.ops.distance.assign` against the one centroid μ:
K1 at k = 1 on the card.  The draws come from a :class:`torch.Generator`
(:func:`draw_indices`: q's CDF at uniform draws), where the reference
draws with ``jax.random.choice``; the probabilities, points and weights
follow from them as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kmeans_tpu_torch.data.synthetic import generator_for
from kmeans_tpu_torch.device import as_tensor, resolve_device

__all__ = ["lightweight_coreset", "coreset_probabilities", "draw_indices"]

#: The fixed-point scale of :func:`draw_indices`' CDF.
_CDF_SCALE = 2.0 ** 40


def coreset_probabilities(x: torch.Tensor, w: torch.Tensor, *,
                          chunk_size: int = 4096,
                          compute_dtype=None) -> torch.Tensor:
    """The sampling distribution q (n,) f32 of :func:`lightweight_coreset`
    for points ``x`` with input weights ``w``, on their device."""
    from kmeans_tpu_torch.ops.distance import assign

    w_total = torch.clamp_min(w.sum(), 1e-30)
    mu = (w[:, None] * x.float()).sum(0) / w_total
    # d(x, μ)² for every row: the fused pass with one centroid.
    _, d2 = assign(x, mu[None], chunk_size=chunk_size,
                   compute_dtype=compute_dtype, device=x.device)
    mass = torch.clamp_min((w * d2).sum(), 1e-30)
    # Σ w·(1/(2·w_total) + d2/(2·mass)) = 1 analytically; the
    # renormalization only mops up float rounding.
    q = w * (0.5 / w_total + 0.5 * d2 / mass)
    return q / q.sum()


def draw_indices(q: torch.Tensor, m: int, generator) -> torch.Tensor:
    """``m`` i.i.d. draws from ``range(len(q))`` with probabilities ``q``
    (summing to 1): q's CDF, inverted at ``m`` uniforms from
    ``generator``.  The CDF is summed in int64 fixed point (q in units of
    2⁻⁴⁰), so every summation order gives the same bits and a seed the
    same draws on every run; ``torch.multinomial`` sums a float CDF, which
    on the card varies from run to run in its last bits.  Rows with q <
    2⁻⁴¹ are never drawn."""
    ticks = torch.round(q.double() * _CDF_SCALE).long()
    cdf = torch.cumsum(ticks, 0)
    u = torch.rand(m, generator=generator, dtype=torch.float64,
                   device=q.device)
    return torch.searchsorted(cdf, (u * cdf[-1]).long(), right=True)


def lightweight_coreset(
    generator,
    x,
    m: int,
    *,
    weights=None,
    chunk_size: int = 4096,
    compute_dtype=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw an m-point lightweight coreset of ``x`` on ``device`` (None is
    the card).

    ``generator`` is a :class:`torch.Generator` on ``device`` or a seed;
    sampling is with replacement (``m > n`` is legal).  ``weights``: (n,)
    nonnegative input weights (the coreset of a weighted set, e.g. a
    compacted window, multiplies them into the sensitivity).  Returns
    ``(points (m, d) in x's dtype, weights (m,) f32)``, the weights summing
    to the input's total in expectation.
    """
    if m < 1:
        raise ValueError(f"coreset size must be >= 1, got {m}")
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    n = x.shape[0]
    w = (torch.ones(n, dtype=torch.float32, device=dev) if weights is None
         else as_tensor(weights, dev, torch.float32))
    q = coreset_probabilities(x, w, chunk_size=chunk_size,
                              compute_dtype=compute_dtype)
    idx = draw_indices(q, m, generator_for(generator, dev))
    # Importance weights: each draw carries w/(m·q), so the weighted cost of
    # the draws estimates the full weighted cost without bias.
    cw = w[idx] / (m * torch.clamp_min(q[idx], 1e-30))
    return x[idx], cw.float()
