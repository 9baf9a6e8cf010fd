"""Model selection: sweep k, score each fit, suggest a k.

Counterpart of ``kmeans_tpu/models/selection.py``: fit a range of k, report
inertia (the elbow curve) and the internal quality metrics of
:mod:`kmeans_tpu_torch.metrics`, and suggest the k with the best
silhouette (or, for a GMM sweep, the lowest BIC / AIC); or the gap
statistic against uniform reference sets.

The draws — each fit's seeding, each silhouette sample, each gap reference
set — come from one :class:`torch.Generator` (default: seeded with
``seed``, as the reference seeds its key), in the order the reference
folds its key: fit i, then its silhouette sample, for each k in turn.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device

__all__ = ["sweep_k", "suggest_k", "gap_statistic", "suggest_k_gap"]

_FITTERS = {
    "lloyd": "fit_lloyd",
    "accelerated": "fit_lloyd_accelerated",
    "minibatch": "fit_minibatch",
    "spherical": "fit_spherical",
    "bisecting": "fit_bisecting",
    "fuzzy": "fit_fuzzy",
    "gmm": "fit_gmm",
    "kernel": "fit_kernel_kmeans",
    "kmedoids": "fit_kmedoids",
    "balanced": "fit_balanced",
    "spectral": "fit_spectral",   # center-free: silhouette-only rows
    # trimmed is deliberately absent: its -1 outlier labels would poison
    # the label-based scores, and the trim budget changes meaning with k.
}


def _check_k_range(ks, n):
    """Validate the whole range up front: a bad k must fail before any fit
    burns compute (shared by sweep_k and gap_statistic)."""
    for k in ks:
        if k < 1 or k > n:
            raise ValueError(f"k={k} out of range for n={n}")


def _sweep_config(k, *, init, max_iter, tol, seed, chunk_size,
                  compute_dtype):
    """One KMeansConfig recipe for every selection fit."""
    return KMeansConfig(
        k=int(k), init=init, max_iter=max_iter, tol=tol, seed=seed,
        chunk_size=chunk_size, compute_dtype=compute_dtype,
    )


def sweep_k(
    x,
    ks: Sequence[int],
    *,
    model: str = "lloyd",
    generator: Optional[torch.Generator] = None,
    max_iter: int = 100,
    tol: float = 1e-4,
    chunk_size: int = 4096,
    compute_dtype=None,
    init: str = "k-means++",
    silhouette_sample: int = 10_000,
    seed: int = 0,
    device=None,
) -> List[Dict]:
    """Fit ``model`` for every k in ``ks`` on ``device`` (None is the card);
    return one scored row per k.

    Rows carry ``{k, inertia, n_iter, converged, silhouette,
    davies_bouldin, calinski_harabasz}`` ("inertia" is each family's
    lower-is-better objective via
    :func:`kmeans_tpu_torch.models.state_objective`; the scores need k ≥
    2, and the two center-based ones are absent for the center-free
    families: ``kernel`` and ``spectral`` rows carry silhouette only).
    GMM rows also carry ``bic`` / ``aic`` (the diag-covariance parameter
    count), for ``suggest_k(rows, criterion="bic")``.  Silhouette is the
    chunked, sampled implementation, scored in the space the family
    clustered in: spectral rows in their Laplacian embedding.  Avoid
    ``criterion="elbow"`` on spectral rows (each row's objective lives in
    another embedding)."""
    import math

    import kmeans_tpu_torch.models as models
    from kmeans_tpu_torch.data.synthetic import generator_for
    from kmeans_tpu_torch.metrics import dispersion_scores, silhouette_score

    if model not in _FITTERS:
        raise ValueError(
            f"unknown model {model!r}; have {sorted(_FITTERS)}"
        )
    fit = getattr(models, _FITTERS[model])
    dev = resolve_device(device)
    gen = generator_for(seed if generator is None else generator, dev)

    x = as_tensor(x, dev)
    _check_k_range(ks, x.shape[0])
    rows: List[Dict] = []
    for k in ks:
        cfg = _sweep_config(k, init=init, max_iter=max_iter, tol=tol,
                            seed=seed, chunk_size=chunk_size,
                            compute_dtype=compute_dtype)
        state = fit(x, int(k), generator=gen, config=cfg, device=dev)
        row = {
            "k": int(k),
            "inertia": models.state_objective(state),
            "n_iter": int(state.n_iter),
            "converged": bool(state.converged),
        }
        if model == "gmm":
            # Diag covariance (the fit default): k·d means + k·d variances
            # + (k-1) mixing weights.
            n, d = x.shape
            p = 2 * int(k) * d + (int(k) - 1)
            ll = float(state.log_likelihood)
            row["bic"] = -2.0 * ll + p * math.log(n)
            row["aic"] = -2.0 * ll + 2 * p
        if k >= 2:
            # Scored in the family's own geometry: spectral labels mean
            # something in the Laplacian embedding, not in raw x.
            x_score = getattr(state, "embedding", None)
            row["silhouette"] = float(silhouette_score(
                x if x_score is None else x_score, state.labels, k=int(k),
                sample_size=silhouette_sample, generator=gen,
                chunk_size=chunk_size, device=dev))
            centers = models.state_centers(state)
            if centers is not None:
                db, ch = dispersion_scores(x, state.labels, centers,
                                           chunk_size=chunk_size, device=dev)
                row["davies_bouldin"] = float(db)
                row["calinski_harabasz"] = float(ch)
        rows.append(row)
    return rows


def suggest_k(rows: List[Dict], *, criterion: str = "silhouette") -> int:
    """The best k among scored rows.

    ``criterion="silhouette"`` (default) picks the highest silhouette;
    ``"bic"`` / ``"aic"`` the lowest information criterion (rows of a GMM
    sweep); ``"elbow"`` the objective kneedle read of the inertia curve."""
    if criterion == "silhouette":
        scored = [r for r in rows if "silhouette" in r]
        if not scored:
            raise ValueError("no rows with k >= 2 to choose among")
        return max(scored, key=lambda r: r["silhouette"])["k"]
    if criterion in ("bic", "aic"):
        scored = [r for r in rows if criterion in r]
        if not scored:
            raise ValueError(
                f"no rows carry {criterion!r} — sweep with model='gmm'"
            )
        return min(scored, key=lambda r: r[criterion])["k"]
    if criterion == "elbow":
        return _elbow_k(rows)
    raise ValueError(f"unknown criterion {criterion!r}")


def _elbow_k(rows: List[Dict]) -> int:
    """The elbow read, made objective (kneedle, Satopää et al. 2011):
    normalize the (k, objective) curve to the unit square and pick the k
    farthest below the chord from the first to the last point; on a log
    axis when every objective is positive.  Needs ≥ 3 rows."""
    import numpy as np

    rows = sorted(rows, key=lambda r: r["k"])
    if len(rows) < 3:
        raise ValueError("criterion='elbow' needs at least 3 swept k values")
    ks = np.asarray([r["k"] for r in rows], np.float64)
    inert = np.asarray([r["inertia"] for r in rows], np.float64)
    if (inert > 0).all():
        inert = np.log(inert)
    span = inert[0] - inert[-1]
    if span <= 0:
        # Flat or increasing objective: no elbow; the smallest k wins.
        return int(ks[0])
    t = (ks - ks[0]) / (ks[-1] - ks[0])
    y = (inert - inert[-1]) / span          # 1 at k_min .. 0 at k_max
    chord = 1.0 - t
    below = chord - y
    return int(ks[int(np.argmax(below))])


def uniform_rows(generator: torch.Generator, n: int, d: int,
                 device) -> torch.Tensor:
    """(n, d) f32 uniform on [0, 1): one gap reference set before its
    scaling to the data's bounding box (the reference's
    ``jax.random.uniform``)."""
    return torch.rand((n, d), generator=generator, device=device,
                      dtype=torch.float32)


def gap_statistic(
    x,
    ks: Sequence[int],
    *,
    n_refs: int = 10,
    generator: Optional[torch.Generator] = None,
    max_iter: int = 50,
    tol: float = 1e-4,
    chunk_size: int = 4096,
    compute_dtype=None,
    init: str = "k-means++",
    seed: int = 0,
    device=None,
) -> List[Dict]:
    """Gap statistic (Tibshirani, Walther & Hastie 2001) for choosing k, on
    ``device`` (None is the card).

    For each k: Gap(k) = E*[log W_k] − log W_k, W_k the fit's inertia and
    the expectation over ``n_refs`` reference datasets drawn uniformly from
    x's bounding box.  Rows carry ``{k, log_w, ref_log_w, gap, s}`` with s
    the standard error of the reference draws (√(1+1/B) included).  Pick
    with :func:`suggest_k_gap`."""
    import numpy as np

    import kmeans_tpu_torch.models as models
    from kmeans_tpu_torch.data.synthetic import generator_for

    if n_refs < 1:
        raise ValueError(f"n_refs must be >= 1, got {n_refs}")
    dev = resolve_device(device)
    gen = generator_for(seed if generator is None else generator, dev)
    x = as_tensor(x, dev)
    n, d = x.shape
    _check_k_range(ks, n)
    lo = x.amin(dim=0).float()
    hi = x.amax(dim=0).float()

    def fit_log_w(data, k):
        cfg = _sweep_config(k, init=init, max_iter=max_iter, tol=tol,
                            seed=seed, chunk_size=chunk_size,
                            compute_dtype=compute_dtype)
        st = models.fit_lloyd(data, int(k), generator=gen, config=cfg,
                              device=dev)
        return float(torch.log(st.inertia.clamp_min(1e-30)))

    rows: List[Dict] = []
    for k in ks:
        log_w = fit_log_w(x, k)
        ref_log_ws = []
        for _ in range(n_refs):
            ref = lo + (hi - lo) * uniform_rows(gen, n, d, dev)
            ref_log_ws.append(fit_log_w(ref.to(x.dtype), k))
        ref_mean = float(np.mean(ref_log_ws))
        sd = float(np.std(ref_log_ws))
        rows.append({
            "k": int(k),
            "log_w": log_w,
            "ref_log_w": ref_mean,
            "gap": ref_mean - log_w,
            "s": sd * float(np.sqrt(1.0 + 1.0 / n_refs)),
        })
    return rows


def suggest_k_gap(rows: List[Dict]) -> int:
    """Tibshirani's rule: the smallest k with Gap(k) ≥ Gap(k+1) − s_{k+1};
    the max-gap k when no k satisfies it."""
    rows = sorted(rows, key=lambda r: r["k"])
    if not rows:
        raise ValueError("no rows")
    for cur, nxt in zip(rows, rows[1:]):
        if cur["gap"] >= nxt["gap"] - nxt["s"]:
            return cur["k"]
    return max(rows, key=lambda r: r["gap"])["k"]
