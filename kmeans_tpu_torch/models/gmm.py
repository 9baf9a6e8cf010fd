"""Gaussian mixture model via EM (diag / spherical / tied covariance).

Counterpart of ``kmeans_tpu/models/gmm.py``.  With a diagonal covariance
the E-step log-density

  log N(x | mu_j, sigma_j^2) = const_j + x . (mu_j/sigma_j^2)
                               - 0.5 * x^2 . (1/sigma_j^2)

is two products a row tile — ``x @ linᵀ`` and ``x² @ inv_varᵀ`` — and the
M-step moments ``rᵀx`` and ``rᵀx²`` two more: 8·n·d·k FLOP an EM
iteration.  Every product is a ``torch.matmul`` in the compute dtype with
f32 accumulation and output (IEEE f32 with TF32 off, or a bf16 product
with f32 output), the logsumexp / exp passes over the (chunk, k) tile
plain PyTorch, as the reference's are XLA code and no Pallas kernel.
Nothing beyond a (chunk, k) tile is made.

``covariance_type="tied"`` shares one (d, d) covariance: the E-step
whitens each tile with the Cholesky inverse (``x @ L⁻ᵀ``, from
``torch.linalg.cholesky`` and ``torch.linalg.solve_triangular`` once a
pass), and the M-step uses the global scatter ``G = Σ w x xᵀ``, constant
across iterations and so summed once a fit.

Update rules (responsibilities r_ij, sample weights w_i):

  r_ij = softmax_j( log pi_j + log N(x_i | mu_j, sigma_j^2) )
  N_j  = sum_i w_i r_ij          pi_j    = N_j / sum_j N_j
  mu_j = sum_i w_i r_ij x_i / N_j
  sigma_j^2 = sum_i w_i r_ij x_i^2 / N_j - mu_j^2 + reg_covar

Convergence follows sklearn's GaussianMixture: stop when the change in
mean per-sample log-likelihood is <= tol (one scalar read a pass).  Known
differences: the Cholesky factor and solves are torch's, and the draws of
``gmm_sample`` and of each ``n_init`` restart come from a
:class:`torch.Generator` seeded as the reference seeds its key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.coreset import draw_indices
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.ops.distance import cd_matmul, full_f32, resolve_cd

__all__ = [
    "GMMState", "GMMParams", "fit_gmm", "gmm_log_resp", "gmm_predict",
    "gmm_sample", "GaussianMixture",
]

_LOG_2PI = math.log(2.0 * math.pi)


class GMMParams(NamedTuple):
    """The EM parameters."""

    means: torch.Tensor        # (k, d) float32
    variances: torch.Tensor    # (k, d) float32 diag/spherical; (d, d) tied
    log_pi: torch.Tensor       # (k,) float32 — log mixing proportions


class GMMState(NamedTuple):
    means: torch.Tensor           # (k, d) float32
    covariances: torch.Tensor     # (k, d) diag/spherical; (d, d) shared tied
    mix_weights: torch.Tensor     # (k,) float32 — mixing proportions pi
    labels: torch.Tensor          # (n,) int32 — argmax responsibility
    log_likelihood: torch.Tensor  # scalar float32 — total weighted log p(x)
    n_iter: torch.Tensor          # scalar int32
    converged: torch.Tensor       # scalar bool
    resp_counts: torch.Tensor     # (k,) float32 — soft counts N_j


def _logp_terms(params: GMMParams, covariance_type: str = "diag"):
    """Per-component constants and product operands of the tile
    log-density: ``(quad, lin, const)``.  Diag/spherical: quad is the
    (k, d) inverse variances.  Tied: quad is the (d, d) ``L⁻¹`` of the
    shared covariance's Cholesky factor, so the tile's quadratic term is a
    row norm after one (chunk, d) @ (d, d) product."""
    with full_f32():
        if covariance_type == "tied":
            sigma = params.variances                           # (d, d)
            d = sigma.shape[0]
            chol = torch.linalg.cholesky(sigma)
            eye = torch.eye(d, dtype=sigma.dtype, device=sigma.device)
            l_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
            lin = torch.cholesky_solve(params.means.T, chol).T  # Σ⁻¹ μ
            logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
            const = params.log_pi - 0.5 * (
                d * _LOG_2PI + logdet + (params.means * lin).sum(dim=1))
            return l_inv, lin, const
        inv_var = 1.0 / params.variances                       # (k, d)
        lin = params.means * inv_var                           # (k, d)
        const = params.log_pi - 0.5 * (
            params.means.shape[1] * _LOG_2PI
            + torch.log(params.variances).sum(dim=1)
            + (params.means * lin).sum(dim=1))                 # (k,)
        return inv_var, lin, const


def _operands(params, covariance_type, cd):
    """``(quad_t, lin_t, const)``: the transposed product operands, rounded
    to the compute dtype (the reference's ``astype(cd).T``)."""
    quad, lin, const = _logp_terms(params, covariance_type)
    return quad.to(cd).T, lin.to(cd).T, const


def _logp_tile(xb, quad_t, lin_t, const, cd, covariance_type="diag"):
    """(chunk, k) component log-densities of one row tile — the one copy
    of the E-step products, shared by the EM pass, predict and log_resp —
    and the f32 ``xb²`` the diag M-step's moment product reuses."""
    xb_f = xb.float()
    xb_sq = xb_f * xb_f
    if covariance_type == "tied":
        z = cd_matmul(xb, quad_t, cd)                          # (chunk, d)
        quad = (z * z).sum(dim=1)[:, None]                     # (chunk, 1)
    else:
        quad = cd_matmul(xb_sq, quad_t, cd)
    cross = cd_matmul(xb, lin_t, cd)
    return const[None, :] + cross - 0.5 * quad, xb_sq


def gmm_scan_tiles(x, w, params: GMMParams, *, chunk_size, compute_dtype,
                   with_labels, with_moments=True, covariance_type="diag"):
    """The EM tile pass — log-density tile, responsibilities, weighted soft
    reductions — without the M-step: returns this block's ``(N (k,),
    S (k, d), Q (k, d), ll, labels (n,) | None)``.  The one copy of the
    E-step body, which :func:`_gmm_loop` finishes (on a mesh, after one
    all-reduce of the four sums).  ``w`` None is all-ones.

    ``with_moments=False`` skips the two moment products (S, Q stay zero):
    the final labelling pass needs only (N, ll, labels).
    """
    cd = resolve_cd(compute_dtype, x.dtype)
    k, d = params.means.shape
    dev = x.device
    quad_t, lin_t, const = _operands(params, covariance_type, cd)
    N = torch.zeros((k,), dtype=torch.float32, device=dev)
    S = torch.zeros((k, d), dtype=torch.float32, device=dev)
    Q = torch.zeros((k, d), dtype=torch.float32, device=dev)
    ll = torch.zeros((), dtype=torch.float32, device=dev)
    labels = (torch.empty((x.shape[0],), dtype=torch.int32, device=dev)
              if with_labels else None)
    for lo in range(0, x.shape[0], chunk_size):
        xb = x[lo:lo + chunk_size]
        logp, xb_sq = _logp_tile(xb, quad_t, lin_t, const, cd,
                                 covariance_type)
        row_ll = torch.logsumexp(logp, dim=1)                 # (chunk,)
        r = torch.exp(logp - row_ll[:, None])
        if w is not None:
            wb = w[lo:lo + chunk_size].float()
            r = r * wb[:, None]                                # weighted
            ll += (wb * row_ll).sum()
        else:
            ll += row_ll.sum()
        N += r.sum(dim=0)
        if with_moments:
            S += cd_matmul(r.T, xb, cd)
            if covariance_type != "tied":
                # The tied M-step takes its (d, d) update from the global
                # scatter, so the second moment is skipped.
                Q += cd_matmul(r.T, xb_sq, cd)
        if with_labels:
            labels[lo:lo + xb.shape[0]] = torch.argmax(logp, dim=1)
    return N, S, Q, ll, labels


def gmm_m_step(params: GMMParams, N, S, Q, *, covariance_type,
               reg_covar, scatter=None) -> GMMParams:
    """Closed-form M-step from the merged soft moments.

    Components with (near-)zero soft mass keep their mean and variance
    and get mixing weight N_j / Σ N (the analog of Lloyd's
    ``empty='keep'``).  ``covariance_type="tied"`` requires ``scatter``,
    the fit's global ``G = Σ_i w_i x_i x_iᵀ``: the shared covariance is
    ``(G − μᵀ diag(N) μ) / Σ_j N_j + reg·I``.
    """
    alive = N > 1e-12
    denom = torch.where(alive, N, torch.ones_like(N))
    means = torch.where(alive[:, None], S / denom[:, None], params.means)
    pi = N / N.sum()
    log_pi = torch.log(pi.clamp_min(1e-37))
    if covariance_type == "tied":
        if scatter is None:
            raise ValueError("tied M-step requires the global scatter")
        d = means.shape[1]
        with full_f32():
            sigma = (scatter - means.T @ (means * N[:, None])) / N.sum()
        sigma = 0.5 * (sigma + sigma.T) + reg_covar * torch.eye(
            d, dtype=torch.float32, device=means.device)
        return GMMParams(means, sigma, log_pi)
    var = Q / denom[:, None] - means * means
    if covariance_type == "spherical":
        var = var.mean(dim=1, keepdim=True) * torch.ones_like(var)
    var = var.clamp_min(0.0) + reg_covar
    var = torch.where(alive[:, None], var, params.variances)
    return GMMParams(means, var, log_pi)


def global_scatter(x, w, chunk_size, mesh=None):
    """``G = Σ_i w_i x_i x_iᵀ`` (d, d), symmetrized: the tied M-step's only
    data moment, summed once a fit with f32 operands (it feeds a
    Cholesky).  With ``mesh`` the rank's sum is all-reduced first."""
    d = x.shape[1]
    g = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    with full_f32():
        for lo in range(0, x.shape[0], chunk_size):
            xb_f = x[lo:lo + chunk_size].float()
            xw = xb_f if w is None else xb_f * w[lo:lo + chunk_size, None]
            g += xw.T @ xb_f
    if mesh is not None:
        mesh.all_reduce(g)
    return 0.5 * (g + g.T)


def _reduce(mesh, *ts):
    """``ts`` summed over ``mesh`` in one all-reduce (no mesh: as they
    are): the sharded fits' one merge a pass."""
    return ts if mesh is None else mesh.all_reduce_packed(*ts)


def init_gmm_params(c0, x, w, *, covariance_type, reg_covar,
                    chunk_size=4096, mesh=None) -> GMMParams:
    """Means from the k-means init; variances from the global weighted
    per-feature variance (spherical: its mean), summed a chunk at a time
    (with ``mesh``, this rank's rows, then one all-reduce); uniform mixing
    weights: EM starts from a soft Lloyd assignment."""
    d = x.shape[1]
    dev = x.device
    s = torch.zeros((d,), dtype=torch.float32, device=dev)
    q = torch.zeros((d,), dtype=torch.float32, device=dev)
    tw = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, x.shape[0], chunk_size):
        xb_f = x[lo:lo + chunk_size].float()
        wb = (torch.ones(xb_f.shape[0], device=dev) if w is None
              else w[lo:lo + chunk_size].float())
        s += (xb_f * wb[:, None]).sum(dim=0)
        q += (xb_f * xb_f * wb[:, None]).sum(dim=0)
        tw += wb.sum()
    s, q, tw = _reduce(mesh, s, q, tw)
    mean = s / tw
    var = (q / tw - mean * mean).clamp_min(0.0)
    k = c0.shape[0]
    if covariance_type == "spherical":
        var = var.mean() * torch.ones_like(var)
    var = var.clamp_min(0.0) + reg_covar
    if covariance_type == "tied":
        cov0 = torch.diag(var)                 # (d, d) shared start
    else:
        cov0 = var.expand(c0.shape).contiguous()
    return GMMParams(c0.float(), cov0.float(),
                     torch.full((k,), -math.log(k), dtype=torch.float32,
                                device=c0.device))


def _gmm_loop(x, c0, weights, tol, reg_covar, *, max_iter, chunk_size,
              compute_dtype, covariance_type, mesh=None):
    """EM passes until the mean log-likelihood moves by <= tol (one scalar
    read a pass), then a labelling pass without the moment products.

    With ``mesh`` (the sharded fit) ``x`` and ``weights`` are this rank's
    rows and the soft moments are all-reduced once a pass (the tied
    scatter once a fit); the returned labels are this rank's rows'."""
    dev = x.device
    total_w = (torch.tensor(float(x.shape[0]), device=dev) if weights is None
               else _reduce(mesh, weights.float().sum())[0])
    params = init_gmm_params(c0, x, weights, covariance_type=covariance_type,
                             reg_covar=reg_covar, chunk_size=chunk_size,
                             mesh=mesh)
    scatter = (global_scatter(x, weights, chunk_size, mesh=mesh)
               if covariance_type == "tied" else None)
    kw = dict(chunk_size=chunk_size, compute_dtype=compute_dtype,
              covariance_type=covariance_type)
    tol_v = torch.tensor(tol, dtype=torch.float32)
    it, converged, prev_ll = 0, False, -math.inf
    while it < max_iter and not converged:
        N, S, Q, ll, _ = gmm_scan_tiles(x, weights, params,
                                        with_labels=False, **kw)
        N, S, Q, ll = _reduce(mesh, N, S, Q, ll)
        params = gmm_m_step(params, N, S, Q, covariance_type=covariance_type,
                            reg_covar=reg_covar, scatter=scatter)
        mean_ll = (ll / total_w).cpu()
        converged = bool((torch.abs(mean_ll - prev_ll) <= tol_v).item())
        prev_ll = mean_ll
        it += 1
    N, _, _, ll, labels = gmm_scan_tiles(x, weights, params, with_labels=True,
                                         with_moments=False, **kw)
    N, ll = _reduce(mesh, N, ll)
    return GMMState(params.means, params.variances, torch.exp(params.log_pi),
                    labels, ll, torch.tensor(it, dtype=torch.int32, device=dev),
                    torch.tensor(converged, device=dev), N)


def to_f32(v: float) -> float:
    """``v`` rounded to float32 (a 0-d f32 array's value)."""
    import numpy as np

    return float(np.float32(v))


def fit_gmm(
    x,
    k: int,
    *,
    covariance_type: str = "diag",
    reg_covar: float = 1e-6,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    device=None,
) -> GMMState:
    """Fit a k-component Gaussian mixture with EM on ``device`` (None is
    the card).

    ``init`` seeds the means like every other family (a method name or a
    (k, d) array, drawn from ``generator``, by default seeded with
    ``config.seed``); variances start at the global per-feature variance
    and mixing weights uniform.  ``tol`` is on the change in mean
    per-sample log-likelihood (sklearn's GMM default is 1e-3 — pass
    ``tol=`` if the shared KMeansConfig default is too tight).
    """
    if covariance_type not in ("diag", "spherical", "tied"):
        raise ValueError(
            f"covariance_type must be 'diag', 'spherical' or 'tied' (full "
            f"is a (k, d, d) non-starter at TPU scale), "
            f"got {covariance_type!r}"
        )
    if not reg_covar >= 0.0:
        raise ValueError(f"reg_covar must be >= 0, got {reg_covar}")
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    cfg, generator, c0 = resolve_fit_inputs(x, k, generator, config, init,
                                            weights)
    return _gmm_loop(
        x, c0, weights, to_f32(tol if tol is not None else cfg.tol),
        to_f32(reg_covar),
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        covariance_type=covariance_type)


def _log_resp_pass(x, params, *, chunk_size, compute_dtype, covariance_type,
                   labels_only):
    cd = resolve_cd(compute_dtype, x.dtype)
    quad_t, lin_t, const = _operands(params, covariance_type, cd)
    n, k = x.shape[0], params.means.shape[0]
    dev = x.device
    if labels_only:
        labels = torch.empty((n,), dtype=torch.int32, device=dev)
    else:
        log_resp = torch.empty((n, k), dtype=torch.float32, device=dev)
        log_prob = torch.empty((n,), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk_size):
        logp, _ = _logp_tile(x[lo:lo + chunk_size], quad_t, lin_t, const,
                             cd, covariance_type)
        hi = lo + logp.shape[0]
        if labels_only:
            labels[lo:hi] = torch.argmax(logp, dim=1)
            continue
        row_ll = torch.logsumexp(logp, dim=1)
        log_resp[lo:hi] = logp - row_ll[:, None]
        log_prob[lo:hi] = row_ll
    return labels if labels_only else (log_resp, log_prob)


def gmm_log_resp(x, params: GMMParams, *, chunk_size: int = 4096,
                 compute_dtype=None, covariance_type: str = "diag"):
    """``(log_resp (n, k), log_prob (n,))`` for given parameters, on the
    parameters' device.  ``exp(log_resp)`` rows sum to 1 (predict_proba);
    ``log_prob`` is the per-sample mixture log-density (score_samples)."""
    return _log_resp_pass(as_tensor(x, params.means.device), params,
                          chunk_size=chunk_size, compute_dtype=compute_dtype,
                          covariance_type=covariance_type, labels_only=False)


def gmm_predict(x, params: GMMParams, *, chunk_size: int = 4096,
                compute_dtype=None, covariance_type: str = "diag"):
    """Component labels (argmax responsibility), a tile at a time — the
    (n, k) responsibility matrix is never made."""
    return _log_resp_pass(as_tensor(x, params.means.device), params,
                          chunk_size=chunk_size, compute_dtype=compute_dtype,
                          covariance_type=covariance_type, labels_only=True)


def gmm_sample(generator: torch.Generator, params: GMMParams, n: int,
               covariance_type: str = "diag"):
    """Draw ``n`` samples from the mixture, from ``generator`` (on the
    parameters' device).

    Returns ``(x (n, d) float32, components (n,) int32)``: components by
    the mixing weights (``data.coreset.draw_indices``: an int64 CDF, so a
    seed draws the same components on every run), then a Gaussian draw a
    row (tied: the noise correlated by the shared covariance's Cholesky
    factor).
    """
    d = params.means.shape[1]
    dev = params.means.device
    probs = torch.exp(params.log_pi)
    comp = draw_indices(probs / probs.sum(), n, generator).to(torch.int32)
    noise = torch.randn((n, d), generator=generator, dtype=torch.float32,
                        device=dev)
    means = params.means[comp.long()]
    if covariance_type == "tied":
        with full_f32():
            chol = torch.linalg.cholesky(params.variances)
            return means + noise @ chol.T, comp
    return means + noise * params.variances[comp.long()].sqrt(), comp


@dataclasses.dataclass
class GaussianMixture:
    """Estimator wrapper over :func:`fit_gmm` (sklearn-like surface), on
    ``device`` (None is the card)."""

    n_components: int = 3
    covariance_type: str = "diag"
    reg_covar: float = 1e-6
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    tol: float = 1e-3
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    device: Optional[str] = None

    state: Optional[GMMState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x, weights=None) -> "GaussianMixture":
        from kmeans_tpu_torch.models.lloyd import best_of_n_init

        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        init = None if isinstance(self.init, str) else self.init
        cfg = KMeansConfig(
            k=self.n_components,
            init=self.init if isinstance(self.init, str) else "given",
            max_iter=self.max_iter, tol=self.tol, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
        )
        self.state = best_of_n_init(
            lambda gen: fit_gmm(
                x, self.n_components, covariance_type=self.covariance_type,
                reg_covar=self.reg_covar, generator=gen, config=cfg,
                init=init, weights=weights, device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev,
            # best_of_n_init minimizes; higher likelihood is better.
            score=lambda s: -float(s.log_likelihood))
        return self

    @property
    def _params(self) -> GMMParams:
        s = self.state
        return GMMParams(s.means, s.covariances,
                         torch.log(s.mix_weights.clamp_min(1e-37)))

    @property
    def means_(self):
        return self.state.means

    @property
    def covariances_(self):
        if self.covariance_type == "spherical":
            return self.state.covariances[:, 0]
        # tied: the shared (d, d) matrix, diag: (k, d) — sklearn's shapes.
        return self.state.covariances

    @property
    def weights_(self):
        return self.state.mix_weights

    @property
    def labels_(self):
        return self.state.labels

    @property
    def n_iter_(self):
        return int(self.state.n_iter)

    @property
    def converged_(self):
        return bool(self.state.converged)

    def _n_parameters(self) -> int:
        k, d = self.state.means.shape
        cov = {"diag": k * d, "spherical": k,
               "tied": d * (d + 1) // 2}[self.covariance_type]
        return k * d + cov + (k - 1)

    def _kw(self):
        return dict(chunk_size=self.chunk_size,
                    compute_dtype=self.compute_dtype,
                    covariance_type=self.covariance_type)

    def score_samples(self, x):
        _, log_prob = gmm_log_resp(x, self._params, **self._kw())
        return log_prob

    def score(self, x) -> float:
        return float(self.score_samples(x).mean())

    def predict_proba(self, x):
        log_resp, _ = gmm_log_resp(x, self._params, **self._kw())
        return torch.exp(log_resp)

    def predict(self, x):
        return gmm_predict(x, self._params, **self._kw())

    def sample(self, n: int, *, generator=None):
        """(x (n, d), components (n,)) drawn from the fitted mixture, from
        ``generator`` (default: seeded with ``seed + 1``, as the reference
        seeds its key)."""
        from kmeans_tpu_torch.data.synthetic import generator_for

        gen = generator_for(self.seed + 1 if generator is None
                            else generator, self.state.means.device)
        return gmm_sample(gen, self._params, n,
                          covariance_type=self.covariance_type)

    def bic(self, x) -> float:
        n = x.shape[0]
        return float(
            -2.0 * self.score(x) * n + self._n_parameters() * math.log(n))

    def aic(self, x) -> float:
        n = x.shape[0]
        return float(-2.0 * self.score(x) * n + 2 * self._n_parameters())
