"""PCA / whitening in front of the clustering fits.

Counterpart of ``kmeans_tpu/data/preprocess.py``: project rows onto the top
principal components, optionally whiten them, then cluster in the reduced
space (the recipe for raw-pixel inputs such as CIFAR-10's 3072 columns).

The covariance is one ``yᵀy`` product a row chunk, summed in f32 (an IEEE
f32 product with TF32 off, or a bf16 product with f32 accumulation in
bf16 compute), over rows centred on a pilot mean: the mean of the first
chunk, subtracted before anything is summed.  Without it the f32 second
moment of raw pixels (mean² ≈ 580× the covariance entries) cancels
catastrophically.  The eigendecomposition runs on the (d, d) covariance
(``torch.linalg.eigh``).  Known difference: neither package fixes the
sign of an eigenvector, and ``torch.linalg.eigh`` may return the opposite
sign of ``jnp.linalg.eigh`` (or the card's of the CPU's) for the same one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.ops.distance import cd_matmul, full_f32, resolve_cd

__all__ = ["PCAState", "pca_fit", "pca_fit_stream", "pca_transform",
           "pca_inverse_transform"]


class PCAState(NamedTuple):
    """Fitted projection.  ``components`` rows are unit eigenvectors of
    the covariance, sorted by decreasing ``explained_variance``."""

    mean: torch.Tensor                 # (d,) float32
    components: torch.Tensor           # (m, d) float32
    explained_variance: torch.Tensor   # (m,) float32 (eigenvalues)
    whiten: bool


def _top_eigs(cov, n_components):
    """Top-``n_components`` eigenpairs of a symmetric matrix, descending:
    the one copy shared by the in-memory, streamed and sharded fits."""
    evals, evecs = torch.linalg.eigh(cov)    # ascending
    top = torch.flip(evals[-n_components:], dims=(0,))
    comps = torch.flip(evecs[:, -n_components:], dims=(1,)).T.contiguous()
    return comps, top.clamp_min(0.0)


def _check_components(n_components: int, n: int, d: int) -> None:
    if not 1 <= n_components <= min(n, d):
        raise ValueError(
            f"n_components must be in [1, {min(n, d)}], got {n_components}"
        )


def _accumulate(s, ss, xb, mu0, cd, wb=None):
    """Add one chunk's centred sum and second moment to ``(s, ss)`` in
    place: ``y = x − mu0`` (zeroed on weight-0 rows), ``s += Σy``,
    ``ss += cd(y)ᵀ cd(y)`` in f32."""
    y = xb.float() - mu0
    if wb is not None:
        y = y * wb[:, None]
    s += y.sum(dim=0)
    ss += cd_matmul(y.T, y, cd)


def _moments(x, chunk_size, cd, w=None, mu0=None):
    """``(s, ss, mu0)``: the centred moments of the rows of ``x`` (weights
    ``w``: 1 on real rows, 0 on padding) around the pilot ``mu0``, by
    default the weighted mean of the first chunk."""
    n, d = x.shape
    if mu0 is None:
        x0 = x[:chunk_size].float()
        w0 = (torch.ones(x0.shape[0], device=x.device) if w is None
              else w[:chunk_size].float())
        mu0 = (x0 * w0[:, None]).sum(dim=0) / w0.sum().clamp_min(1.0)
    s = torch.zeros((d,), dtype=torch.float32, device=x.device)
    ss = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    for lo in range(0, n, chunk_size):
        _accumulate(s, ss, x[lo:lo + chunk_size], mu0, cd,
                    None if w is None else w[lo:lo + chunk_size])
    return s, ss, mu0


def _finish(s, ss, mu0, n_eff, n_components, whiten) -> PCAState:
    """The covariance ``E[yyᵀ] − E[y]E[y]ᵀ`` and its top eigenpairs."""
    mean_y = s / n_eff
    with full_f32():
        cov = ss / n_eff - torch.outer(mean_y, mean_y)
        comps, top = _top_eigs(cov, n_components)
    return PCAState(mu0 + mean_y, comps, top, whiten)


def pca_fit(
    x,
    n_components: int,
    *,
    whiten: bool = False,
    chunk_size: int = 8192,
    compute_dtype: Optional[str] = None,
    device=None,
) -> PCAState:
    """Fit PCA on rows of ``x`` on ``device`` (None is the card): the top
    ``n_components`` eigenvectors of the covariance, summed a chunk of
    rows at a time.

    ``whiten=True`` rescales projected coordinates to unit variance —
    equalizing feature importance before k-means, the usual recipe for
    raw-pixel inputs.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    n, d = x.shape
    _check_components(n_components, n, d)
    s, ss, mu0 = _moments(x, chunk_size, resolve_cd(compute_dtype, x.dtype))
    return _finish(s, ss, mu0, n, n_components, whiten)


def _whiten_scale(state: PCAState) -> torch.Tensor:
    """Per-component scale of the projection: ``1/√λ``, or 0 for a
    component whose eigenvalue lies within two f32 steps of eigh's noise
    floor (``2·eps·λ_max``), which flooring would amplify by up to 1e6."""
    ev = state.explained_variance
    if not state.whiten:
        return torch.ones((), dtype=torch.float32, device=ev.device)
    cutoff = 2 * torch.finfo(torch.float32).eps * ev.max()
    return torch.where(ev > cutoff, 1.0 / ev.clamp_min(1e-30).sqrt(),
                       torch.zeros_like(ev))


def pca_transform(state: PCAState, x, *, chunk_size: int = 8192):
    """Project rows onto the fitted components (whitening if fitted so),
    on the state's device.  Returns float32 (n, n_components)."""
    dev = state.mean.device
    x = as_tensor(x, dev)
    scale = _whiten_scale(state)
    out = torch.empty((x.shape[0], state.components.shape[0]),
                      dtype=torch.float32, device=dev)
    with full_f32():
        for lo in range(0, x.shape[0], chunk_size):
            z = (x[lo:lo + chunk_size].float() - state.mean) \
                @ state.components.T
            out[lo:lo + chunk_size] = z * scale
    return out


def pca_inverse_transform(state: PCAState, z):
    """Map projected coordinates back to the input space (the closest
    rank-m reconstruction; exact when m == d).  Accepts (n, m) or a
    single (m,) row — e.g. fitted centroids back into pixel space."""
    z = as_tensor(z, state.mean.device, torch.float32)
    if state.whiten:
        z = z * state.explained_variance.clamp_min(1e-12).sqrt()
    with full_f32():
        return z @ state.components + state.mean


def pca_fit_stream(
    data,
    n_components: int,
    *,
    whiten: bool = False,
    chunk_size: int = 65536,
    compute_dtype: Optional[str] = None,
    device=None,
) -> PCAState:
    """Out-of-core :func:`pca_fit` over host-resident rows (an ndarray or
    a memory-mapped ``.npy``) on ``device`` (None is the card): one
    streamed pass sums the (d,) and (d, d) centred moments on the device
    around the first chunk's mean, then the same eigh as the in-memory
    fit.  Rows never all sit in memory."""
    from kmeans_tpu_torch.data.stream import foreach_chunk

    dev = resolve_device(device)
    n, d = data.shape
    _check_components(n_components, n, d)
    s = torch.zeros((d,), dtype=torch.float32, device=dev)
    ss = torch.zeros((d, d), dtype=torch.float32, device=dev)
    pilot = [None]

    def step(xb, lo):
        if pilot[0] is None:
            pilot[0] = xb.float().mean(dim=0)
        _accumulate(s, ss, xb, pilot[0], resolve_cd(compute_dtype, xb.dtype))

    foreach_chunk(data, chunk_size, step, device=dev)
    return _finish(s, ss, pilot[0], n, n_components, whiten)
