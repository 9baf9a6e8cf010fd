"""PCA fit on a mesh (DP over rows).

Counterpart of ``kmeans_tpu/parallel/preprocess.py``.  The covariance's
sufficient statistics are sums over rows, so each rank sums the centred
``(Σy, Σyyᵀ)`` of its row block and one all-reduce a statistic merges
them; the (d, d) eigh then runs on every rank, as in the single-device
:func:`~kmeans_tpu_torch.data.preprocess.pca_fit`.

The pilot mean must be global — a per-rank pilot would make the centring
rank-dependent — so it is the weighted mean of every rank's first chunk:
one all-reduce of that chunk's (sum | weight) before the pass.
"""

from __future__ import annotations

from typing import Optional

from kmeans_tpu_torch.data.preprocess import (PCAState, _check_components,
                                              _finish, _moments)
from kmeans_tpu_torch.ops.distance import resolve_cd

__all__ = ["pca_fit_sharded"]


def _moments_local(mesh, x_loc, w_loc, *, chunk_size, cd):
    """This rank's centred moments around the global pilot, all-reduced:
    ``(Σy (d,), Σyyᵀ (d, d), mu0 (d,), n_eff)`` on every rank."""
    x0 = x_loc[:chunk_size].float()
    w0 = w_loc[:chunk_size].float()
    s0, c0 = mesh.all_reduce_packed((x0 * w0[:, None]).sum(dim=0), w0.sum())
    mu0 = s0 / c0.clamp_min(1.0)
    s, ss, _ = _moments(x_loc, chunk_size, cd, w=w_loc, mu0=mu0)
    s, ss, n_eff = mesh.all_reduce_packed(s, ss, w_loc.float().sum())
    return s, ss, mu0, n_eff


def pca_fit_sharded(
    x,
    n_components: int,
    *,
    mesh,
    whiten: bool = False,
    chunk_size: int = 8192,
    compute_dtype: Optional[str] = None,
    data_axis: str = "data",
) -> PCAState:
    """:func:`~kmeans_tpu_torch.data.preprocess.pca_fit` on ``mesh`` (DP
    over rows; every rank calls it with the same global ``x`` and gets the
    same state).  Components and variances match the single-device fit to
    float tolerance."""
    from kmeans_tpu_torch.parallel.engine import pad_and_place

    n, d = x.shape
    _check_components(n_components, n, d)
    x_loc, w_loc, n = pad_and_place(x, mesh, data_axis)
    s, ss, mu0, n_eff = _moments_local(
        mesh, x_loc, w_loc, chunk_size=chunk_size,
        cd=resolve_cd(compute_dtype, x_loc.dtype))
    return _finish(s, ss, mu0, n_eff, n_components, whiten)
