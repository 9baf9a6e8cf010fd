"""The Nyström spectral embedding over a mesh of processes.

Counterpart of ``kmeans_tpu/parallel/spectral.py``.  Every O(n·m) step
runs on the rank's own rows, and only landmark-sized data crosses ranks:

* landmark draw: the single-device embedding's draw (the same generator
  gives the same indices), the rows indexed in the global x that every
  rank holds;
* degrees: one (m,) all-reduce of the local Cᵀ·valid;
* the Gram of Z: one (m, m) all-reduce; every rank runs ``eigh`` on the
  same bits, so every rank cuts its rows in one basis;
* U = Z V S^{-1/2} and the row normalization are row-local.

The row math is :func:`kmeans_tpu_torch.models.spectral.embed_rows`, the
single-device embedding's own, so a mesh of one returns its bits.  The
result, like every sharded fit's, is the global (n, k) embedding on every
rank (one all-gather of the embedding's rows at the end).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.spectral import (check_landmarks,
                                              draw_landmarks, embed_rows,
                                              landmark_ops)

__all__ = ["spectral_embedding_sharded"]


def spectral_embedding_sharded(
    x,
    k: int,
    *,
    mesh,
    data_axis: str = "data",
    n_landmarks: Optional[int] = None,
    gamma: Optional[float] = None,
    landmarks=None,
    generator: Optional[torch.Generator] = None,
    reg: float = 1e-4,
    chunk_size: int = 4096,
    compute_dtype=None,
):
    """Row-normalized (n, k) Nyström embedding over ``mesh``: the contract
    (and, for the same ``generator``, the draws) of
    :func:`~kmeans_tpu_torch.models.spectral.spectral_embedding`.  Every
    rank calls it with the same global ``x`` and places only its own rows;
    every rank returns the global embedding."""
    from kmeans_tpu_torch.device import as_dtype, as_tensor
    from kmeans_tpu_torch.models.kernel import resolve_kernel_params
    from kmeans_tpu_torch.parallel.engine import _gather_rows, _place

    n, d = x.shape
    dev = mesh.device
    gamma, degree, coef0 = resolve_kernel_params("rbf", gamma, 3, 1.0, d)
    ring = mesh.sub((data_axis,))
    if landmarks is None:
        idx = draw_landmarks(n, k, n_landmarks, generator, dev)
        landmarks = (x[idx.to(x.device)] if isinstance(x, torch.Tensor)
                     else np.asarray(x[idx.cpu().numpy()]))
    landmarks = as_tensor(landmarks, dev)
    check_landmarks(landmarks, k, d)
    ops = landmark_ops(landmarks, gamma=gamma, degree=degree, coef0=coef0,
                       reg=reg)
    x_loc, w_loc, _, n = _place(x, mesh, data_axis)
    cd = torch.float32 if compute_dtype is None else as_dtype(compute_dtype)
    u_loc, _ = embed_rows(x_loc, (w_loc > 0).float(), ops, k=k,
                          gamma=gamma, cd=cd, chunk_size=chunk_size,
                          mesh=ring)
    return _gather_rows(ring, u_loc, n)
