"""Sharded kernel k-means: the O(n²) kernel-mass sweep as a ring pass.

Counterpart of ``kmeans_tpu/parallel/kernel.py``.  Every rank keeps its
row block and label block; the visiting block moves one rank a step round
the ring (:meth:`~kmeans_tpu_torch.parallel.mesh.Mesh.ring_shift`, the
reference's ``ppermute``), and each of the dp steps adds one
``kernel(x_loc, block) @ (w·onehot(block labels))`` pair of products to
the local rows' kernel mass S.  After dp steps S is exact while no rank
held more than its own block and one visitor.  (N, T) are one all-reduce
a pass, the changed-label count another; padding rows (a global index at
or past n) are pinned to label 0.  The loop is
:func:`kmeans_tpu_torch.models.kernel._kernel_loop` itself, whose one
device is a ring of one: a mesh of one sums what one device sums, bit for
bit.

Parity caveat (the reference's own): on more than one rank S adds up over
the ring steps in another f32 order than one device's full-row product,
so a sub-ulp argmin tie can resolve differently.
"""

from __future__ import annotations

from typing import Optional

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.models.init import resolve_fit_config
from kmeans_tpu_torch.models.kernel import (KernelKMeansState, _kernel_loop,
                                            label_init,
                                            resolve_kernel_params)

__all__ = ["fit_kernel_kmeans_sharded"]


def fit_kernel_kmeans_sharded(
    x,
    k: int,
    *,
    mesh,
    kernel: str = "rbf",
    gamma: Optional[float] = None,
    degree: int = 3,
    coef0: float = 1.0,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    data_axis: str = "data",
    max_iter: Optional[int] = None,
) -> KernelKMeansState:
    """Kernel k-means over ``mesh`` (a ring pass over the row blocks).

    The contract of :func:`~kmeans_tpu_torch.models.kernel.
    fit_kernel_kmeans`; every rank calls it with the same global ``x``
    (host memory or a tensor) and places only its own rows.  ``init`` may
    be (n,) labels, a (k, d) centroid array or an init-method name (the
    sharded seeding, which draws what one device draws, then K1 on the
    rank's rows).  Every rank returns the global state."""
    from kmeans_tpu_torch.ops.distance import assign
    from kmeans_tpu_torch.parallel.engine import (_check_weights, _place,
                                                  _seed_on_mesh, _soft_fit)

    cfg, gen = resolve_fit_config(k, generator, config, mesh.device)
    gamma, degree, coef0 = resolve_kernel_params(kernel, gamma, degree,
                                                 coef0, x.shape[1])
    _check_weights(x, weights)
    kind, val = label_init(init, cfg, x.shape[0], k, x.shape[1])
    ring = mesh.sub((data_axis,))
    x_loc, w_loc, _, n = _place(x, mesh, data_axis, weights=weights)
    n_loc = x_loc.shape[0]
    lo = mesh.coord(data_axis) * n_loc
    real = (lo + torch.arange(n_loc, device=mesh.device)) < n
    if kind == "labels":
        lab0 = torch.zeros(n_loc, dtype=torch.int32)
        lab0[:max(min(n - lo, n_loc), 0)] = val[lo:lo + n_loc]
        lab0 = lab0.to(mesh.device)
    else:
        c0 = val.to(mesh.device) if kind == "centroids" else _seed_on_mesh(
            gen, x_loc, w_loc, k, mesh=ring, n=n, method=val,
            weights=weights, cfg=cfg)
        lab0, _ = assign(x_loc, c0, chunk_size=cfg.chunk_size,
                         compute_dtype=cfg.compute_dtype, device=mesh.device)
        lab0 = torch.where(real, lab0, 0)
    return _soft_fit(ring, "kernel", lambda: _kernel_loop(
        x_loc, lab0, w_loc, k=k,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        kernel=kernel, gamma=gamma, degree=degree, coef0=coef0, mesh=ring,
        real=real), n)
