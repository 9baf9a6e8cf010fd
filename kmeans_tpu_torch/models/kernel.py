"""Kernel k-means: non-linear clustering in an implicit feature space.

Counterpart of ``kmeans_tpu/models/kernel.py``.  Points are clustered by
the k-means objective in the feature space of a kernel (linear, rbf, poly)
without materializing that space; the feature-space distance needs only
kernel sums:

  d²(φ(x_i), μ_c) = K_ii − 2·S_ic/N_c + T_c/N_c²
  S_ic = Σ_{j: l_j=c} w_j K_ij       (per-point per-cluster kernel mass)
  N_c  = Σ_{j: l_j=c} w_j            (weighted cluster size)
  T_c  = Σ_{j: l_j=c} w_j S_jc       (within-cluster kernel mass)

S is computed in row tiles as two products: the kernel tile ``K(xb, y)``
(:func:`kernel_tile`, on :func:`~kmeans_tpu_torch.ops.distance.cd_product`)
times the weighted one-hot label matrix, cast to the compute dtype first
as the reference's is.  Both are ``torch.matmul`` in the reference's
precision (its sweep is XLA code, no Pallas kernel); only a (chunk, n)
tile is live, and the rbf tile is finished in place on the product's
buffer.  K_ii is constant per row and is added back for the objective
only.  Labels are integer state; the fit stops when no label changes.
Empty clusters keep N_c = 0 and are masked to +inf (they stay empty).

One loop serves one device and a mesh (:func:`_kernel_loop`): on a mesh
the S sweep is a ring over the row blocks (the visiting block moves one
rank a step, :meth:`~kmeans_tpu_torch.parallel.mesh.Mesh.ring_shift`),
and (N, T), the changed count and the objective are all-reduced; one
device is a ring of one.  N and T are column sums of the weighted one-hot
(times S), in place of the reference's ``segment_sum``: the same sums,
and on the card free of float atomics, so a rerun and a ring of one give
the same bits.

The seeding of the labels (an init method, or (k, d) centroids) assigns
with :func:`~kmeans_tpu_torch.ops.distance.assign`: K1 on the card.
:func:`nystrom_features` is the O(n·m·d) scale-out: Euclidean k-means on
its features approximates kernel k-means, on the engine's kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.ops.distance import (cd_matmul, cd_product, full_f32,
                                           resolve_cd, sq_norms)

__all__ = ["KernelKMeansState", "fit_kernel_kmeans", "kernel_assign",
           "KernelKMeans", "nystrom_features", "kernel_tile",
           "resolve_kernel_params"]

_KERNELS = ("linear", "rbf", "poly")


class KernelKMeansState(NamedTuple):
    labels: torch.Tensor       # (n,) int32
    objective: torch.Tensor    # scalar f32, Σ w_i d²(φ(x_i), μ_{l_i}) AT
    #                            these labels (converged or stopped alike)
    n_iter: torch.Tensor       # scalar int32
    converged: torch.Tensor    # scalar bool (labels reached a fixed point)
    counts: torch.Tensor       # (k,) f32, weighted cluster sizes N_c
    within_mass: torch.Tensor  # (k,) f32, T_c, cached so predict is O(m·n·d)


def resolve_kernel_params(kernel, gamma, degree, coef0, d):
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}, got {kernel!r}")
    if gamma is None:
        gamma = 1.0 / d            # sklearn pairwise default
    if not gamma > 0:
        raise ValueError(f"gamma must be > 0, got {gamma}")
    return float(gamma), int(degree), float(coef0)


def kernel_tile(xb, y, xb_sq, y_sq, *, kernel, gamma, degree, coef0, cd):
    """(chunk_x, chunk_y) kernel values of the rows ``xb`` against the rows
    ``y``, the product in ``cd`` with f32 accumulation: THE one copy of
    the kernel math, shared by the fit, prediction, the Nyström maps and
    the ring pass.  The rbf and poly tiles are finished in place on the
    product's buffer; each in-place step is an exact rewrite of the
    reference's expression (``−2p + a`` is ``a − 2p``), so the values are
    its values."""
    prod = cd_product(xb, y, cd)
    if kernel == "linear":
        return prod
    if kernel == "rbf":
        d2 = prod.mul_(-2.0).add_(xb_sq[:, None]).add_(y_sq[None, :])
        return d2.clamp_min_(0.0).mul_(-gamma).exp_()
    return prod.mul_(gamma).add_(coef0).pow_(degree)          # poly


def kernel_diag(x_sq, *, kernel, gamma, degree, coef0):
    """K_ii for each row, from the squared norms (f32)."""
    if kernel == "linear":
        return x_sq
    if kernel == "rbf":
        return torch.ones_like(x_sq)
    return (gamma * x_sq + coef0) ** degree


def kernel_mass_scan(x, x_sq, y, y_sq, wl, *, kernel, gamma, degree, coef0,
                     cd, chunk_size):
    """(n_x, k) rows ``kernel(x, y) @ wl``, a tile of ``chunk_size`` rows at
    a time: ``wl`` is (n_y, k), the weighted one-hot of y's labels (or the
    Nyström transform); the kernel tile is cast to ``cd`` before the
    product, as the reference's is."""
    out = torch.empty((x.shape[0], wl.shape[1]), dtype=torch.float32,
                      device=x.device)
    for lo in range(0, x.shape[0], chunk_size):
        hi = lo + chunk_size
        kt = kernel_tile(x[lo:hi], y, x_sq[lo:hi], y_sq, kernel=kernel,
                         gamma=gamma, degree=degree, coef0=coef0, cd=cd)
        out[lo:hi] = cd_matmul(kt, wl, cd)
    return out


def _weighted_onehot(labels, w, k):
    return torch.nn.functional.one_hot(labels.long(), k).float() * w[:, None]


def _labels_from_mass(S, N, T):
    """argmin_c(−2·S/N + T/N²) with empty clusters masked to +inf (the
    lowest index on a tie); also each row's min value."""
    safe_n = torch.where(N > 0, N, 1.0)
    val = -2.0 * S / safe_n[None, :] + (T / (safe_n * safe_n))[None, :]
    val = torch.where((N > 0)[None, :], val, torch.inf)
    return torch.argmin(val, dim=1).to(torch.int32), val.amin(dim=1)


def _partition_value(S, N, T, labels, w):
    """Each row's −2·S/N + T/N² AT its own label, zeroed where w == 0: the
    per-row term of the partition objective."""
    lab = labels.long()
    nl = N[lab]
    safe = torch.where(nl > 0, nl, 1.0)
    own = S.gather(1, lab[:, None])[:, 0]
    val = -2.0 * own / safe + T[lab] / (safe * safe)
    return torch.where(w > 0, val, 0.0)


def _masses(x, x_sq, w, labels, *, k, mesh, kw):
    """(S, N, T) at ``labels``: S of this block's rows against every row,
    the visiting block moving one rank a step round the ring (one step
    over the own block on one device), then (N, T) summed over the mesh
    in one all-reduce."""
    steps = 1 if mesh is None else mesh.size
    blk = (x, w, labels, x_sq)
    S = None
    for i in range(steps):
        bx, bw, bl, bsq = blk
        part = kernel_mass_scan(x, x_sq, bx, bsq,
                                _weighted_onehot(bl, bw, k), **kw)
        S = part if S is None else S.add_(part)
        if i + 1 < steps:
            blk = mesh.ring_shift(*blk)
    wl = _weighted_onehot(labels, w, k)
    N = wl.sum(dim=0)
    T = (wl * S).sum(dim=0)
    if mesh is not None:
        N, T = mesh.all_reduce_packed(N, T)
    return S, N, T


def _kernel_loop(x, labels0, w, *, k, max_iter, chunk_size, compute_dtype,
                 kernel, gamma, degree, coef0, mesh=None, real=None):
    """Label passes until no label changes (one scalar read a pass), then
    the objective AT the returned labels.  With ``mesh`` the rows are this
    rank's block (``real`` marks the rows that are not padding: padding
    rows are pinned to label 0) and the returned labels are its rows'."""
    cd = resolve_cd(compute_dtype, x.dtype)
    dev = x.device
    kw = dict(kernel=kernel, gamma=gamma, degree=degree, coef0=coef0, cd=cd,
              chunk_size=chunk_size)
    x_sq = sq_norms(x)
    labels = labels0.to(torch.int32)
    it, converged = 0, False
    while it < max_iter and not converged:
        S, N, T = _masses(x, x_sq, w, labels, k=k, mesh=mesh, kw=kw)
        new, _ = _labels_from_mass(S, N, T)
        if real is not None:
            new = torch.where(real, new, 0)
        changed = (new != labels).sum()
        if mesh is not None:
            mesh.all_reduce(changed)
        converged = bool(changed.item() == 0)
        labels = new
        it += 1
    S, N, T = _masses(x, x_sq, w, labels, k=k, mesh=mesh, kw=kw)
    diag = kernel_diag(x_sq, kernel=kernel, gamma=gamma, degree=degree,
                       coef0=coef0)
    obj = (w * diag + _partition_value(S, N, T, labels, w) * w).sum()
    if mesh is not None:
        mesh.all_reduce(obj)
    return KernelKMeansState(
        labels, obj, torch.tensor(it, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev), N, T)


def label_init(init, cfg, n: int, k: int, d: int):
    """What ``init`` asks for: ``("labels", (n,) int tensor)``,
    ``("centroids", (k, d) f32)`` or ``("method", name)``, validated with
    the reference's errors.  Shared by the fit and the ring fit."""
    if init is not None and not isinstance(init, str):
        arr = init if isinstance(init, torch.Tensor) else \
            torch.as_tensor(np.asarray(init))
        if arr.ndim == 1:
            if arr.shape[0] != n:
                raise ValueError(
                    f"init labels shape {tuple(arr.shape)} != ({n},)")
            if arr.dtype not in (torch.int32, torch.int64):
                raise ValueError(
                    "1-D init must be integer labels, got "
                    f"{str(arr.dtype).replace('torch.', '')}")
            return "labels", arr.to(torch.int32)
        if tuple(arr.shape) != (k, d):
            raise ValueError(
                f"init must be (n,) labels or (k, d) centroids; got "
                f"{tuple(arr.shape)}")
        return "centroids", arr.to(torch.float32)
    return "method", init if isinstance(init, str) else cfg.init


def _resolve_labels0(x, k, generator, cfg, init, weights):
    """Initial labels: an (n,) int array, or an input-space k-means init
    (seeding, then one nearest-centroid assignment, K1 on the card)."""
    from kmeans_tpu_torch.models.init import init_centroids
    from kmeans_tpu_torch.ops.distance import assign

    kind, val = label_init(init, cfg, x.shape[0], k, x.shape[1])
    if kind == "labels":
        return val.to(x.device)
    if kind == "centroids":
        centroids = val.to(x.device)
    else:
        centroids = init_centroids(
            generator, x, k, method=val, weights=weights,
            compute_dtype=cfg.compute_dtype, chunk_size=cfg.chunk_size)
    labels, _ = assign(x, centroids, chunk_size=cfg.chunk_size,
                       compute_dtype=cfg.compute_dtype, device=x.device)
    return labels


def fit_kernel_kmeans(
    x,
    k: int,
    *,
    kernel: str = "rbf",
    gamma: Optional[float] = None,
    degree: int = 3,
    coef0: float = 1.0,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    weights=None,
    max_iter: Optional[int] = None,
    device=None,
) -> KernelKMeansState:
    """Fit kernel k-means (linear / rbf / poly kernels) on ``device`` (None
    is the card).

    ``init`` may be an (n,) integer label array, a (k, d) centroid array,
    or an init-method name (seeded in input space from ``generator``, then
    one nearest-centroid assignment).  With ``kernel='linear'`` the
    objective equals plain k-means' inertia at the same partition.
    O(n²·d) an iteration: use :func:`kmeans_tpu_torch.parallel.
    fit_kernel_kmeans_sharded` to spread the quadratic work over a mesh.
    """
    from kmeans_tpu_torch.models.init import resolve_fit_config

    dev = resolve_device(device)
    x = as_tensor(x, dev)
    cfg, gen = resolve_fit_config(k, generator, config, dev)
    gamma, degree, coef0 = resolve_kernel_params(kernel, gamma, degree,
                                                 coef0, x.shape[1])
    w = None if weights is None else as_tensor(weights, dev, torch.float32)
    labels0 = _resolve_labels0(x, k, gen, cfg, init, w)
    return _kernel_loop(
        x, labels0,
        torch.ones(x.shape[0], dtype=torch.float32, device=dev)
        if w is None else w, k=k,
        max_iter=max_iter if max_iter is not None else cfg.max_iter,
        chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
        kernel=kernel, gamma=gamma, degree=degree, coef0=coef0)


def kernel_assign(
    x_new,
    x_fit,
    labels_fit,
    *,
    k: int,
    kernel: str = "rbf",
    gamma: Optional[float] = None,
    degree: int = 3,
    coef0: float = 1.0,
    weights_fit=None,
    within_mass=None,
    chunk_size: int = 4096,
    compute_dtype=None,
    device=None,
):
    """Assign new points to the fitted feature-space clusters, on
    ``device`` (None: ``x_fit``'s device when it is a tensor, else the
    card).

    Kernel k-means has no input-space centroids: prediction computes each
    new point's kernel mass against the training set, O(m·n·d) when
    ``within_mass`` (the fit's cached T_c) is given; without it T is
    rebuilt from the training set, an extra O(n²·d) sweep a call.  Kernel
    parameters default as :func:`fit_kernel_kmeans`'s do."""
    gamma, degree, coef0 = resolve_kernel_params(
        kernel, gamma, degree, coef0, x_fit.shape[1])
    if device is None and isinstance(x_fit, torch.Tensor):
        device = x_fit.device
    dev = resolve_device(device)
    x_new = as_tensor(x_new, dev)
    x_fit = as_tensor(x_fit, dev)
    labels_fit = as_tensor(labels_fit, dev)
    n = x_fit.shape[0]
    w = (torch.ones(n, dtype=torch.float32, device=dev)
         if weights_fit is None else as_tensor(weights_fit, dev,
                                               torch.float32))
    cd = resolve_cd(compute_dtype, x_new.dtype)
    kw = dict(kernel=kernel, gamma=gamma, degree=degree, coef0=coef0, cd=cd,
              chunk_size=chunk_size)
    wl = _weighted_onehot(labels_fit, w, k)
    x_fit_sq = sq_norms(x_fit)
    S = kernel_mass_scan(x_new, sq_norms(x_new), x_fit, x_fit_sq, wl, **kw)
    N = wl.sum(dim=0)
    if within_mass is not None:
        T = as_tensor(within_mass, dev, torch.float32)
    else:
        # T from the fitted partition (the training pass's formula).
        s_fit = kernel_mass_scan(x_fit, x_fit_sq, x_fit, x_fit_sq, wl, **kw)
        T = (wl * s_fit).sum(dim=0)
    labels, _ = _labels_from_mass(S, N, T)
    return labels


@dataclasses.dataclass
class KernelKMeans:
    """Estimator wrapper over :func:`fit_kernel_kmeans` (sklearn-like), on
    ``device`` (None is the card)."""

    n_clusters: int = 3
    kernel: str = "rbf"
    gamma: Optional[float] = None
    degree: int = 3
    coef0: float = 1.0
    init: Union[str, object] = "k-means++"
    max_iter: int = 100
    seed: int = 0
    n_init: int = 1
    chunk_size: int = 4096
    compute_dtype: Optional[str] = None
    device: Optional[str] = None

    state: Optional[KernelKMeansState] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _x_fit: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _w_fit: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x, weights=None) -> "KernelKMeans":
        from kmeans_tpu_torch.models.lloyd import best_of_n_init

        dev = resolve_device(self.device)
        x = as_tensor(x, dev)
        init = None if isinstance(self.init, str) else self.init
        cfg = KMeansConfig(
            k=self.n_clusters,
            init=self.init if isinstance(self.init, str) else "given",
            max_iter=self.max_iter, seed=self.seed,
            chunk_size=self.chunk_size, compute_dtype=self.compute_dtype,
        )
        self.state = best_of_n_init(
            lambda gen: fit_kernel_kmeans(
                x, self.n_clusters, kernel=self.kernel, gamma=self.gamma,
                degree=self.degree, coef0=self.coef0, generator=gen,
                config=cfg, init=init, weights=weights, device=dev),
            self.seed, 1 if init is not None else self.n_init, device=dev,
            score=lambda s: float(s.objective))
        self._x_fit = x
        self._w_fit = None if weights is None else as_tensor(
            weights, dev, torch.float32)
        return self

    @property
    def labels_(self):
        return self.state.labels

    @property
    def objective_(self):
        return float(self.state.objective)

    @property
    def n_iter_(self):
        return int(self.state.n_iter)

    def predict(self, x):
        return kernel_assign(
            x, self._x_fit, self.state.labels, k=self.n_clusters,
            kernel=self.kernel, gamma=self.gamma, degree=self.degree,
            coef0=self.coef0, weights_fit=self._w_fit,
            within_mass=self.state.within_mass, chunk_size=self.chunk_size,
            compute_dtype=self.compute_dtype, device=self._x_fit.device)

    def fit_predict(self, x, weights=None):
        return self.fit(x, weights=weights).labels_


def _nystrom_map(x, landmarks, transform, *, kernel, gamma, degree, coef0,
                 chunk_size, compute_dtype):
    # The tiled kernel(x, L) @ M body of the mass scan, with the (m, m)
    # inverse square root in place of the one-hot.
    cd = resolve_cd(compute_dtype, x.dtype)
    return kernel_mass_scan(x, sq_norms(x), landmarks, sq_norms(landmarks),
                            transform, kernel=kernel, gamma=gamma,
                            degree=degree, coef0=coef0, cd=cd,
                            chunk_size=chunk_size)


def nystrom_features(
    x,
    m: int,
    *,
    kernel: str = "rbf",
    gamma: Optional[float] = None,
    degree: int = 3,
    coef0: float = 1.0,
    landmarks=None,
    generator: Optional[torch.Generator] = None,
    reg: float = 1e-6,
    chunk_size: int = 4096,
    compute_dtype=None,
    device=None,
):
    """(n, m) Nyström feature map, on ``device`` (None is the card):
    kernel k-means at O(n·m·d).

    With m landmark rows L, ``z(x) = K(x, L) · K(L, L)^{−1/2}`` satisfies
    ``z(x)·z(y) ≈ K(x, y)``, so Euclidean k-means on z approximates kernel
    k-means, on the whole engine (``fit_lloyd``, the sharded fits,
    minibatch, streaming).  ``landmarks`` defaults to m distinct rows of x
    drawn from ``generator`` (default: seeded with 0); ``reg`` floors the
    eigenvalues of K(L, L) for the inverse square root, which is
    ``U f(S) Uᵀ`` and so free of the signs ``eigh`` picks."""
    from kmeans_tpu_torch.data.synthetic import generator_for

    dev = resolve_device(device)
    x = as_tensor(x, dev)
    gamma, degree, coef0 = resolve_kernel_params(kernel, gamma, degree,
                                                 coef0, x.shape[1])
    if landmarks is None:
        if m < 1 or m > x.shape[0]:
            raise ValueError(f"m={m} out of range for n={x.shape[0]}")
        gen = generator_for(0 if generator is None else generator, dev)
        idx = torch.randperm(x.shape[0], generator=gen, device=dev)[:m]
        landmarks = x[idx]
    else:
        landmarks = as_tensor(landmarks, dev)
        if landmarks.ndim != 2 or landmarks.shape[1] != x.shape[1]:
            raise ValueError(
                f"landmarks must be (m, {x.shape[1]}), got "
                f"{tuple(landmarks.shape)}")
    lf = landmarks.float()
    l_sq = sq_norms(lf)
    f32 = torch.float32
    k_mm = kernel_tile(lf, lf, l_sq, l_sq, kernel=kernel, gamma=gamma,
                       degree=degree, coef0=coef0, cd=f32)
    # Symmetrize, then the inverse square root with floored eigenvalues.
    k_mm = 0.5 * (k_mm + k_mm.T)
    s, u = torch.linalg.eigh(k_mm)
    inv_sqrt = u * (1.0 / torch.sqrt(s.clamp_min(reg)))[None, :]
    with full_f32():
        transform = inv_sqrt @ u.T                  # K_mm^{-1/2}, (m, m)
    return _nystrom_map(x, lf, transform, kernel=kernel, gamma=gamma,
                        degree=degree, coef0=coef0, chunk_size=chunk_size,
                        compute_dtype=compute_dtype)
