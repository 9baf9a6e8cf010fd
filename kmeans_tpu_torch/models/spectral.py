"""Spectral clustering: normalized-Laplacian embedding + k-means.

Counterpart of ``kmeans_tpu/models/spectral.py``.  Clusters by graph
connectivity instead of Euclidean compactness (concentric rings,
half-moons): rbf affinity W, normalized Laplacian D^{-1/2} W D^{-1/2}, its
top-k eigenvectors, row-normalized, then k-means (Ng, Jordan & Weiss).
The embedding is the Nyström approximation (Fowlkes et al.): chunked
kernel tiles against m landmark rows and one (m, m) ``eigh``:

    C  = K(x, L)                          (n, m)  chunked kernel tiles
    d̂  = C · K(L,L)⁺ · (Cᵀ·1)             approximate degrees
    Z  = diag(d̂)^{-1/2} · C · K(L,L)^{+1/2}        (n, m)
    Zᵀ Z = V S Vᵀ  (m, m eigh)  →  U = Z V S^{-1/2}  top-k columns

Every product is ``torch.matmul`` in IEEE f32 (the reference's are XLA
code, no Pallas kernel); the final k-means is :func:`~kmeans_tpu_torch.
models.lloyd.fit_lloyd` on the embedding (K1 and K2 on the card), or with
``mesh=`` the sharded engine on the embedding of
:func:`~kmeans_tpu_torch.parallel.spectral.spectral_embedding_sharded`.
The embedding is unique only up to a rotation of its top eigenspace (the
signs ``eigh`` picks, and any turn inside a near-degenerate eigenvalue
pair), so it is compared by its projector, and labels up to permutation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.lloyd import fit_lloyd
from kmeans_tpu_torch.ops.distance import full_f32, sq_norms

__all__ = ["SpectralState", "spectral_embedding", "fit_spectral",
           "SpectralClustering", "landmark_ops"]


def landmark_ops(landmarks, *, gamma, degree, coef0, reg):
    """Landmark-side operators of the Nyström embedding: the f32 landmark
    rows, their squared norms, and the pseudo-inverse and its square root
    of the (m, m) landmark kernel: THE one copy shared by the single-device
    and the sharded embeddings."""
    from kmeans_tpu_torch.models.kernel import kernel_tile

    lf = landmarks.float()
    l_sq = sq_norms(lf)
    w_mm = kernel_tile(lf, lf, l_sq, l_sq, kernel="rbf", gamma=gamma,
                       degree=degree, coef0=coef0, cd=torch.float32)
    w_mm = 0.5 * (w_mm + w_mm.T)
    s_mm, u_mm = torch.linalg.eigh(w_mm)
    # A relative-cutoff pseudo-inverse, not an absolute floor: an rbf Gram
    # over nearby landmarks is numerically low-rank, and flooring its junk
    # eigenvalues at a tiny constant would amplify those directions by
    # 1/sqrt(floor) in f32 and drown the Laplacian's eigenvectors.
    cut = reg * s_mm.max()
    inv_s = torch.where(s_mm > cut, 1.0 / torch.maximum(s_mm, cut), 0.0)
    with full_f32():
        w_inv = (u_mm * inv_s[None, :]) @ u_mm.T
        w_inv_sqrt = (u_mm * torch.sqrt(inv_s)[None, :]) @ u_mm.T
    return lf, l_sq, w_inv, w_inv_sqrt


def embed_rows(x, valid, ops, *, k, gamma, cd, chunk_size, mesh=None,
               mark=None):
    """The row-normalized embedding of the rows ``x`` (``valid`` 1 on a
    real row, 0 on padding) and the top-k eigenvectors of the Gram: THE
    one copy of the embedding's row math.  On a mesh the two
    landmark-sized sums (Cᵀ·valid and the (m, m) Gram) are all-reduced and
    every rank runs ``eigh`` on the same bits; nothing row-sized crosses
    ranks.  ``mark(name)``, if given, is called as each stage is queued
    (C tiles, degrees, Gram, eigh, U), for a timed split.  Returns
    ``(U (n_rows, k), V_top (m, k))``."""
    mark = mark or (lambda name: None)
    from kmeans_tpu_torch.models.kernel import kernel_tile

    lf, l_sq, w_inv, w_inv_sqrt = ops
    m = lf.shape[0]
    C = torch.empty((x.shape[0], m), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], chunk_size):
        # The rows rounded to the compute dtype, the landmarks in f32: the
        # reference's tile product (its landmarks are never cast).
        xb = x[lo:lo + chunk_size].float()
        C[lo:lo + chunk_size] = kernel_tile(
            xb.to(cd).float(), lf, sq_norms(xb), l_sq, kernel="rbf",
            gamma=gamma, degree=3, coef0=1.0, cd=torch.float32)
    mark("C tiles")
    with full_f32():
        t = C.T @ valid
        if mesh is not None:
            mesh.all_reduce(t)
        deg = (C @ (w_inv @ t)).clamp_min(1e-12)
        mark("degrees")
        Z = (C / torch.sqrt(deg)[:, None]) @ w_inv_sqrt      # (n, m)
        del C
        zm = Z * valid[:, None]
        g = zm.T @ zm
        if mesh is not None:
            mesh.all_reduce(g)
        g = 0.5 * (g + g.T)
        mark("Gram")
        s_g, v_g = torch.linalg.eigh(g)
        mark("eigh")
        top = torch.arange(m - 1, m - k - 1, -1, device=x.device)
        v_top = v_g[:, top]
        s_top = s_g[top].clamp_min(1e-12)
        U = (Z @ v_top) / torch.sqrt(s_top)[None, :]          # (n, k)
    norms = torch.sqrt((U * U).sum(dim=1, keepdim=True).clamp_min(1e-12))
    U = U / norms
    mark("U")
    return U, v_top


def draw_landmarks(n: int, k: int, n_landmarks, generator, device):
    """The landmark rows' indices: ``min(max(n_landmarks or max(256, 2k),
    1), n)`` distinct rows drawn from ``generator`` (default: seeded with
    0) on ``device``; fewer than k is refused."""
    from kmeans_tpu_torch.data.synthetic import generator_for

    # Default scales with k (a k-dim embedding needs comfortably more than
    # k landmark directions); small datasets go exact.
    m = min(max(n_landmarks or max(256, 2 * k), 1), n)
    if m < k:
        raise ValueError(f"n_landmarks must be >= k={k}, got {m}")
    gen = generator_for(0 if generator is None else generator, device)
    return torch.randperm(n, generator=gen, device=device)[:m]


def check_landmarks(landmarks, k: int, d: int):
    if landmarks.ndim != 2 or landmarks.shape[1] != d:
        raise ValueError(
            f"landmarks must be (m, {d}), got {tuple(landmarks.shape)}")
    if landmarks.shape[0] < k:
        raise ValueError(
            f"need at least k={k} landmarks, got {landmarks.shape[0]}")


class SpectralState(NamedTuple):
    """Result of a spectral fit: cluster labels plus the embedding the
    k-means ran on."""

    labels: torch.Tensor      # (n,) int32
    embedding: torch.Tensor   # (n, k) float32, row-normalized
    inertia: torch.Tensor     # k-means objective IN EMBEDDING SPACE
    n_iter: torch.Tensor      # scalar int32 (of the embedding k-means)
    converged: torch.Tensor   # scalar bool
    counts: torch.Tensor      # (k,) float32


def spectral_embedding(
    x,
    k: int,
    *,
    n_landmarks: Optional[int] = None,
    gamma: Optional[float] = None,
    landmarks=None,
    generator: Optional[torch.Generator] = None,
    reg: float = 1e-4,
    chunk_size: int = 4096,
    compute_dtype=None,
    device=None,
):
    """Row-normalized (n, k) Nyström approximation of the normalized
    Laplacian's top-k eigenvector embedding (rbf affinity), on ``device``
    (None is the card).

    ``gamma`` defaults to 1/d; explicit ``landmarks`` (m, d) set the
    approximation's support, otherwise ``n_landmarks`` distinct rows drawn
    from ``generator`` (clamped to n).  ``reg`` is the relative spectrum
    cutoff of the landmark kernel's pseudo-inverse.  ``compute_dtype``
    sets the rows' dtype in the K(x, L) tiles (the dominant cost); the
    landmark side and ``eigh`` stay f32."""
    from kmeans_tpu_torch.device import as_dtype
    from kmeans_tpu_torch.models.kernel import resolve_kernel_params

    dev = resolve_device(device)
    x = as_tensor(x, dev)
    n, d = x.shape
    gamma, degree, coef0 = resolve_kernel_params("rbf", gamma, 3, 1.0, d)
    if landmarks is None:
        landmarks = x[draw_landmarks(n, k, n_landmarks, generator, dev)]
    else:
        landmarks = as_tensor(landmarks, dev)
        check_landmarks(landmarks, k, d)
    ops = landmark_ops(landmarks, gamma=gamma, degree=degree, coef0=coef0,
                       reg=reg)
    cd = torch.float32 if compute_dtype is None else as_dtype(compute_dtype)
    return embed_rows(x, torch.ones(n, dtype=torch.float32, device=dev), ops,
                      k=k, gamma=gamma, cd=cd, chunk_size=chunk_size)[0]


def fit_generator(generator, config, device):
    """``(landmark generator, fit generator)``: the landmarks draw from
    ``generator`` (default: seeded with ``config.seed``) and the k-means
    seeding from a generator derived from its seed and 1, the reference's
    ``fold_in(key, 1)``: so explicit landmarks leave the seeding as it
    was."""
    from kmeans_tpu_torch.data.synthetic import generator_for
    from kmeans_tpu_torch.models.lloyd import restart_generator

    gen = generator_for(
        (config.seed if config is not None else 0) if generator is None
        else generator, device)
    return gen, restart_generator(gen.initial_seed(), 1, device)


def fit_spectral(
    x,
    k: int,
    *,
    n_landmarks: Optional[int] = None,
    gamma: Optional[float] = None,
    landmarks=None,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    mesh=None,
    data_axis: str = "data",
    device=None,
) -> SpectralState:
    """Spectral clustering: Nyström Laplacian embedding + k-means, on
    ``device`` (None is the card) or with ``mesh`` over its ranks.

    One generator drives the landmark sample and, through a derived one
    (:func:`fit_generator`), the embedding-space k-means seeding.  With
    ``mesh`` both stages shard: the embedding through
    :func:`~kmeans_tpu_torch.parallel.spectral.spectral_embedding_sharded`
    (only landmark-sized data crosses ranks) and the k-means on the
    sharded engine; the same generator draws the same landmarks, so the
    embedding is the single-device one up to the f32 order of the sums
    (bit for bit on a mesh of one)."""
    chunk = config.chunk_size if config is not None else 4096
    cd = config.compute_dtype if config is not None else None
    if mesh is None:
        dev = resolve_device(device)
        gen, fit_gen = fit_generator(generator, config, dev)
        emb = spectral_embedding(
            x, k, n_landmarks=n_landmarks, gamma=gamma, landmarks=landmarks,
            generator=gen, chunk_size=chunk, compute_dtype=cd, device=dev)
        st = fit_lloyd(emb, k, generator=fit_gen, config=config, tol=tol,
                       max_iter=max_iter, device=dev)
    else:
        from kmeans_tpu_torch.parallel import fit_lloyd_sharded
        from kmeans_tpu_torch.parallel.spectral import \
            spectral_embedding_sharded

        gen, fit_gen = fit_generator(generator, config, mesh.device)
        emb = spectral_embedding_sharded(
            x, k, mesh=mesh, data_axis=data_axis, n_landmarks=n_landmarks,
            gamma=gamma, landmarks=landmarks, generator=gen,
            chunk_size=chunk, compute_dtype=cd)
        st = fit_lloyd_sharded(emb, k, mesh=mesh, data_axis=data_axis,
                               generator=fit_gen, config=config, tol=tol,
                               max_iter=max_iter)
    return SpectralState(st.labels, emb, st.inertia, st.n_iter,
                         st.converged, st.counts)


@dataclasses.dataclass
class SpectralClustering:
    """Estimator wrapper over :func:`fit_spectral` (sklearn-like), on
    ``device`` (None is the card).

    >>> sc = SpectralClustering(n_clusters=2, seed=0).fit(x)
    >>> sc.labels_            # separates rings Lloyd cannot
    """

    n_clusters: int = 3
    n_landmarks: Optional[int] = None
    gamma: Optional[float] = None
    max_iter: int = 100
    tol: float = 1e-4
    seed: int = 0
    chunk_size: int = 4096
    device: Optional[str] = None

    state: Optional[SpectralState] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def fit(self, x) -> "SpectralClustering":
        self.state = fit_spectral(
            x, self.n_clusters, n_landmarks=self.n_landmarks,
            gamma=self.gamma,
            config=KMeansConfig(k=self.n_clusters, max_iter=self.max_iter,
                                tol=self.tol, seed=self.seed,
                                chunk_size=self.chunk_size),
            device=self.device)
        return self

    def fit_predict(self, x):
        return self.fit(x).labels_

    @property
    def labels_(self):
        return self.state.labels

    @property
    def embedding_(self):
        return self.state.embedding

    @property
    def n_iter_(self):
        return int(self.state.n_iter)
