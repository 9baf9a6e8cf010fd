"""Pairwise distances and assignment (the Lloyd "assign" step).

Counterpart of ``kmeans_tpu/ops/distance.py``.  Assignment is
``argmin_k ||x - c_k||²`` computed as ``argmin_k (||c_k||² - 2·x·c_kᵀ)``;
the row term ``||x||²`` is added back for the distance value.

Products in the compute dtype follow the reference's numerics: bf16 operands
multiply exactly and accumulate in f32 (the MXU's, and the tensor cores',
behaviour), and f32 means real f32 — TF32 is off for every f32 product, as
the reference forces ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

__all__ = ["chunk_tiles", "sq_norms", "pairwise_sq_dists", "assign",
           "full_f32", "cd_product", "cd_matmul", "resolve_cd"]


def resolve_cd(compute_dtype, x_dtype: torch.dtype) -> torch.dtype:
    """The compute dtype: ``compute_dtype`` (name or dtype) or ``x_dtype``."""
    from kmeans_tpu_torch.device import as_dtype

    return x_dtype if compute_dtype is None else as_dtype(compute_dtype)


@contextlib.contextmanager
def full_f32():
    """Run f32 products in full f32: TF32 off for matmuls and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def cd_product(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype):
    """``cd(a) @ cd(b)ᵀ`` with f32 accumulation, as an f32 tensor.

    The operands are rounded to ``cd`` and widened back to f32, so a bf16
    product is exact and only the accumulation rounds — the MXU's
    ``preferred_element_type=f32`` semantics."""
    with full_f32():
        return a.to(cd).float() @ b.to(cd).float().T


def cd_matmul(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype):
    """``cd(a) @ cd(b)`` with f32 accumulation and output: on the card a
    bf16 product with f32 output, else the f32 product of the
    ``cd``-rounded operands with TF32 off (the same values: bf16 products
    are exact in f32)."""
    if a.is_cuda and cd == torch.bfloat16:
        return torch.mm(a.to(cd), b.to(cd), out_dtype=torch.float32)
    with full_f32():
        return a.to(cd).float() @ b.to(cd).float()


def chunk_tiles(x: torch.Tensor, w: Optional[torch.Tensor], chunk_size: int):
    """Pad rows to a chunk multiple and reshape into tiles.

    Returns ``(xs (n_chunks, chunk, d), ws (n_chunks, chunk), n)``; padding
    rows carry weight 0.  ``w`` may be None (all-ones weights)."""
    n, d = x.shape
    w = (torch.ones(n, dtype=torch.float32, device=x.device) if w is None
         else w.float())
    pad = (-n) % chunk_size
    if pad:
        x = torch.cat([x, x.new_zeros(pad, d)])
        w = torch.cat([w, w.new_zeros(pad)])
    return (x.reshape(-1, chunk_size, d), w.reshape(-1, chunk_size), n)


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms in float32."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def pairwise_sq_dists(x, centroids, *, compute_dtype=None) -> torch.Tensor:
    """Full (n × k) squared-distance matrix (small problems and tests)."""
    cd = resolve_cd(compute_dtype, x.dtype)
    prod = cd_product(x, centroids, cd)
    d2 = sq_norms(x)[:, None] - 2.0 * prod + sq_norms(centroids)[None, :]
    return d2.clamp_min(0.0)


def assign(x, centroids, *, chunk_size: int = 4096, compute_dtype=None,
           backend: str = "auto",
           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid ``(labels int32 [n], min_sq_dists f32 [n])``; ties
    break toward the lower centroid index.  On the card this is the classic
    kernel with its fold switched off."""
    from kmeans_tpu_torch.ops.lloyd import lloyd_pass

    labels, mind, _, _, _ = lloyd_pass(
        x, centroids, chunk_size=chunk_size, compute_dtype=compute_dtype,
        with_update=False, backend=backend, device=device)
    return labels, mind
