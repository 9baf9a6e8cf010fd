"""Codebook compression: per-centroid-scale symmetric int8 and bf16.

Counterpart of ``kmeans_tpu/quant/codebook.py``, copied (pure NumPy, bit
for bit): the engine builds a :class:`QuantizedCodebook` inside its
``PreparedModel`` on the hot-swap path.

The contract every consumer leans on is the **error bound**: for each
centroid, ``err[j]`` is an upper bound on ``||c_j - dequantize(c_j)||`` in
exact arithmetic, computed from the actual dequantized values in float64
and rounded up on the cast to f32, so it holds however degenerate the
scales get (all-zero centroids, subnormal scales, anything finite).  The
pruning scorers (:mod:`kmeans_tpu_torch.quant.score`) turn that bound into a
provably complete candidate set.

int8 layout: ``q[j] = clip(round(c[j] / scale[j]), -127, 127)`` with
``scale[j] = max|c[j]| / 127``.  bf16 layout: round-to-nearest-even
truncation of the f32 bit pattern, stored as the uint16 high halves;
dequantization is a 16-bit shift.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["QUANT_MODES", "QuantizedCodebook", "quantize_codebook",
           "dequantize", "dequantize_matrix"]

#: The codebook compression modes and their per-element payload bytes.
QUANT_MODES = {"int8": 1, "bf16": 2}

#: int8 symmetric range: +-127 (not -128) keeps the scale symmetric so
#: negation commutes with quantization and |q| * scale never exceeds
#: the row's max magnitude.
_QMAX = 127.0


class QuantizedCodebook(NamedTuple):
    """One immutable compressed codebook.

    ``q``
        ``(k, d)`` payload: int8 codes, or uint16 bf16 bit patterns.
    ``scale``
        ``(k,)`` f32 per-centroid dequantization scale (all-ones for
        bf16 — the bf16 payload carries its own exponents).
    ``err``
        ``(k,)`` f32 upper bound on ``||c_j - dequant(c_j)||_2``,
        float64-measured and rounded up — THE soundness contract.
    ``csq_hat``
        ``(k,)`` f32 squared norms of the dequantized centroids (the
        quantized score constant, cached once like ``Generation.
        sq_norms``).
    ``mode``
        ``"int8"`` | ``"bf16"``.
    """

    q: np.ndarray
    scale: np.ndarray
    err: np.ndarray
    csq_hat: np.ndarray
    mode: str

    @property
    def k(self) -> int:
        return int(self.q.shape[0])

    @property
    def d(self) -> int:
        return int(self.q.shape[1])

    def nbytes(self) -> int:
        """Resident bytes of the compressed scoring tier (payload +
        scales + error bounds + cached norms)."""
        return (self.q.nbytes + self.scale.nbytes + self.err.nbytes
                + self.csq_hat.nbytes)


def _bf16_trunc(c: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even bf16 bit patterns (uint16) of f32 ``c``."""
    u = np.ascontiguousarray(c, np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16))
                                        & np.uint32(1))) >> np.uint32(16)
    return rounded.astype(np.uint16)


def _bf16_expand(q: np.ndarray) -> np.ndarray:
    """f32 values from uint16 bf16 bit patterns."""
    return (np.ascontiguousarray(q, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def quantize_codebook(centroids: np.ndarray,
                      mode: str = "int8") -> QuantizedCodebook:
    """Compress a ``(k, d)`` f32 codebook; exports per-centroid error
    bounds (see the module docstring for the layouts and the bound's
    contract).  Raises ``ValueError`` on an unknown mode, a non-2D
    input, or non-finite centroid values — a NaN/inf centroid has no
    sound error bound, and quantizing it silently would turn the
    provable prune into a lie.
    """
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; "
                         f"have {sorted(QUANT_MODES)}")
    c = np.ascontiguousarray(centroids, np.float32)
    if c.ndim != 2:
        raise ValueError(f"centroids must be (k, d); got shape {c.shape}")
    if not np.isfinite(c).all():
        raise ValueError(
            "centroids contain non-finite values; no quantization error "
            "bound exists for them")
    if mode == "bf16":
        q = _bf16_trunc(c)
        scale = np.ones(c.shape[0], np.float32)
        c_hat = _bf16_expand(q)
    else:
        amax = np.abs(c).max(axis=1)
        scale = (amax / _QMAX).astype(np.float32)
        # Reciprocal in float64: a subnormal f32 scale would overflow
        # 1/scale to inf in f32 arithmetic; a zero scale (all-zero
        # centroid, or amax so small the f32 quotient flushed to zero)
        # maps the whole row to code 0 — the error bound below is
        # measured from the actual dequantized values either way, so
        # both degeneracies stay sound.
        inv = np.where(scale > 0, 1.0 / np.maximum(
            scale.astype(np.float64), np.finfo(np.float64).tiny), 0.0)
        q = np.clip(np.rint(c.astype(np.float64) * inv[:, None]),
                    -_QMAX, _QMAX).astype(np.int8)
        c_hat = q.astype(np.float32) * scale[:, None]
    # The bound is measured, not modeled: float64 residual norm of the
    # ACTUAL f32 dequantization, then one ulp up on the f32 cast so the
    # stored f32 value can never round below the true norm.
    r = c.astype(np.float64) - c_hat.astype(np.float64)
    err64 = np.sqrt(np.einsum("kd,kd->k", r, r))
    err = np.nextafter(err64.astype(np.float32), np.float32(np.inf))
    err[err64 == 0.0] = 0.0
    csq_hat = np.einsum("kd,kd->k", c_hat.astype(np.float64),
                        c_hat.astype(np.float64)).astype(np.float32)
    return QuantizedCodebook(q=q, scale=scale, err=err,
                             csq_hat=csq_hat, mode=mode)


def dequantize(qcb: QuantizedCodebook) -> np.ndarray:
    """The ``(k, d)`` f32 codebook the scores are actually computed
    against — i.e. ``c_hat``, the thing ``err`` bounds the distance
    to."""
    if qcb.mode == "bf16":
        return _bf16_expand(qcb.q)
    return qcb.q.astype(np.float32) * qcb.scale[:, None]


def dequantize_matrix(q: np.ndarray, mode: str,
                      out: np.ndarray = None) -> np.ndarray:
    """Expand ONE packed payload matrix (any shape) to f32 *without*
    applying scales — the grouped-GEMM hot loop's helper: the
    per-centroid scale folds into the post-GEMM elementwise pass, so
    the expansion here is a cast (int8) or a shift (bf16) straight into
    the reusable scratch buffer.
    """
    if mode == "bf16":
        src = (np.ascontiguousarray(q, np.uint16).astype(np.uint32)
               << np.uint32(16)).view(np.float32)
        if out is None:
            return src
        np.copyto(out, src)
        return out
    if out is None:
        return q.astype(np.float32)
    np.copyto(out, q, casting="safe")
    return out
