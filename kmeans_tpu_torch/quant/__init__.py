"""Compressed-codebook scoring with an exact f32 rescore.

Counterpart of ``kmeans_tpu/quant/``.  At codebook scale (k = 65536,
d = 2048) the f32 codebook is a 512 MiB slab; this package compresses the
scoring copy (per-centroid-scale int8, or bf16 truncation) and exports
per-centroid error bounds that make the quantized prune provably complete,
so labels stay the dense f32 path's.

* :mod:`kmeans_tpu_torch.quant.codebook`: ``quantize_codebook`` /
  ``dequantize`` and :class:`QuantizedCodebook` (NumPy).
* :mod:`kmeans_tpu_torch.quant.score`: the host pruner the engine's grouped
  route composes with (NumPy) and the device scan (PyTorch).
"""

from kmeans_tpu_torch.quant.codebook import (
    QUANT_MODES,
    QuantizedCodebook,
    dequantize,
    dequantize_matrix,
    quantize_codebook,
)
from kmeans_tpu_torch.quant.score import (
    QUANT_MARGIN_REL,
    quant_assign_device,
    quant_candidates,
    quant_prune,
)

__all__ = [
    "QUANT_MODES",
    "QUANT_MARGIN_REL",
    "QuantizedCodebook",
    "dequantize",
    "dequantize_matrix",
    "quantize_codebook",
    "quant_assign_device",
    "quant_candidates",
    "quant_prune",
]
