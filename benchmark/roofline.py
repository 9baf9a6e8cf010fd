"""The card's peaks and the operations and bytes of the kernels the cells read.

Peaks are NVIDIA's published H100 SXM figures (dense, no sparsity), at the
full 700 W power limit; a card set below it runs slower under load, so every
share is printed beside the card's power limit (:func:`power_limit_w`).

A share of a roofline is the least time the work could take on the card --
the larger of its operations over the peak rate and its bytes over the peak
bandwidth -- over the time the kernels took.  Operations and bytes are those
the inputs need: each input byte read once and each output byte written
once, whatever a kernel reads again.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

#: Dense bf16 tensor-core rate.  It is taken as the least time of a scoring
#: product whatever precision the route uses (the f32 route's six bf16
#: passes included), so a share never exceeds what the card could do.
PEAK_OPS_PER_S = 989e12
#: HBM3 bandwidth.
PEAK_BYTES_PER_S = 3.35e12

_ITEM = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def itemsize(dtype: Optional[str], default: str = "float32") -> int:
    return _ITEM[dtype or default]


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time for ``ops`` operations moving ``nbytes`` bytes."""
    return max(ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


def scoring_ops(rows: float, d: int, k: int) -> float:
    """Multiply-adds, counted as two operations, of scoring ``rows`` rows of
    width ``d`` against ``k`` centroids."""
    return 2.0 * rows * d * k


def delta_sweep_bytes(n: int, d: int, k: int, x_bytes: int,
                      c_bytes: int) -> float:
    """One incremental sweep (K2, ``lloyd_delta_cuda``): x and the centroid
    operand read once; ||c||², the weights and the previous labels read;
    labels and min_d2 written; the delta sums and counts written."""
    reads = n * d * x_bytes + k * d * c_bytes + 4.0 * k + 2 * 4.0 * n
    writes = 2 * 4.0 * n + 4.0 * k * d + 4.0 * k
    return reads + writes


def k2_least_seconds(n: int, d: int, k: int, x_dtype: str,
                     compute_dtype: Optional[str]) -> float:
    """The least time of one K2 call at this shape."""
    xb = itemsize(x_dtype)
    cb = itemsize(compute_dtype, x_dtype)
    return least_seconds(scoring_ops(n, d, k),
                         delta_sweep_bytes(n, d, k, xb, cb))


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts as ``nvidia-smi`` reads it, or None
    where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (subprocess.SubprocessError, ValueError, IndexError, OSError):
        return None
