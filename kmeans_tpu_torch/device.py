"""Device and dtype resolution shared by the port's public entry points.

Every public entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU device it raises rather
than falling back quietly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "as_dtype"]

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return dev


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """``a`` (tensor, numpy array or sequence) on ``device``.  float64
    becomes float32, as JAX computes with x64 off."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if dtype is None and t.dtype == torch.float64:
        dtype = torch.float32
    return t.to(device=device, dtype=dtype)
