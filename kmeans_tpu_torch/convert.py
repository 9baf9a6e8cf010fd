"""Carry fit state between the JAX package and the port, as numpy arrays.

A reference ``KMeansState`` (or any mapping or object with the fields
``centroids``, ``labels``, ``counts``, ``inertia``, ``n_iter`` and, where
present, ``converged``) becomes a port :class:`KMeansState` on a device, and
back.  Nothing here imports JAX: a JAX array converts through
``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.models.lloyd import KMeansState

__all__ = ["state_from_numpy", "state_to_numpy"]

_DTYPES = {"centroids": np.float32, "labels": np.int32, "inertia": np.float32,
           "n_iter": np.int32, "converged": np.bool_, "counts": np.float32}


def state_from_numpy(src, *, device=None) -> KMeansState:
    """A port state on ``device`` (None is the card) from ``src``: a mapping
    or an object with the state's fields (``converged`` defaults to
    False)."""
    dev = resolve_device(device)

    def field(name):
        if isinstance(src, dict):
            value = src.get(name, False) if name == "converged" else src[name]
        else:
            value = getattr(src, name, False) if name == "converged" \
                else getattr(src, name)
        # A copy: JAX arrays convert to read-only numpy views.
        arr = np.array(value, dtype=_DTYPES[name], order="C")
        return torch.from_numpy(arr).to(dev)

    return KMeansState(**{name: field(name) for name in KMeansState._fields})


def state_to_numpy(state: KMeansState) -> dict:
    """``{field: numpy array}`` of a port state, in the reference's dtypes."""
    return {name: np.asarray(getattr(state, name).cpu().numpy(),
                             dtype=_DTYPES[name])
            for name in KMeansState._fields}
