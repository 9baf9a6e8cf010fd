"""Carry fit state between the JAX package and the port, as numpy arrays.

A reference ``KMeansState`` (or any mapping or object with the fields
``centroids``, ``labels``, ``counts``, ``inertia``, ``n_iter`` and, where
present, ``converged``) becomes a port :class:`KMeansState` on a device, and
back.  A reference ``MiniBatchKMeans``'s state and lifetime counts
(``_n_seen``) carry on in the port's estimator.  A reference registry
``Generation`` (its published fields) becomes a port
:class:`~kmeans_tpu_torch.continuous.registry.Generation`, and a fitted
state publishes into a port registry, so both engines can serve one model.
Nothing here imports JAX: a JAX array converts through ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.continuous.registry import Generation, ModelRegistry
from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.models.lloyd import KMeansState

__all__ = ["state_from_numpy", "state_to_numpy", "minibatch_from_numpy",
           "generation_from_numpy", "publish_state"]

_DTYPES = {"centroids": np.float32, "labels": np.int32, "inertia": np.float32,
           "n_iter": np.int32, "converged": np.bool_, "counts": np.float32}


def _field(src, name, default=None):
    if isinstance(src, dict):
        return src.get(name, default)
    return getattr(src, name, default)


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


def minibatch_from_numpy(state, n_seen=None, *, device=None):
    """``(state, n_seen)`` for a port ``MiniBatchKMeans`` on ``device``
    (None is the card) to carry on a reference estimator's ``partial_fit``
    stream: ``state`` as :func:`state_from_numpy` takes it (the estimator's
    ``state`` fields) and ``n_seen`` its ``_n_seen`` lifetime counts, or
    None after ``fit`` (the port rescales from the state's counts, as the
    reference does).  Set both on the estimator::

        est = MiniBatchKMeans(n_clusters=k, batch_size=b)
        est.state, est._n_seen = minibatch_from_numpy(fields, n_seen)
    """
    st = state_from_numpy(state, device=device)
    if n_seen is not None:
        n_seen = torch.from_numpy(np.array(n_seen, dtype=np.float32,
                                           order="C")).to(st.centroids.device)
    return st, n_seen


def generation_from_numpy(src) -> Generation:
    """A port generation from ``src``, a mapping or an object with the
    reference's published fields: ``centroids`` and ``generation``, and
    where present ``trigger``, ``meta`` and ``created_ts``."""
    return Generation(np.asarray(_field(src, "centroids"), np.float32),
                      int(_field(src, "generation")),
                      trigger=_field(src, "trigger", "publish"),
                      meta=_field(src, "meta"),
                      created_ts=_field(src, "created_ts"))


def publish_state(registry: ModelRegistry, state, *,
                  trigger: str = "publish", meta=None,
                  generation=None) -> Generation:
    """Publish the centroids of a fitted state (a port or reference
    ``KMeansState``, a mapping with ``centroids``, or a fitted ``KMeans``
    with ``cluster_centers_``) into a port registry; returns the new
    generation."""
    c = _field(state, "centroids")
    if c is None:
        c = _field(state, "cluster_centers_")
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    return registry.publish(np.asarray(c, np.float32), trigger=trigger,
                            meta=meta, generation=generation)
