"""Carry fit state between the JAX package and the port, as numpy arrays.

A reference ``KMeansState`` (or any mapping or object with the fields
``centroids``, ``labels``, ``counts``, ``inertia``, ``n_iter`` and, where
present, ``converged``) becomes a port :class:`KMeansState` on a device, and
back; :func:`trimmed_from_numpy` / :func:`trimmed_to_numpy` do the same
for a reference ``TrimmedState`` (its ``outlier_mask`` too), and
:func:`gmm_from_numpy` / :func:`gmm_to_numpy`, :func:`fuzzy_from_numpy`,
:func:`balanced_from_numpy` and :func:`pca_from_numpy` /
:func:`pca_to_numpy` for the GMM, fuzzy, balanced and PCA states, and
:func:`kmedoids_from_numpy` / :func:`kmedoids_to_numpy`,
:func:`kernel_from_numpy` (with the rows the fit saw) and
:func:`spectral_from_numpy` (with its embedding) for the pairwise
families, so a reference fit carried across predicts, soft-predicts,
assigns and projects the same in the port.  A reference
``MiniBatchKMeans``'s state and lifetime counts
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
from kmeans_tpu_torch.data.preprocess import PCAState
from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.models.balanced import BalancedState
from kmeans_tpu_torch.models.fuzzy import FuzzyState
from kmeans_tpu_torch.models.gmm import GMMState
from kmeans_tpu_torch.models.kernel import KernelKMeansState
from kmeans_tpu_torch.models.lloyd import KMeansState
from kmeans_tpu_torch.models.medoids import KMedoidsState
from kmeans_tpu_torch.models.spectral import SpectralState
from kmeans_tpu_torch.models.trimmed import TrimmedState

__all__ = ["state_from_numpy", "state_to_numpy", "minibatch_from_numpy",
           "trimmed_from_numpy", "trimmed_to_numpy", "gmm_from_numpy",
           "gmm_to_numpy", "fuzzy_from_numpy", "balanced_from_numpy",
           "pca_from_numpy", "pca_to_numpy", "kmedoids_from_numpy",
           "kmedoids_to_numpy", "kernel_from_numpy", "spectral_from_numpy",
           "generation_from_numpy", "publish_state"]

_DTYPES = {"centroids": np.float32, "labels": np.int32, "inertia": np.float32,
           "n_iter": np.int32, "converged": np.bool_, "counts": np.float32,
           "outlier_mask": np.bool_, "means": np.float32,
           "covariances": np.float32, "mix_weights": np.float32,
           "log_likelihood": np.float32, "resp_counts": np.float32,
           "objective": np.float32, "col_masses": np.float32,
           "medoids": np.float32, "medoid_indices": np.int32,
           "within_mass": np.float32, "embedding": np.float32}


def _field(src, name, default=None):
    if isinstance(src, dict):
        return src.get(name, default)
    return getattr(src, name, default)


def state_from_numpy(src, *, device=None, cls=KMeansState):
    """A port state on ``device`` (None is the card) from ``src``: a mapping
    or an object with the state's fields (``converged`` defaults to
    False).  ``cls`` is the state type (the fields it names are read)."""
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

    return cls(**{name: field(name) for name in cls._fields})


def state_to_numpy(state) -> dict:
    """``{field: numpy array}`` of a port state (``KMeansState`` or
    ``TrimmedState``), in the reference's dtypes."""
    return {name: np.asarray(getattr(state, name).cpu().numpy(),
                             dtype=_DTYPES[name])
            for name in state._fields}


def trimmed_from_numpy(src, *, device=None) -> TrimmedState:
    """A port :class:`TrimmedState` on ``device`` (None is the card) from
    ``src``, a reference ``TrimmedState`` or a mapping with its fields."""
    return state_from_numpy(src, device=device, cls=TrimmedState)


def trimmed_to_numpy(state: TrimmedState) -> dict:
    """``{field: numpy array}`` of a port :class:`TrimmedState`, in the
    reference's dtypes; the reference's ``TrimmedState(**fields)`` takes
    it."""
    return state_to_numpy(state)


def gmm_from_numpy(src, *, device=None) -> GMMState:
    """A port :class:`~kmeans_tpu_torch.models.gmm.GMMState` on ``device``
    (None is the card) from a reference ``GMMState`` or a mapping with its
    fields: set it as a ``GaussianMixture``'s ``state``."""
    return state_from_numpy(src, device=device, cls=GMMState)


def gmm_to_numpy(state: GMMState) -> dict:
    """``{field: numpy array}`` of a port GMM state; the reference's
    ``GMMState(**fields)`` takes it."""
    return state_to_numpy(state)


def fuzzy_from_numpy(src, *, device=None) -> FuzzyState:
    """A port :class:`~kmeans_tpu_torch.models.fuzzy.FuzzyState` from a
    reference ``FuzzyState`` or a mapping with its fields."""
    return state_from_numpy(src, device=device, cls=FuzzyState)


def balanced_from_numpy(src, *, device=None) -> BalancedState:
    """A port :class:`~kmeans_tpu_torch.models.balanced.BalancedState`
    from a reference ``BalancedState`` or a mapping with its fields."""
    return state_from_numpy(src, device=device, cls=BalancedState)


def pca_from_numpy(src, *, device=None) -> PCAState:
    """A port :class:`~kmeans_tpu_torch.data.preprocess.PCAState` on
    ``device`` (None is the card) from a reference ``PCAState`` or a
    mapping with its fields (``mean``, ``components``,
    ``explained_variance``, ``whiten``)."""
    dev = resolve_device(device)

    def arr(name):
        return torch.from_numpy(np.array(_field(src, name), dtype=np.float32,
                                         order="C")).to(dev)

    return PCAState(arr("mean"), arr("components"),
                    arr("explained_variance"), bool(_field(src, "whiten")))


def pca_to_numpy(state: PCAState) -> dict:
    """``{field: value}`` of a port PCA state (float32 arrays and the
    ``whiten`` flag); the reference's ``PCAState(**fields)`` takes it."""
    out = {name: np.asarray(getattr(state, name).cpu().numpy(), np.float32)
           for name in ("mean", "components", "explained_variance")}
    out["whiten"] = bool(state.whiten)
    return out


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


def kmedoids_from_numpy(src, *, device=None) -> KMedoidsState:
    """A port :class:`~kmeans_tpu_torch.models.medoids.KMedoidsState` on
    ``device`` (None is the card) from a reference ``KMedoidsState`` or a
    mapping with its fields: set it as a ``KMedoids``'s ``state`` to
    ``predict`` with it."""
    return state_from_numpy(src, device=device, cls=KMedoidsState)


def kmedoids_to_numpy(state: KMedoidsState) -> dict:
    """``{field: numpy array}`` of a port k-medoids state; the reference's
    ``KMedoidsState(**fields)`` takes it."""
    return state_to_numpy(state)


def kernel_from_numpy(src, x_fit, weights_fit=None, *, device=None):
    """``(state, x_fit, weights_fit)`` on ``device`` (None is the card) for
    a port ``KernelKMeans`` to predict as a reference fit does: ``src`` a
    reference ``KernelKMeansState`` or a mapping with its fields (labels,
    counts, ``within_mass`` and the rest), ``x_fit`` / ``weights_fit`` the
    rows (and weights) it was fitted on.  Set them on the estimator::

        est = KernelKMeans(n_clusters=k, kernel="rbf")
        est.state, est._x_fit, est._w_fit = kernel_from_numpy(st, x)
    """
    dev = resolve_device(device)
    st = state_from_numpy(src, device=dev, cls=KernelKMeansState)
    x = torch.from_numpy(np.array(x_fit, dtype=np.float32, order="C")).to(dev)
    w = None if weights_fit is None else torch.from_numpy(
        np.array(weights_fit, dtype=np.float32, order="C")).to(dev)
    return st, x, w


def spectral_from_numpy(src, *, device=None) -> SpectralState:
    """A port :class:`~kmeans_tpu_torch.models.spectral.SpectralState` on
    ``device`` (None is the card) from a reference ``SpectralState`` or a
    mapping with its fields, the embedding with them: a final k-means on
    ``state.embedding`` then runs on the reference's embedding."""
    return state_from_numpy(src, device=device, cls=SpectralState)
