"""Fit models of the port: initialization, full-batch Lloyd, the
step-paced runner, the accelerated fits and minibatch k-means."""

from kmeans_tpu_torch.models.accelerated import fit_lloyd_accelerated
from kmeans_tpu_torch.models.lloyd import (KMeans, KMeansState, fit_lloyd,
                                           fit_plan)
from kmeans_tpu_torch.models.minibatch import (MiniBatchKMeans, batch_update,
                                               fit_minibatch, nested_ladder)
from kmeans_tpu_torch.models.runner import IterInfo, LloydRunner


def state_centers(state):
    """The (k, d) center array of any family's fit state, or ``None`` for
    center-free families: the reference's one copy of the field-name
    mapping (centroids / medoids / means)."""
    for attr in ("centroids", "medoids", "means"):
        arr = getattr(state, attr, None)
        if arr is not None:
            return arr
    return None


def state_objective(state) -> float:
    """One lower-is-better scalar for any family's fit state, as in the
    reference: hard families report inertia, fuzzy / kernel their objective
    J, the GMM its negated log-likelihood.  The CLI's result line reads
    it."""
    if hasattr(state, "inertia"):
        return float(state.inertia)
    if hasattr(state, "objective"):
        return float(state.objective)
    return -float(state.log_likelihood)


__all__ = ["KMeans", "KMeansState", "fit_lloyd", "fit_plan",
           "fit_lloyd_accelerated", "fit_minibatch", "MiniBatchKMeans",
           "nested_ladder", "batch_update", "LloydRunner", "IterInfo",
           "state_centers", "state_objective"]
