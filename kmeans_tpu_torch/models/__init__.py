"""Fit models of the port: initialization, full-batch Lloyd, the accelerated
fits and minibatch k-means."""

from kmeans_tpu_torch.models.accelerated import fit_lloyd_accelerated
from kmeans_tpu_torch.models.lloyd import (KMeans, KMeansState, fit_lloyd,
                                           fit_plan)
from kmeans_tpu_torch.models.minibatch import (MiniBatchKMeans, batch_update,
                                               fit_minibatch, nested_ladder)

__all__ = ["KMeans", "KMeansState", "fit_lloyd", "fit_plan",
           "fit_lloyd_accelerated", "fit_minibatch", "MiniBatchKMeans",
           "nested_ladder", "batch_update"]
