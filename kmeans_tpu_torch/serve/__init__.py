"""Serving: the HTTP model server (:mod:`kmeans_tpu_torch.serve.server`) and
the assignment engine (:mod:`kmeans_tpu_torch.serve.assign`)."""

from kmeans_tpu_torch.serve.assign import AssignEngine, assign_direct
from kmeans_tpu_torch.serve.server import KMeansServer, serve

__all__ = ["KMeansServer", "serve", "AssignEngine", "assign_direct"]
