"""Serving: the HTTP model server (:mod:`kmeans_tpu_torch.serve.server`),
the assignment engine (:mod:`kmeans_tpu_torch.serve.assign`) and the worker
fleet over one port (:mod:`kmeans_tpu_torch.serve.fleet`)."""

from kmeans_tpu_torch.serve.assign import AssignEngine, assign_direct
from kmeans_tpu_torch.serve.server import KMeansServer, serve

__all__ = ["KMeansServer", "serve", "AssignEngine", "assign_direct"]
