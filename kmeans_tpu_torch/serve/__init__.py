"""Serving: the assignment engine (:mod:`kmeans_tpu_torch.serve.assign`)."""

from kmeans_tpu_torch.serve.assign import AssignEngine, assign_direct

__all__ = ["AssignEngine", "assign_direct"]
