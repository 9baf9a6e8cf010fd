"""Continuous clustering: the fitted-model registry the engine serves."""

from kmeans_tpu_torch.continuous.registry import Generation, ModelRegistry

__all__ = ["Generation", "ModelRegistry"]
