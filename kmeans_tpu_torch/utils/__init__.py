"""Shared helpers: verified array checkpoints and fault injection."""

from kmeans_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    latest_step,
    load_array_checkpoint,
    save_array_checkpoint,
)

__all__ = ["CorruptCheckpointError", "latest_step", "load_array_checkpoint",
           "save_array_checkpoint"]
