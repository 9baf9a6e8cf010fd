"""Shared helpers: verified array and state checkpoints, preemption,
profiling, room codes and fault injection."""

from kmeans_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    latest_step,
    load_array_checkpoint,
    load_checkpoint,
    save_array_checkpoint,
    save_checkpoint,
)
from kmeans_tpu_torch.utils.preempt import Preempted, PreemptionGuard
from kmeans_tpu_torch.utils.profiling import Timer, capture, trace
from kmeans_tpu_torch.utils.rooms import (code4, initials, new_card_id,
                                          new_centroid_id)

__all__ = ["CorruptCheckpointError", "latest_step", "load_array_checkpoint",
           "load_checkpoint", "save_array_checkpoint", "save_checkpoint",
           "Preempted", "PreemptionGuard", "Timer", "capture", "trace",
           "code4", "initials", "new_card_id", "new_centroid_id"]
