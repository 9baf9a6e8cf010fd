"""Drift-aware continuous clustering over unbounded streams.

Counterpart of ``kmeans_tpu/continuous``:

* :mod:`~kmeans_tpu_torch.continuous.drift`: threshold and EWMA drift
  detectors over the per-batch inertia.
* :mod:`~kmeans_tpu_torch.continuous.window`: sliding-window storage with
  lightweight-coreset compaction, so the refits' "recent data" stays
  bounded however long the stream runs.
* :mod:`~kmeans_tpu_torch.continuous.registry`: the fitted-model registry
  (atomic publishes, verified persistence) that ``cli serve --model-dir``
  serves.
* :mod:`~kmeans_tpu_torch.continuous.pipeline`: the loop that composes
  them: watch inertia, compact the window, refit, publish.
* :mod:`~kmeans_tpu_torch.continuous.synth`: the deterministic
  drifting-blob stream (batch t a pure function of ``(seed, t)``).
"""

from kmeans_tpu_torch.continuous.drift import (DriftMonitor, EWMADetector,
                                               ThresholdDetector)
from kmeans_tpu_torch.continuous.pipeline import (BatchInfo, ContinuousConfig,
                                                  ContinuousPipeline)
from kmeans_tpu_torch.continuous.registry import Generation, ModelRegistry
from kmeans_tpu_torch.continuous.synth import (drift_batch, drift_stream,
                                               true_centers)
from kmeans_tpu_torch.continuous.window import SlidingWindow

__all__ = [
    "BatchInfo",
    "ContinuousConfig",
    "ContinuousPipeline",
    "DriftMonitor",
    "EWMADetector",
    "Generation",
    "ModelRegistry",
    "SlidingWindow",
    "ThresholdDetector",
    "drift_batch",
    "drift_stream",
    "true_centers",
]
