"""kmeans_tpu_torch: the PyTorch / CUDA port of ``kmeans_tpu``.

A package of its own beside the JAX one, which it never imports: full-batch
Lloyd k-means with the incremental delta sweep, the bound-pruned hamerly and
yinyang sweeps and the adaptive ``update="auto"`` loop, the accelerated fits
(beta, Anderson, the nested ladder) and minibatch k-means, whose sweep
kernels are hand-written CUDA for Hopper (``csrc/lloyd.cu``), built with
``nvcc`` at first use.  The assignment engine (:class:`AssignEngine`) serves
a fitted model from a :class:`ModelRegistry`: dense scoring on the
streamed-argmin kernel, closure-pruned and int8-codebook routes.  Every
public entry point runs on the card unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch versions run; with
no card and no ``device="cpu"`` it raises.
"""

from kmeans_tpu_torch.config import KMeansConfig, ServeConfig
from kmeans_tpu_torch.continuous.registry import Generation, ModelRegistry
from kmeans_tpu_torch.data.synthetic import make_blobs
from kmeans_tpu_torch.models.accelerated import fit_lloyd_accelerated
from kmeans_tpu_torch.models.init import kmeans_plus_plus
from kmeans_tpu_torch.models.lloyd import (KMeans, KMeansState, fit_lloyd,
                                           fit_plan)
from kmeans_tpu_torch.models.minibatch import (MiniBatchKMeans, batch_update,
                                               fit_minibatch, nested_ladder)
from kmeans_tpu_torch.ops.delta import delta_pass
from kmeans_tpu_torch.ops.lloyd import lloyd_pass
from kmeans_tpu_torch.serve.assign import AssignEngine

__all__ = ["KMeans", "KMeansConfig", "KMeansState", "fit_lloyd", "fit_plan",
           "kmeans_plus_plus", "make_blobs", "lloyd_pass", "delta_pass",
           "ServeConfig", "Generation", "ModelRegistry", "AssignEngine",
           "fit_lloyd_accelerated", "fit_minibatch", "MiniBatchKMeans",
           "nested_ladder", "batch_update"]
