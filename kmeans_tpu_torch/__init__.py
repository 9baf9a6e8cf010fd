"""kmeans_tpu_torch: the PyTorch / CUDA port of ``kmeans_tpu``.

A package of its own beside the JAX one, which it never imports: full-batch
Lloyd k-means with the incremental delta sweep, whose three sweep kernels
are hand-written CUDA for Hopper (``csrc/lloyd.cu``), built with ``nvcc`` at
first use.  Every public entry point runs on the card unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch versions run; with
no card and no ``device="cpu"`` it raises.
"""

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.synthetic import make_blobs
from kmeans_tpu_torch.models.init import kmeans_plus_plus
from kmeans_tpu_torch.models.lloyd import KMeans, KMeansState, fit_lloyd
from kmeans_tpu_torch.ops.delta import delta_pass
from kmeans_tpu_torch.ops.lloyd import lloyd_pass

__all__ = ["KMeans", "KMeansConfig", "KMeansState", "fit_lloyd",
           "kmeans_plus_plus", "make_blobs", "lloyd_pass", "delta_pass"]
