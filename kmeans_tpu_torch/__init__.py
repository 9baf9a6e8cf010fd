"""kmeans_tpu_torch: the PyTorch / CUDA port of ``kmeans_tpu``.

A package of its own beside the JAX one, which it never imports: full-batch
Lloyd k-means with the incremental delta sweep, the bound-pruned hamerly and
yinyang sweeps and the adaptive ``update="auto"`` loop, the accelerated fits
(beta, Anderson, the nested ladder), minibatch (in memory, or streamed out
of core from host memory: :func:`fit_minibatch_stream`), trimmed,
spherical and bisecting k-means, x-means and g-means, Gaussian mixtures
(:func:`fit_gmm`, streamed: :func:`fit_gmm_stream`), fuzzy c-means,
balanced (Sinkhorn) k-means, k-medoids, kernel k-means (with Nyström
features) and spectral clustering, PCA / whitening
(:mod:`kmeans_tpu_torch.data.preprocess`) and model selection
(:func:`sweep_k`, :mod:`kmeans_tpu_torch.metrics`), whose
sweep kernels are hand-written CUDA for Hopper (``csrc/lloyd.cu``), built
with ``nvcc`` at first use.  The assignment engine (:class:`AssignEngine`) serves
a fitted model from a :class:`ModelRegistry` (in memory, or a directory
of verified checkpoints): dense scoring on the streamed-argmin kernel,
closure-pruned and int8-codebook routes; :mod:`kmeans_tpu_torch.serve.server`
puts it behind HTTP (``python -m kmeans_tpu_torch.cli serve --model-dir D``).
:class:`LloydRunner` steps a fit one sweep at a time (callbacks, telemetry,
checkpoints, a resumable exit on SIGTERM), and ``python -m
kmeans_tpu_torch.cli train`` fits from the command line.
:mod:`kmeans_tpu_torch.continuous` runs drift-aware continuous clustering
into the registry (``python -m kmeans_tpu_torch.cli continuous``).  Every
public entry point runs on the card unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch versions run; with
no card and no ``device="cpu"`` it raises.
"""

from kmeans_tpu_torch.config import KMeansConfig, ServeConfig
from kmeans_tpu_torch.continuous.registry import Generation, ModelRegistry
from kmeans_tpu_torch.data.synthetic import make_blobs
from kmeans_tpu_torch.models.accelerated import fit_lloyd_accelerated
from kmeans_tpu_torch.models.balanced import BalancedKMeans, fit_balanced
from kmeans_tpu_torch.models.bisecting import BisectingKMeans, fit_bisecting
from kmeans_tpu_torch.models.fuzzy import FuzzyCMeans, fit_fuzzy
from kmeans_tpu_torch.models.gmeans import GMeans, fit_gmeans
from kmeans_tpu_torch.models.gmm import GaussianMixture, fit_gmm
from kmeans_tpu_torch.models.gmm_stream import fit_gmm_stream
from kmeans_tpu_torch.models.init import kmeans_plus_plus
from kmeans_tpu_torch.models.kernel import KernelKMeans, fit_kernel_kmeans
from kmeans_tpu_torch.models.lloyd import (KMeans, KMeansState, fit_lloyd,
                                           fit_plan)
from kmeans_tpu_torch.models.medoids import KMedoids, fit_kmedoids
from kmeans_tpu_torch.models.minibatch import (MiniBatchKMeans, batch_update,
                                               fit_minibatch, nested_ladder)
from kmeans_tpu_torch.models.runner import IterInfo, LloydRunner
from kmeans_tpu_torch.models.selection import suggest_k, sweep_k
from kmeans_tpu_torch.models.spectral import SpectralClustering, fit_spectral
from kmeans_tpu_torch.models.spherical import SphericalKMeans, fit_spherical
from kmeans_tpu_torch.models.streaming import (assign_stream,
                                               fit_minibatch_stream)
from kmeans_tpu_torch.models.trimmed import (TrimmedKMeans, TrimmedState,
                                             fit_trimmed)
from kmeans_tpu_torch.models.xmeans import XMeans, fit_xmeans
from kmeans_tpu_torch.ops.delta import delta_pass
from kmeans_tpu_torch.ops.lloyd import lloyd_pass
from kmeans_tpu_torch.serve.assign import AssignEngine

__all__ = ["KMeans", "KMeansConfig", "KMeansState", "fit_lloyd", "fit_plan",
           "kmeans_plus_plus", "make_blobs", "lloyd_pass", "delta_pass",
           "ServeConfig", "Generation", "ModelRegistry", "AssignEngine",
           "fit_lloyd_accelerated", "fit_minibatch", "MiniBatchKMeans",
           "nested_ladder", "batch_update", "LloydRunner", "IterInfo",
           "TrimmedKMeans", "TrimmedState", "fit_trimmed",
           "fit_minibatch_stream", "assign_stream", "SphericalKMeans",
           "fit_spherical", "BisectingKMeans", "fit_bisecting", "XMeans",
           "fit_xmeans", "GMeans", "fit_gmeans", "sweep_k", "suggest_k",
           "GaussianMixture", "fit_gmm", "fit_gmm_stream", "FuzzyCMeans",
           "fit_fuzzy", "BalancedKMeans", "fit_balanced", "KernelKMeans",
           "fit_kernel_kmeans", "KMedoids", "fit_kmedoids",
           "SpectralClustering", "fit_spectral"]
