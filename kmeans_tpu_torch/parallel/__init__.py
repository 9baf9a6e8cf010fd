"""Parallelism: the mesh of processes, the data-parallel engine and the
multi-process bootstrap.

Counterpart of ``kmeans_tpu/parallel``, one process per device over
``torch.distributed`` (NCCL on the cards, gloo between CPU processes): the
Lloyd fit (DP, DP×TP, DP×FP and DP×TP×FP; elastic checkpoints), the DP
accelerated, trimmed, spherical, minibatch, fuzzy, GMM and balanced
fits, ``sharded_assign``, sharded k-means|| and the sharded PCA fit, and
the pairwise families: k-medoids and kernel k-means as ring passes over
the row blocks (:meth:`Mesh.ring_shift`) and the spectral embedding with
landmark-sized all-reduces.
"""

from kmeans_tpu_torch.parallel.distributed import (ensure_initialized,
                                                   process_info)
from kmeans_tpu_torch.parallel.engine import (
    fit_balanced_sharded, fit_fuzzy_sharded, fit_gmm_sharded,
    fit_lloyd_accelerated_sharded, fit_lloyd_sharded, fit_minibatch_sharded,
    fit_spherical_sharded, fit_trimmed_sharded, pad_and_place,
    sharded_assign)
from kmeans_tpu_torch.parallel.init_sharded import kmeans_parallel_sharded
from kmeans_tpu_torch.parallel.kernel import fit_kernel_kmeans_sharded
from kmeans_tpu_torch.parallel.medoids import fit_kmedoids_sharded
from kmeans_tpu_torch.parallel.mesh import (Mesh, cpu_mesh, make_mesh,
                                            mesh_from_config)
from kmeans_tpu_torch.parallel.preprocess import pca_fit_sharded
from kmeans_tpu_torch.parallel.spectral import spectral_embedding_sharded

__all__ = [
    "ensure_initialized",
    "process_info",
    "fit_lloyd_sharded",
    "fit_lloyd_accelerated_sharded",
    "fit_trimmed_sharded",
    "fit_minibatch_sharded",
    "fit_spherical_sharded",
    "fit_fuzzy_sharded",
    "fit_gmm_sharded",
    "fit_balanced_sharded",
    "pca_fit_sharded",
    "fit_kernel_kmeans_sharded",
    "fit_kmedoids_sharded",
    "spectral_embedding_sharded",
    "kmeans_parallel_sharded",
    "pad_and_place",
    "sharded_assign",
    "Mesh",
    "cpu_mesh",
    "make_mesh",
    "mesh_from_config",
]
