"""Parallelism: the mesh of processes, the data-parallel engine and the
multi-process bootstrap.

Counterpart of ``kmeans_tpu/parallel``, one process per device over
``torch.distributed`` (NCCL on the cards, gloo between CPU processes): the
Lloyd fit (DP, DP×TP, DP×FP and DP×TP×FP; elastic checkpoints), the DP
accelerated, trimmed, spherical, minibatch, fuzzy, GMM and balanced
fits, ``sharded_assign``, sharded k-means|| and the sharded PCA fit.  The
pairwise families are not ported yet (ROADMAP A9c).
"""

from kmeans_tpu_torch.parallel.distributed import (ensure_initialized,
                                                   process_info)
from kmeans_tpu_torch.parallel.engine import (
    fit_balanced_sharded, fit_fuzzy_sharded, fit_gmm_sharded,
    fit_lloyd_accelerated_sharded, fit_lloyd_sharded, fit_minibatch_sharded,
    fit_spherical_sharded, fit_trimmed_sharded, pad_and_place,
    sharded_assign)
from kmeans_tpu_torch.parallel.init_sharded import kmeans_parallel_sharded
from kmeans_tpu_torch.parallel.mesh import (Mesh, cpu_mesh, make_mesh,
                                            mesh_from_config)
from kmeans_tpu_torch.parallel.preprocess import pca_fit_sharded

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
    "kmeans_parallel_sharded",
    "pad_and_place",
    "sharded_assign",
    "Mesh",
    "cpu_mesh",
    "make_mesh",
    "mesh_from_config",
]
