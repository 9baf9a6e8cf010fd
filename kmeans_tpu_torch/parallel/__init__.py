"""Parallelism: the mesh of processes, the data-parallel engine and the
multi-process bootstrap.

Counterpart of ``kmeans_tpu/parallel``, one process per device over
``torch.distributed`` (NCCL on the cards, gloo between CPU processes): the
Lloyd fit (DP, DP×TP, DP×FP and DP×TP×FP; elastic checkpoints), the DP
accelerated, trimmed, spherical and minibatch fits, ``sharded_assign``
and sharded k-means||.  The other sharded families are not ported yet
(ROADMAP A9b, A9c).
"""

from kmeans_tpu_torch.parallel.distributed import (ensure_initialized,
                                                   process_info)
from kmeans_tpu_torch.parallel.engine import (
    fit_lloyd_accelerated_sharded, fit_lloyd_sharded, fit_minibatch_sharded,
    fit_spherical_sharded, fit_trimmed_sharded, pad_and_place,
    sharded_assign)
from kmeans_tpu_torch.parallel.init_sharded import kmeans_parallel_sharded
from kmeans_tpu_torch.parallel.mesh import (Mesh, cpu_mesh, make_mesh,
                                            mesh_from_config)

__all__ = [
    "ensure_initialized",
    "process_info",
    "fit_lloyd_sharded",
    "fit_lloyd_accelerated_sharded",
    "fit_trimmed_sharded",
    "fit_minibatch_sharded",
    "fit_spherical_sharded",
    "kmeans_parallel_sharded",
    "pad_and_place",
    "sharded_assign",
    "Mesh",
    "cpu_mesh",
    "make_mesh",
    "mesh_from_config",
]
