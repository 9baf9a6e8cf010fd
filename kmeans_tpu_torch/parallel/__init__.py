"""Parallelism: the mesh of processes, the data-parallel engine and the
multi-process bootstrap.

Counterpart of ``kmeans_tpu/parallel``, one process per device over
``torch.distributed`` (NCCL on the cards, gloo between CPU processes).  The
data-parallel Lloyd and minibatch fits, ``sharded_assign`` and sharded
k-means|| are ported (ROADMAP A4a); the TP / FP bodies, the elastic path
and the other sharded families are not yet (A4b, A9).
"""

from kmeans_tpu_torch.parallel.distributed import (ensure_initialized,
                                                   process_info)
from kmeans_tpu_torch.parallel.engine import (fit_lloyd_sharded,
                                              fit_minibatch_sharded,
                                              pad_and_place, sharded_assign)
from kmeans_tpu_torch.parallel.init_sharded import kmeans_parallel_sharded
from kmeans_tpu_torch.parallel.mesh import (Mesh, cpu_mesh, make_mesh,
                                            mesh_from_config)

__all__ = [
    "ensure_initialized",
    "process_info",
    "fit_lloyd_sharded",
    "fit_minibatch_sharded",
    "kmeans_parallel_sharded",
    "pad_and_place",
    "sharded_assign",
    "Mesh",
    "cpu_mesh",
    "make_mesh",
    "mesh_from_config",
]
