"""Data of the port: synthetic datasets (blobs, rings, moons), lightweight
coresets, PCA / whitening and the host-to-card streaming of data larger
than the card."""

from kmeans_tpu_torch.data.coreset import lightweight_coreset
from kmeans_tpu_torch.data.preprocess import (PCAState, pca_fit,
                                              pca_fit_stream,
                                              pca_inverse_transform,
                                              pca_transform)
from kmeans_tpu_torch.data.stream import (foreach_chunk, load_mmap,
                                          prefetch_to_device, sample_batches)
from kmeans_tpu_torch.data.synthetic import (BENCH_CONFIGS, bench_config,
                                             make_blobs, make_moons,
                                             make_rings)

__all__ = ["make_blobs", "make_rings", "make_moons", "BENCH_CONFIGS",
           "bench_config", "lightweight_coreset", "load_mmap",
           "sample_batches",
           "prefetch_to_device", "foreach_chunk", "PCAState", "pca_fit",
           "pca_fit_stream", "pca_inverse_transform", "pca_transform"]
