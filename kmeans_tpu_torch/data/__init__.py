"""Synthetic data of the port."""

from kmeans_tpu_torch.data.synthetic import (BENCH_CONFIGS, bench_config,
                                             make_blobs)

__all__ = ["make_blobs", "BENCH_CONFIGS", "bench_config"]
