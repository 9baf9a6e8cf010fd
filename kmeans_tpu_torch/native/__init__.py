"""Native (C++) host-side components of the port, bound with ctypes: the
streamed fits' row gather (:mod:`kmeans_tpu_torch.native.loader`)."""

from kmeans_tpu_torch.native.loader import (gather_counts, gather_rows,
                                            native_available,
                                            reset_gather_counts, to_bfloat16)

__all__ = ["gather_rows", "native_available", "to_bfloat16", "gather_counts",
           "reset_gather_counts"]
