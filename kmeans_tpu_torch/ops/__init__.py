"""Sweep operators of the port: distances, the fused and delta passes, the
centroid update, and the CUDA kernels with their plain versions."""
