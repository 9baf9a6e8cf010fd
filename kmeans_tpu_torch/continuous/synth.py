"""Deterministic drifting-blob stream for soak drills and tests.

A copy of ``kmeans_tpu/continuous/synth.py`` (numpy only): the port's
batches are the reference's bit for bit.

Batch ``t`` is a pure function of ``(seed, t)``, the same contract the
streamed loaders give their reads (``data/stream.py``), and the property
every recovery drill leans on: a pipeline killed at batch 17 and resumed
replays batches 17, 18, ... bit-identically, so "resumed run matches the
undisturbed run" is a testable equality, not a statistical hope.

The stream is k Gaussian blobs whose centers move: before ``drift_at``
they sit at the base positions; over the ``drift_len`` batches after it
they glide (smoothstep) to the base plus a per-center offset of norm
``drift``.  ``drift_len=0`` makes the jump abrupt — the regime the
threshold detector exists for; long ``drift_len`` creeps — the EWMA
regime.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["drift_batch", "drift_stream", "true_centers"]


def _base_centers(seed: int, k: int, d: int) -> np.ndarray:
    rng = np.random.default_rng((seed, 0xBA5E))
    return (rng.normal(size=(k, d)) * 4.0).astype(np.float32)


def _offsets(seed: int, k: int, d: int, drift: float) -> np.ndarray:
    rng = np.random.default_rng((seed, 0x0FF5))
    off = rng.normal(size=(k, d)).astype(np.float32)
    norms = np.maximum(np.linalg.norm(off, axis=1, keepdims=True), 1e-9)
    return off / norms * drift


def _drift_frac(t: int, drift_at: int, drift_len: int) -> float:
    if t < drift_at:
        return 0.0
    if drift_len <= 0:
        return 1.0
    u = min(1.0, (t - drift_at) / float(drift_len))
    return u * u * (3.0 - 2.0 * u)          # smoothstep


def true_centers(t: int, *, seed: int = 0, k: int = 4, d: int = 8,
                 drift_at: int = 30, drift: float = 6.0,
                 drift_len: int = 0) -> np.ndarray:
    """The generating centers at batch ``t`` (test oracle)."""
    frac = _drift_frac(t, drift_at, drift_len)
    return _base_centers(seed, k, d) + frac * _offsets(seed, k, d, drift)


def drift_batch(t: int, *, n: int = 512, d: int = 8, k: int = 4,
                seed: int = 0, drift_at: int = 30, drift: float = 6.0,
                drift_len: int = 0,
                cluster_std: float = 0.6) -> np.ndarray:
    """One ``(n, d)`` float32 batch — a pure function of ``(seed, t)``."""
    centers = true_centers(t, seed=seed, k=k, d=d, drift_at=drift_at,
                           drift=drift, drift_len=drift_len)
    rng = np.random.default_rng((seed, t))
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + rng.normal(size=(n, d)) * cluster_std
    return pts.astype(np.float32)


def drift_stream(steps: int, *, start: int = 0, **kw) -> Iterator[np.ndarray]:
    """Batches ``start..steps-1`` of the drifting stream."""
    for t in range(start, steps):
        yield drift_batch(t, **kw)
