"""Sliding-window storage with lightweight-coreset compaction.

Counterpart of ``kmeans_tpu/continuous/window.py``: the window's entries
live on the host as numpy arrays, as the reference's do, and a compaction
runs :func:`~kmeans_tpu_torch.data.coreset.lightweight_coreset` on the
window's device (K1 at k = 1 on the card for the distances to the mean),
its draws from a :class:`torch.Generator` seeded with
``(compaction sequence << 16) | 0xC0``, the integer the reference feeds
``jax.random.key``.

The continuous pipeline's refits run on "the recent data" — but a stream
is unbounded, so the window must be bounded in BOTH directions:

* **Slide** — only the newest ``max_batches`` entries stay; older ones
  are dropped.  Forgetting is the point: after drift, the window is
  fully on the new regime within one window length, so refits track the
  stream instead of averaging over every regime it ever visited.
* **Compact** — when the resident point count crosses ``compact_above``
  the whole window is folded into one m-point weighted coreset
  (:func:`kmeans_tpu_torch.data.coreset.lightweight_coreset`, which composes
  over already-weighted sets — repeated compaction stays an unbiased
  cost estimator of the window it summarizes).  The coreset occupies a
  single entry and slides out like any other batch.

Memory is therefore O(max(coreset_size, max_batches · batch_size))
points forever; the weighted fits downstream
(``fit_lloyd(..., weights=...)``) treat raw rows (weight 1) and
compacted rows (importance weights) identically.

The compaction is the ``continuous.compact`` fault-injection site: it is
pure compute over data the window still
holds and mutates nothing until it succeeds, so an injected transient
failure leaves the window intact and the next push simply retries.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from kmeans_tpu_torch.obs import counter as _obs_counter, gauge as _obs_gauge
from kmeans_tpu_torch.utils import faults

__all__ = ["SlidingWindow"]

_WINDOW_POINTS = _obs_gauge(
    "kmeans_tpu_continuous_window_points",
    "Points (raw + compacted coreset rows) resident in the continuous "
    "pipeline's sliding window",
)
_COMPACTIONS_TOTAL = _obs_counter(
    "kmeans_tpu_continuous_compactions_total",
    "Sliding-window coreset compactions performed",
)
_COMPACT_FAILURES_TOTAL = _obs_counter(
    "kmeans_tpu_continuous_compact_failures_total",
    "Transient compaction failures absorbed (window left intact, retried "
    "at the next push)",
)


class SlidingWindow:
    """Bounded weighted point store over the newest stream batches.

    ``decay`` < 1 multiplies the weights produced by each compaction, so
    mass that has survived a compaction cycle counts less than fresh raw
    batches — a soft-forgetting knob on top of the hard slide.
    ``decay=1`` keeps the unbiased-summary semantics.  Compactions run on
    ``device`` (None is the card).
    """

    def __init__(self, *, max_batches: int = 8, compact_above: int = 32768,
                 coreset_size: int = 4096, decay: float = 1.0,
                 chunk_size: int = 4096, device=None):
        from kmeans_tpu_torch.device import resolve_device

        if max_batches < 1:
            raise ValueError(f"max_batches must be >= 1, got {max_batches}")
        if coreset_size < 1:
            raise ValueError(f"coreset_size must be >= 1, got {coreset_size}")
        if compact_above <= coreset_size:
            raise ValueError(
                f"compact_above ({compact_above}) must exceed coreset_size "
                f"({coreset_size}) or compaction could never shrink the "
                "window"
            )
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.max_batches = int(max_batches)
        self.compact_above = int(compact_above)
        self.coreset_size = int(coreset_size)
        self.decay = float(decay)
        self.chunk_size = int(chunk_size)
        self.device = resolve_device(device)
        #: (points (m, d) f32, weights (m,) f32) entries, newest last.
        self._entries: List[Tuple[np.ndarray, np.ndarray]] = []
        self._compact_seq = 0

    # ------------------------------------------------------------- inspect
    @property
    def n_points(self) -> int:
        return sum(int(p.shape[0]) for p, _ in self._entries)

    @property
    def n_batches(self) -> int:
        return len(self._entries)

    @property
    def compactions(self) -> int:
        return self._compact_seq

    # -------------------------------------------------------------- mutate
    def push(self, points: np.ndarray,
             weights: Optional[np.ndarray] = None) -> None:
        """Append one batch (and slide/compact as the bounds require)."""
        points = np.asarray(points, np.float32)
        if points.ndim != 2:
            raise ValueError(
                f"window batches are 2-D (n, d); got shape {points.shape}"
            )
        w = (np.ones((points.shape[0],), np.float32) if weights is None
             else np.asarray(weights, np.float32))
        if w.shape != (points.shape[0],):
            raise ValueError(
                f"weights shape {w.shape} != ({points.shape[0]},)"
            )
        self._entries.append((points, w))
        # Slide: entries beyond the window are forgotten outright.
        while len(self._entries) > self.max_batches:
            self._entries.pop(0)
        if self.n_points > self.compact_above:
            try:
                self.compact()
            except (OSError, ConnectionError, TimeoutError):
                # A transient failure left the window uncorrupted, merely
                # over its SOFT cap; the next push retries.  Long-running
                # pipelines must not die to one flaky compaction — but a
                # PERMANENT fault must not let the window grow without
                # bound either, so past 2x the cap it surfaces.
                if self.n_points > 2 * self.compact_above:
                    raise
                _COMPACT_FAILURES_TOTAL.inc()
        _WINDOW_POINTS.set(self.n_points)

    def compact(self) -> None:
        """Fold the resident window into one coreset entry."""
        from kmeans_tpu_torch.obs import tracing as _tracing

        pts, w = self.snapshot()
        if pts.shape[0] <= self.coreset_size:
            return
        with _tracing.span("continuous.compact", category="compact",
                           points=int(pts.shape[0]),
                           coreset=self.coreset_size):
            # Fault site before any state mutates: an injected failure (or
            # a kill) here leaves the window exactly as it was.
            faults.check("continuous.compact")
            from kmeans_tpu_torch.data.coreset import lightweight_coreset

            # Deterministic per compaction: the seed folds in the
            # compaction sequence number, so a resumed pipeline that
            # replays the same batches compacts identically.
            cpts, cw = lightweight_coreset(
                (self._compact_seq << 16) | 0xC0, pts, self.coreset_size,
                weights=w, chunk_size=self.chunk_size, device=self.device,
            )
            entry = (cpts.float().cpu().numpy(),
                     cw.cpu().numpy().astype(np.float32) * self.decay)
        self._entries = [entry]
        self._compact_seq += 1
        _COMPACTIONS_TOTAL.inc()
        _WINDOW_POINTS.set(self.n_points)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(points (n, d) f32, weights (n,) f32)`` of the whole window,
        a copy safe to hand to a fit."""
        if not self._entries:
            raise ValueError("window is empty — push at least one batch")
        pts = np.concatenate([p for p, _ in self._entries])
        w = np.concatenate([wi for _, wi in self._entries])
        return pts, w

    def snapshot_parts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Snapshot plus per-entry row counts, so :meth:`restore` can
        rebuild the exact entry structure — the slide schedule depends on
        it, and a resumed pipeline must slide exactly as the undisturbed
        one would (the bit-identical-replay contract)."""
        pts, w = self.snapshot()
        splits = np.asarray([p.shape[0] for p, _ in self._entries],
                            np.int64)
        return pts, w, splits

    def restore(self, points: np.ndarray, weights: np.ndarray,
                splits: Optional[np.ndarray] = None) -> None:
        """Reload the window from a checkpointed snapshot.  ``splits``
        (per-entry row counts) rebuilds the original entry boundaries;
        without it the snapshot loads as one entry (it then slides out
        as a unit — coarser, but safe)."""
        points = np.asarray(points, np.float32)
        weights = np.asarray(weights, np.float32)
        if points.ndim != 2 or weights.shape != (points.shape[0],):
            raise ValueError(
                f"bad window snapshot shapes {points.shape} / "
                f"{weights.shape}"
            )
        if splits is None:
            counts = [points.shape[0]]
        else:
            counts = [int(c) for c in np.asarray(splits).ravel()]
            if sum(counts) != points.shape[0]:
                raise ValueError(
                    f"window splits {counts} do not partition "
                    f"{points.shape[0]} rows"
                )
        self._entries = []
        lo = 0
        for c in counts:
            if c > 0:
                self._entries.append((points[lo:lo + c].copy(),
                                      weights[lo:lo + c].copy()))
            lo += c
        _WINDOW_POINTS.set(self.n_points)
