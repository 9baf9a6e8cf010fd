"""Fitted-model registry: atomic hot-swap publish, in memory.

Counterpart of ``kmeans_tpu/continuous/registry.py``.  A
:class:`ModelRegistry` holds the current :class:`Generation`, an immutable
snapshot of a fitted model.  Publishing is one reference swap under a lock,
so a reader that took ``current()`` before a swap finishes its request on
the old generation and the next request sees the new one; no reader sees a
torn model and nothing blocks while a swap happens.

Persistence (``path=``, ``load_latest``) rides the reference's verified
checkpoints, which the port does not have yet: a registry with a ``path``
refuses to publish rather than skip the write.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["Generation", "ModelRegistry"]


class Generation:
    """One immutable published model, read freely from any thread.

    The centroids are copied at construction (f32, host memory) and never
    mutated: a reader holding a generation across a swap keeps exactly the
    model it started with.
    """

    __slots__ = ("centroids", "generation", "trigger", "created_ts", "meta",
                 "_sq_norms")

    def __init__(self, centroids, generation: int, *,
                 trigger: str = "publish",
                 meta: Optional[Dict[str, Any]] = None,
                 created_ts: Optional[float] = None):
        self.centroids = np.array(centroids, np.float32, copy=True)
        self._sq_norms: Optional[np.ndarray] = None
        if self.centroids.ndim != 2:
            raise ValueError(
                f"centroids must be (k, d); got {self.centroids.shape}")
        self.generation = int(generation)
        self.trigger = str(trigger)
        self.created_ts = (time.time() if created_ts is None
                           else float(created_ts))
        self.meta = dict(meta or {})

    @property
    def k(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def d(self) -> int:
        return int(self.centroids.shape[1])

    def sq_norms(self) -> np.ndarray:
        """(k,) f32 squared centroid norms, computed once per generation.
        Concurrent first readers compute the same value; the slot
        assignment is atomic."""
        sq = self._sq_norms
        if sq is None:
            c = self.centroids
            sq = np.einsum("kd,kd->k", c, c).astype(np.float32)
            self._sq_norms = sq
        return sq

    def describe(self) -> Dict[str, Any]:
        """JSON-safe metadata (the reference's ``/api/model`` body)."""
        return {
            "generation": self.generation,
            "k": self.k,
            "d": self.d,
            "trigger": self.trigger,
            "created_ts": round(self.created_ts, 6),
            "meta": {k: v for k, v in self.meta.items()
                     if isinstance(v, (str, int, float, bool, type(None)))},
        }


class ModelRegistry:
    """Current-generation holder.  ``path`` names the reference's
    checkpoint directory; the port keeps it for call compatibility and
    refuses to publish under it (see the module docstring)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._cond = threading.Condition()
        self._current: Optional[Generation] = None

    def current(self) -> Optional[Generation]:
        """The served generation (None before the first publish).  Lock
        free: a reference read is atomic and the object behind it
        immutable, which is the whole hot-swap contract."""
        return self._current

    @property
    def generation(self) -> int:
        gen = self._current
        return gen.generation if gen is not None else 0

    def wait_for(self, generation: int, timeout: Optional[float] = None
                 ) -> bool:
        """Block until ``self.generation >= generation``."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self.generation >= generation, timeout=timeout)

    def publish(self, centroids, *, trigger: str = "publish",
                meta: Optional[Dict[str, Any]] = None,
                generation: Optional[int] = None) -> Generation:
        """Install a new generation atomically and return it.  A
        ``generation`` equal to the current one is a no-op reload; a lower
        one raises."""
        if self.path:
            raise NotImplementedError(
                f"ModelRegistry(path={self.path!r}): persistence needs the "
                "verified checkpoints, which the port does not have yet; "
                "use path=None")
        gen_no = (self.generation + 1 if generation is None
                  else int(generation))
        gen = Generation(centroids, gen_no, trigger=trigger, meta=meta)
        self._install(gen)
        return gen

    def _install(self, gen: Generation) -> None:
        with self._cond:
            cur = self._current
            if cur is not None and gen.generation <= cur.generation:
                if gen.generation == cur.generation:
                    return
                raise ValueError(
                    f"generation {gen.generation} does not advance the "
                    f"registry (current {cur.generation})")
            self._current = gen
            self._cond.notify_all()
