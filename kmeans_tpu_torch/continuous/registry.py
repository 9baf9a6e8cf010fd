"""Fitted-model registry: atomic hot-swap publish and verified persistence.

Counterpart of ``kmeans_tpu/continuous/registry.py``.  A
:class:`ModelRegistry` holds the current :class:`Generation`, an immutable
snapshot of a fitted model.  Publishing is one reference swap under a lock,
so a reader that took ``current()`` before a swap finishes its request on
the old generation and the next request sees the new one; no reader sees a
torn model and nothing blocks while a swap happens.

With ``path=`` every publish first writes a verified checkpoint
(:mod:`kmeans_tpu_torch.utils.checkpoint`, the reference's format, so
either package reads the other's model directory) and then swaps: disk is
never behind memory, including at the ``registry.swap`` fault site between
the two.  ``load_latest`` restores the newest verified generation.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from kmeans_tpu_torch.obs import counter as _obs_counter, gauge as _obs_gauge
from kmeans_tpu_torch.obs import tracing as _tracing
from kmeans_tpu_torch.utils import faults
from kmeans_tpu_torch.utils.checkpoint import (latest_step,
                                               load_array_checkpoint,
                                               save_array_checkpoint)

__all__ = ["Generation", "ModelRegistry"]

_REGISTRY_GENERATION = _obs_gauge(
    "kmeans_tpu_registry_generation",
    "Generation number of the model currently served by the registry "
    "(0 = no model published yet)",
)
_REGISTRY_SWAPS_TOTAL = _obs_counter(
    "kmeans_tpu_registry_swaps_total",
    "Model generations published (atomic hot-swaps completed)",
    labels=("trigger",),
)


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
    """Current-generation holder with persist-then-swap publishes.

    ``path`` is the checkpoint directory (None keeps the registry in
    memory); ``keep`` step-tagged retention dirs survive each publish.
    """

    def __init__(self, path: Optional[str] = None, *, keep: int = 2):
        self.path = path
        self.keep = int(keep)
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
                extra_arrays: Optional[Dict[str, np.ndarray]] = None,
                generation: Optional[int] = None) -> Generation:
        """Persist (when ``path`` is set), then install a new generation
        atomically; returns it.  ``extra_arrays`` ride the same verified
        checkpoint and ``meta`` lands in its ``extra`` dict and the
        generation's metadata.  A ``generation`` equal to the current one
        is a no-op reload; a lower one raises."""
        gen_no = (self.generation + 1 if generation is None
                  else int(generation))
        gen = Generation(centroids, gen_no, trigger=trigger, meta=meta)
        if self.path and self._current is None:
            # A fresh registry over a dir that already holds a newer
            # generation would lose every later load to that stale higher
            # step.  Strictly greater: an equal step is this publish's own
            # checkpoint from a retried attempt.
            prior = latest_step(self.path)
            if prior is not None and prior > gen_no:
                raise ValueError(
                    f"model dir {self.path!r} already holds generation "
                    f"{prior} (final or retention siblings); resume from "
                    "it (load_latest / --resume) or remove "
                    f"{self.path!r}, {self.path!r}.old and "
                    f"{self.path!r}.step-* to start fresh"
                )
        if self.path:
            arrays = {"centroids": gen.centroids}
            for name, arr in (extra_arrays or {}).items():
                if name in arrays:
                    raise ValueError(f"extra array name {name!r} collides")
                arrays[name] = np.asarray(arr)
            save_array_checkpoint(
                self.path, arrays, step=gen_no,
                extra={"continuous_model": True, "trigger": gen.trigger,
                       "created_ts": gen.created_ts, **gen.meta},
                keep=self.keep,
            )
        # A kill here leaves disk one generation ahead of memory: the safe
        # direction (a restart serves the newer model).
        faults.check("registry.swap")
        self._install(gen)
        return gen

    def _install(self, gen: Generation) -> None:
        with _tracing.span("registry.swap", category="swap",
                           generation=gen.generation, trigger=gen.trigger):
            with self._cond:
                cur = self._current
                if cur is not None and gen.generation <= cur.generation:
                    if gen.generation == cur.generation:
                        return        # reload of what is already served
                    raise ValueError(
                        f"generation {gen.generation} does not advance the "
                        f"registry (current {cur.generation})")
                self._current = gen
                self._cond.notify_all()
        _REGISTRY_GENERATION.set(gen.generation)
        _REGISTRY_SWAPS_TOTAL.labels(trigger=gen.trigger).inc()

    def load_latest(self) -> Optional[Tuple[Generation, dict, dict]]:
        """Restore the newest verified generation from ``path``.

        Returns ``(generation, arrays, meta)`` (the raw checkpoint
        contents), or None when no checkpoint exists.  A checkpoint that
        exists but fails verification raises
        :class:`~kmeans_tpu_torch.utils.checkpoint.CorruptCheckpointError`,
        and one without the registry's tag a ``ValueError``: serving a
        silently wrong model is the one thing this layer must not do.
        """
        if not self.path:
            return None
        try:
            arrays, meta = load_array_checkpoint(self.path)
        except FileNotFoundError:
            return None
        extra = dict(meta.get("extra") or {})
        if not extra.pop("continuous_model", False):
            raise ValueError(
                f"checkpoint at {self.path!r} is not a model-registry "
                "checkpoint (no continuous_model tag) — refusing to serve "
                "arbitrary arrays as a model"
            )
        gen = Generation(
            arrays["centroids"], int(meta["step"]),
            trigger=str(extra.pop("trigger", "resume")),
            created_ts=extra.pop("created_ts", None),
            meta=extra,
        )
        self._install(gen)
        return gen, arrays, meta
