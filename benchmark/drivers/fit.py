"""The driver of fitting mixes: one closed-loop caller of ``KMeans.fit``.

A traffic mix whose ``driver`` is ``"fit"`` is a data file,
``traffic/<mix>.json``, of parameters:

* ``init``: ``"k-means++"`` (every fit seeds itself) or ``"warm"`` (every
  fit starts from the model the rows drifted away from, plus a jitter);
* ``drift``, ``jitter``: for ``"warm"``, in units of the configuration's
  ``cluster_std`` a latent coordinate (:mod:`benchmark.data`);
* ``check_fits``: how many of the window's fits the judge compares with
  the reference, drawn from the seed.

One caller starts each fit when the last has returned, its result
synchronised.  Fit ``i`` of a run gets the seed ``derive_seed(seed,
FIT_STREAM, i)`` cut to 32 bits (a fit's seed also seeds numpy's legacy
generator, which takes no more), so every run of a seed makes the same
calls; the warm-up fit is index -1.  The end-to-end reading is ``fit_s``:
the window over the fits completed in it.

While a session is open two taps wrap functions of the program's fit, for
the judge: :class:`SeedingTap` keeps each fit's k-means++ centres (and, in
a traced run, times the seeding), :class:`UpdateTap` counts each fit's
centroid updates and keeps the centroids its last sweep started from.
"""

from __future__ import annotations

import json
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.data import Dataset, derive_seed, make_dataset, warm_init
from benchmark.judge import Sample, decide, label_tie, readings

__all__ = ["FitCall", "FitRecord", "Traffic", "SeedingTap", "UpdateTap",
           "Session", "fit_once", "is_fit", "sample_of", "FIT_STREAM",
           "WARM_INDEX"]

FIT_STREAM = 3
SAMPLE_STREAM = 4
WARM_INDEX = -1
_INITS = ("k-means++", "warm")


class FitCall(NamedTuple):
    index: int
    seed: int
    init: Optional[torch.Tensor]    # None: the configuration's init method


class FitRecord(NamedTuple):
    """One window fit as the per-layer metrics read it."""
    index: int
    seconds: float              # call to synchronised result, host clock
    n_iter: int
    diag: dict                  # ``KMeans.diag_``
    seed_s: Optional[float]     # its k-means++ span (traced runs)


class Traffic:
    """The calls of one run of a fitting mix."""

    def __init__(self, params: dict, config: dict, ds: Dataset, seed: int):
        if params.get("init") not in _INITS:
            raise ValueError(f"traffic init must be one of {_INITS}")
        if params["init"] == "warm" and ds.c_prev is None:
            raise ValueError("a warm mix needs the dataset's c_prev")
        self.params = params
        self.config = config
        self.ds = ds
        self.seed = seed
        self.check_fits = int(params["check_fits"])

    @property
    def warm_start(self) -> bool:
        return self.params["init"] == "warm"

    def call(self, index: int) -> FitCall:
        init = None
        if self.warm_start:
            init = warm_init(self.ds, self.config, self.params, self.seed,
                             index)
        fit_seed = derive_seed(self.seed, FIT_STREAM, index) & 0xFFFFFFFF
        return FitCall(index, fit_seed, init)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Tap:
    """Wraps ``module.<name>`` for the life of the block."""

    def _wrap(self, module, name, make):
        self._mod, self._name = module, name
        self._orig = getattr(module, name)
        setattr(module, name, make(self._orig))
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self._name, self._orig)
        return False


class SeedingTap(_Tap):
    """Holds each fit's k-means++ centres, and with ``timed`` times the
    seeding between two synchronisations: wraps
    ``kmeans_tpu_torch.models.init.kmeans_plus_plus``, the seeding a fit's
    ``init="k-means++"`` calls."""

    def __init__(self, timed: bool):
        self.timed = timed
        self.seeds = None
        self.seconds = None

    def __enter__(self):
        from kmeans_tpu_torch.models import init as init_mod

        def make(orig):
            def seeding(*args, **kwargs):
                if not self.timed:
                    out = orig(*args, **kwargs)
                else:
                    with torch.profiler.record_function("bench.seeding"):
                        _sync()
                        t = time.perf_counter()
                        out = orig(*args, **kwargs)
                        _sync()
                        self.seconds = time.perf_counter() - t
                self.seeds = out.detach().clone()
                return out
            return seeding
        return self._wrap(init_mod, "kmeans_plus_plus", make)

    def reset(self):
        self.seeds = self.seconds = None


class UpdateTap(_Tap):
    """Counts a fit's centroid updates and keeps the centroids its last
    sweep started from (``prev``): wraps ``apply_update`` as
    ``kmeans_tpu_torch.models.lloyd`` calls it once a sweep.  It keeps a
    reference, not a copy; the loop never writes into its centroids."""

    def __init__(self):
        self.count = 0
        self.prev = None

    def __enter__(self):
        from kmeans_tpu_torch.models import lloyd as lloyd_mod

        def make(orig):
            def update(c, sums, counts):
                self.count += 1
                self.prev = c
                return orig(c, sums, counts)
            return update
        return self._wrap(lloyd_mod, "apply_update", make)

    def reset(self):
        self.count = 0
        self.prev = None


def fit_once(call: FitCall, x, config: dict, device, taps):
    """One fit of ``call`` as the window makes it: ``(km, seconds)``."""
    from kmeans_tpu_torch import KMeans

    fit_cfg = config["fit"]
    km = KMeans(n_clusters=int(config["k"]),
                init=call.init if call.init is not None else fit_cfg["init"],
                max_iter=int(fit_cfg["max_iter"]), tol=float(fit_cfg["tol"]),
                seed=call.seed, n_init=int(fit_cfg["n_init"]),
                compute_dtype=config.get("compute_dtype"),
                update=fit_cfg["update"], device=device)
    for tap in taps:
        tap.reset()
    t = time.perf_counter()
    with torch.profiler.record_function("bench.fit"):
        km.fit(x)
        _sync()
    return km, time.perf_counter() - t


def is_fit(km, updates: int, max_iter: int) -> bool:
    """A result is a fit: a finite inertia, as many centroid updates as
    sweeps it reports, 1..max_iter of them, and a stop that the loop
    allows (it converged, or it ran ``max_iter`` sweeps)."""
    n_iter = int(km.n_iter_)
    return (math.isfinite(km.inertia_) and 1 <= n_iter <= max_iter
            and updates == n_iter
            and (bool(km.state.converged) or n_iter == max_iter))


def sample_of(index: int, call: FitCall, km, seeding: SeedingTap,
              update: UpdateTap) -> Sample:
    return Sample(index, call.seed, seeding.seeds, update.prev,
                  km.state.centroids, km.state.labels, km.inertia_,
                  km.n_iter_, bool(km.state.converged))


class Session:
    """One run of a fitting cell: the rows, the warm-up, the window's fits,
    the traced fits and the judge, as :mod:`benchmark.run` drives them."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool):
        self.config = config
        self.device = device
        self.ds = make_dataset(config, traffic, seed, device)
        self.gen = Traffic(traffic, config, self.ds, seed)
        self.seeding = (not self.gen.warm_start
                        and config["fit"]["init"] == "k-means++")
        self.max_iter = int(config["fit"]["max_iter"])
        self.rng = np.random.default_rng(derive_seed(seed, SAMPLE_STREAM))
        self.records, self.kept, self.bad, self.next = [], {}, 0, 0
        self.taps = (SeedingTap(timed=trace), UpdateTap())

    def __enter__(self):
        for tap in self.taps:
            tap.__enter__()
        return self

    def __exit__(self, *exc):
        for tap in reversed(self.taps):
            tap.__exit__(*exc)
        return False

    def _call(self, index: int):
        call = self.gen.call(index)
        km, dt = fit_once(call, self.ds.x, self.config, self.device,
                          self.taps)
        self.bad += int(not is_fit(km, self.taps[1].count, self.max_iter))
        return call, km, dt

    def warm(self):
        self._call(WARM_INDEX)
        self.bad = 0

    def window(self, seconds: float):
        """Fits back to back until ``seconds`` have passed; a reservoir of
        ``check_fits`` of them, drawn from the seed, is kept to judge."""
        w0 = time.perf_counter()
        check = self.gen.check_fits
        while True:
            i = self.next
            call, km, dt = self._call(i)
            self.records.append(FitRecord(i, dt, km.n_iter_,
                                          dict(km.diag_ or {}),
                                          self.taps[0].seconds))
            slot = i if i < check else int(self.rng.integers(0, i + 1))
            if slot < check:
                self.kept[slot] = sample_of(i, call, km, *self.taps)
            del km
            self.next += 1
            if time.perf_counter() - w0 >= seconds:
                return

    def traced(self, seconds: float):
        """More fits of the same traffic, at least one, for the trace."""
        p0 = time.perf_counter()
        while True:
            _, km, _ = self._call(self.next)
            del km
            self.next += 1
            if time.perf_counter() - p0 >= seconds:
                return

    @property
    def attempted(self) -> int:
        return len(self.records)

    def end_to_end(self, window_s: float) -> dict:
        return {"fit_s": window_s / len(self.records)}

    def judge(self, limits: Optional[dict]):
        """``(correct, checks, failed, lines)`` of the kept fits."""
        tie = label_tie(limits)
        order = sorted(self.kept)
        per_fit = [readings(self.ds.x, self.kept[s], self.config,
                            self.seeding, tie) for s in order]
        correct, checks, failed = decide(per_fit, limits, self.bad)
        lines = [f"judged fit {self.kept[s].index}: " + json.dumps(r)
                 for s, r in zip(order, per_fit)]
        return correct, checks, failed, lines
