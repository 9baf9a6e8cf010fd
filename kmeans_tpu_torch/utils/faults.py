"""Deterministic fault injection for the hardened failure paths.

A copy of ``kmeans_tpu/utils/faults.py``, its counter on the port's
``obs``.  The port's code declares the checkpoint sites (``ckpt.*``),
``registry.swap`` and the fleet's (``fleet.*``, in
``serve/fleet.py``); the catalog below is the reference's whole list.

The long-running surfaces (streamed fits, the sharded engine, the serve
layer) die to preemptions, torn writes, and transient I/O errors in
production — failure paths that ordinary tests never exercise.  This module
makes those paths *testable*: code under test declares named injection
sites (``faults.check("ckpt.pre_rename")``) that are zero-cost no-ops
until a :class:`FaultPlan` is installed, at which point a site can raise a
transient error, stall, deliver SIGTERM to the process, or kill it
outright at the Nth hit — deterministically, so a crash matrix replays the
same way every run.

Site catalog (see docs/RESILIENCE.md for the authoritative list):

======================  ====================================================
``ckpt.pre_write``      checkpoint tmp dir created, nothing written yet
``ckpt.pre_meta``       arrays written, ``meta.json`` not yet
``ckpt.pre_rename``     tmp dir complete, final dir untouched
``ckpt.mid_swap``       between the two renames (final displaced, tmp not in)
``ckpt.post_rename``    final dir in place, retention/cleanup pending
``stream.read``         one host batch/chunk read in the streaming loader
``native.compile``      the native loader's g++ invocation
``dist.init``           ``jax.distributed.initialize`` attempt
``dist.heartbeat``      per-segment liveness probe of the elastic engine
``engine.sweep_merge``  elastic sweep segment returned, merged state on host
``engine.ckpt``         elastic engine checkpoint cut, before the save
``engine.resume``       elastic engine resume, before the verified load
``serve.sse_emit``      one SSE event write in the serve layer
``continuous.compact``  sliding-window coreset compaction, pre-mutation
``continuous.refit``    continuous-pipeline refit, before the fit runs
``registry.swap``       model generation persisted, in-memory swap pending
``fleet.worker_spawn``  fleet supervisor, before forking a worker process
``fleet.heartbeat``     fleet WORKER, before each heartbeat write (so
                        ``kill@2`` dies at the second heartbeat — the
                        deterministic mid-load worker-kill drill)
``fleet.reload_push``   fleet supervisor, before pushing RELOAD to one
                        worker (a failed push retries next watcher tick)
======================  ====================================================

Activation is programmatic (``faults.install(plan)`` / ``faults.active``)
or environment-driven for CLI-level tests::

    KMEANS_TPU_FAULTS="ckpt.mid_swap:kill@2;stream.read:raise@3x2"

Spec grammar (``;``-separated rules, plus an optional ``seed=N`` entry)::

    SITE:ACTION[=PARAM][?PROB][@NTH][xCOUNT]

* ``SITE`` — a site name or ``fnmatch`` glob (``ckpt.*``).
* ``ACTION`` — ``raise`` (an :class:`InjectedFault`, an ``OSError``
  subclass so retry policies treat it as transient), ``stall`` (sleep
  ``PARAM`` seconds, default 0.05), ``sigterm`` (deliver SIGTERM to this
  process — the preemption drill), ``kill`` (``os._exit(137)`` — the
  torn-write drill; nothing below the site ever runs).
* ``@NTH`` — first hit of the site that fires (1-based, default 1).
* ``xCOUNT`` — how many consecutive hits fire (default 1; ``x0`` = every
  hit from NTH on, i.e. a permanent fault).
* ``?PROB`` — instead of the NTH window, fire each hit with this
  probability from the plan's seeded RNG (deterministic given the seed
  and hit order).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import random
import signal
import threading
import time
from contextlib import contextmanager
from typing import Iterable, Optional

from kmeans_tpu_torch.obs import counter as _obs_counter

__all__ = ["InjectedFault", "FaultRule", "FaultPlan", "check", "install",
           "clear", "active", "parse_spec"]

#: Fires only when a rule actually injects (never on the zero-cost no-op
#: path), so a drill's assertion "the fault really happened" has a metric
#: to read — and a soak report can show which sites a run exercised.
_FAULT_INJECTIONS_TOTAL = _obs_counter(
    "kmeans_tpu_fault_injections_total",
    "Fault-harness injections that fired, by site and action (counts "
    "actual injections, not site visits; kill injections exit before "
    "any scrape and are visible only to same-process readers)",
    labels=("site", "action"),
)


class InjectedFault(OSError):
    """The error a ``raise`` rule injects.

    Subclasses :class:`OSError` deliberately: the injected failure stands
    in for a transient I/O error, so the production
    :class:`~kmeans_tpu.utils.retry.RetryPolicy` instances (whose default
    retryable set includes ``OSError``) absorb it exactly as they would
    the real thing.
    """


@dataclasses.dataclass
class FaultRule:
    """One injection rule; see the module docstring for the grammar."""

    site: str                      #: site name or fnmatch glob
    action: str                    #: raise | stall | sigterm | kill
    nth: int = 1                   #: first hit that fires (1-based)
    count: int = 1                 #: consecutive firing hits (0 = forever)
    param: float = 0.05            #: stall duration in seconds
    prob: Optional[float] = None   #: probabilistic mode (overrides nth/count)

    def __post_init__(self):
        if self.action not in ("raise", "stall", "sigterm", "kill"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.nth < 1:
            raise ValueError(f"fault nth must be >= 1, got {self.nth}")
        if self.count < 0:
            raise ValueError(f"fault count must be >= 0, got {self.count}")
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"fault prob must be in [0, 1], got {self.prob}")


class FaultPlan:
    """A seeded set of rules with per-rule hit counters (thread-safe: the
    streamed loaders hit sites from producer threads)."""

    def __init__(self, rules: Iterable[FaultRule], *, seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._hits = [0] * len(self.rules)
        self._lock = threading.Lock()

    def hits(self, site: str) -> int:
        """Total hits recorded against rules matching ``site`` (test aid)."""
        with self._lock:
            return sum(h for r, h in zip(self.rules, self._hits)
                       if fnmatch.fnmatchcase(site, r.site))

    def check(self, site: str) -> None:
        fire = None
        with self._lock:
            for i, rule in enumerate(self.rules):
                if not fnmatch.fnmatchcase(site, rule.site):
                    continue
                self._hits[i] += 1
                h = self._hits[i]
                if rule.prob is not None:
                    hot = h >= rule.nth and self._rng.random() < rule.prob
                else:
                    hot = h >= rule.nth and (
                        rule.count == 0 or h < rule.nth + rule.count
                    )
                if hot:
                    fire = rule
                    break
        if fire is None:
            return
        _FAULT_INJECTIONS_TOTAL.labels(site=site, action=fire.action).inc()
        if fire.action == "raise":
            raise InjectedFault(f"injected fault at {site!r}")
        if fire.action == "stall":
            time.sleep(fire.param)
            return
        if fire.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        # "kill": the torn-write drill — the process dies HERE, mid-
        # operation, exactly as a preemption would end it.  os._exit skips
        # atexit/finally blocks on purpose: nothing below the site runs.
        os._exit(137)


def parse_spec(spec: str) -> FaultPlan:
    """Parse a ``KMEANS_TPU_FAULTS`` spec string into a :class:`FaultPlan`."""
    rules = []
    seed = 0
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[5:])
            continue
        if ":" not in part:
            raise ValueError(
                f"bad fault rule {part!r}: expected SITE:ACTION"
                f"[=PARAM][?PROB][@NTH][xCOUNT]"
            )
        site, _, tail = part.partition(":")
        nth, count, prob, param = 1, 1, None, 0.05
        # xCOUNT is the last suffix and valid with or without @NTH
        # ("stream.read:raisex0" is the documented permanent-fault form);
        # the digits check keeps an "x" inside a site/action/param from
        # being misread — no action name or float param contains x+digits.
        head, sep, c = tail.rpartition("x")
        if sep and c.isdigit():
            tail, count = head, int(c)
        if "@" in tail:
            tail, _, n = tail.rpartition("@")
            nth = int(n)
        if "?" in tail:
            tail, _, p = tail.rpartition("?")
            prob = float(p)
        action, _, par = tail.partition("=")
        if par:
            param = float(par)
        rules.append(FaultRule(site=site.strip(), action=action.strip(),
                               nth=nth, count=count, param=param, prob=prob))
    return FaultPlan(rules, seed=seed)


# ---------------------------------------------------------------------------
# Module-level plan: the hot-path contract is ONE global read when inactive.
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def check(site: str) -> None:
    """Hit the named injection site.  A no-op unless a plan is installed."""
    if _PLAN is None:
        return
    _PLAN.check(site)


def install(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def clear() -> None:
    global _PLAN
    _PLAN = None


@contextmanager
def active(plan_or_spec):
    """Scoped activation: ``with faults.active("stream.read:raise@2"): ...``"""
    plan = (parse_spec(plan_or_spec) if isinstance(plan_or_spec, str)
            else plan_or_spec)
    prev = _PLAN
    install(plan)
    try:
        yield plan
    finally:
        install(prev) if prev is not None else clear()


_env_spec = os.environ.get("KMEANS_TPU_FAULTS")
if _env_spec:
    try:
        install(parse_spec(_env_spec))
    except ValueError as e:
        # Never run with a half-applied (or silently ignored) fault plan —
        # a drill that quietly doesn't inject proves nothing.  SystemExit
        # keeps the CLI's one-line-error contract instead of a traceback.
        raise SystemExit(
            f"error: bad KMEANS_TPU_FAULTS spec {_env_spec!r}: {e}"
        ) from e
