"""One retry/backoff policy for every transient-failure path.

A copy of ``kmeans_tpu/utils/retry.py``, its two metric families on the
port's ``obs``.  :class:`RetryPolicy` is the one copy of the bounded
attempts, jittered exponential backoff, deadline and retryable predicate,
used by the streamed loaders' host reads (:mod:`kmeans_tpu_torch.data.
stream`), the native loader's compile step (:mod:`kmeans_tpu_torch.native.
loader`) and the continuous pipeline's refits.

The jitter RNG mixes the policy seed with the process id and a per-process
call sequence: reproducible within one process given call order, but
decorrelated across concurrent retriers (threads, processes), so a shared
policy never produces lockstep backoff.  The defaults treat ``OSError``
(which :class:`~kmeans_tpu_torch.utils.faults.InjectedFault` subclasses),
``ConnectionError`` and ``TimeoutError`` as transient.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import random
import time
from typing import Callable, Optional, Tuple, Type, Union

from kmeans_tpu_torch.obs import counter as _obs_counter

__all__ = ["RetryPolicy", "RetryError"]

#: Per-site retry observability: every absorbed transient failure and every
#: exhausted budget increments here, so retries show up on ``GET /metrics``.
#: ``site`` is the caller-supplied callsite tag (``stream.read``,
#: ``native.compile``, ``continuous.refit``, ...), a closed set in
#: practice, so cardinality stays bounded.
_RETRIES_TOTAL = _obs_counter(
    "kmeans_tpu_retry_attempts_total",
    "Transient failures absorbed by RetryPolicy (one per retried attempt)",
    labels=("site",),
)
_RETRY_EXHAUSTED_TOTAL = _obs_counter(
    "kmeans_tpu_retry_exhausted_total",
    "RetryPolicy budgets exhausted (RetryError raised)",
    labels=("site",),
)

#: Per-process call sequence mixed into each call()'s jitter seed: N hosts
#: (or N prefetch threads) sharing one policy must NOT sleep identical
#: "jittered" schedules — lockstep backoff is the thundering herd jitter
#: exists to break.  Within one process the sequence is deterministic
#: given call order, so a test run's schedule is still reproducible.
_CALL_SEQ = itertools.count()


class RetryError(RuntimeError):
    """Raised when a policy exhausts its attempts or deadline.

    ``__cause__`` is the last underlying exception; ``attempts`` is how
    many times the callable actually ran.
    """

    def __init__(self, msg: str, *, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts + jittered exponential backoff + optional deadline.

    ``retryable`` is either a tuple of exception types or a predicate
    ``exc -> bool``; anything else propagates immediately (a permanent
    fault must fail fast, not burn the budget).
    """

    max_attempts: int = 3
    base_delay: float = 0.05      #: first backoff, seconds
    max_delay: float = 2.0        #: backoff ceiling, seconds
    multiplier: float = 2.0       #: exponential growth factor
    jitter: float = 0.1           #: +/- fraction of each delay, seeded
    deadline: Optional[float] = None   #: total budget in seconds, or None
    retryable: Union[Tuple[Type[BaseException], ...],
                     Callable[[BaseException], bool]] = (
        OSError, ConnectionError, TimeoutError)
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def _is_retryable(self, exc: BaseException) -> bool:
        if callable(self.retryable) and not isinstance(self.retryable, tuple):
            return bool(self.retryable(exc))
        return isinstance(exc, self.retryable)

    def delays(self):
        """The backoff schedule (without jitter), one entry per retry."""
        d = self.base_delay
        for _ in range(self.max_attempts - 1):
            yield min(d, self.max_delay)
            d *= self.multiplier

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             site: str = "unlabeled",
             **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying transient failures.

        ``on_retry(attempt, exc)`` fires before each backoff sleep (attempt
        is the 1-based attempt that just failed) — the observability hook
        the callers use to log what was absorbed.  ``site`` tags the
        callsite in the retry metrics
        (``kmeans_tpu_retry_attempts_total{site=...}`` /
        ``kmeans_tpu_retry_exhausted_total{site=...}``) so per-site retry
        pressure is visible on ``GET /metrics``.
        """
        rng = random.Random(
            self.seed * 1_000_003 + os.getpid() * 7919 + next(_CALL_SEQ)
        )
        retried = _RETRIES_TOTAL.labels(site=site)
        start = time.monotonic()
        schedule = list(self.delays())
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if not self._is_retryable(e):
                    raise
                last = e
                if attempt >= self.max_attempts:
                    break
                delay = schedule[attempt - 1]
                if self.jitter:
                    delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
                if self.deadline is not None and (
                    time.monotonic() - start + delay > self.deadline
                ):
                    break
                retried.inc()
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(delay)
        _RETRY_EXHAUSTED_TOTAL.labels(site=site).inc()
        raise RetryError(
            f"gave up after {attempt} attempt(s): {last}", attempts=attempt,
        ) from last
