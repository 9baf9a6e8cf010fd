"""Preemption safety: SIGTERM/SIGINT → one final checkpoint → clean exit.

A copy of ``kmeans_tpu/utils/preempt.py``: JAX-free,
but importing it would run ``kmeans_tpu/__init__.py``, which imports JAX.

TPU-VM spot/preemptible instances get SIGTERM with a short grace window;
an interactive Ctrl-C is the same event at human scale.  The long-running
fits (streamed k-means/GMM, the step-wise Lloyd runner) wrap their loops
in a :class:`PreemptionGuard`: the signal handler only sets a flag, the
loop notices it at the next step boundary, cuts a final checkpoint, and
raises :class:`Preempted` — so the process exits with a RESUMABLE state
instead of dying mid-write (the checkpoint layer's atomic swap makes even
a second signal during that last save safe).

Signal handlers are process-global and main-thread-only, so the guard
no-ops when entered off the main thread (e.g. the serve layer's train
workers) — those surfaces rely on the process-level guard installed by
whoever owns the main thread.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

__all__ = ["Preempted", "PreemptionGuard"]


class Preempted(RuntimeError):
    """A fit exited early on SIGTERM/SIGINT with a resumable checkpoint.

    ``step`` is the step/iteration the state was cut at; ``path`` is the
    checkpoint directory (None when the run had no checkpoint_path — the
    state is lost, but the exit is still clean and prompt).
    """

    def __init__(self, msg: str, *, path: Optional[str] = None,
                 step: Optional[int] = None,
                 resume_hint: Optional[str] = None):
        super().__init__(msg)
        self.path = path
        self.step = step
        #: Copy-pasteable CLI flags that resume this state ("--resume
        #: <path>" by default) — the RAISER knows its surface's flag
        #: shape (the continuous pipeline's --resume is a bare flag with
        #: the path in --model-dir), so the shared CLI handler must not.
        self.resume_hint = resume_hint or (
            f"--resume {path}" if path else None)

    @classmethod
    def during(cls, what: str, *, path: Optional[str] = None,
               step: Optional[int] = None,
               resume_hint: Optional[str] = None) -> "Preempted":
        """``what`` + the one resume-hint suffix every fit loop needs —
        the single copy of the checkpoint-or-lost phrasing."""
        hint = (f"; resumable checkpoint at {path!r}" if path
                else " (no checkpoint_path — progress not saved)")
        return cls(what + hint, path=path, step=step,
                   resume_hint=resume_hint)


class PreemptionGuard:
    """Context manager that latches SIGTERM/SIGINT into a flag.

    The handler does no I/O — checkpointing from inside a signal handler
    could re-enter a save already in progress; the owning loop polls
    :attr:`triggered` at step boundaries instead.  Previous handlers are
    restored on exit, and a signal that arrived is re-raised to them only
    through the ordinary Python control flow (the loop's
    :class:`Preempted`), never swallowed silently.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._event = threading.Event()
        self._prev: dict = {}
        self._installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        """Manual trip (tests, or an external orchestrator's own handler)."""
        self._event.set()

    def _handler(self, signum, frame):
        if self._event.is_set():
            # Second signal while the loop is still draining toward a
            # step boundary: the step may be wedged (device hang, stalled
            # read), so escalate to an immediate interrupt instead of
            # leaving the process killable only by SIGKILL.
            raise KeyboardInterrupt(
                f"second signal ({signum}) before the preemption "
                "checkpoint could be cut"
            )
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._installed = False
        return False
