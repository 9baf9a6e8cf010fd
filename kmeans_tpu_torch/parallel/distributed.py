"""Multi-process bootstrap for the sharded engine, on ``torch.distributed``.

Counterpart of ``kmeans_tpu/parallel/distributed.py``.  The reference joins
hosts with ``jax.distributed.initialize`` and then drives every local device
from one process; the port runs one process per device, so joining the
process group is what makes a mesh.  Configuration comes from the arguments
or the standard environment variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them).  With none of them set
:func:`ensure_initialized` is a no-op, so every entry point can call it
unconditionally.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from kmeans_tpu_torch.utils import faults
from kmeans_tpu_torch.utils.retry import RetryPolicy

__all__ = ["ensure_initialized", "heartbeat", "is_multiprocess",
           "process_info", "INIT_TIMEOUT_S"]

#: Every process group the port makes takes this timeout: a rank that dies
#: while the others wait in a collective ends their wait with an error
#: instead of a hang.
INIT_TIMEOUT_S = 300.0

_initialized = False


def _transient_init_error(e: BaseException) -> bool:
    """Retry only the bootstrap race, never a real configuration problem:
    connection-flavoured failures (the rendezvous not listening yet) are
    transient; "initialize twice" and everything else are not."""
    if isinstance(e, (ConnectionError, OSError)):
        return True
    msg = str(e).lower()
    if "twice" in msg or "already initialized" in msg:
        return False
    return isinstance(e, RuntimeError) and any(
        s in msg for s in ("unavailable", "deadline", "connection",
                           "refused", "timed out", "timeout", "reset")
    )


#: Ranks start at slightly different times and rank 0's store may not be
#: listening yet when another rank dials in.  A patient bounded retry turns
#: the race into a rendezvous; exhaustion raises
#: :class:`~kmeans_tpu_torch.utils.retry.RetryError` with the cause chained.
_INIT_RETRY = RetryPolicy(
    max_attempts=5, base_delay=0.5, max_delay=8.0, deadline=60.0,
    retryable=_transient_init_error,
)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def ensure_initialized(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """Join the default process group if one is configured, else no-op.

    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``); ``world_size`` and ``rank`` to ``WORLD_SIZE`` /
    ``RANK``.  ``backend`` defaults to NCCL where a card is present, gloo
    otherwise; ``timeout`` (seconds) to :data:`INIT_TIMEOUT_S`.  A group
    made outside this module is left as it is.
    """
    global _initialized
    if _initialized:
        return
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if init_method is None and world_size is None and not (
            os.environ.get("MASTER_ADDR") or os.environ.get("MASTER_PORT")):
        # Single-process run: nothing to join.
        _initialized = True
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend, init_method=init_method or "env://",
              timeout=datetime.timedelta(
                  seconds=INIT_TIMEOUT_S if timeout is None else timeout))
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank

    def init_once():
        faults.check("dist.init")
        dist.init_process_group(**kw)

    def reset_partial_init(attempt, exc):
        # A failed attempt may leave a half-made default group behind; a
        # re-dial on top of it would die on "initialize twice" instead of
        # retrying the rendezvous.
        try:
            dist.destroy_process_group()
        except Exception:  # allow-silent-except: best-effort teardown of a half-made group; the next attempt fails loudly if it did not go
            pass

    try:
        _INIT_RETRY.call(init_once, on_retry=reset_partial_init,
                         site="distributed.init")
    except BaseException as e:
        # on_retry fires only between attempts: tear down after the final
        # failure too, unless the failure is the "twice" guard itself,
        # whose live group belongs to a caller outside this module.
        msg = str(e).lower()
        if not ("twice" in msg or "already initialized" in msg):
            reset_partial_init(0, None)
        raise
    _initialized = True


def heartbeat() -> None:
    """Liveness probe at segment boundaries: the ``dist.heartbeat`` fault
    site, which a drill uses to model a rank dying between collectives."""
    faults.check("dist.heartbeat")


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_info() -> dict:
    joined = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size() if joined else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": size,
        "local_device_count": (torch.cuda.device_count()
                               if torch.cuda.is_available() else 1),
        "device_count": size,
    }
