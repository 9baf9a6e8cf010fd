"""Host → card streaming for datasets larger than the card's memory.

Counterpart of ``kmeans_tpu/data/stream.py``.  The data stays on the host
(an ``np.ndarray`` or an ``np.memmap`` from :func:`load_mmap`); batches are
sampled there and a few are kept in flight to the card, so the host gather,
the copy over PCIe and the card's compute overlap.

The host gather is the native loader's (:mod:`kmeans_tpu_torch.native`): a
threaded, GIL-releasing memcpy, optionally fused with the f32 → bf16
conversion, with a bit-identical numpy version.

The copy to the card.  ``jax.device_put`` is asynchronous; a torch copy from
pageable memory is not.  So on the card the streamed paths stage through a
:class:`PinnedRing`: a ring of pinned host buffers allocated once per fit.
The gather writes straight into a buffer, the buffer is copied to the card
on a side CUDA stream that records an event, the consumer's stream waits on
that event, and a buffer is gathered into again only once its copy's event
has completed.  With ``background=True`` the produce side (gather and copy)
runs on its own thread behind a depth-bounded queue; the gather releases the
GIL, so producer and consumer run in parallel.  On the CPU (the tests) there
is no ring: each batch is a fresh tensor and the "copy" is the identity.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.obs import counter as _obs_counter, gauge as _obs_gauge
from kmeans_tpu_torch.utils import faults
from kmeans_tpu_torch.utils.retry import RetryPolicy

__all__ = ["load_mmap", "sample_batches", "prefetch_to_device",
           "foreach_chunk", "PinnedRing", "READ_RETRY"]

#: The prefetch pipeline's families, the reference's: the queue-depth gauge
#: says whether the producer keeps ahead of the consumer (pinned at 0: the
#: card starves on host reads), and the stall counter counts the times the
#: producer blocked on a full queue (the host is ahead).  One gauge per
#: process, last writer wins across concurrent streams.
_PREFETCH_DEPTH = _obs_gauge(
    "kmeans_tpu_prefetch_queue_depth",
    "Batches currently buffered in the background prefetch queue "
    "(last stream to touch the queue wins)",
)
_PREFETCH_STALLS_TOTAL = _obs_counter(
    "kmeans_tpu_prefetch_producer_stalls_total",
    "Times the prefetch producer blocked because the queue was full "
    "(consumer slower than host gather + transfer)",
)

#: Transient host-read policy of the streamed loaders: a memmap page-in
#: against flaky storage can throw a one-off ``OSError``; a bounded retry
#: absorbs it without changing the batch sequence (a read is a pure function
#: of (seed, step), so a retried read returns identical bytes).  Exhaustion
#: raises :class:`~kmeans_tpu_torch.utils.retry.RetryError`.
READ_RETRY = RetryPolicy(max_attempts=4, base_delay=0.05, max_delay=1.0)

#: Bounded producer join at generator teardown (seconds); see
#: :func:`_prefetch_background`.
_JOIN_TIMEOUT = 2.0


def load_mmap(path: str) -> np.ndarray:
    """Memory-map an ``.npy`` feature matrix (rows never fully materialize)."""
    x = np.load(path, mmap_mode="r")
    if x.ndim != 2:
        raise ValueError(f"{path}: expected a 2-D array, got shape {x.shape}")
    return x


class PinnedRing:
    """``slots`` pinned host buffers of ``(rows, d)`` ``dtype``, used in
    turn by one producer: :meth:`next` hands out the next buffer once the
    copy that last read it has completed, and :meth:`copied` records the
    event of the copy just enqueued from it.  Allocated once per fit."""

    def __init__(self, slots: int, rows: int, d: int, dtype: torch.dtype):
        self.bufs = [torch.empty((rows, d), dtype=dtype, pin_memory=True)
                     for _ in range(slots)]
        self._events = [None] * slots
        self._i = 0
        self._last = None

    def next(self) -> torch.Tensor:
        i = self._i
        self._i = (i + 1) % len(self.bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        self._last = i
        return self.bufs[i]

    def copied(self, event) -> None:
        self._events[self._last] = event


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def staging_ring(device: torch.device, depth: int, rows: int, d: int,
                 dtype: torch.dtype) -> Optional[PinnedRing]:
    """The ring a streamed pass on ``device`` stages through: ``depth + 1``
    buffers on the card, None on the CPU."""
    if device.type != "cuda":
        return None
    return PinnedRing(depth + 1, rows, d, dtype)


def sample_batches(
    data,
    batch_size: int,
    steps: int,
    *,
    seed: int = 0,
    start_step: int = 0,
    to_bf16: bool = False,
    retry: Optional[RetryPolicy] = None,
    ring: Optional[PinnedRing] = None,
    part: Tuple[int, int] = (0, 1),
) -> Iterator[torch.Tensor]:
    """Yield batches ``start_step..steps-1`` as CPU tensors, sampled with
    replacement from host ``data``.  With ``part=(r, p)`` only the r-th of
    p equal contiguous slices of each step's sorted index list is gathered
    (``batch_size // p`` rows, ``batch_size`` a multiple of p): the rows a
    rank of a p-way data axis takes of the global batch.

    Each step draws from its own ``np.random.default_rng((seed, step))``,
    so batch t is a pure function of (seed, t), the reference's batch bit
    for bit, and a resume at step t replays what an uninterrupted run would
    have seen.  Indices are sorted within a batch: on a memmap the gather
    becomes a forward scan, and the minibatch update never looks at the
    order.  ``to_bf16`` fuses the f32 → bf16 conversion into the gather.
    With ``ring`` each batch is gathered into the ring's next pinned buffer
    (valid until that buffer comes round again).

    Each read runs under ``retry`` (default :data:`READ_RETRY`) and is the
    ``stream.read`` fault site; a retried read is bit-identical, so a
    retried run fits what an undisturbed one does.
    """
    from kmeans_tpu_torch.native import gather_rows

    policy = retry if retry is not None else READ_RETRY
    n = data.shape[0]
    if batch_size < 1 or steps < 0 or not 0 <= start_step <= steps:
        raise ValueError(
            f"bad batch_size={batch_size} / steps={steps} / "
            f"start_step={start_step}"
        )

    def read(idx):
        faults.check("stream.read")
        return gather_rows(data, idx, to_bf16=to_bf16,
                           out=None if ring is None else ring.next())

    r, p = part
    if batch_size % p or not 0 <= r < p:
        raise ValueError(f"bad part={part} of batch_size={batch_size}")
    b = batch_size // p
    for step in range(start_step, steps):
        rng = np.random.default_rng((seed, step))
        idx = np.sort(rng.integers(0, n, size=batch_size))[r * b:(r + 1) * b]
        yield policy.call(read, idx, site="stream.read")


def _to_device(batch, device: torch.device, ring: Optional[PinnedRing]):
    """``(tensor on device, event or None)``: on the card the copy runs on
    the side stream and records the event the consumer waits on."""
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    if device.type != "cuda":
        return t.to(device), None
    side = _side_stream(device)
    with torch.cuda.stream(side):
        out = t.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    if ring is not None:
        ring.copied(event)
    return out, event


_SIDE = {}


def _side_stream(device: torch.device):
    """The copy stream of a card, made at its first use."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    s = _SIDE.get(index)
    if s is None:
        s = _SIDE.setdefault(index, torch.cuda.Stream(device=index))
    return s


def _consume(item):
    """The consumer's half of a copy: its stream waits on the copy's event,
    and the tensor is marked in use by that stream (the allocator must not
    hand its block to the side stream before the consumer's work ends)."""
    t, event = item
    if event is not None:
        cur = torch.cuda.current_stream(t.device)
        cur.wait_event(event)
        t.record_stream(cur)
    return t


def prefetch_to_device(
    batches: Iterable,
    *,
    depth: int = 2,
    device=None,
    background: bool = False,
    ring: Optional[PinnedRing] = None,
) -> Iterator[torch.Tensor]:
    """Keep ``depth`` batches in flight to ``device`` (None is the card)
    ahead of the consumer.

    Each batch is copied as it is produced (on the card: on a side stream,
    from the pinned buffer the gather wrote), so while the consumer works on
    batch t, batches t+1..t+depth are already crossing.  ``ring`` is the
    :class:`PinnedRing` the batches were gathered into, which the copies
    release.  With ``background=True`` gather and copy run on a producer
    thread behind a queue of ``depth``; order and values are the same
    either way, and a producer exception re-raises in the consumer.
    """
    from kmeans_tpu_torch.device import resolve_device

    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = resolve_device(device)
    if background:
        yield from _prefetch_background(batches, depth, device, ring)
        return
    it = iter(batches)
    pending = []
    try:
        for _ in range(depth):
            pending.append(_to_device(next(it), device, ring))
    except StopIteration:
        pass
    while pending:
        out = pending.pop(0)
        try:
            pending.append(_to_device(next(it), device, ring))
        except StopIteration:
            pass
        yield _consume(out)


def foreach_chunk(data, chunk_size: int, fn, *, device=None,
                  depth: int = 2) -> None:
    """Run ``fn(xb, lo)`` over sequential row chunks of host ``data``,
    ``xb`` on ``device``, double-buffered through pinned staging on the
    card.  The one copy of the streamed full-pass skeleton (chunk reads,
    prefetch, row offsets)."""
    from kmeans_tpu_torch.device import resolve_device

    device = resolve_device(device)
    n, d = data.shape
    ring = staging_ring(device, depth, min(chunk_size, n), d,
                        torch_dtype(data.dtype))

    def read(lo):
        faults.check("stream.read")
        if ring is None:
            return torch.from_numpy(np.array(data[lo:lo + chunk_size]))
        # Straight from the (mapped) rows into the pinned buffer.
        buf = ring.next()[:min(chunk_size, n - lo)]
        buf.numpy()[...] = data[lo:lo + chunk_size]
        return buf

    def chunks():
        for lo in range(0, n, chunk_size):
            yield READ_RETRY.call(read, lo, site="stream.read")

    lo = 0
    for xb in prefetch_to_device(chunks(), depth=depth, device=device,
                                 ring=ring):
        fn(xb, lo)
        lo += int(xb.shape[0])


def _prefetch_background(batches, depth, device, ring):
    done = object()
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list = []

    def producer():
        try:
            for b in batches:
                if stop.is_set():
                    return
                item = _to_device(b, device, ring)
                stalled = False
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        _PREFETCH_DEPTH.set(q.qsize())
                        break
                    except queue.Full:
                        if not stalled:
                            # Count each batch's stall once, however many
                            # 0.1 s put timeouts it spans.
                            stalled = True
                            _PREFETCH_STALLS_TOTAL.inc()
                        continue
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(done, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, name="kt-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            _PREFETCH_DEPTH.set(q.qsize())
            if item is done:
                break
            yield _consume(item)
        if err:
            raise err[0]
    finally:
        stop.set()
        # Bounded join: an abandoned producer must not keep running native
        # code (the GIL-free gather, a copy into a pinned buffer) while the
        # caller unwinds.  stop is polled every 0.1 s, so _JOIN_TIMEOUT
        # covers any cooperative exit; a producer stuck past it (a stalled
        # upstream iterator, a hung read) leaks a live daemon thread, which
        # is named and reported.
        t.join(timeout=_JOIN_TIMEOUT)
        if t.is_alive():
            warnings.warn(
                f"prefetch producer thread {t.name!r} still alive "
                f"{_JOIN_TIMEOUT:.1f}s after teardown (stalled batch "
                "source?); it runs as a daemon and may hold the data "
                "source open",
                RuntimeWarning,
                stacklevel=2,
            )
