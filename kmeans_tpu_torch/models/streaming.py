"""Out-of-core minibatch k-means: fit data that never fits on the card.

Counterpart of ``kmeans_tpu/models/streaming.py``.  The update is the
in-memory minibatch fit's Sculley step (:func:`~kmeans_tpu_torch.models.
minibatch.batch_update`, plain PyTorch, as the reference's runs outside its
kernels), but the batches come from the host (an ``np.ndarray`` or an
``np.memmap``): sampled there, gathered by the native loader into pinned
buffers and double-buffered onto the card (:mod:`kmeans_tpu_torch.data.
stream`), so only the batches in flight and the (k, d) centroids occupy
the card.  The final labeling pass streams the data in chunks through
:func:`~kmeans_tpu_torch.ops.distance.assign`: K1 with its fold off.

Batches are a pure function of (seed, step) drawn with numpy, so they are
the reference's bit for bit, and the checkpoints are the reference's
(``extra`` holds ``stream``, ``host_seed``, ``batch_size``,
``total_steps``, ``transfer_width`` and ``mesh_dp``): either package
resumes the other's directory.  With ``mesh=`` (a data-parallel
:class:`~kmeans_tpu_torch.parallel.mesh.Mesh`) each rank gathers only its
contiguous slice of every step's index list, computes that slice's
:func:`~kmeans_tpu_torch.models.minibatch.batch_stats`, and one all-reduce
of (counts | sums) feeds the replicated Sculley update, as the reference's
sharded step does.  Known difference: the seeding's init method draws from
a :class:`torch.Generator` (the subsample rows are the reference's).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.stream import (foreach_chunk, prefetch_to_device,
                                          sample_batches, staging_ring,
                                          torch_dtype)
from kmeans_tpu_torch.device import as_dtype, as_tensor, resolve_device
from kmeans_tpu_torch.models.init import (host_subsample_seed,
                                          resolve_fit_config)
from kmeans_tpu_torch.models.lloyd import KMeansState

__all__ = ["fit_minibatch_stream", "assign_stream"]


def assign_stream(data, centroids, *, chunk_size: int = 65536,
                  compute_dtype=None, device=None,
                  backend: str = "auto") -> Tuple[np.ndarray, float]:
    """Labels and inertia of host-resident ``data`` in one streamed pass on
    ``device`` (None is the card): ``(labels (n,) int32 ndarray, inertia
    float)``.

    Chunks stream through pinned staging to the card; each chunk's labels
    are copied into pinned host memory and its min-d² sum kept on the card,
    with no sync per chunk.  At the end one sync reads the per-chunk f32
    sums, which are added on the host in chunk order: the reference's
    running sum.
    """
    from kmeans_tpu_torch.ops.distance import assign

    dev = resolve_device(device)
    n = data.shape[0]
    c = as_tensor(centroids, dev, torch.float32)
    labels = torch.empty((n,), dtype=torch.int32,
                         pin_memory=dev.type == "cuda")
    sums = []

    def one_chunk(xb, lo):
        lab, mind = assign(xb, c, chunk_size=chunk_size,
                           compute_dtype=compute_dtype, backend=backend,
                           device=dev)
        labels[lo:lo + lab.shape[0]].copy_(lab, non_blocking=True)
        sums.append(mind.sum())

    foreach_chunk(data, chunk_size, one_chunk, device=dev)
    inertia = 0.0
    if sums:
        for s in torch.stack(sums).cpu().tolist():   # the one sync
            inertia += s
    return labels.numpy(), inertia


def _transfer_width(transfer_dtype, compute_dtype, data_dtype) -> bool:
    """Whether batches cross as bf16: validates ``transfer_dtype``."""
    if transfer_dtype not in (None, "auto", "float32", "bfloat16"):
        raise ValueError(
            f"transfer_dtype must be auto/float32/bfloat16/None, "
            f"got {transfer_dtype!r}"
        )
    data_is_f32 = np.dtype(data_dtype) == np.float32
    if transfer_dtype == "bfloat16" and not data_is_f32:
        raise ValueError(
            f"transfer_dtype='bfloat16' requires float32 data, "
            f"got {np.dtype(data_dtype)}"
        )
    return (transfer_dtype == "bfloat16"
            or (transfer_dtype == "auto" and compute_dtype is not None
                and as_dtype(compute_dtype) == torch.bfloat16
                and data_is_f32))


def _resume_state(checkpoint_path, k, d, init, ck_specs, transfer_width,
                  dp, n_steps, dev):
    """The reference's resume refusals, then ``(c0, n_seen, start_step,
    resolved)`` from the checkpoint at ``checkpoint_path``, or None when
    there is none."""
    from kmeans_tpu_torch.utils.checkpoint import (latest_step,
                                                   load_array_checkpoint,
                                                   resolve_resume_params)

    # latest_step resolves the <path>.old kept during a crashed save swap.
    if latest_step(checkpoint_path) is None:
        return None
    if init is not None and not isinstance(init, str):
        raise ValueError(
            "resume found an existing checkpoint; an explicit init "
            "centroid array contradicts it — drop init or the "
            "checkpoint"
        )
    # Array-level load: the family tag is checked before any state-shape
    # assumption touches the arrays.
    arrays, meta = load_array_checkpoint(checkpoint_path)
    ck = (meta or {}).get("extra", {})
    tag = ck.get("stream")
    if tag == "gmm":
        raise ValueError(
            f"checkpoint at {checkpoint_path!r} is a streamed-GMM "
            "checkpoint — resume it with fit_gmm_stream"
        )
    if not tag:
        raise ValueError(
            f"checkpoint at {checkpoint_path!r} has no stream tag "
            "— it was not written by fit_minibatch_stream (runner "
            "checkpoints resume via LloydRunner.resume)"
        )
    c0 = as_tensor(arrays["centroids"], dev, torch.float32)
    if tuple(c0.shape) != (k, d):
        raise ValueError(
            f"checkpoint centroids {tuple(c0.shape)} != {(k, d)}")
    n_seen = as_tensor(arrays["counts"], dev, torch.float32)
    start_step = int(arrays["n_iter"])
    # The exact replay needs the original sampling parameters: adopt them
    # when the caller passed none, refuse an explicit mismatch.
    resolved = resolve_resume_params(ck, ck_specs)
    # The transfer width changes the values the update sums (bf16
    # rounding), so a mismatched resume would fork the trajectory.
    if "transfer_width" in ck and ck["transfer_width"] != transfer_width:
        raise ValueError(
            f"resume transfer width {transfer_width!r} contradicts "
            f"the checkpoint's {ck['transfer_width']!r}; pass "
            f"transfer_dtype={ck['transfer_width']!r} (or matching "
            "auto/compute_dtype) to continue this stream"
        )
    ck_dp = int(ck.get("mesh_dp", 0))
    if ck_dp != dp:
        want = (f"mesh with a {ck_dp}-way data axis" if ck_dp
                else "no mesh")
        raise ValueError(
            f"resume mesh (data axis {dp or 'absent'}) contradicts "
            f"the checkpoint's ({ck_dp or 'absent'}); continue this "
            f"stream with {want}"
        )
    if start_step > n_steps:
        raise ValueError(
            f"checkpoint is at step {start_step} > requested "
            f"steps={n_steps}; raise steps to continue this stream"
        )
    return c0, n_seen, start_step, resolved


def fit_minibatch_stream(
    data,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    batch_size: Optional[int] = None,
    steps: Optional[int] = None,
    seed: Optional[int] = None,
    prefetch_depth: int = 2,
    background_prefetch: bool = True,
    transfer_dtype: Optional[str] = None,
    final_pass: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 100,
    checkpoint_keep: int = 0,
    resume: bool = False,
    mesh=None,
    data_axis: str = "data",
    callback: Optional[Callable] = None,
    device=None,
) -> KMeansState:
    """Minibatch k-means over host or disk data of unbounded size, on
    ``device`` (None is the card).

    ``data`` is a 2-D ``np.ndarray`` or ``np.memmap`` (from
    :func:`~kmeans_tpu_torch.data.stream.load_mmap`).  Step t updates the
    centroids with the batch ``sample_batches`` draws for (``seed``, t).
    ``transfer_dtype``: None or ``"float32"`` ship f32 rows, ``"bfloat16"``
    bf16 rows (f32 data only), ``"auto"`` bf16 when ``config.compute_dtype``
    is bfloat16; the conversion is fused into the native gather.  The
    centroid sums then add the rounded rows, so a stream replays only under
    the width it started with, and a resume refuses another.

    ``callback`` (an :class:`~kmeans_tpu_torch.models.runner.IterInfo`
    consumer) fires once a step with the squared centroid shift, which
    costs a sync a step; without it the loop never waits on the card.  Step
    times land in ``kmeans_tpu_iteration_seconds{model="minibatch_stream"}``
    either way.  With ``checkpoint_path`` the centroids, per-centre counts
    and step are saved every ``checkpoint_every`` steps and at the end;
    ``resume`` continues an existing checkpoint from its step, with the
    reference's refusals.  SIGTERM / SIGINT cut a checkpoint at the next
    step boundary and raise :class:`~kmeans_tpu_torch.utils.preempt.
    Preempted`.  With ``final_pass`` a streamed labeling pass fills labels,
    inertia and counts; otherwise those fields are empty.

    ``mesh`` runs the step sharded (every rank calls this with the same
    arguments, on its mesh device): the batch is rounded down to a multiple
    of the data axis, ``max(dp, bs - bs % dp)`` rows, each rank gathers its
    ``1/dp`` contiguous slice of the sorted index list, and one all-reduce
    merges the slices' stats.  Rank 0 alone writes checkpoints (``mesh_dp``
    records dp, and a resume refuses another), a signal on any rank stops
    every rank within two steps (its flag rides the all-reduce and is read
    a step late, so the loop never waits on the card for it), and the
    final pass labels each rank's contiguous row block.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg, generator = resolve_fit_config(k, generator, config, dev)
    n, d = data.shape
    bs = batch_size if batch_size is not None else cfg.batch_size
    dp = mesh.axis_sizes[data_axis] if mesh is not None else 0
    rank0 = mesh is None or mesh.rank == 0
    n_steps = steps if steps is not None else cfg.steps
    host_seed = seed if seed is not None else cfg.seed
    to_bf16 = _transfer_width(transfer_dtype, cfg.compute_dtype, data.dtype)
    transfer_width = "bfloat16" if to_bf16 else "float32"

    # 0 is the final/preempt-saves-only mode; a negative cadence is a bug.
    if checkpoint_path and checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}"
        )

    start_step = 0
    c0 = None
    if resume:
        if not checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        found = _resume_state(
            checkpoint_path, k, d, init,
            [("seed", "host_seed", seed, host_seed),
             ("batch_size", "batch_size", batch_size, bs)],
            transfer_width, dp, n_steps, dev)
        if found is not None:
            c0, n_seen, start_step, r = found
            host_seed, bs = r["seed"], r["batch_size"]

    if c0 is None:
        n_seen = torch.zeros((k,), dtype=torch.float32, device=dev)
        c0 = host_subsample_seed(data, k, generator, cfg, init,
                                 host_seed=host_seed, device=dev)

    from kmeans_tpu_torch.models.minibatch import batch_update
    from kmeans_tpu_torch.models.runner import StepObserver
    from kmeans_tpu_torch.obs import tracing as _tracing
    from kmeans_tpu_torch.parallel.engine import _any_rank
    from kmeans_tpu_torch.utils.checkpoint import (PeriodicSaver,
                                                   save_checkpoint)
    from kmeans_tpu_torch.utils.preempt import Preempted, PreemptionGuard

    saver = PeriodicSaver(checkpoint_path if rank0 else None,
                          checkpoint_every)

    def checkpoint_now(c, n_seen, step):
        save_checkpoint(
            checkpoint_path,
            KMeansState(
                centroids=c,
                labels=torch.zeros((0,), dtype=torch.int32),
                inertia=torch.zeros((), dtype=torch.float32),
                n_iter=torch.tensor(step, dtype=torch.int32),
                converged=torch.tensor(False),
                counts=n_seen,
            ),
            step=step, config=cfg,
            extra={"stream": True, "host_seed": int(host_seed),
                   "batch_size": int(bs), "total_steps": int(n_steps),
                   "transfer_width": transfer_width, "mesh_dp": int(dp)},
            keep=checkpoint_keep,
        )

    # Rounded after the resume check: the checkpoint records the raw
    # batch size, the mesh_dp check pins dp, and the two give bs_eff.
    bs_eff = max(dp, bs - bs % dp) if dp else bs
    part = (mesh.rank, dp) if mesh is not None else (0, 1)
    c = c0.float()
    ring = staging_ring(dev, prefetch_depth, bs_eff // part[1], d,
                        torch.bfloat16 if to_bf16 else torch_dtype(data.dtype))
    batches = sample_batches(data, bs_eff, n_steps, seed=host_seed,
                             start_step=start_step, to_bf16=to_bf16,
                             ring=ring, part=part)
    flags = _MeshFlags(mesh) if mesh is not None else None
    step = start_step
    rec = StepObserver("minibatch_stream", callback)
    fit_span = _tracing.span("fit_minibatch_stream", category="run",
                             model="minibatch_stream", k=k,
                             steps=int(n_steps))
    # SIGTERM / SIGINT latch a flag; the loop notices at the next step
    # boundary, cuts one final checkpoint and exits resumable.  The guard
    # does not cover the final pass: a signal there keeps its default
    # handling.
    with fit_span:
        with PreemptionGuard() as guard:
            rec.start()
            for xb in prefetch_to_device(batches, depth=prefetch_depth,
                                         background=background_prefetch,
                                         device=dev, ring=ring):
                with _tracing.span("step", category="iteration",
                                   step=step + 1):
                    c_prev = c if rec.wants_sync else None
                    if xb.dtype == torch.float64:
                        xb = xb.float()      # f64 rows compute in f32
                    with _tracing.span(
                            "sweep", category="compile"
                            if step == start_step else "assign"):
                        if mesh is None:
                            c, n_seen, _, _ = batch_update(
                                c, n_seen, xb,
                                compute_dtype=cfg.compute_dtype)
                        else:
                            c, n_seen = _sharded_step(
                                mesh, c, n_seen, xb, flags, guard.triggered,
                                compute_dtype=cfg.compute_dtype)
                    step += 1
                    # The shift read syncs with the card, so the step's
                    # seconds are true wall time (no callback: no sync and
                    # no span).
                    if rec.wants_sync:
                        with _tracing.span("host_sync",
                                           category="host_sync"):
                            shift_sq = float(((c - c_prev) ** 2).sum())
                    else:
                        shift_sq = None
                    rec.step(step, shift_sq=shift_sq)
                    saver.maybe(step, lambda c=c, ns=n_seen, t=step:
                                checkpoint_now(c, ns, t))
                    rec.exclude()    # checkpoint writes are not step time
                    stop = (guard.triggered if mesh is None
                            else flags.previous())
                    if stop and step < n_steps:
                        saver.maybe(step, lambda c=c, ns=n_seen, t=step:
                                    checkpoint_now(c, ns, t), force=True)
                        if mesh is not None:
                            mesh.barrier()    # the bundle is whole
                        raise Preempted.during(
                            f"fit_minibatch_stream preempted by signal at "
                            f"step {step}/{n_steps}",
                            path=checkpoint_path, step=step,
                        )
            saver.maybe(step, lambda: checkpoint_now(c, n_seen, step),
                        force=True)
            # A signal during the last step: with a checkpoint, exit
            # resumable (the final pass could outlast the grace window);
            # without one, finish rather than discard the streamed phase.
            # On a mesh one all-reduce of the flag (after rank 0's save)
            # gives every rank the same answer.
            stop = (guard.triggered if mesh is None else
                    _any_rank(mesh, guard.triggered or flags.previous()))
            if stop and checkpoint_path is not None:
                raise Preempted.during(
                    f"fit_minibatch_stream preempted by signal after the "
                    f"final step ({step}/{n_steps})" + (
                        "; only the final labeling pass remains"
                        if final_pass
                        else "; streamed phase complete and checkpointed"),
                    path=checkpoint_path, step=step,
                )

        if final_pass:
            with _tracing.span("final_pass", category="assign",
                               model="minibatch_stream"):
                kw = dict(chunk_size=max(cfg.chunk_size, 8192),
                          compute_dtype=cfg.compute_dtype, device=dev)
                if mesh is None:
                    labels_np, inertia = assign_stream(data, c, **kw)
                else:
                    labels_np, inertia = _sharded_final(mesh, data, c, kw)
            labels = torch.from_numpy(labels_np).to(dev)
            counts = torch.from_numpy(
                np.bincount(labels_np, minlength=k).astype(np.float32)
            ).to(dev)
            inertia_v = torch.tensor(inertia, dtype=torch.float32,
                                     device=dev)
        else:
            labels = torch.zeros((0,), dtype=torch.int32, device=dev)
            counts = torch.zeros((k,), dtype=torch.float32, device=dev)
            inertia_v = torch.zeros((), dtype=torch.float32, device=dev)

        return KMeansState(
            centroids=c,
            labels=labels,
            inertia=inertia_v,
            n_iter=torch.tensor(step, dtype=torch.int32, device=dev),
            converged=torch.tensor(False, device=dev),
            counts=counts,
        )


class _MeshFlags:
    """The mesh's preemption flags: each step's merged flag is copied to
    the host without a wait, and :meth:`previous` reads the one of the
    step before, which every rank reads alike."""

    def __init__(self, mesh):
        self._on = torch.ones(1, device=mesh.device)
        self._off = torch.zeros(1, device=mesh.device)
        self._cuda = mesh.device.type == "cuda"
        self._prev = None
        self._last = None

    def local(self, triggered: bool) -> torch.Tensor:
        return self._on if triggered else self._off

    def merged(self, flag: torch.Tensor) -> None:
        self._prev = self._last
        if self._cuda:
            host = torch.empty(1, pin_memory=True)
            host.copy_(flag, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._last = (host, ev)
        else:
            self._last = (flag.clone(), None)

    def previous(self) -> bool:
        if self._prev is None:
            return False
        host, ev = self._prev
        if ev is not None:
            ev.synchronize()
        return bool(host[0] > 0)


def _sharded_step(mesh, c, n_seen, xb_loc, flags, triggered, *,
                  compute_dtype):
    """One streamed step on a mesh: this rank's slice of the batch, one
    all-reduce of the packed (counts | sums | flag), the replicated
    Sculley update."""
    from kmeans_tpu_torch.models.minibatch import (apply_batch_stats,
                                                   batch_stats)

    bc, bsums, _ = batch_stats(c, xb_loc, compute_dtype=compute_dtype)
    k, d = bsums.shape
    packed = mesh.all_reduce(torch.cat([
        torch.cat([bc[:, None], bsums], dim=1).reshape(-1),
        flags.local(triggered)]))
    flags.merged(packed[-1:])
    stats = packed[:-1].view(k, d + 1)
    new_c, n_after, _ = apply_batch_stats(c, n_seen, stats[:, 0],
                                          stats[:, 1:])
    return new_c, n_after


def _sharded_final(mesh, data, c, kw):
    """The final pass on a mesh: each rank labels its contiguous block of
    rows; the labels are all-gathered and the inertias summed.  Returns
    ``(labels (n,) int32 ndarray, inertia float)``."""
    from kmeans_tpu_torch.parallel.engine import _gather_rows

    n = data.shape[0]
    n_loc = -(-n // mesh.size)
    lo = min(mesh.rank * n_loc, n)
    hi = min(lo + n_loc, n)
    lab = torch.full((n_loc,), -1, dtype=torch.int32)
    inertia = 0.0
    if hi > lo:
        lab_np, inertia = assign_stream(data[lo:hi], c, **kw)
        lab[:hi - lo] = torch.from_numpy(lab_np)
    labels = _gather_rows(mesh, lab.to(mesh.device), n)
    total = mesh.all_reduce(torch.tensor([inertia], dtype=torch.float64,
                                         device=mesh.device))
    return labels.cpu().numpy(), float(total[0])
