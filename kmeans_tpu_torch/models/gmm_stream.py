"""Out-of-core Gaussian mixture: online (stepwise) EM on streamed batches.

Counterpart of ``kmeans_tpu/models/gmm_stream.py``.  Where
:mod:`kmeans_tpu_torch.models.streaming` streams Sculley minibatch
k-means, this streams Cappé–Moulines stepwise EM: the running
per-unit-mass statistics s = (N̄, S̄, Q̄) are blended toward each batch's
with a decaying rate

  s ← (1 − ρ_t)·s + ρ_t·ŝ_batch,     ρ_t = (t + t₀)^(−κ),  κ ∈ (0.5, 1]

and the closed-form M-step (:func:`~kmeans_tpu_torch.models.gmm.
gmm_m_step`, shared with the full-batch fit) runs after every batch.  The
batch E-step is the full-batch fit's tile pass over one (batch, d) tile,
so only the batches in flight and the (k, d) parameters occupy the card.

Batches ride the streamed k-means' host loader (the native gather into
pinned buffers, double-buffered to the card) and are a pure function of
(seed, step) drawn with numpy, the reference's bit for bit.  Checkpoints
are the reference's (``extra`` holds ``stream="gmm"``, the raw batch
size, the schedule, ``mesh_dp``): either package resumes the other's
directory.  Known difference: the seeding's init method draws from a
:class:`torch.Generator` (the host subsample rows are the reference's).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.stream import (foreach_chunk, prefetch_to_device,
                                          sample_batches, staging_ring,
                                          torch_dtype)
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.gmm import (GMMParams, GMMState, gmm_log_resp,
                                         gmm_m_step, gmm_scan_tiles,
                                         init_gmm_params, to_f32)
from kmeans_tpu_torch.models.init import (host_subsample_seed,
                                          resolve_fit_config)

__all__ = ["fit_gmm_stream", "gmm_assign_stream"]


def _blend_and_mstep(params, stats, N, S, Q, ll, b, rho, reg_covar, *,
                     covariance_type):
    """The post-reduction half of one stepwise-EM update: the
    Robbins–Monro blend of the batch's per-unit moments into the running
    statistics, then the closed-form M-step — the one copy shared by the
    single-device and mesh steps (only the moment reduction differs).
    ``rho`` is an f32 value; ``1 − ρ`` is rounded to f32 as the
    reference's, so the blend's f32 arithmetic is the reference's."""
    batch = (N / b, S / b, Q / b)
    keep = to_f32(1.0 - rho)
    stats = tuple(keep * s + rho * bn for s, bn in zip(stats, batch))
    new_params = gmm_m_step(params, stats[0], stats[1], stats[2],
                            covariance_type=covariance_type,
                            reg_covar=reg_covar)
    return new_params, stats, ll / b


def _gmm_stream_step(params, stats, xb, rho, reg_covar, *, covariance_type,
                     compute_dtype, mesh=None, flags=None, triggered=False):
    """One stepwise-EM update from one batch: ``(new_params, new_stats,
    mean_batch_ll)``.  The M-step is scale-free in the statistics, so the
    per-unit averages feed it directly.  With ``mesh`` ``xb`` is this
    rank's slice of the batch and one all-reduce of the packed (N | S | Q
    | ll | preemption flag) merges the slices."""
    N, S, Q, ll, _ = gmm_scan_tiles(
        xb, None, params, chunk_size=max(int(xb.shape[0]), 1),
        compute_dtype=compute_dtype, with_labels=False)
    b = xb.shape[0]
    if mesh is not None:
        N, S, Q, ll, flag = mesh.all_reduce_packed(
            N, S, Q, ll, flags.local(triggered))
        flags.merged(flag)
        b = b * mesh.size
    return _blend_and_mstep(params, stats, N, S, Q, ll, b, rho, reg_covar,
                            covariance_type=covariance_type)


def gmm_assign_stream(data, params: GMMParams, *, chunk_size: int = 65536,
                      compute_dtype=None, device=None):
    """Labels, total log-likelihood and soft counts of host-resident
    ``data`` in one streamed pass on ``device`` (None: the parameters'
    device).  Returns ``(labels (n,) int32 ndarray, log_likelihood float,
    soft_counts (k,) f32 ndarray)``.  Each chunk's sums stay on the
    device; one sync at the end reads them, and they are added on the
    host in chunk order (in f64), as the reference's running sums are."""
    dev = params.means.device if device is None else resolve_device(device)
    n = data.shape[0]
    labels = torch.empty((n,), dtype=torch.int32,
                         pin_memory=dev.type == "cuda")
    lls, softs = [], []

    def one_chunk(xb, lo):
        log_resp, log_prob = gmm_log_resp(xb, params, chunk_size=chunk_size,
                                          compute_dtype=compute_dtype)
        lab = torch.argmax(log_resp, dim=1).to(torch.int32)
        labels[lo:lo + lab.shape[0]].copy_(lab, non_blocking=True)
        lls.append(log_prob.sum())
        softs.append(torch.exp(log_resp).sum(dim=0))

    foreach_chunk(data, chunk_size, one_chunk, device=dev)
    ll = 0.0
    soft = np.zeros((params.means.shape[0],), np.float64)
    if lls:
        for v in torch.stack(lls).cpu().tolist():     # the one sync
            ll += v
        for row in torch.stack(softs).cpu().numpy():
            soft += row.astype(np.float64)
    return labels.numpy(), ll, soft.astype(np.float32)


def _resume(checkpoint_path, k, d, init, specs, dp, n_steps, dev):
    """The reference's resume refusals, then ``(params, stats, start_step,
    resolved)`` from the checkpoint at ``checkpoint_path``, or None when
    there is none."""
    from kmeans_tpu_torch.utils.checkpoint import (latest_step,
                                                   load_array_checkpoint,
                                                   resolve_resume_params)

    if latest_step(checkpoint_path) is None:
        return None
    if init is not None and not isinstance(init, str):
        raise ValueError(
            "resume found an existing checkpoint; an explicit init "
            "array contradicts it — drop init or the checkpoint"
        )
    arrays, meta = load_array_checkpoint(checkpoint_path)
    ck = (meta or {}).get("extra", {})
    if ck.get("stream") != "gmm":
        raise ValueError(
            f"checkpoint at {checkpoint_path!r} is not a streamed-"
            f"GMM checkpoint (stream tag {ck.get('stream')!r}) — "
            "resume it with the family that wrote it"
        )
    if arrays["means"].shape != (k, d):
        raise ValueError(
            f"checkpoint means {arrays['means'].shape} != {(k, d)}")
    # The exact replay: refuse explicit contradictions, adopt the
    # checkpoint's sampling and schedule parameters otherwise.
    resolved = resolve_resume_params(ck, specs)
    # Mesh presence and shape change the soft-moment reduction order and
    # the batch rounding: a silent fork is refused.
    ck_dp = int(ck.get("mesh_dp", 0))
    if ck_dp != dp:
        want = (f"mesh with a {ck_dp}-way data axis" if ck_dp
                else "no mesh")
        raise ValueError(
            f"resume mesh (data axis {dp or 'absent'}) contradicts "
            f"the checkpoint's ({ck_dp or 'absent'}); continue "
            f"this stream with {want}"
        )

    def t(name):
        return as_tensor(arrays[name], dev, torch.float32)

    start_step = int(meta["step"])
    if start_step > n_steps:
        raise ValueError(
            f"checkpoint is at step {start_step} > requested "
            f"steps={n_steps}; raise steps to continue this stream"
        )
    return (GMMParams(t("means"), t("variances"), t("log_pi")),
            (t("stat_n"), t("stat_s"), t("stat_q")), start_step, resolved)


def fit_gmm_stream(
    data,
    k: int,
    *,
    covariance_type: Optional[str] = None,
    reg_covar: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    config: Optional[KMeansConfig] = None,
    init=None,
    batch_size: Optional[int] = None,
    steps: Optional[int] = None,
    seed: Optional[int] = None,
    kappa: Optional[float] = None,
    t0: Optional[float] = None,
    prefetch_depth: int = 2,
    background_prefetch: bool = True,
    final_pass: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 100,
    checkpoint_keep: int = 0,
    resume: bool = False,
    mesh=None,
    data_axis: str = "data",
    callback: Optional[Callable] = None,
    device=None,
) -> GMMState:
    """Online EM over host or disk data of unbounded size, on ``device``
    (None is the card).

    ``data`` is a 2-D ``np.ndarray`` or ``np.memmap``.  ``kappa`` is the
    Robbins–Monro decay exponent (in (0.5, 1]; default 0.7) and ``t0 >=
    1`` offsets the schedule (the default 1 makes the first batch set the
    statistics outright).  ``callback`` (an :class:`~kmeans_tpu_torch.
    models.runner.IterInfo` consumer) fires once a step with the negated
    mean batch log-likelihood as the lower-is-better "inertia", which
    costs a sync a step; step times land in
    ``kmeans_tpu_iteration_seconds{model="gmm_stream"}`` either way.

    With ``checkpoint_path`` (parameters, running statistics, step) are
    saved every ``checkpoint_every`` steps and at the end; ``resume``
    continues an existing checkpoint from its step, replaying exactly what
    an uninterrupted run would have seen.  Sampling and schedule
    parameters (seed, batch size, kappa, t0, covariance_type, reg_covar)
    are adopted from the checkpoint when not passed, and an explicit
    contradiction is refused.  SIGTERM / SIGINT cut a checkpoint at the
    next step boundary and raise :class:`~kmeans_tpu_torch.utils.preempt.
    Preempted`.  With ``final_pass`` a streamed evaluation fills labels,
    the total log-likelihood and the soft counts; otherwise those fields
    are empty.

    With ``mesh`` (every rank calls this with the same arguments) the
    batch rounds down to a multiple of the data axis, each rank gathers
    its contiguous slice of every step's sorted index list, and one
    all-reduce merges the slices' soft moments; checkpoints record the
    raw batch size and ``mesh_dp``, and a mesh-mismatched resume is
    refused.  Rank 0 alone writes checkpoints.
    """
    if covariance_type not in (None, "diag", "spherical"):
        # "tied" is full-batch only: its M-step leans on a global scatter
        # constant across iterations, which decaying averages don't give.
        raise ValueError(
            f"covariance_type must be 'diag' or 'spherical' for the "
            f"streamed fit ('tied' is full-batch fit_gmm only), "
            f"got {covariance_type!r}"
        )
    if reg_covar is not None and not reg_covar >= 0.0:
        raise ValueError(f"reg_covar must be >= 0, got {reg_covar}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg, generator = resolve_fit_config(k, generator, config, dev)
    n, d = data.shape
    bs = batch_size if batch_size is not None else cfg.batch_size
    dp = mesh.axis_sizes[data_axis] if mesh is not None else 0
    rank0 = mesh is None or mesh.rank == 0
    n_steps = steps if steps is not None else cfg.steps
    host_seed = seed if seed is not None else cfg.seed

    # 0 is the final/preempt-saves-only mode; a negative cadence is a bug.
    if checkpoint_path and checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}"
        )

    start_step = 0
    params = None
    if resume:
        if not checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        found = _resume(checkpoint_path, k, d, init, [
            ("seed", "host_seed", seed, host_seed),
            ("batch_size", "batch_size", batch_size, bs),
            ("kappa", "kappa", kappa, 0.7),
            ("t0", "t0", t0, 1.0),
            ("covariance_type", "covariance_type", covariance_type, "diag"),
            ("reg_covar", "reg_covar", reg_covar, 1e-6),
        ], dp, n_steps, dev)
        if found is not None:
            params, stats, start_step, r = found
            host_seed, bs = r["seed"], r["batch_size"]
            kappa, t0 = r["kappa"], r["t0"]
            covariance_type = r["covariance_type"]
            reg_covar = r["reg_covar"]

    covariance_type = covariance_type or "diag"
    reg_covar = 1e-6 if reg_covar is None else float(reg_covar)
    kappa = 0.7 if kappa is None else float(kappa)
    t0 = 1.0 if t0 is None else float(t0)
    if not 0.5 < kappa <= 1.0:
        raise ValueError(f"kappa must be in (0.5, 1], got {kappa}")
    if not t0 >= 1.0:
        raise ValueError(f"t0 must be >= 1, got {t0}")

    if params is None:
        # Seeded on a host subsample: means from the init method, variances
        # from the subsample's per-feature variance, uniform mixing.
        c0, xs_sub = host_subsample_seed(
            data, k, generator, cfg, init, host_seed=host_seed, device=dev,
            return_sample=True)
        params = init_gmm_params(c0, xs_sub, None,
                                 covariance_type=covariance_type,
                                 reg_covar=to_f32(reg_covar),
                                 chunk_size=cfg.chunk_size)
        del xs_sub
        stats = (torch.zeros((k,), dtype=torch.float32, device=dev),
                 torch.zeros((k, d), dtype=torch.float32, device=dev),
                 torch.zeros((k, d), dtype=torch.float32, device=dev))

    from kmeans_tpu_torch.models.runner import StepObserver
    from kmeans_tpu_torch.models.streaming import _MeshFlags
    from kmeans_tpu_torch.obs import tracing as _tracing
    from kmeans_tpu_torch.parallel.engine import _any_rank
    from kmeans_tpu_torch.utils.checkpoint import (PeriodicSaver,
                                                   save_array_checkpoint)
    from kmeans_tpu_torch.utils.preempt import Preempted, PreemptionGuard

    saver = PeriodicSaver(checkpoint_path if rank0 else None,
                          checkpoint_every)

    def save(params, stats, step):
        save_array_checkpoint(
            checkpoint_path,
            {"means": params.means, "variances": params.variances,
             "log_pi": params.log_pi, "stat_n": stats[0],
             "stat_s": stats[1], "stat_q": stats[2]},
            step=step, config=cfg,
            extra={"stream": "gmm", "host_seed": int(host_seed),
                   "batch_size": int(bs), "kappa": float(kappa),
                   "t0": float(t0), "covariance_type": covariance_type,
                   "reg_covar": float(reg_covar),
                   "total_steps": int(n_steps), "mesh_dp": int(dp)},
            keep=checkpoint_keep,
        )

    reg = to_f32(reg_covar)
    # Rounded after the resume check, the raw value recorded: sampling
    # uses the shard-even size.
    bs_eff = max(dp, bs - bs % dp) if dp else bs
    part = (mesh.rank, dp) if mesh is not None else (0, 1)
    ring = staging_ring(dev, prefetch_depth, bs_eff // part[1], d,
                        torch_dtype(data.dtype))
    batches = sample_batches(data, bs_eff, n_steps, seed=host_seed,
                             start_step=start_step, ring=ring, part=part)
    flags = _MeshFlags(mesh) if mesh is not None else None
    step = start_step
    rec = StepObserver("gmm_stream", callback)
    fit_span = _tracing.span("fit_gmm_stream", category="run",
                             model="gmm_stream", k=k, steps=int(n_steps))
    # The guard covers the streamed steps, not the final pass: a signal
    # there keeps its default handling.
    with fit_span:
        with PreemptionGuard() as guard:
            rec.start()
            for xb in prefetch_to_device(batches, depth=prefetch_depth,
                                         background=background_prefetch,
                                         device=dev, ring=ring):
                with _tracing.span("step", category="iteration",
                                   step=step + 1):
                    if xb.dtype == torch.float64:
                        xb = xb.float()      # f64 rows compute in f32
                    rho = to_f32((step + t0) ** (-kappa))
                    with _tracing.span(
                            "sweep", category="compile"
                            if step == start_step else "assign"):
                        params, stats, mean_ll = _gmm_stream_step(
                            params, stats, xb, rho, reg,
                            covariance_type=covariance_type,
                            compute_dtype=cfg.compute_dtype, mesh=mesh,
                            flags=flags, triggered=guard.triggered)
                    step += 1
                    # The ll read syncs with the card; the negated mean ll
                    # keeps "inertia" lower-is-better.  No callback: no
                    # sync and no span.
                    if rec.wants_sync:
                        with _tracing.span("host_sync",
                                           category="host_sync"):
                            neg_ll = -float(mean_ll)
                    else:
                        neg_ll = None
                    rec.step(step, inertia=neg_ll)
                    saver.maybe(step, lambda p=params, s=stats, t=step:
                                save(p, s, t))
                    rec.exclude()    # checkpoint writes are not step time
                    stop = (guard.triggered if mesh is None
                            else flags.previous())
                    if stop and step < n_steps:
                        saver.maybe(step, lambda p=params, s=stats, t=step:
                                    save(p, s, t), force=True)
                        if mesh is not None:
                            mesh.barrier()    # the bundle is whole
                        raise Preempted.during(
                            f"fit_gmm_stream preempted by signal at step "
                            f"{step}/{n_steps}",
                            path=checkpoint_path, step=step,
                        )
            saver.maybe(step, lambda: save(params, stats, step), force=True)
            # A signal during the last step: with a checkpoint, exit
            # resumable; without one, finish rather than discard the
            # streamed phase.
            stop = (guard.triggered if mesh is None else
                    _any_rank(mesh, guard.triggered or flags.previous()))
            if stop and checkpoint_path is not None:
                raise Preempted.during(
                    f"fit_gmm_stream preempted by signal after the final "
                    f"step ({step}/{n_steps})" + (
                        "; only the final pass remains" if final_pass
                        else "; streamed phase complete and checkpointed"),
                    path=checkpoint_path, step=step,
                )

        if final_pass:
            with _tracing.span("final_pass", category="assign",
                               model="gmm_stream"):
                kw = dict(chunk_size=max(cfg.chunk_size, 8192),
                          compute_dtype=cfg.compute_dtype, device=dev)
                if mesh is None:
                    labels_np, ll, soft = gmm_assign_stream(data, params,
                                                            **kw)
                else:
                    labels_np, ll, soft = _sharded_final(mesh, data, params,
                                                         kw)
            labels = torch.from_numpy(labels_np).to(dev)
            ll_v = torch.tensor(ll, dtype=torch.float32, device=dev)
            counts = torch.from_numpy(soft).to(dev)
        else:
            labels = torch.zeros((0,), dtype=torch.int32, device=dev)
            ll_v = torch.zeros((), dtype=torch.float32, device=dev)
            counts = torch.zeros((k,), dtype=torch.float32, device=dev)

        return GMMState(
            means=params.means,
            covariances=params.variances,
            mix_weights=torch.exp(params.log_pi),
            labels=labels,
            log_likelihood=ll_v,
            n_iter=torch.tensor(step, dtype=torch.int32, device=dev),
            converged=torch.tensor(False, device=dev),
            resp_counts=counts,
        )


def _sharded_final(mesh, data, params, kw):
    """The final pass on a mesh: each rank evaluates its contiguous block
    of rows; the labels are all-gathered, the log-likelihoods and soft
    counts summed (f64).  Returns what :func:`gmm_assign_stream` does."""
    from kmeans_tpu_torch.parallel.engine import _gather_rows

    n = data.shape[0]
    k = params.means.shape[0]
    n_loc = -(-n // mesh.size)
    lo = min(mesh.rank * n_loc, n)
    hi = min(lo + n_loc, n)
    lab = torch.full((n_loc,), -1, dtype=torch.int32)
    ll, soft = 0.0, np.zeros((k,), np.float32)
    if hi > lo:
        lab_np, ll, soft = gmm_assign_stream(data[lo:hi], params, **kw)
        lab[:hi - lo] = torch.from_numpy(lab_np)
    labels = _gather_rows(mesh, lab.to(mesh.device), n)
    total = mesh.all_reduce(torch.tensor(
        np.concatenate([[ll], soft.astype(np.float64)]),
        dtype=torch.float64, device=mesh.device))
    return (labels.cpu().numpy(), float(total[0]),
            total[1:].cpu().numpy().astype(np.float32))
