"""Step-paced Lloyd runner: per-iteration visibility, checkpoint and resume.

Counterpart of ``kmeans_tpu/models/runner.py``.  :func:`fit_lloyd` runs the
whole loop and reads back one scalar a sweep; ``LloydRunner`` is the middle
ground long jobs use:

* one sweep per Lloyd iteration, on the same sweep functions the fit calls
  (``ops.lloyd.lloyd_pass`` for the refresh, ``ops.delta.delta_pass``,
  ``ops.hamerly.hamerly_pass``, ``ops.yinyang.yinyang_pass``; on the card
  each is a hand-written kernel),
* a callback per iteration with (iteration, inertia, shift², wall time),
  the iteration metrics on the registry and an ``iter`` telemetry event,
* periodic checkpoints, a resumable exit on SIGTERM / SIGINT, and resume,
  in the reference's format on disk (a directory either package's runner
  wrote resumes in the other),
* optional step-paced Anderson acceleration
  (``ops.anderson.anderson_step``, the one copy of the decision).

Known differences from the reference:

* ``mesh=`` (a :class:`~kmeans_tpu_torch.parallel.mesh.Mesh`, one process
  per device) steps the dense per-sweep reduction through the sharded
  engine's DP body (``parallel.engine._dp_local_pass``), or with
  ``model_axis`` its TP body (``parallel.engine._sharded_pass``: K1 in
  raw-score mode on this rank's k-slice, two MIN all-reduces, K3's fold):
  every rank keeps its row block, the runner's centroids stay whole on
  every rank (each TP step gathers the slices), and only rank 0 writes a
  checkpoint.
* Nothing is compiled per shape, so the iteration events carry no
  ``compile_s`` / ``compile_flops`` / ``compile_bytes``.  The ``phase`` tag
  stays: ``compile+step`` marks the first call of each sweep function in
  this runner, which on the card carries the kernel library's load (and
  its build, when nothing is built yet).  The kernel launch counters
  (``ops.cuda_lloyd.launch_counts``) stand in for the reference's compile
  observatory.
* k-means++ draws from one :class:`torch.Generator` seeded with
  ``config.seed`` (the reference draws from ``jax.random``).  The
  checkpoint stores the reference's key data for that seed
  (:func:`seed_key_data`), so a reference runner resuming the directory
  holds the key it would have made.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from kmeans_tpu_torch import obs
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data.synthetic import generator_for
from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.accelerated import ACCEL_STEPS
from kmeans_tpu_torch.models.init import init_centroids
from kmeans_tpu_torch.models.lloyd import KMeansState, _SWEEP_RECOMPUTE_ROWS
from kmeans_tpu_torch.obs import tracing as _tracing
from kmeans_tpu_torch.ops import yinyang as _yy
from kmeans_tpu_torch.ops.anderson import (OUTCOME_ACCEPTED, OUTCOME_REJECTED,
                                           anderson_reset, anderson_state,
                                           anderson_step)
from kmeans_tpu_torch.ops.delta import DELTA_REFRESH, delta_pass
from kmeans_tpu_torch.ops.distance import resolve_cd
from kmeans_tpu_torch.ops.hamerly import _NORM_INFLATE, hamerly_pass, row_norms
from kmeans_tpu_torch.ops.lloyd import (lloyd_pass, resolve_backend,
                                        resolve_update)
from kmeans_tpu_torch.ops.update import apply_update, reseed_empty_farthest
from kmeans_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from kmeans_tpu_torch.utils.preempt import Preempted, PreemptionGuard

__all__ = ["LloydRunner", "IterInfo", "StepObserver", "ITER_SECONDS",
           "ITERS_TOTAL", "seed_key_data"]

#: The per-iteration metric family: every step-paced fit observes its
#: iteration wall time here under its own ``model`` label, so ``GET
#: /metrics`` shows one iteration-latency histogram.  The reference's names.
ITER_SECONDS = obs.histogram(
    "kmeans_tpu_iteration_seconds",
    "Wall time of one training iteration/step",
    labels=("model",),
)
ITERS_TOTAL = obs.counter(
    "kmeans_tpu_iterations_total",
    "Training iterations/steps completed",
    labels=("model",),
)

# Pre-seed the reference's model labels: a labeled family with no children
# exposes no samples, and ``GET /metrics`` should show the iteration
# histograms (zeroed) from process start, not only after the first fit.
for _model in ("lloyd", "minibatch_stream", "gmm_stream"):
    ITER_SECONDS.labels(model=_model)
    ITERS_TOTAL.labels(model=_model)
del _model
_LLOYD_SECONDS = ITER_SECONDS.labels(model="lloyd")
_LLOYD_ITERS = ITERS_TOTAL.labels(model="lloyd")


def seed_key_data(seed: int) -> np.ndarray:
    """The raw data of the reference's ``jax.random.key(seed)`` (threefry,
    64-bit types off): ``[0, seed mod 2³²]`` as uint32."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


class StepObserver:
    """The streamed fits' per-step bookkeeping: wall clock between steps,
    the :data:`ITER_SECONDS` / :data:`ITERS_TOTAL` records and the
    :class:`IterInfo` callback.

    Usage: ``start()`` right before the loop, ``step(...)`` once per step,
    and ``exclude()`` after any off-loop work (checkpoint writes) so its
    cost is not counted in the next step's seconds.
    """

    def __init__(self, model: str, callback=None):
        self._hist = ITER_SECONDS.labels(model=model)
        self._total = ITERS_TOTAL.labels(model=model)
        self._callback = callback
        self._t_last = time.perf_counter()

    @property
    def wants_sync(self) -> bool:
        """Whether the caller should pay a per-step device sync to feed
        the callback real values (no callback: keep full overlap)."""
        return self._callback is not None

    def start(self) -> None:
        self._t_last = time.perf_counter()

    def exclude(self) -> None:
        """Re-arm the clock after work that must not count as step time."""
        self._t_last = time.perf_counter()

    def step(self, iteration: int, *, inertia=None, shift_sq=None) -> None:
        now = time.perf_counter()
        dt, self._t_last = now - self._t_last, now
        self._hist.observe(dt)
        self._total.inc()
        if self._callback is not None:
            self._callback(IterInfo(iteration, inertia, shift_sq, dt,
                                    False))


class IterInfo:
    __slots__ = ("iteration", "inertia", "shift_sq", "seconds", "converged")

    def __init__(self, iteration, inertia, shift_sq, seconds, converged):
        self.iteration = iteration
        self.inertia = inertia
        self.shift_sq = shift_sq
        self.seconds = seconds
        self.converged = converged

    def as_dict(self) -> dict:
        return {
            "iteration": self.iteration,
            "inertia": self.inertia,
            "shift_sq": self.shift_sq,
            "seconds": self.seconds,
            "converged": self.converged,
        }


class LloydRunner:
    """Python-paced Lloyd loop with per-iteration visibility, on ``device``
    (None is the card).  ``x`` is placed on the device once, here."""

    def __init__(
        self,
        x,
        k: int,
        *,
        config: Optional[KMeansConfig] = None,
        generator: Optional[torch.Generator] = None,
        mesh=None,
        model_axis: Optional[str] = None,
        accel: Optional[str] = None,
        device=None,
    ):
        self.cfg = (config or KMeansConfig(k=k)).validate()
        if config is not None and config.k != k:
            raise ValueError(f"k={k} contradicts config.k={config.k}")
        self.k = k
        self.iteration = 0
        self.centroids: Optional[torch.Tensor] = None
        self.last_inertia: Optional[float] = None
        #: False until the corresponding sweep function has run once in
        #: this runner: that iteration's telemetry is ``compile+step``.  Two
        #: flags because the delta update runs two sweeps: the refresh
        #: (iteration 1) and the carried-state delta sweep (first at 2).
        self._stepped = False
        self._stepped_delta = False
        # Carried state of the incremental update between run() calls;
        # None: the next sweep is a refresh (fresh runner, after resume or
        # init).  delta carries (labels, sums, counts); hamerly / yinyang
        # also their bounds (sb, slb|glb, c_prev_cd, csq_prev).
        # ``_bound_tail`` holds the fit-static trailing arguments of the
        # bound sweep (the row norms and, for yinyang, the group map).
        self._dstate = None
        self._bound_tail = ()
        self._group_of = None
        self._t = None

        self._accel = False
        if accel is not None:
            if accel != "anderson":
                raise ValueError(
                    f"unknown accel {accel!r}; the runner's step-paced "
                    "acceleration is 'anderson' (the fused β loop is "
                    "fit_lloyd_accelerated)"
                )
            if mesh is not None:
                raise ValueError(
                    "accel='anderson' steps single-device; the sharded "
                    "loop is fit_lloyd_accelerated_sharded(accel="
                    "'anderson')"
                )
            if self.cfg.empty == "farthest":
                raise ValueError(
                    "empty='farthest' is not supported under "
                    "acceleration (reseeding mid-extrapolation breaks "
                    "the fixed-point safeguard)"
                )
            self._accel = True
            self._accel_m = self.cfg.anderson_m
        self.mesh = mesh
        self._ax = None
        if mesh is not None:
            from kmeans_tpu_torch.parallel.engine import _place

            # The step-wise mesh path runs the dense per-sweep reduction
            # (stateless rank bodies); the carried-state incremental loops
            # on a mesh are fit_lloyd_sharded's.
            if self.cfg.update in ("delta", "hamerly", "yinyang"):
                raise ValueError(
                    "LloydRunner on a mesh runs the dense per-sweep "
                    "reduction; use fit_lloyd_sharded(update='delta'/"
                    "'hamerly'/'yinyang') for the incremental sharded "
                    "loops, or update='auto'"
                )
            dev = mesh.device
            self.x, self._w, _, self._n = _place(x, mesh, "data")
            if model_axis is not None:
                from kmeans_tpu_torch.parallel.engine import _Axes

                mp = mesh.axis_sizes[model_axis]
                if k % mp != 0:
                    raise ValueError(
                        f"LloydRunner TP path needs k % model axis == 0 "
                        f"(k={k}, model={mp}); use fit_lloyd_sharded for "
                        "automatic k padding")
                self._ax = _Axes(mesh, "data", model_axis, None)
        elif model_axis is not None:
            raise ValueError("model_axis needs mesh=")
        else:
            dev = resolve_device(device)
            self.x = as_tensor(x, dev).contiguous()
        self.device = dev
        self.generator = generator_for(
            self.cfg.seed if generator is None else generator, dev)
        #: The PRNG key data stored with a checkpoint (the reference's for
        #: ``config.seed``; a resume adopts the checkpoint's).
        self.key = seed_key_data(self.cfg.seed)
        if self._accel:
            # Made once: a Python float becomes a card tensor through a
            # copy that waits for the card.
            self._accel_reg = torch.tensor(self.cfg.anderson_reg,
                                           dtype=torch.float32, device=dev)
        cfg = self.cfg
        # The runner has no sample weights, so "auto" resolves to the
        # incremental delta loop (the path fit_lloyd's default takes); on a
        # mesh, to the dense reduction.
        self._update = (("matmul" if cfg.update == "auto" else cfg.update)
                        if mesh is not None
                        else resolve_update(cfg.update, w_exact=True))
        if self._update in ("hamerly", "yinyang"):
            if self._accel:
                raise ValueError(
                    f"accel='anderson' extrapolates between sweeps, "
                    f"which would interleave with update="
                    f"{self._update!r}'s carried-bound refresh "
                    "cadence; use update='delta' under acceleration"
                )
            if cfg.empty == "farthest":
                raise ValueError(
                    f"update={self._update!r} prunes rows, so the "
                    "per-sweep min-distances that empty='farthest' "
                    "reseeds from are never computed; use "
                    "empty='keep'"
                )
        if self._ax is not None:
            from kmeans_tpu_torch.ops.lloyd import sweep_route

            self._backend, self._k_tile = sweep_route(
                "classic", cfg.backend, self.x, k // self._ax.mp,
                weights=self._w, weights_are_binary=True,
                compute_dtype=cfg.compute_dtype)
        else:
            self._backend = resolve_backend(
                cfg.backend, self.x, k,
                weights=self._w if mesh is not None else None,
                weights_are_binary=True, compute_dtype=cfg.compute_dtype)
        self._kw = dict(chunk_size=cfg.chunk_size,
                        compute_dtype=cfg.compute_dtype,
                        backend=self._backend, device=dev)
        if self._update in ("hamerly", "yinyang"):
            # Fit-static per-row norms (the drift bounds' R_r terms).
            self._rno = row_norms(self.x, compute_dtype=cfg.compute_dtype)
            self._bound_tail = (self._rno,)

    # ---------------------------------------------------------------- sweeps
    def _new_centroids(self, c, sums, counts, min_d2):
        new_c = apply_update(c, sums, counts)
        if self.cfg.empty == "farthest":
            new_c = reseed_empty_farthest(new_c, counts, self.x, min_d2)
        return new_c, ((new_c - c) ** 2).sum()

    def _step(self, c):
        """The classic sweep (every sweep of a dense update, the delta
        loop's refresh): ``(new_c, inertia, shift², labels, sums,
        counts)``; on a mesh ``(new_c, inertia, shift²)``, the rank body
        and its merge."""
        if self._ax is not None:
            from kmeans_tpu_torch.parallel.engine import _sharded_pass

            new_loc, _, inertia, _, _ = _sharded_pass(
                self._ax, self.x, self._w, self._k_slice(c),
                empty=self.cfg.empty, **self._tp_kw())
            new_c = self._ax.model.all_gather(new_loc)
            return new_c, inertia, ((new_c - c) ** 2).sum()
        if self.mesh is not None:
            from kmeans_tpu_torch.parallel.engine import _dp_local_pass

            new_c, inertia, _ = _dp_local_pass(
                self.mesh, self.x, c, self._w,
                chunk_size=self.cfg.chunk_size,
                compute_dtype=self.cfg.compute_dtype, update=self._update,
                backend=self._backend, empty=self.cfg.empty)
            return new_c, inertia, ((new_c - c) ** 2).sum()
        labels, min_d2, sums, counts, inertia = lloyd_pass(
            self.x, c, update=self._update, **self._kw)
        new_c, shift_sq = self._new_centroids(c, sums, counts, min_d2)
        return new_c, inertia, shift_sq, labels, sums, counts

    def _k_slice(self, c):
        k_loc = self.k // self._ax.mp
        m = self._ax.model.rank
        return c[m * k_loc:(m + 1) * k_loc]

    def _tp_kw(self):
        return dict(k_real=self.k, route=self._backend, k_tile=self._k_tile,
                    kw=dict(chunk_size=self.cfg.chunk_size,
                            compute_dtype=self.cfg.compute_dtype,
                            update=self._update, weights_are_binary=True,
                            backend=self._backend))

    def _step_delta(self, c, lab, sums, counts):
        """The carried-state delta sweep; inertia is reported every
        iteration, so the row norms are always computed."""
        labels, min_d2, sums, counts, inertia, _ = delta_pass(
            self.x, c, lab, sums, counts, with_mind=True, **self._kw)
        new_c, shift_sq = self._new_centroids(c, sums, counts, min_d2)
        return new_c, inertia, shift_sq, labels, sums, counts

    def _step_bound(self, c, *state):
        """One bound-pruned sweep from the carried state: ``(new_c,
        inertia, shift², *carried state, n_recomputed[, n_group_pruned])``.
        Pruned sweeps never score every row, so the inertia is the upper
        estimate ``Σ max(‖x‖² + sb, 0)`` from the own-centroid bounds, as
        in the reference (exact on refresh sweeps up to the scoring
        rounding; :meth:`finalize` reports the exact value)."""
        sweep = (hamerly_pass if self._update == "hamerly"
                 else _yy.yinyang_pass)
        out = sweep(self.x, c, *state, *self._bound_tail, **self._kw)
        sums2, counts2, sb3 = out[1], out[2], out[3]
        new_c = apply_update(c, sums2, counts2)
        shift_sq = ((new_c - c) ** 2).sum()
        xsq = (self._rno / _NORM_INFLATE) ** 2
        inertia = torch.clamp_min(xsq + sb3, 0.0).sum()
        return (new_c, inertia, shift_sq) + tuple(out)

    def _sentinel_bound_state(self):
        """Fresh carried state for a bound-pruned refresh sweep: the
        ``labels_prev = -1`` sentinel plus zeroed sums, counts and bounds
        makes :func:`hamerly_pass` / :func:`yinyang_pass` run a full
        reduction (every row recomputed, bounds re-derived exactly): the
        reset the fused loop applies every ``DELTA_REFRESH`` iterations."""
        n, d = self.x.shape
        k = self.k
        dev = self.device
        f32 = torch.float32
        cd = resolve_cd(self.cfg.compute_dtype, self.x.dtype)
        lower = (torch.zeros((n, self._t), dtype=f32, device=dev)
                 if self._update == "yinyang"
                 else torch.zeros(n, dtype=f32, device=dev))
        return (
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(k, d, dtype=f32, device=dev),
            torch.zeros(k, dtype=f32, device=dev),
            torch.zeros(n, dtype=f32, device=dev),  # sb (the sweep writes)
            lower,                                   # slb | glb
            self.centroids.to(cd),
            torch.zeros(k, dtype=f32, device=dev),   # csq_prev (unused)
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ API
    def init(self, init=None) -> None:
        self._dstate = None          # carried delta state is init-specific
        self._group_of = None        # yinyang groups re-form per init
        if init is not None and not isinstance(init, str):
            self.centroids = as_tensor(init, self.device, torch.float32)
        elif self.mesh is not None:
            from kmeans_tpu_torch.parallel.init_sharded import init_on_mesh

            # On a mesh the rank's block carries zero padding rows: the
            # sharded seeding gives them weight 0.
            self.centroids = init_on_mesh(
                self.generator, self.x, self.k, n=self._n,
                mesh=self.mesh if self._ax is None else self._ax.rows,
                method=init if isinstance(init, str) else self.cfg.init,
                weights=self._w, compute_dtype=self.cfg.compute_dtype,
                chunk_size=self.cfg.chunk_size)
        else:
            method = init if isinstance(init, str) else self.cfg.init
            self.centroids = init_centroids(
                self.generator, self.x, self.k, method=method,
                compute_dtype=self.cfg.compute_dtype,
                chunk_size=self.cfg.chunk_size,
            )

    def run(
        self,
        *,
        max_iter: Optional[int] = None,
        tol: Optional[float] = None,
        callback: Optional[Callable[[IterInfo], None]] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
        checkpoint_keep: int = 0,
        telemetry=None,
        run_id: Optional[str] = None,
    ) -> KMeansState:
        """Iterate until convergence; fire ``callback`` each iteration.

        ``telemetry`` is a :class:`kmeans_tpu_torch.obs.TelemetryWriter`
        (or a path, opened and closed by this call): one ``iter`` JSONL
        event per iteration (the :class:`IterInfo` fields plus model,
        device and ``phase``: ``compile+step`` for the first call of each
        sweep function, ``step`` after), bracketed by ``run_start`` /
        ``run_done`` events.  Every iteration's wall time (up to a device
        synchronisation) lands in :data:`ITER_SECONDS`.

        ``run_id`` pins the id stamped into this run's spans; default: the
        telemetry writer's id, or a fresh one.  SIGTERM / SIGINT cut a
        checkpoint at the next iteration boundary (with ``checkpoint_path``)
        and raise :class:`~kmeans_tpu_torch.utils.preempt.Preempted`.
        """
        if self.centroids is None:
            self.init()
        if self._update == "yinyang" and self._group_of is None:
            # Fit-static centroid → group map, formed once from the current
            # centroids (the fused fit does the same from centroids0; a
            # resume re-derives it: bounds are init/resume-specific).
            g_np, self._t = _yy.centroid_groups(
                self.centroids.cpu().numpy(), self.cfg.yinyang_groups,
                seed=self.cfg.seed)
            self._group_of = torch.from_numpy(g_np).to(self.device)
            self._bound_tail = (self._rno, self._group_of)
        if checkpoint_path and checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}"
            )
        max_iter = max_iter if max_iter is not None else self.cfg.max_iter
        tol = tol if tol is not None else self.cfg.tol

        tw = telemetry
        own_tw = False
        if isinstance(telemetry, str):
            tw = obs.TelemetryWriter(telemetry)
            own_tw = True
        device = self.device.type
        converged = False
        saved = False
        t_run0 = time.perf_counter()
        n, d = self.x.shape
        if self._accel:
            self._acc_counters = {
                o: ACCEL_STEPS.labels(outcome=o)
                for o in ("accepted", "rejected", "fallback")}
            # Carried safeguard and history state of the shared step
            # (reset per run; a resume restarts the history like _dstate).
            acc_xs, acc_rs, _ = anderson_reset(self._accel_m, self.k * d,
                                               device=self.device)
            self._acc_state = anderson_state(self.centroids.float(),
                                             acc_xs, acc_rs)
            self._acc_tol = torch.tensor(tol, dtype=torch.float32,
                                         device=self.device)
        if run_id is None:
            run_id = tw.run_id if tw is not None else _tracing.new_run_id()

        def preempt_exit():
            if checkpoint_path and not saved:
                self.checkpoint(checkpoint_path, keep=checkpoint_keep)
            raise Preempted.during(
                f"LloydRunner preempted by signal at iteration "
                f"{self.iteration}",
                path=checkpoint_path, step=self.iteration,
            )

        try:
            # The run span is the trace root of a CLI fit, so every
            # iteration / sweep / update child and every telemetry event
            # share one trace id.
            with _tracing.span("lloyd.run", category="run", model="lloyd",
                               run_id=run_id, k=self.k, update=self._update):
                if tw is not None:
                    tw.event(
                        "run_start", model="lloyd", device=device,
                        n=int(n), d=int(d), k=self.k, update=self._update,
                        max_iter=int(max_iter), tol=float(tol),
                        start_iteration=self.iteration,
                    )
                with PreemptionGuard() as guard:
                    for it in range(max_iter):
                        with _tracing.span("iteration",
                                           category="iteration",
                                           iteration=self.iteration + 1):
                            converged, saved = self._iterate(
                                tol, tw, device, callback, checkpoint_path,
                                checkpoint_every, checkpoint_keep)
                        if converged:
                            break
                        # Mid-loop, exit promptly: running more iterations
                        # only races the grace window.  On the last
                        # iteration fall through to the post-loop policy,
                        # which knows whether anything was saved.
                        if guard.triggered and it < max_iter - 1:
                            preempt_exit()
                    # Only finalize()'s full labeling pass remains.  With a
                    # checkpoint, exit resumable now (the resumed run
                    # finalizes at once); with nothing saved, raising would
                    # discard the finished fit.
                    if guard.triggered and checkpoint_path is not None:
                        preempt_exit()
                if tw is not None:
                    tw.event(
                        "run_done", model="lloyd", device=device,
                        iterations=self.iteration,
                        converged=bool(converged),
                        inertia=self.last_inertia,
                        seconds=time.perf_counter() - t_run0,
                    )
                with _tracing.span("finalize", category="assign"):
                    return self.finalize(converged=converged)
        finally:
            if own_tw:
                tw.close()

    def _iterate(self, tol, tw, device, callback, checkpoint_path,
                 checkpoint_every, checkpoint_keep):
        """One iteration: the sweep, the host sync, the update and the
        bookkeeping.  Returns ``(converged, saved)``."""
        t0 = time.perf_counter()
        ran_delta = False
        n_rec = n_gp = None
        refresh = (self._dstate is None
                   or self.iteration % DELTA_REFRESH == 0)
        if self._update in ("hamerly", "yinyang"):
            # Bound-carrying loop: a sentinel refresh on the first sweep
            # after (re)init / resume and every DELTA_REFRESH-th iteration
            # (the fused cadence), the carried sweep otherwise.  One sweep
            # function either way: a refresh differs only in what it is fed.
            if refresh:
                self._dstate = self._sentinel_bound_state()
            ran_delta = True
            first = not self._stepped_delta
            with _tracing.span("sweep",
                               category="compile" if first else "assign",
                               sweep="refresh" if refresh else self._update):
                out = self._step_bound(self.centroids, *self._dstate)
            new_c, inertia, shift_sq = out[0], out[1], out[2]
            self._dstate = out[3:10]
            n_rec = out[10]
            if self._update == "yinyang":
                n_gp = out[11]
        elif self._update == "delta":
            # Incremental loop: the classic sweep on the first sweep after
            # (re)init / resume and every DELTA_REFRESH-th iteration, the
            # carried-state delta sweep otherwise.
            ran_delta = not refresh
            first = not (self._stepped_delta if ran_delta
                         else self._stepped)
            with _tracing.span("sweep",
                               category="compile" if first else "assign",
                               sweep="delta" if ran_delta else "refresh"):
                if ran_delta:
                    out = self._step_delta(self.centroids, *self._dstate)
                else:
                    out = self._step(self.centroids)
            new_c, inertia, shift_sq = out[:3]
            self._dstate = out[3:]
        else:
            first = not self._stepped
            with _tracing.span("sweep",
                               category="compile" if first else "assign",
                               sweep=self._update):
                new_c, inertia, shift_sq = self._step(self.centroids)[:3]
        with _tracing.span("host_sync", category="host_sync"):
            self._sync()
        dt = time.perf_counter() - t0
        if ran_delta:
            phase = "step" if self._stepped_delta else "compile+step"
            self._stepped_delta = True
        else:
            phase = "step" if self._stepped else "compile+step"
            self._stepped = True
        with _tracing.span("update", category="update"):
            outcome = None
            if self._accel:
                # The shared safeguarded decision: the sweep's inertia is
                # the objective at the pre-sweep iterate; a rejection
                # rewinds to the safe plain output with the history
                # cleared, residual growth or the settle switch fall back
                # to the plain step, all with the fused loops' carries.
                c_next, self._acc_state, code = anderson_step(
                    self.centroids, new_c, inertia, shift_sq,
                    self._acc_state, tol=self._acc_tol, reg=self._accel_reg)
                code = int(code)
                outcome = ("accepted" if code == OUTCOME_ACCEPTED
                           else "rejected" if code == OUTCOME_REJECTED
                           else "fallback")
                self.centroids = c_next
                self._acc_counters[outcome].inc()
            else:
                self.centroids = new_c
            self.iteration += 1
            self.last_inertia = float(inertia)
            shift = float(shift_sq)
            converged = shift <= tol and outcome != "rejected"
            if converged and outcome is not None:
                # Land on the safe plain output: the mixed iterate was
                # never objective-checked.
                self.centroids = new_c
            _LLOYD_SECONDS.observe(dt)
            _LLOYD_ITERS.inc()
            info = IterInfo(self.iteration, self.last_inertia, shift, dt,
                            converged)
            extra = {} if outcome is None else {"accel": outcome}
            if n_rec is not None:
                # Pruning effectiveness of this sweep: the fraction of rows
                # whose distances were recomputed (1.0 on refreshes).
                rec = float(n_rec)
                extra["recompute_fraction"] = rec / self.x.shape[0]
                _SWEEP_RECOMPUTE_ROWS.labels(update=self._update).inc(
                    max(rec, 0.0))
            if n_gp is not None and float(n_rec) > 0:
                extra["group_filter_fraction"] = (
                    float(n_gp) / (float(n_rec) * self._t))
            if tw is not None:
                tw.iteration(info, model="lloyd", device=device,
                             phase=phase, **extra)
            if callback:
                callback(info)
        saved = bool(checkpoint_path) and (
            self.iteration % checkpoint_every == 0 or converged)
        if saved:
            # save_array_checkpoint opens the "checkpoint_save" span.
            self.checkpoint(checkpoint_path, keep=checkpoint_keep)
        return converged, saved

    def finalize(self, *, converged: bool = False) -> KMeansState:
        """Labels, inertia and counts at the current centroids (on a mesh,
        of every row: the engine's final labeling pass)."""
        if self._ax is not None:
            from kmeans_tpu_torch.parallel.engine import (_gather_rows,
                                                          _sharded_pass)

            _, _, inertia, counts, labels = _sharded_pass(
                self._ax, self.x, self._w, self._k_slice(self.centroids),
                final=True, **self._tp_kw())
            labels = _gather_rows(self._ax.rows, labels, self._n)
            counts = self._ax.model.all_gather(counts)
        elif self.mesh is not None:
            from kmeans_tpu_torch.parallel.engine import _dense_final

            labels, inertia, counts = _dense_final(
                self.mesh, self.x, self._w, self.centroids, self._n,
                chunk_size=self.cfg.chunk_size,
                compute_dtype=self.cfg.compute_dtype, backend=self._backend)
        else:
            labels, _, _, counts, inertia = lloyd_pass(
                self.x, self.centroids, **self._kw)
        return KMeansState(
            self.centroids[: self.k],
            labels,
            inertia,
            torch.tensor(self.iteration, dtype=torch.int32,
                         device=self.device),
            torch.tensor(converged, device=self.device),
            counts[: self.k],
        )

    # --------------------------------------------------------- checkpointing
    def checkpoint(self, path: str, *, keep: int = 0) -> str:
        """Save centroids and iteration; on a mesh only rank 0 writes (the
        centroids are replicated)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return path
        state = KMeansState(
            self.centroids,
            torch.zeros(0, dtype=torch.int32),
            torch.tensor(self.last_inertia or 0.0, dtype=torch.float32),
            torch.tensor(self.iteration, dtype=torch.int32),
            torch.tensor(False),
            torch.zeros(self.k, dtype=torch.float32),
        )
        return save_checkpoint(
            path, state, step=self.iteration, config=self.cfg, key=self.key,
            keep=keep,
        )

    def resume(self, path: str) -> int:
        """Restore centroids and iteration from a checkpoint; returns the
        step."""
        state, meta = load_checkpoint(path)
        self.centroids = as_tensor(state.centroids, self.device,
                                   torch.float32)
        self._dstate = None          # stale across a process boundary
        self._group_of = None        # groups re-form from the new centroids
        self.iteration = int(meta["step"])
        if meta.get("key_data") is not None:
            self.key = meta["key_data"]
        return self.iteration
