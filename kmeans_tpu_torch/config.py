"""Typed configuration of the port's Lloyd engine.

Counterpart of ``kmeans_tpu/config.py``: :class:`KMeansConfig` is copied
from there field for field (that module imports no JAX, but importing it
would run ``kmeans_tpu/__init__.py``, which does).  Only ``backend`` differs:
its values name the port's routes, ``"auto"`` (the CUDA kernels for a tensor
on the card, the plain PyTorch versions for one on the CPU), ``"cuda"`` and
``"plain"``.  Every field is kept (``comm`` is read by the
sharded engine, :mod:`kmeans_tpu_torch.parallel`), so that a configuration
carries over unchanged.  :class:`MeshConfig`, :class:`RunConfig` and
:func:`run_config_from_dict` are the reference's; ``MeshConfig.platform``
names the device type of the port's mesh (``None`` or ``"cuda"``: the
cards over NCCL; ``"cpu"``: gloo CPU processes).

:class:`ServeConfig` holds every field of the reference's, with its
defaults, so one configuration picks the same route and limits on both
servers; the board (:mod:`kmeans_tpu_torch.serve.server`'s rooms) reads
``max_render_cards``, ``max_concurrent_train``, ``persist_dir`` and
``persist_debounce_s`` as the reference's does.  The fleet supervisor
(:mod:`kmeans_tpu_torch.serve.fleet`) reads the ``fleet_*`` fields;
``fleet_drain_s`` also bounds a server's own drain.

The board's constants (the palette, the centroid cap, room codes, the drop
clamp, the session modes and the zone height rule) are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["KMeansConfig", "ServeConfig", "MeshConfig", "RunConfig",
           "run_config_from_dict", "COLORS", "MAX_CENTROIDS",
           "ROOM_ALPHABET", "ROOM_CODE_LEN", "POS_CLAMP_X", "POS_CLAMP_Y",
           "clamp_pos", "MODES", "zone_min_height_px"]

# ---------------------------------------------------------------------------
# The reference's board constants (``kmeans_tpu/config.py``, its values)
# ---------------------------------------------------------------------------

#: Centroid color palette, first-unused-wins (app.mjs:8,125).
COLORS: Tuple[str, ...] = (
    "#6EE7B7", "#93C5FD", "#FBCFE8", "#FDE68A", "#C7D2FE", "#FCA5A5",
)

#: Hard cap on centroid zones in the collaborative session (app.mjs:127).
MAX_CENTROIDS: int = 3

#: Room-code alphabet: A-Z + 2-9 minus lookalikes I/O/0/1 (app.mjs:19).
ROOM_ALPHABET: str = "ABCDEFGHJKLMNPQRSTUVWXYZ23456789"
ROOM_CODE_LEN: int = 4

#: Normalized drop-position clamp bounds: x ∈ [0.02, 0.92], y ∈ [0.10, 0.92]
#: (app.mjs:366-367).
POS_CLAMP_X: Tuple[float, float] = (0.02, 0.92)
POS_CLAMP_Y: Tuple[float, float] = (0.10, 0.92)


def clamp_pos(x: float, y: float) -> Tuple[float, float]:
    """Clamp a normalized board position exactly as the drop handler does
    (app.mjs:362-367)."""
    cx = min(max(x, POS_CLAMP_X[0]), POS_CLAMP_X[1])
    cy = min(max(y, POS_CLAMP_Y[0]), POS_CLAMP_Y[1])
    return (cx, cy)


#: Card geometry for zone min-height: max(260, 64 + n*(110+10)) px
#: (app.mjs:302-306).
CARD_H_PX: int = 110
CARD_GAP_PX: int = 10
ZONE_BASE_PX: int = 64
ZONE_MIN_PX: int = 260

#: Session modes (index.html:125-127). ``mode`` is synced but never branched
#: on in the reference (SURVEY.md §8.7); it is kept as a document field.
MODES: Tuple[str, ...] = ("learn", "playtest", "custom")


def zone_min_height_px(n_cards: int) -> int:
    """Zone min-height rule from app.mjs:302-306."""
    return max(ZONE_MIN_PX, ZONE_BASE_PX + n_cards * (CARD_H_PX + CARD_GAP_PX))


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """Configuration of the numeric Lloyd / minibatch engine.

    This is the typed replacement for the reference's scattered knobs, extended
    with everything the TPU engine needs (SURVEY.md §5.6 "New build" note).
    """

    k: int = 3
    init: str = "k-means++"          # "k-means++" | "k-means||" | "random" | "given"
    max_iter: int = 100
    #: Convergence: stop when the summed squared centroid shift <= tol.
    tol: float = 1e-4
    seed: int = 0
    #: Rows per scan tile in the fused assign+reduce pass.
    chunk_size: int = 4096
    #: Matmul input dtype ("bfloat16" | "float32" | None = x.dtype).
    #: Accumulation is always float32.
    compute_dtype: Optional[str] = None
    #: Centroid-update reduction: "auto" (the policy default: the
    #: incremental "delta" sweep wherever its gates pass — a plain or
    #: DP-sharded Lloyd fit with exactly-representable weights — else the
    #: dense "matmul"/"segment" reduction), "matmul" (one-hot^T @ X on the
    #: MXU), "segment" (jax.ops.segment_sum scatter-add), or "delta"
    #: (forced incremental: the one-hot update runs only over rows whose
    #: label changed since the previous sweep — ~2x fewer MXU FLOPs at
    #: steady-state churn, bit-exact labels; RAISES where unsupported, the
    #: same strictness contract as backend="pallas"; see
    #: kmeans_tpu.ops.delta and kmeans_tpu.ops.lloyd.resolve_update), or
    #: "hamerly" (forced bound-pruned sweeps: rows whose carried score
    #: bounds prove the argmin unchanged skip the distance matmul too —
    #: exact labels, but the win is DATA-DEPENDENT: large on naturally
    #: clustered data where first/second-centroid gaps are wide, absent
    #: when k far exceeds the natural cluster count; single-device and
    #: DP-mesh Lloyd fits, empty="keep" only; see kmeans_tpu.ops.hamerly),
    #: or "yinyang" (forced group-bound pruning: hamerly's test with
    #: t ≈ k/10 per-GROUP drift bounds instead of one global one, so a
    #: single fast-moving centroid no longer poisons every row's lower
    #: bound — same exactness contract, same fit-shape support, strictly
    #: tighter filtering; see kmeans_tpu.ops.yinyang).  Under "auto" the
    #: fit loop also engages the runtime-adaptive delta ↔ yinyang switch
    #: on large fits, judged each refresh period from the measured
    #: recompute fraction (kmeans_tpu.models.lloyd).
    update: str = "auto"
    #: Yinyang group count t (None = max(1, ceil(k / 10))).  t=1
    #: degenerates to hamerly's single bound; t=k tracks one bound per
    #: centroid.  Groups are formed once per fit from the initial
    #: centroids (kmeans_tpu.ops.yinyang.centroid_groups).
    yinyang_groups: Optional[int] = None
    #: Empty-cluster policy: "keep" (retain old centroid) or "farthest"
    #: (reseed to the currently-worst-fit points).
    empty: str = "keep"
    #: Sweep backend: "auto" (the hand-written CUDA kernels for a tensor on
    #: the card, the plain PyTorch versions for one on the CPU), "cuda"
    #: (forced; raises where the kernels do not apply) or "plain" (the plain
    #: versions on any device, for tests and kernel checks).
    backend: str = "auto"
    #: Sweep-merge collective of the SHARDED engine's DP paths: "allreduce"
    #: (psum the full per-shard sums|counts|inertia slab, update replicated
    #: on every device), "scatter" (reduce-scatter the slab so each data
    #: shard owns and updates a k/dp centroid slice, then all-gather only
    #: the finished centroids — RAISES on model_axis/feature_axis meshes,
    #: whose bodies already own slices), or "auto" (scatter once the f32
    #: (k, d) slab crosses the engine's byte threshold and dp > 1).
    #: Single-device fits ignore it.
    comm: str = "auto"

    # Accelerated-fit engine (models/accelerated.py).
    #: Extrapolation scheme of the accelerated Lloyd loop: "beta" (the
    #: safeguarded single-direction over-relaxation c ← T(c) + β(T(c)−c))
    #: or "anderson" (depth-m Anderson mixing over a carried history of
    #: iterates/residuals, solved on-device each step; ops/anderson.py).
    #: Both share the free-objective safeguard: a step that increased the
    #: objective is rejected and iteration restarts from the last plain
    #: Lloyd iterate.
    accel: str = "beta"
    #: Anderson history depth m (ring of (m, k·d) carried buffers; the
    #: paper's sweet spot is ~5 — deeper histories mostly buy a worse-
    #: conditioned Gram).
    anderson_m: int = 5
    #: Tikhonov ridge of the Gram solve, relative to tr(G)/m (scale-free).
    anderson_reg: float = 1e-8
    #: Iteration schedule of the accelerated/minibatch fits: "full" (every
    #: iteration sees all n rows) or "nested" (a doubling ladder of nested
    #: prefix subsamples — early iterations run on x[:b], b doubling once
    #: the subsample centroid shift falls below the sampling noise floor,
    #: then the fit promotes to the full-batch loop; Nested Mini-Batch
    #: K-Means, PAPERS.md).
    schedule: str = "full"
    #: First rung size of the nested ladder (clamped to n).
    nested_start: int = 8192

    # Minibatch engine.
    batch_size: int = 8192
    steps: int = 200

    def validate(self) -> "KMeansConfig":
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.init not in ("k-means++", "k-means||", "random", "given"):
            raise ValueError(f"unknown init {self.init!r}")
        if self.update not in ("auto", "matmul", "segment", "delta",
                               "hamerly", "yinyang"):
            raise ValueError(f"unknown update {self.update!r}")
        if self.yinyang_groups is not None and self.yinyang_groups < 1:
            raise ValueError(
                f"yinyang_groups must be >= 1, got {self.yinyang_groups}")
        if self.empty not in ("keep", "farthest"):
            raise ValueError(f"unknown empty-cluster policy {self.empty!r}")
        if self.backend not in ("auto", "cuda", "plain"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.comm not in ("auto", "allreduce", "scatter"):
            raise ValueError(f"unknown comm {self.comm!r}")
        if self.accel not in ("beta", "anderson"):
            raise ValueError(f"unknown accel {self.accel!r}")
        if not 2 <= self.anderson_m <= 64:
            raise ValueError(
                f"anderson_m must be in [2, 64], got {self.anderson_m}"
            )
        if self.anderson_reg <= 0.0:
            raise ValueError("anderson_reg must be positive")
        if self.schedule not in ("full", "nested"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.nested_start < 1:
            raise ValueError("nested_start must be positive")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be positive")
        if self.batch_size < 1:
            raise ValueError("batch_size must be positive")
        if self.steps < 1:
            raise ValueError("steps must be positive")
        return self


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded engine.

    ``data`` shards points (DP, the north-star axis); ``model`` optionally
    shards centroids over k (TP) when k·d is too large per device.
    """

    data: int = 1
    model: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    platform: Optional[str] = None   # None = the cards

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.model)

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (self.data_axis, self.model_axis)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The server's and the assignment engine's knobs
    (``kmeans_tpu/config.py``'s ``ServeConfig``, field for field)."""

    host: str = "127.0.0.1"
    port: int = 8787
    #: Cap on cards materialized into a browser-facing document (board).
    max_render_cards: int = 2000
    #: Server-wide bound on concurrent ``train`` jobs (board).
    max_concurrent_train: int = 2
    #: ``Retry-After`` floor, in seconds, of a 503 (no generation yet, a
    #: full queue, a shed request); the measured backlog over the drain
    #: rate raises it under load.
    retry_after_s: int = 5
    #: Bounded uniform jitter added to ``Retry-After`` per response, so
    #: rejected clients do not all come back in the same second.  0 sends
    #: the exact integer.
    retry_after_jitter_s: float = 2.0
    #: Model registry checkpoint directory: the newest verified generation
    #: is restored at boot and re-loaded on ``POST /api/model/reload``.
    #: None leaves the registry in memory only.
    model_dir: Optional[str] = None
    #: Request-body byte cap of every POST (413 beyond it).
    max_import_bytes: int = 4 * 1024 * 1024
    #: Room durability directory (board): each room is written there as
    #: export JSON and revived at boot.  None keeps rooms in memory only.
    persist_dir: Optional[str] = None
    #: Seconds of quiet after a version bump before a room is written
    #: (board).
    persist_debounce_s: float = 0.5
    #: Serve ``GET /metrics`` (Prometheus text); off answers 404.
    metrics: bool = True
    #: Enable the process span tracer while the server runs and serve
    #: ``GET /api/trace``; off leaves the tracer switch alone and answers
    #: 404.  ``X-Trace-Id`` is minted or adopted either way.
    tracing: bool = True
    #: JSONL telemetry file of train jobs (board); probed for
    #: writability at construction.
    telemetry_path: Optional[str] = None
    #: Per-request row cap (a request asking for an unbounded distance
    #: computation is refused at the wire; the batcher re-coalesces split
    #: requests anyway).
    assign_max_points: int = 4096
    #: Adaptive micro-batching; off is the plain per-request NumPy path
    #: (:func:`kmeans_tpu_torch.serve.assign.assign_direct`).
    assign_batching: bool = True
    #: Upper bound on how long the batcher holds the oldest queued request
    #: open to coalesce arrivals behind it.  The adaptive policy usually
    #: dispatches far sooner: it stops waiting as soon as the observed
    #: arrival gap says nothing more is coming.
    assign_max_delay_s: float = 0.002
    #: Row cap on one coalesced batch.
    assign_max_batch_rows: int = 8192
    #: Floor of the power-of-two ladder ``stats()["batch_rows_pow2"]``
    #: summarises batch sizes on (the port pads no batch to it).
    assign_min_bucket: int = 64
    #: Pending-request cap on the batcher queue; beyond it a request is
    #: refused (``QueueFullError``) instead of queueing without bound.
    assign_pending_limit: int = 512
    #: Seconds a request waits for its batch before ``AssignTimeoutError``.
    assign_timeout_s: float = 30.0
    #: Closure-pruned scoring (candidate lists from
    #: :func:`kmeans_tpu_torch.ops.hamerly.closure_candidates`) when the
    #: served model's k is at least this; 0 disables pruning.  Exact: rows
    #: whose triangle-inequality certificate fails are scored densely.
    assign_prune_min_k: int = 256
    #: Dispatcher threads draining the queue, each coalescing its own batch.
    assign_workers: int = 1
    #: Threads of the host pruned route's grouped GEMM within one batch.
    assign_kernel_threads: int = 1
    #: Route of the pruned stage: ``host`` (grouped NumPy GEMM), ``device``
    #: (:func:`kmeans_tpu_torch.ops.hamerly.closure_assign_device` on the
    #: engine's device), ``quant`` (the int8 tier), or ``auto`` (``device``
    #: when the engine's device is a CUDA card, ``host`` on the CPU).
    assign_pruned_backend: str = "auto"
    #: Compressed-codebook tier: ``int8`` / ``bf16`` force it, ``off``
    #: leaves it to policy (``assign_pruned_backend="quant"`` or an f32
    #: codebook of 256 MiB and more engage int8).  Exact by its error
    #: bounds; engages only for pruned-prepared models.
    assign_quant: str = "off"
    #: Batches with fewer rows than this skip the quant tier for the f32
    #: pruned route (same labels; both are exact).
    assign_quant_min_rows: int = 512
    #: Bind the listening socket with ``SO_REUSEPORT`` so fleet worker
    #: processes share one port.  Off by default: a lone server wants the
    #: EADDRINUSE a stale twin would otherwise silently split traffic with.
    reuse_port: bool = False
    #: Fleet supervisor knobs: heartbeat cadence and timeout, respawn
    #: backoff, drain budget (also the longest a server's stop() waits for
    #: accepted requests) and registry watch cadence.
    fleet_heartbeat_s: float = 0.5
    fleet_heartbeat_timeout_s: float = 3.0
    fleet_backoff_base_s: float = 0.1
    fleet_backoff_max_s: float = 5.0
    fleet_drain_s: float = 5.0
    fleet_reload_poll_s: float = 0.1
    #: Per-tenant admission control on ``POST /api/assign``:
    #: ``(class, priority, rate_per_s, burst)`` tuples.  A request's
    #: ``X-Tenant`` names its tenant; a tenant matching a class belongs to
    #: it, anything else (no header included) to the lowest-priority
    #: class.  Each tenant value gets its own token bucket at its class's
    #: rate (0 = unmetered).  Empty, the default, disables admission.
    tenant_classes: Tuple[Tuple[str, int, float, float], ...] = ()
    #: Once the assign queue passes this fraction of
    #: ``assign_pending_limit``, classes shed lowest priority first, at
    #: evenly spaced thresholds up to the top class at a full queue.
    shed_start_fraction: float = 0.5
    #: Directory where the server appends its completed spans as
    #: ``spans-<pid>.jsonl``.  None disables the spool; the span ring
    #: works either way.
    trace_dir: Optional[str] = None
    #: Port of the fleet supervisor's observability endpoint (fleet).
    fleet_obs_port: Optional[int] = 0
    #: Burn-rate SLO monitor (:mod:`kmeans_tpu_torch.obs.slo`): while a
    #: window is in breach ``/readyz`` answers 503.  Off gates readiness
    #: on the model and the engine only.
    slo: bool = False
    #: Latency SLO: a request slower than this is a bad event; the
    #: objective is the good fraction required.
    slo_latency_target_s: float = 0.25
    slo_latency_objective: float = 0.99
    #: Availability SLO: 5xx or shed responses are bad events.
    slo_availability_objective: float = 0.999
    #: Rolling windows and their burn-rate thresholds, one to one.
    slo_windows_s: Tuple[float, ...] = (10.0, 60.0, 300.0)
    slo_burn_thresholds: Tuple[float, ...] = (14.4, 6.0, 1.0)
    #: A window breaches only with at least this many events in it.
    slo_min_samples: int = 50
    #: Burn re-evaluation rate limit.
    slo_eval_s: float = 0.25


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One fully-specified run: data shape + engine + mesh."""

    n: int = 500
    d: int = 2
    kmeans: KMeansConfig = dataclasses.field(default_factory=KMeansConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    minibatch: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def run_config_from_dict(d: dict) -> RunConfig:
    d = dict(d)
    km = KMeansConfig(**d.pop("kmeans", {}))
    mesh = MeshConfig(**d.pop("mesh", {}))
    return RunConfig(kmeans=km.validate(), mesh=mesh, **d)
