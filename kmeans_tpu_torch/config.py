"""Typed configuration of the port's Lloyd engine.

Counterpart of ``kmeans_tpu/config.py``: :class:`KMeansConfig` is copied
from there field for field (that module imports no JAX, but importing it
would run ``kmeans_tpu/__init__.py``, which does).  Only ``backend`` differs:
its values name the port's routes, ``"auto"`` (the CUDA kernels for a tensor
on the card, the plain PyTorch versions for one on the CPU), ``"cuda"`` and
``"plain"``.  Fields that no ported module reads yet (``comm``, the
accelerated and minibatch engines' knobs) are kept so that a configuration
carries over unchanged.

:class:`ServeConfig` holds the reference's ``assign_*`` fields, the ones the
assignment engine (:mod:`kmeans_tpu_torch.serve.assign`) reads, with the
same defaults; the HTTP, room and fleet fields wait for the server.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["KMeansConfig", "ServeConfig"]


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
class ServeConfig:
    """The assignment engine's knobs (``kmeans_tpu/config.py``'s
    ``ServeConfig``, its ``assign_*`` fields only)."""

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
