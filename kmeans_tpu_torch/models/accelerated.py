"""Accelerated Lloyd: safeguarded extrapolation of the fixed-point map.

Counterpart of ``kmeans_tpu/models/accelerated.py``.  Lloyd's update is a
fixed-point map ``c ← T(c)`` whose convergence is linear and often slow
near the end.  Two extrapolation schemes share one safeguard:

* ``accel="beta"``: over-relaxation along the update direction,
  ``c_{t+1} = T(c_t) + β_t · (T(c_t) − c_t)`` with β_t adapted online; every
  sweep is the classic one (K1 on the card);
* ``accel="anderson"``: depth-m Anderson mixing over a ring of the last m
  iterates and residuals (:mod:`kmeans_tpu_torch.ops.anderson`).  Its sweeps
  follow ``cfg.update`` as ``fit_lloyd`` resolves it: under the default
  ``"delta"`` every ``DELTA_REFRESH``-th sweep is the classic one (K1) and
  the others the incremental one (K2), with the row norms, since the
  safeguard reads the objective every sweep.

The safeguard: the objective at the current iterate comes free with its
sweep, and if the last extrapolation raised it the step is rejected and
iteration restarts from the last plain Lloyd iterate (history cleared, for
Anderson).  The reference's ``lax.while_loop`` becomes a Python loop over
sweeps; every decision is a ``torch.where`` on the device, and the loop
reads one flag (``done``) back per iteration, as ``fit_lloyd``'s does.

``schedule="nested"`` first runs the doubling nested-prefix ladder
(:func:`kmeans_tpu_torch.models.minibatch.nested_ladder`) and promotes its
warm start into the full-batch loop.

:data:`ACCEL_STEPS` counts Anderson outcomes across the process under the
reference's metric name and labels.  It is an in-process tally until the
port has the reference's metrics registry, as the kernels' launch counts
stand in for its cost observatory.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from kmeans_tpu_torch.device import as_tensor, resolve_device
from kmeans_tpu_torch.models.init import resolve_fit_inputs
from kmeans_tpu_torch.models.lloyd import KMeansState
from kmeans_tpu_torch.models.minibatch import nested_ladder
from kmeans_tpu_torch.ops.anderson import (OUTCOME_ACCEPTED,
                                           OUTCOME_FALLBACK,
                                           OUTCOME_REJECTED, anderson_reset,
                                           anderson_state, anderson_step)
from kmeans_tpu_torch.ops.delta import DELTA_REFRESH, default_cap, delta_pass
from kmeans_tpu_torch.ops.distance import resolve_cd
from kmeans_tpu_torch.ops.lloyd import (lloyd_pass, resolve_backend,
                                        resolve_update, weights_exact)
from kmeans_tpu_torch.ops.update import apply_update

__all__ = ["fit_lloyd_accelerated", "record_accel_steps", "ACCEL_STEPS"]

#: The outcome labels, by ``OUTCOME_*`` code.
OUTCOMES = {OUTCOME_ACCEPTED: "accepted", OUTCOME_REJECTED: "rejected",
            OUTCOME_FALLBACK: "fallback"}


class OutcomeTally:
    """A labelled counter kept in the process: ``inc(n, outcome=...)`` and
    ``value(outcome=...)``, the reads of the reference's counter."""

    def __init__(self, name: str, help: str, outcomes):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values = dict.fromkeys(outcomes, 0)

    def inc(self, amount: int = 1, *, outcome: str) -> None:
        with self._lock:
            self._values[outcome] += int(amount)

    def value(self, *, outcome: str) -> int:
        with self._lock:
            return self._values[outcome]


#: Extrapolation outcomes across every Anderson fit in the process:
#: ``accepted`` = the extrapolated iterate was used, ``rejected`` = the
#: safeguard fired, ``fallback`` = the plain Lloyd step ran.  Each fit adds
#: its totals when it returns.
ACCEL_STEPS = OutcomeTally(
    "kmeans_tpu_accel_steps_total",
    "Accelerated-fit extrapolation steps by outcome",
    OUTCOMES.values())


def record_accel_steps(n_accepted: int, n_rejected: int,
                       n_fallback: int) -> None:
    """Fold one fit's outcome totals into :data:`ACCEL_STEPS`."""
    ACCEL_STEPS.inc(n_accepted, outcome="accepted")
    ACCEL_STEPS.inc(n_rejected, outcome="rejected")
    ACCEL_STEPS.inc(n_fallback, outcome="fallback")


def _finish(x, c, it, converged, outcomes, kw):
    """The final consistent view at ``c`` and the per-iteration outcome
    codes, one int32 tensor."""
    labels, _, _, counts, inertia = lloyd_pass(x, c, **kw)
    dev = x.device
    codes = (torch.stack(outcomes).to(torch.int32) if outcomes
             else torch.zeros(0, dtype=torch.int32, device=dev))
    return KMeansState(c, labels, inertia,
                       torch.tensor(it, dtype=torch.int32, device=dev),
                       torch.tensor(converged, device=dev), counts), codes


def _accelerated_loop(x, centroids0, weights, tol, *, max_iter, chunk_size,
                      compute_dtype, update, backend, beta_max=1.0):
    """The beta loop.  Returns ``(KMeansState, outcome codes)``: per
    iteration ``OUTCOME_REJECTED`` where the safeguard fired, else
    ``OUTCOME_ACCEPTED``.

    Only an extrapolated iterate (β > 0) can be rejected.  A plain step —
    the first, each one after a rewind, every one under ``beta_max=0`` — is
    T of the iterate whose objective is ``f_prev``, so Lloyd's monotonicity
    bounds its objective and a rise there is the f32 sum's rounding.  The
    reference rejects it all the same, and then re-measures the same
    rewound iterate, rejects it again and spins to ``max_iter``.

    At β = 1 with frozen labels the iterate mirrors about the fixed point
    (``c' = 2m − c``) at a constant shift, so the loop ends when a rounding
    rise of the objective rejects a step, here as in the reference."""
    dev = x.device
    kw = dict(weights=weights, chunk_size=chunk_size,
              compute_dtype=compute_dtype, update=update, backend=backend,
              device=dev)
    f32 = torch.float32
    tol = torch.tensor(tol, dtype=f32, device=dev)
    c = c_safe = centroids0.float()
    f_prev = torch.full((), float("inf"), dtype=f32, device=dev)
    beta = torch.zeros((), dtype=f32, device=dev)
    extrapolated = torch.zeros((), dtype=torch.bool, device=dev)
    outcomes = []
    it, done = 0, False
    while it < max_iter and not done:
        _, _, sums, counts, f_c = lloyd_pass(x, c, **kw)
        tc = apply_update(c, sums, counts)
        shift_sq = ((tc - c) ** 2).sum()
        # f_c is the objective at the current iterate: if the previous
        # extrapolation raised it, restart from the last plain Lloyd output
        # (whose objective is at most f_prev) with β switched back off.
        rejected = extrapolated & (f_c > f_prev)
        c_acc = tc + beta * (tc - c)
        c = torch.where(rejected, c_safe, c_acc)
        extrapolated = ~rejected & (beta > 0)
        beta = torch.where(rejected, 0.0,
                           torch.clamp_max(1.1 * beta + 0.1, beta_max))
        f_prev = torch.where(rejected, f_prev, f_c)
        c_safe = torch.where(rejected, c_safe, tc)
        outcomes.append(torch.where(rejected, OUTCOME_REJECTED,
                                    OUTCOME_ACCEPTED))
        it += 1
        done = bool(((shift_sq <= tol) & ~rejected).item())
    # Land on the safe iterate: `c` may be an extrapolation that was never
    # checked; `c_safe` is always the last plain Lloyd output.
    return _finish(x, c_safe, it, done, outcomes, kw)


def _anderson_loop(x, centroids0, weights, tol, xs0, rs0, reg, *, max_iter,
                   chunk_size, compute_dtype, update, backend,
                   inject_at=None):
    """Anderson-accelerated Lloyd.  Returns ``(KMeansState, outcome
    codes)``; the outcome totals are the codes' counts.

    ``inject_at`` is the safeguard drill: at that iteration the next iterate
    is displaced far from the data, so the objective grows and the reject
    path fires.

    With ``update="delta"`` the sweeps carry (labels, sums, counts) as
    ``fit_lloyd``'s delta loop does, refresh every ``DELTA_REFRESH`` sweeps
    included; the carried invariant never refers to where the centroids
    are, so extrapolated jumps and rewinds compose with it.
    """
    dev = x.device
    kw = dict(weights=weights, chunk_size=chunk_size,
              compute_dtype=compute_dtype, update=update, backend=backend,
              device=dev)
    n, d = x.shape
    k = centroids0.shape[0]
    if update == "delta":
        dkw = dict(weights=weights, cap=default_cap(n),
                   chunk_size=chunk_size, compute_dtype=compute_dtype,
                   # A forced route was resolved at the classic kernel's
                   # plan; "auto" lets delta_pass resolve at its own.
                   backend="auto" if backend == "cuda" else backend,
                   # The safeguard reads the objective every sweep, so the
                   # raw-score shortcut is never safe here.
                   with_mind=True, device=dev)
    tol = torch.tensor(tol, dtype=torch.float32, device=dev)
    c = centroids0.float()
    st = anderson_state(centroids0, xs0, rs0)
    lab = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sums = torch.zeros(k, d, dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    outcomes = []
    it, done = 0, False
    while it < max_iter and not done:
        if update != "delta" or it % DELTA_REFRESH == 0:
            lab, _, sums, counts, f_c = lloyd_pass(x, c, **kw)
        else:
            lab, _, sums, counts, f_c, _ = delta_pass(x, c, lab, sums,
                                                      counts, **dkw)
        tc = apply_update(c, sums, counts)
        shift_sq = ((tc - c) ** 2).sum()
        c, st, outcome = anderson_step(c, tc, f_c, shift_sq, st, tol=tol,
                                       reg=reg)
        if it == inject_at:
            c = c + 1e3 * (1.0 + c.abs())
        outcomes.append(outcome)
        it += 1
        done = bool(((shift_sq <= tol)
                     & (outcome != OUTCOME_REJECTED)).item())
    # Land on the safe iterate; the history rings go with `st`.
    return _finish(x, st.c_safe, it, done, outcomes, kw)


def fit_lloyd_accelerated(
    x,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    config=None,
    init=None,
    weights=None,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    beta_max: float = 1.0,
    accel: Optional[str] = None,
    schedule: Optional[str] = None,
    anderson_m: Optional[int] = None,
    anderson_reg: Optional[float] = None,
    inject_bad_step: Optional[int] = None,
    device=None,
    diag: bool = False,
):
    """Full-batch Lloyd with safeguarded extrapolation, on ``device`` (None
    is the card).

    Same arguments and result as :func:`~kmeans_tpu_torch.models.lloyd.
    fit_lloyd`, plus the reference's: ``accel`` (default ``config.accel``)
    ``"beta"`` (``beta_max`` caps the factor; 0 is plain Lloyd exactly) or
    ``"anderson"`` (``anderson_m`` / ``anderson_reg`` override the config);
    ``schedule="nested"`` runs the doubling subsample ladder first, whose
    iterations ride the returned ``n_iter`` (``max_iter`` bounds each
    phase, so ``n_iter`` can exceed it: test ``converged``);
    ``inject_bad_step`` is the Anderson safeguard drill.  ``diag=True``
    returns ``(state, diag)``: ``diag["outcomes"]``, the full-batch loop's
    ``OUTCOME_*`` code per iteration (a list of ints; the beta loop's are
    accepted or rejected), and its totals under ``"accepted"``,
    ``"rejected"`` and ``"fallback"``.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev).contiguous()
    weights = None if weights is None else as_tensor(weights, dev,
                                                     torch.float32)
    cfg, generator, c0 = resolve_fit_inputs(x, k, generator, config, init,
                                            weights)
    accel = accel if accel is not None else cfg.accel
    schedule = schedule if schedule is not None else cfg.schedule
    if accel not in ("beta", "anderson"):
        raise ValueError(f"unknown accel {accel!r}")
    if schedule not in ("full", "nested"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if cfg.empty == "farthest":
        raise NotImplementedError(
            "empty='farthest' is not supported by the accelerated loop "
            "(reseeding mid-extrapolation breaks the fixed-point safeguard); "
            "use fit_lloyd")
    backend = resolve_backend(cfg.backend, x, k, weights=weights,
                              compute_dtype=cfg.compute_dtype)
    tol_f = float(tol if tol is not None else cfg.tol)
    max_it = max_iter if max_iter is not None else cfg.max_iter

    ladder_iters = 0
    if schedule == "nested":
        if weights is not None:
            raise ValueError(
                "schedule='nested' subsamples nested row prefixes; "
                "weighted rows would need weight-aware rung statistics — "
                "use schedule='full' for weighted fits")
        c0, ladder_iters, _ = nested_ladder(
            x, c0, tol=tol_f, start=cfg.nested_start,
            chunk_size=cfg.chunk_size, compute_dtype=cfg.compute_dtype,
            backend=backend, max_iter=max_it, device=dev)

    loop = dict(max_iter=max_it, chunk_size=cfg.chunk_size,
                compute_dtype=cfg.compute_dtype, backend=backend)
    if accel == "beta":
        if inject_bad_step is not None:
            raise ValueError(
                "inject_bad_step is the Anderson safeguard drill; the "
                "beta loop has no mixing step to corrupt")
        state, codes = _accelerated_loop(x, c0, weights, tol_f,
                                         update=cfg.update,
                                         beta_max=beta_max, **loop)
    else:
        m = anderson_m if anderson_m is not None else cfg.anderson_m
        reg = anderson_reg if anderson_reg is not None else cfg.anderson_reg
        if not 2 <= m <= 64:
            raise ValueError(f"anderson_m must be in [2, 64], got {m}")
        # Resolved as fit_lloyd resolves it (the default rides the delta
        # sweep); the bound-pruned flavours stay fit_lloyd's: dense here.
        upd = resolve_update(cfg.update, w_exact=weights_exact(
            resolve_cd(cfg.compute_dtype, x.dtype), weights=weights))
        if upd == "hamerly":
            upd = "matmul"
        xs0, rs0, _ = anderson_reset(m, k * x.shape[1], device=dev)
        state, codes = _anderson_loop(
            x, c0, weights, tol_f, xs0, rs0,
            torch.tensor(reg, dtype=torch.float32, device=dev),
            update=upd, inject_at=inject_bad_step, **loop)
    codes = codes.tolist()
    totals = {name: codes.count(code) for code, name in OUTCOMES.items()}
    if accel == "anderson":
        record_accel_steps(totals["accepted"], totals["rejected"],
                           totals["fallback"])
    if ladder_iters:
        state = state._replace(n_iter=state.n_iter + ladder_iters)
    return (state, dict(totals, outcomes=codes)) if diag else state
