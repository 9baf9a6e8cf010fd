"""Depth-m Anderson mixing for fixed-point centroid iterations.

Counterpart of ``kmeans_tpu/ops/anderson.py``.  Lloyd's update is a
fixed-point map ``c ← T(c)``.  Anderson acceleration keeps the last m
iterates x_i and residuals r_i = T(x_i) − x_i and proposes

    c_next = Σ_i α_i · T(x_i),    α = argmin ‖Σ_i α_i r_i‖²  s.t. Σα = 1

— the constrained (Type-II) form, solved through the normal equations on
the m×m Gram matrix G = R Rᵀ: solve G α ∝ 1, then normalize.  Its solution
does not depend on the row order of the history, so the ring needs no
rotation before the solve.

Everything here stays on the tensors' device and reads nothing back to the
host: the history is a pair of ``(m, k·d)`` f32 buffers plus a 0-d int32
slot counter, a push is a ring write at ``count % m``, the m×m solve is
``torch.linalg.solve_ex`` (whose ``info`` folds into ``ok`` instead of a
host-side check), and every decision is a ``torch.where``.  The Gram and
the mix are IEEE f32 products (:func:`~kmeans_tpu_torch.ops.distance.
full_f32`: never TF32).

Safeguarding is the caller's half of the contract: the mixed iterate is an
extrapolation with no descent guarantee, so the loop that takes it compares
the objective at the next sweep and restarts from the last plain Lloyd
iterate when it grew (:func:`anderson_step`, called by
:mod:`kmeans_tpu_torch.models.accelerated`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.ops.distance import full_f32

__all__ = ["anderson_reset", "anderson_push", "anderson_mix",
           "anderson_step", "anderson_state", "AndersonState",
           "ANDERSON_GAMMA_CAP", "MIX_FLOOR", "MIX_STALL", "REJECT_SLACK",
           "OUTCOME_ACCEPTED", "OUTCOME_REJECTED", "OUTCOME_FALLBACK"]

#: Σ|α| above this means the Gram solve exploded (near-singular history,
#: e.g. a stalled iterate pushed twice): the caller takes the plain step.
ANDERSON_GAMMA_CAP = 1e4

#: Settle threshold: mixing turns off for good once the squared residual
#: falls within this factor of the tolerance, and plain Lloyd polishes to
#: the exact fixed point.  The reference's value.
MIX_FLOOR = 300.0

#: Stall guard: if the residual sets no new minimum for this many
#: consecutive iterations, mixing turns off for good.  Bounds the worst
#: case at about plain Lloyd's iterations + MIX_STALL.
MIX_STALL = 8

#: Relative slack of the rejection test, ``f > f_prev·(1 + REJECT_SLACK)``:
#: the objective is an f32 sum of n terms whose sweep-to-sweep noise (the
#: accumulation order) can exceed the true improvement on a plateau, and a
#: rejection on noise
#: sustains itself.  A diverging extrapolation overshoots by far more.
REJECT_SLACK = 1e-5

#: Outcome codes of :func:`anderson_step`: the extrapolated iterate was
#: used / the objective safeguard fired / the plain Lloyd step ran
#: (warm-up history, ill-conditioned Gram, residual growth or the settle
#: switch).
OUTCOME_ACCEPTED = 0
OUTCOME_REJECTED = 1
OUTCOME_FALLBACK = 2


def anderson_reset(m: int, kd: int, *, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Empty history on ``device`` (None is the card): ``(xs (m, kd),
    rs (m, kd), count)``, all zero (f32 rings, an int32 count)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return (torch.zeros(m, kd, dtype=f32, device=dev),
            torch.zeros(m, kd, dtype=f32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def anderson_push(xs: torch.Tensor, rs: torch.Tensor, count: torch.Tensor,
                  x_flat: torch.Tensor, r_flat: torch.Tensor):
    """Ring-write one ``(iterate, residual)`` pair at slot ``count % m``;
    returns new ``(xs, rs, count + 1)`` (the inputs are not written).  The
    live rows are ``min(count, m)``; :func:`anderson_mix` does not depend on
    their order, so the wrap needs no rotation."""
    m = xs.shape[0]
    slot = torch.remainder(count, m).long().view(1)
    xs = xs.index_copy(0, slot, x_flat.reshape(1, -1).to(xs.dtype))
    rs = rs.index_copy(0, slot, r_flat.reshape(1, -1).to(rs.dtype))
    return xs, rs, count + 1


def anderson_mix(xs: torch.Tensor, rs: torch.Tensor, count: torch.Tensor, *,
                 reg, gamma_cap: float = ANDERSON_GAMMA_CAP):
    """Solve the regularized constrained least squares and mix.

    Returns ``(mixed (kd,), ok)``: the proposal ``Σ α_i (x_i + r_i)`` and a
    0-d bool that is False whenever the proposal must not be used — fewer
    than two history pairs, a solve that failed (``solve_ex``'s ``info``) or
    is not finite, or coefficient mass over ``gamma_cap``.  ``reg`` is the
    Tikhonov ridge relative to the Gram's mean diagonal
    (``λ = reg·tr(G)/m_live``)."""
    m = xs.shape[0]
    f32 = torch.float32
    dev = xs.device
    n_live = torch.clamp_max(count, m)
    valid = torch.arange(m, device=dev) < n_live
    validf = valid.to(f32)
    # Rows past the live count may hold stale pairs from before a reset.
    rs_v = rs * validf[:, None]
    with full_f32():
        gram = rs_v @ rs_v.T                                  # (m, m) f32
    eye = torch.eye(m, dtype=f32, device=dev)
    # Dead rows get a unit diagonal so the system stays well-posed; their
    # α is forced to 0 after the solve either way.
    gram = torch.where(valid[:, None] & valid[None, :], gram, eye)
    lam = (torch.as_tensor(reg, dtype=f32, device=dev) * torch.trace(gram)
           / torch.clamp_min(n_live, 1).to(f32))
    alpha, info = torch.linalg.solve_ex(gram + lam * eye, validf)
    alpha = torch.where(valid, alpha, 0.0)
    s = alpha.sum()
    big = s.abs() > 1e-12
    alpha = alpha / torch.where(big, s, 1.0)
    ok = ((n_live >= 2) & (info == 0) & torch.isfinite(s) & big
          & torch.isfinite(alpha).all()
          & (alpha.abs().sum() <= gamma_cap))
    with full_f32():
        mixed = (alpha[None, :] @ (xs + rs))[0]               # Σ α_i T(x_i)
    return mixed, ok


class AndersonState(NamedTuple):
    """Carried safeguard and history state of one Anderson-accelerated
    fit, all tensors on the fit's device."""

    c_safe: torch.Tensor   # last plain-Lloyd output (the rewind target)
    f_prev: torch.Tensor   # objective at the last accepted iterate
    r_prev: torch.Tensor   # previous squared residual ‖T(c)−c‖²
    mix_on: torch.Tensor   # settle switch (False = plain forever)
    r_best: torch.Tensor   # best residual so far (stall detector)
    stall: torch.Tensor    # iterations since a new best residual
    xs: torch.Tensor       # (m, k·d) iterate ring
    rs: torch.Tensor       # (m, k·d) residual ring
    count: torch.Tensor    # ring slot counter
    n_acc: torch.Tensor    # outcome totals (int32)
    n_rej: torch.Tensor
    n_fb: torch.Tensor


def anderson_state(c0: torch.Tensor, xs0: torch.Tensor,
                   rs0: torch.Tensor) -> AndersonState:
    """Fresh safeguard state around the history buffers of
    :func:`anderson_reset`, on ``c0``'s device."""
    dev = c0.device
    f32, i32 = torch.float32, torch.int32

    def inf():
        return torch.full((), float("inf"), dtype=f32, device=dev)

    def zero():
        return torch.zeros((), dtype=i32, device=dev)

    return AndersonState(
        c_safe=c0.float(), f_prev=inf(), r_prev=inf(),
        mix_on=torch.ones((), dtype=torch.bool, device=dev),
        r_best=inf(), stall=zero(), xs=xs0, rs=rs0, count=zero(),
        n_acc=zero(), n_rej=zero(), n_fb=zero())


def anderson_step(c, tc, f_c, shift_sq, state: AndersonState, *, tol, reg):
    """One safeguarded accept / reject / fallback decision — the one copy
    of that arithmetic, as in the reference: the fused Anderson loop and
    the step-paced runner (:mod:`kmeans_tpu_torch.models.runner`) call it,
    and the sharded loop will.

    Inputs: the pre-sweep iterate ``c``, its plain Lloyd update
    ``tc = T(c)``, the objective ``f_c`` measured at ``c`` and
    ``shift_sq = ‖tc − c‖²`` (0-d f32 tensors); ``tol`` and ``reg`` are
    0-d tensors or floats, taken as f32 (a float is copied to the device,
    and on the card that copy waits for it: the loops pass tensors made
    once).  Returns ``(c_next, state', outcome)``, ``outcome`` a 0-d int32
    tensor holding one of the ``OUTCOME_*`` codes (also added to the
    state's totals).  Nothing is read back to the host.  The settle / stall bookkeeping and ``r_prev`` run on
    every step, rejected or not, as in the reference.
    """
    st = state
    dev = c.device
    f32 = torch.float32
    tol = torch.as_tensor(tol, dtype=f32, device=dev)
    rejected = f_c > st.f_prev * (1.0 + REJECT_SLACK)
    grew = shift_sq > st.r_prev
    improved = shift_sq < st.r_best
    r_best = torch.minimum(st.r_best, shift_sq)
    stall = torch.where(improved, 0, st.stall + 1).to(torch.int32)
    mix_on = st.mix_on & (shift_sq > MIX_FLOOR * tol) & (stall < MIX_STALL)
    xs_p, rs_p, cnt_p = anderson_push(st.xs, st.rs, st.count,
                                      c.reshape(-1), (tc - c).reshape(-1))
    mixed, ok = anderson_mix(xs_p, rs_p, cnt_p, reg=reg)
    use_mix = ok & ~grew & mix_on
    c_acc = torch.where(use_mix, mixed.reshape(tc.shape), tc)
    c_next = torch.where(rejected, st.c_safe, c_acc)
    # A rejection clears the history: directions measured through a
    # diverged extrapolation would poison the restarted trajectory.
    xs_n = torch.where(rejected, 0.0, xs_p)
    rs_n = torch.where(rejected, 0.0, rs_p)
    cnt_n = torch.where(rejected, 0, cnt_p).to(torch.int32)
    acc = ~rejected & use_mix
    fb = ~rejected & ~use_mix
    outcome = torch.where(
        rejected, OUTCOME_REJECTED,
        torch.where(acc, OUTCOME_ACCEPTED, OUTCOME_FALLBACK),
    ).to(torch.int32)
    new_state = AndersonState(
        c_safe=torch.where(rejected, st.c_safe, tc),
        f_prev=torch.where(rejected, st.f_prev, f_c),
        r_prev=shift_sq,
        mix_on=mix_on,
        r_best=r_best,
        stall=stall,
        xs=xs_n, rs=rs_n, count=cnt_n,
        n_acc=st.n_acc + acc, n_rej=st.n_rej + rejected,
        n_fb=st.n_fb + fb,
    )
    return c_next, new_state, outcome
