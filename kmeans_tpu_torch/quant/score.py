"""Error-bounded pruning over a quantized codebook.

Counterpart of ``kmeans_tpu/quant/score.py``.  Both scorers turn
:attr:`~kmeans_tpu_torch.quant.codebook.QuantizedCodebook.err` into a
provably complete candidate set through the triangle inequality: with
``dhat_j = ||x - c_hat_j||`` and ``err_j >= ||c_j - c_hat_j||``,

    dhat_j - err_j  <=  ||x - c_j||  <=  dhat_j + err_j

so every centroid whose lower bound exceeds ``b = min_j upper_j`` is not
the argmin, and the argmin itself always survives.  f32 evaluation slop is
absorbed by slackening both bounds by ``margin_rel * (dhat + 1)``.

:func:`quant_candidates` and :func:`quant_prune` are the host tier, copied
(pure NumPy, bit for bit).  :func:`quant_assign_device` is the device tier,
a k-tiled PyTorch scan on the tensors' device with the reference's
strict-``<`` merges and carry.
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.ops.distance import full_f32

__all__ = ["QUANT_MARGIN_REL", "quant_candidates", "quant_prune",
           "quant_assign_device"]

#: Relative soundness slack folded into both quantized distance bounds, as
#: the certificate margins of ``serve.assign`` and ``ops.hamerly``: it
#: covers f32 evaluation error, which the exact-arithmetic ``err`` does
#: not.
QUANT_MARGIN_REL = 1e-3

# Elementwise budget of the exact rescore's centroid gather (rows x
# survivors x d): one rescore chunk holds at most ~16 MiB of f32 scratch.
_RESCORE_ELEMS = 1 << 22

_IDX_INF = np.iinfo(np.int64).max


def quant_candidates(dhat, err, *, margin_rel=QUANT_MARGIN_REL):
    """Candidate mask from quantized distances + error bounds.

    ``dhat``: ``(B, m)`` f32 quantized distances; ``err``: ``(B, m)``
    (or broadcastable) f32 per-centroid bounds.  Returns ``(keep, iup,
    b)``: the ``(B, m)`` bool survivor mask, the per-row argmin of the
    upper bound (first-min, i.e. lowest column on exact ties — the
    provable label when only one candidate survives), and the ``(B,)``
    min upper bound itself.
    """
    slack = margin_rel * (dhat + np.float32(1.0))
    upper = dhat + err + slack
    lower = dhat - err - slack
    iup = upper.argmin(axis=1)
    b = np.take_along_axis(upper, iup[:, None], axis=1)[:, 0]
    keep = lower <= b[:, None]
    return keep, iup, b


def quant_prune(x, xsq, s, err_cand, cand_rows, centroids, csq, *,
                margin_rel=QUANT_MARGIN_REL,
                rescore_elems=_RESCORE_ELEMS):
    """Prune one routed batch against quantized scores, then rescore the
    ambiguous survivors exactly in f32.

    Inputs (all f32 unless noted): ``x`` ``(B, d)`` rows, ``xsq``
    ``(B,)`` their squared norms, ``s`` ``(B, m)`` quantized score
    offsets such that ``dhat^2 = xsq + s`` (i.e. ``csq_hat - 2 x.c_hat``,
    as produced by the grouped GEMM), ``err_cand`` ``(B, m)`` the
    per-candidate error bounds, ``cand_rows`` ``(B, m)`` int global
    centroid ids aligned with ``s``'s columns, and the exact f32
    ``centroids``/``csq`` for the rescore.

    Returns ``(labels, se_best, n_cand, n_rescore)``: int64 global
    labels; the exact f32 score offset of each chosen centroid
    (``csq[label] - 2 x.c_label``, so callers recover the certified
    distance as ``sqrt(max(xsq + se_best, 0))``); the ``(B,)`` survivor
    counts; and how many rows needed the exact rescore.
    """
    n_rows = s.shape[0]
    dhat = np.sqrt(np.maximum(xsq[:, None] + s, np.float32(0.0)))
    keep, iup, _b = quant_candidates(dhat, err_cand, margin_rel=margin_rel)
    n_cand = keep.sum(axis=1)
    labels = cand_rows[np.arange(n_rows), iup].astype(np.int64)
    amb = np.flatnonzero(n_cand > 1)
    if amb.size:
        # Padded gather over survivors only: survivors are compacted to
        # the left (stable argsort of ~keep preserves candidate order,
        # keeping the lowest-index tie-break exact), chunked so the
        # (rows, R, d) centroid gather stays within the scratch budget.
        keep_a = keep[amb]
        r_max = int(keep_a.sum(axis=1).max())
        pos = np.argsort(~keep_a, axis=1, kind="stable")[:, :r_max]
        taken = np.take_along_axis(keep_a, pos, axis=1)
        cidx = np.take_along_axis(cand_rows[amb], pos, axis=1)
        d = centroids.shape[1]
        step = max(1, int(rescore_elems) // max(1, r_max * d))
        for i0 in range(0, amb.size, step):
            i1 = min(amb.size, i0 + step)
            rows = amb[i0:i1]
            ci = cidx[i0:i1]
            cg = centroids[ci]
            se = csq[ci] - 2.0 * np.einsum(
                "ad,ard->ar", x[rows], cg).astype(np.float32)
            se[~taken[i0:i1]] = np.inf
            # Exact lowest-centroid-id tie-break, independent of the
            # survivor packing order.  ci must be widened BEFORE the
            # where: under NEP 50 an int32 ci would pull the int64-max
            # sentinel down to int32 (wrapping to -1, which then wins
            # every min).
            tied = se == se.min(axis=1, keepdims=True)
            labels[rows] = np.where(tied, ci.astype(np.int64),
                                    _IDX_INF).min(axis=1)
    cbest = centroids[labels]
    se_best = (csq[labels]
               - 2.0 * np.einsum("bd,bd->b", x, cbest).astype(np.float32))
    return labels, se_best.astype(np.float32), n_cand, int(amb.size)


def dequantize_tile(q: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 values of a packed payload tile without its scales: the int8
    cast, or for bf16 the ``uint16 << 16`` bitcast."""
    if mode == "bf16":
        return (q.to(torch.int32) << 16).view(torch.float32)
    return q.to(torch.float32)


def quant_assign_device(x, q, scale, err, csq_hat, mode, *, k_tile=None,
                        margin_rel=QUANT_MARGIN_REL):
    """Quantized assign on the tensors' device: a scan over ``k_tile``-wide
    slices of the packed codebook (all of k at once when None) that labels
    each row with its argmin *upper* bound and certifies rows where no
    other centroid's lower bound can beat it.

    ``x`` (B, d) f32; ``q`` (k, d) int8, or the bf16 payload's uint16 bit
    patterns; ``scale``, ``err``, ``csq_hat`` (k,) f32.  Returns ``(labels
    int32 (B,), ok bool (B,))``; ``ok`` False rows are ambiguous under the
    error bound and must be rescored exactly by the caller.  Slices merge
    with strict ``<`` in increasing order, so the label is the lowest id
    among exact ties and the result does not depend on ``k_tile``.  The
    carry ``(b_up, lab, l1, i1, l2)`` holds the least upper bound and its
    label and the two least lower bounds with the first one's index; a
    row is certified when the least lower bound over the other centroids
    exceeds ``b_up``.  The f32 expressions keep the reference's order.
    """
    k = int(q.shape[0])
    kt = max(1, min(int(k_tile) if k_tile else k, k))
    xf = x.to(torch.float32)
    rows = xf.shape[0]
    dev = xf.device
    xsq = (xf * xf).sum(dim=1)
    inf = torch.tensor(torch.inf, device=dev)
    b_up = torch.full((rows,), torch.inf, device=dev)
    lab = torch.zeros(rows, dtype=torch.int64, device=dev)
    l1 = torch.full((rows,), torch.inf, device=dev)
    i1 = torch.full((rows,), -1, dtype=torch.int64, device=dev)
    l2 = torch.full((rows,), torch.inf, device=dev)
    for off in range(0, k, kt):
        hi = min(k, off + kt)
        et = err[off:hi]
        with full_f32():
            prod = xf @ dequantize_tile(q[off:hi], mode).T
        # sq = csq_hat - 2·prod·scale, then dhat = sqrt(max(xsq + sq, 0)).
        dhat = csq_hat[off:hi] - prod.mul_(2.0).mul_(scale[off:hi])
        del prod
        dhat = dhat.add_(xsq[:, None]).clamp_min_(0.0).sqrt_()
        slack = (dhat + 1.0).mul_(margin_rel)
        up = (dhat + et).add_(slack)
        lo = dhat.sub_(et).sub_(slack)
        del slack
        t_ui = up.argmin(dim=1, keepdim=True)
        t_up = up.gather(1, t_ui)[:, 0]
        del up
        t_i1 = lo.argmin(dim=1, keepdim=True)
        t_l1 = lo.gather(1, t_i1)[:, 0]
        t_l2 = lo.scatter_(1, t_i1, torch.inf).amin(dim=1)
        del lo
        t_ui, t_i1 = t_ui[:, 0] + off, t_i1[:, 0] + off
        take = t_up < b_up
        b_up = torch.where(take, t_up, b_up)
        lab = torch.where(take, t_ui, lab)
        # The second least of {l1, l2, t_l1, t_l2}: each pair is ordered.
        i1 = torch.where(t_l1 < l1, t_i1, i1)
        l2 = torch.minimum(torch.maximum(l1, t_l1), torch.minimum(l2, t_l2))
        l1 = torch.minimum(l1, t_l1)
    l_excl = torch.where(i1 == lab, l2, l1)
    return lab.to(torch.int32), l_excl > b_up
