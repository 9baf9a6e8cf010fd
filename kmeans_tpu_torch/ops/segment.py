"""One segment sum for the whole package: :func:`segment_sum`.

Counterpart of the reference's ``jax.ops.segment_sum``, which gives the
same bits for the same input on every run.  On the CPU the sum is
``index_add_``, which adds each output row's values in row order.  On the
card ``index_add_`` (like ``scatter_add_`` and a weighted ``bincount``)
adds with float atomics, so its order, and the last bits of every sum, vary
from run to run (``torch.use_deterministic_algorithms`` lists it among the
normally-nondeterministic operations).  On the card the sum is instead
``index_put_(accumulate=True)``, which sorts the indices (a stable radix
sort) and sums each output row's values in one fixed order, with no
atomics; or, for rows of values into at most ``ONE_HOT_MAX_K`` segments,
a one-hot product in IEEE f32 (the sorted sum gives each segment one
thread a column, so a few segments sum long runs in sequence: the plain
route's 2-means fits of the splitting families).  Either way a seed gives
the same bits on every run.  Every float sum by label in the port goes
through this function, and a test of the sources holds it to that
(``tests/test_torch_fit.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from kmeans_tpu_torch.ops.distance import full_f32

__all__ = ["segment_sum", "ONE_HOT_MAX_K"]

#: Most segments the card sums rows of values into by a one-hot product
#: (``chip_smoke.py --fold-bench``: the one-hot product against
#: ``index_put_`` by k).
ONE_HOT_MAX_K = 128
#: Rows of one one-hot block.
_ONE_HOT_ROWS = 32768


def segment_sum(values: torch.Tensor, index: torch.Tensor, k: int, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[j] += Σ values[i]`` over the rows i with ``index[i] == j``, for
    ``0 <= j < k``; a row whose index lies outside ``[0, k)`` adds nothing.

    ``values`` is (n,) or (n, ...); ``out`` (default: zeros of shape (k,
    ...) in ``values``' dtype) is added into in place and returned.  On the
    card no call syncs with the host."""
    index = index.long()
    if out is None:
        out = values.new_zeros((k,) + tuple(values.shape[1:]))
    keep = (index >= 0) & (index < k)
    if values.device.type == "cpu":
        if not bool(keep.all()):
            values, index = values[keep], index[keep]
        return out.index_add_(0, index, values)
    n = index.numel()
    if k == 0 or n == 0:
        return out
    # A row outside [0, k) adds an exact 0.0 (no host sync to drop it).
    values = torch.where(keep.view((-1,) + (1,) * (values.dim() - 1)),
                         values, 0.0)
    if values.dim() > 1 and k <= ONE_HOT_MAX_K:
        rows = values.reshape(n, -1)
        cols = torch.arange(k, device=index.device)
        acc = out.view(k, -1)
        with full_f32():
            for lo in range(0, n, _ONE_HOT_ROWS):
                hot = index[lo:lo + _ONE_HOT_ROWS, None] == cols
                acc += hot.to(rows.dtype).T @ rows[lo:lo + _ONE_HOT_ROWS]
        return out
    # Spread the dropped rows over the segments, so that no one row sums a
    # long run of zeros in sequence.
    spread = torch.arange(n, device=index.device) % k
    return out.index_put_((torch.where(keep, index, spread),), values,
                          accumulate=True)
