"""Selection by value in ``lax.top_k``'s order, on every device.

``torch.topk`` fixes no order among equal values, and its order differs
between the CPU and the card; ``lax.top_k`` puts the lower index first.
Every selection by value in the port (the farthest reseed, the trimmed
selection, k-means||'s candidates, the sharded engine's nominations) goes
through :func:`top_stable`, so it picks the reference's rows on a tie.
"""

from __future__ import annotations

import torch

__all__ = ["order_keys", "top_stable"]


def order_keys(v: torch.Tensor) -> torch.Tensor:
    """``v``'s f32 bits as int32 keys in the floats' total order
    (``lax.top_k``'s: -0.0 below +0.0), the order every selection sorts by
    on one device and across a mesh."""
    bits = v.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_stable(v: torch.Tensor, m: int):
    """``(vals, idx)``: the ``m`` largest entries of the 1-D ``v`` (all of
    them where ``m`` exceeds its length) and their indices, as
    ``lax.top_k`` gives them: descending in the floats' total order, the
    lower index first on a tie.

    A stable descending sort of the order keys, with no host sync.  On an
    H100 it costs about what ``torch.topk`` does (a radix sort of n int32
    keys), where ``torch.topk`` over unique int64 keys (order key, then
    index) took two to four times as long (``chip_smoke.py
    --select-bench``)."""
    idx = torch.sort(order_keys(v), descending=True, stable=True).indices[:m]
    return v[idx], idx
