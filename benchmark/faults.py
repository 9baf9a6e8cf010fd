"""Faults planted in the program under a run, for the check that each
makes ``correct`` come out false: a sweep that returns its state
unchanged; half of the rows left out of the fold, each mean taken over the
rest; an answer altered where it is produced (a final label, a k-means++
centre).  The exchange between chips has no place on one chip.

Each fault takes a ``setattr``-like ``patch(obj, name, value)``
(``pytest``'s ``monkeypatch.setattr``); :func:`planted` plants one for the
life of a block, as ``control.py --fault`` does on the card.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS", "planted"]

#: Rows the half-batch fault folds at a time.
_ROWS = 65536


def _state_unchanged(patch):
    import kmeans_tpu_torch.models.lloyd as lloyd_mod
    patch(lloyd_mod, "apply_update", lambda c, sums, counts: c)


def _half_batch(patch):
    """Every sweep folds only the first half of the rows: each pass's sums
    and counts are those of the labels it gave the first half (the passes
    take no fractional weights in bf16, so the fold is redone here)."""
    import kmeans_tpu_torch.models.lloyd as lloyd_mod
    import kmeans_tpu_torch.ops.yinyang as yy_mod

    def fold_half(x, labels, k):
        half = x.shape[0] // 2
        sums = torch.zeros(k, x.shape[1], dtype=torch.float32,
                           device=x.device)
        for s in range(0, half, _ROWS):
            e = min(half, s + _ROWS)
            sums.index_add_(0, labels[s:e].long(), x[s:e].float())
        counts = torch.bincount(labels[:half].long(), minlength=k).float()
        return sums, counts

    def halve(fn, at):
        """``fn``'s sums and counts sit at ``at`` and ``at + 1``."""
        def wrapped(x, c, *args, **kw):
            out = list(fn(x, c, *args, **kw))
            out[at], out[at + 1] = fold_half(x, out[0], c.shape[0])
            return tuple(out)
        return wrapped
    patch(lloyd_mod, "lloyd_pass", halve(lloyd_mod.lloyd_pass, 2))
    patch(lloyd_mod, "delta_pass", halve(lloyd_mod.delta_pass, 2))
    patch(lloyd_mod, "hamerly_pass", halve(lloyd_mod.hamerly_pass, 1))
    patch(yy_mod, "yinyang_pass", halve(yy_mod.yinyang_pass, 1))


def _label_altered(patch):
    """The classic pass gives row 7 the next centroid's label."""
    import kmeans_tpu_torch.models.lloyd as lloyd_mod
    orig = lloyd_mod.lloyd_pass

    def wrapped(x, c, **kw):
        labels, *rest = orig(x, c, **kw)
        labels = labels.clone()
        labels[7] = (labels[7] + 1) % c.shape[0]
        return (labels, *rest)
    patch(lloyd_mod, "lloyd_pass", wrapped)


def _seed_altered(patch):
    """k-means++ hands back another row in place of its fifth centre."""
    import kmeans_tpu_torch.models.init as init_mod
    orig = init_mod.kmeans_plus_plus

    def wrapped(generator, x, k, **kw):
        c = orig(generator, x, k, **kw).clone()
        c[4] = x[0].float()
        return c
    patch(init_mod, "kmeans_plus_plus", wrapped)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "label_altered": _label_altered, "seed_altered": _seed_altered}


@contextlib.contextmanager
def planted(name: str):
    """Fault ``name`` planted inside the block, the program restored after."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
