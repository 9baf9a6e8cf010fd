"""Bridge between the numeric engine and the session document.

Counterpart of ``kmeans_tpu/session/bridge.py``; ``dataset_to_document``
and ``cards_to_features`` are copies (JAX-free, but importing them would
run ``kmeans_tpu/__init__.py``, which imports JAX).

* ``dataset_to_document`` — turn a fitted clustering over 2-D data into a
  session document whose cards sit at their data coordinates (normalized
  into the reference's drop-clamp box, app.mjs:366-367) and are assigned to
  colored, named centroid zones; ``train --out`` exports it.
* ``cards_to_features`` — featurize cards for the numeric engine: binary
  bag-of-trait-tokens vectors using the reference's own tokenizer.
* ``auto_assign`` — one fit over the document's cards on the device
  (``fit_lloyd``, or ``fit_trimmed`` with an outlier budget), writing the
  assignments back through the normal mutators in one transaction (locked
  zones are respected: their cards are kept, everyone else is
  re-assigned).  k-means++ draws from a :class:`torch.Generator` seeded
  with ``seed``, where the reference draws from ``jax.random.key(seed)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from kmeans_tpu_torch.config import MAX_CENTROIDS, POS_CLAMP_X, POS_CLAMP_Y
from kmeans_tpu_torch.session.document import Document
from kmeans_tpu_torch.session.metrics import tokens_for_card

__all__ = [
    "dataset_to_document",
    "cards_to_features",
    "auto_assign",
]


def _normalize_positions(x2: np.ndarray) -> np.ndarray:
    """Map 2-D points into the reference's position box
    ([0.02, 0.92] × [0.10, 0.92], app.mjs:366-367)."""
    lo = x2.min(axis=0)
    hi = x2.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    unit = (x2 - lo) / span
    out = np.empty_like(unit)
    out[:, 0] = POS_CLAMP_X[0] + unit[:, 0] * (POS_CLAMP_X[1] - POS_CLAMP_X[0])
    out[:, 1] = POS_CLAMP_Y[0] + unit[:, 1] * (POS_CLAMP_Y[1] - POS_CLAMP_Y[0])
    return out


def dataset_to_document(
    x,
    labels,
    *,
    room: str = "TPU0",
    names: Optional[Sequence[str]] = None,
    max_cards: int = 500,
    enforce_limit: bool = True,
) -> Document:
    """Build a session document from a fitted clustering over 2-D data.

    Only the first two feature dimensions are used for board positions.
    ``max_cards`` caps the rendered cards (the browser board is built for
    dozens, not millions).  With ``enforce_limit`` (default), the number of
    distinct clusters must respect the reference's 3-centroid cap
    (app.mjs:127); pass False to emit framework-native documents with more.
    """
    x = np.asarray(x)
    labels = np.asarray(labels)
    n = min(len(x), max_cards)
    # Negative labels mean "not a member of any cluster" (the trimmed
    # family's outliers) and map to the reference's unassigned state —
    # exactly how the teaching app expects its designated outliers to end
    # up (app.mjs:214-215: left off every centroid zone).
    used = sorted(l for l in set(labels[:n].tolist()) if l >= 0)
    if enforce_limit and len(used) > MAX_CENTROIDS:
        raise ValueError(
            f"{len(used)} clusters exceed the reference's cap of "
            f"{MAX_CENTROIDS}; pass enforce_limit=False for a "
            "framework-native document"
        )

    doc = Document(room=room)
    cent_ids = {}
    with doc.txn():
        for j, lab in enumerate(used):
            cent = {
                "id": f"c:tpu-{lab}",
                "name": (names[j] if names and j < len(names)
                         else f"Cluster {lab}"),
                "color": doc.next_color(),
                "locked": False,
            }
            doc.centroids.append(cent)
            cent_ids[lab] = cent["id"]
        pos = _normalize_positions(x[:n, :2].astype(np.float64))
        for i in range(n):
            cid = f"card:tpu-{i}"
            lab = int(labels[i])
            doc.cards.append({
                "id": cid,
                "title": f"p{i}",
                "traits": ["", ""],
                "assignedTo": cent_ids[lab] if lab >= 0 else None,
                "createdBy": "tpu",
            })
            if lab >= 0:
                # Unassigned cards carry no board position, matching the
                # reference's unassign path (app.mjs:151-155: pos cleared).
                doc.meta[f"pos:{cid}"] = {
                    "x": float(pos[i, 0]), "y": float(pos[i, 1])
                }
        doc.meta.setdefault("mode", "custom")
        doc.meta.setdefault("iteration", 0)
        doc._mutate()
    return doc


def cards_to_features(
    cards: Sequence[dict],
) -> Tuple[np.ndarray, List[str]]:
    """Binary bag-of-tokens matrix (n_cards × vocab) + the sorted vocab.

    Uses the reference's tokenizer so "Sweet / Creamy" and "sweet,creamy"
    featurize identically (app.mjs:436-449).
    """
    tokens = [tokens_for_card(c) for c in cards]
    vocab = sorted(set().union(*tokens)) if tokens else []
    index = {t: i for i, t in enumerate(vocab)}
    x = np.zeros((len(cards), max(len(vocab), 1)), np.float32)
    for i, ts in enumerate(tokens):
        for t in ts:
            x[i, index[t]] = 1.0
    return x, vocab


def auto_assign(
    doc: Document,
    *,
    seed: int = 0,
    features: str = "traits",
    outliers: int = 0,
    device=None,
) -> dict:
    """Run the assign step for the humans on ``device`` (None is the
    card): fit k = the number of unlocked centroids on the document's
    cards and write the assignments back.  Returns the new metrics
    snapshot.

    ``features``: "traits" (bag-of-tokens) or "pos" (board coordinates;
    cards without a position fall back to zero vectors).  Locked zones
    follow app.mjs:360 in both directions: their cards keep their
    assignment AND no card is moved into them.

    ``outliers`` > 0 runs the trimmed family (k-means--) instead of plain
    Lloyd and leaves the ``outliers`` least-fitting cards UNASSIGNED (the
    fixture's designated outliers ``seed:t10`` / ``t11``, app.mjs:214-215,
    are the ones the teaching game expects humans to leave off every
    zone).  Locked-zone cards carry weight 0, so they never eat that
    budget.
    """
    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.data.synthetic import generator_for
    from kmeans_tpu_torch.device import resolve_device
    from kmeans_tpu_torch.models import fit_lloyd, fit_trimmed

    unlocked = [c for c in doc.centroids if not c.get("locked")]
    k = len(unlocked)
    if k == 0 or not doc.cards:
        return doc.snapshot()

    if features == "pos":
        x = np.zeros((len(doc.cards), 2), np.float32)
        for i, c in enumerate(doc.cards):
            p = doc.get_card_pos(c["id"])
            if p:
                x[i] = (p["x"], p["y"])
    else:
        x, _ = cards_to_features(doc.cards)

    dev = resolve_device(device)
    gen = generator_for(seed, dev)
    locked_ids = {c["id"] for c in doc.centroids if c.get("locked")}
    cfg = KMeansConfig(k=k, max_iter=50, chunk_size=max(64, len(doc.cards)))
    if outliers > 0:
        w = np.array(
            [0.0 if c.get("assignedTo") in locked_ids else 1.0
             for c in doc.cards], np.float32,
        )
        m = min(int(outliers), max(int(w.sum()) - 1, 0))
        state = fit_trimmed(x, k, n_trim=m, generator=gen, config=cfg,
                            weights=w, device=dev)
    else:
        state = fit_lloyd(x, k, generator=gen, config=cfg, device=dev)
    labels = state.labels.cpu().numpy()

    order = [c["id"] for c in unlocked]
    with doc.txn():
        for i, card in enumerate(doc.cards):
            if card.get("assignedTo") in locked_ids:
                continue
            lab = int(labels[i])
            doc.update_card_assign(
                card["id"], None if lab < 0 else order[lab % k]
            )
    return doc.snapshot()
