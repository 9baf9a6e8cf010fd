"""Seeds, fixtures and resets (app.mjs:187-237; SURVEY.md §4).

A copy of ``kmeans_tpu/session/seeds.py``: JAX-free,
but importing it would run ``kmeans_tpu/__init__.py``, which imports JAX.

The reference's manual-test affordances, promoted to first-class fixtures:

* ``JESSICA`` — the singleton seed card (app.mjs:188).
* ``ensure_jessica_once`` — double-guarded seeding (meta flag AND presence
  check, app.mjs:190-196).
* ``dedupe_seeds`` — drop duplicate ``seed:*`` cards keeping the first
  occurrence (app.mjs:197-201): the reference's repair for its concurrent-
  seeding race.
* ``populate_test_data`` — the deterministic 11-card fixture ``seed:t1`` …
  ``seed:t11`` (app.mjs:202-224); t10 (Espresso/Hot) and t11 (Vegan/Not
  Sweet) are the designated outliers; idempotent by id-set check.
* ``hard_reset`` — clear everything, iteration=0, re-seed Jessica
  (app.mjs:225-237).
"""

from __future__ import annotations

from typing import Optional

from kmeans_tpu_torch.session.document import Document

__all__ = [
    "JESSICA",
    "TEST_ITEMS",
    "ensure_jessica_once",
    "dedupe_seeds",
    "populate_test_data",
    "hard_reset",
]

#: app.mjs:188
JESSICA = {"id": "seed:jessica", "title": "Jessica", "traits": ["Fresh", "Sorbet"]}

#: app.mjs:204-215 — (id, title, traitA, traitB); last two are outliers.
TEST_ITEMS = [
    ("seed:t1", "Nguyen", "Sweet", "Creamy"),
    ("seed:t2", "Patel", "Fresh", "Sorbet"),
    ("seed:t3", "Garcia", "Chocolatey", "Crunchy"),
    ("seed:t4", "Rossi", "Milky", "Silky"),
    ("seed:t5", "Kim", "Nutty", "Creamy"),
    ("seed:t6", "Smith", "Fruity", "Swirled"),
    ("seed:t7", "Ahmed", "Bitter", "Rich"),
    ("seed:t8", "Lopez", "Sweet", "Colorful"),
    ("seed:t9", "Chen", "Rich", "Spicy"),
    ("seed:t10", "Nils", "Espresso", "Hot"),      # outlier
    ("seed:t11", "sally", "Vegan", "Not Sweet"),  # outlier
]


def ensure_jessica_once(doc: Document) -> bool:
    """Seed Jessica iff the meta flag is unset AND the card is absent
    (app.mjs:190-196).  Returns True when seeding happened."""
    seeded = doc.meta.get("seededJessica")
    has = any(c["id"] == JESSICA["id"] for c in doc.cards)
    if seeded or has:
        return False
    with doc.txn():
        doc.add_card(
            JESSICA["title"],
            (JESSICA["traits"][0], JESSICA["traits"][1]),
            card_id=JESSICA["id"],
            created_by="seed",
        )
        doc.meta["seededJessica"] = True
    return True


def dedupe_seeds(doc: Document) -> int:
    """Drop duplicate ``seed:*`` cards, keeping first occurrences
    (app.mjs:197-201).  Returns the number removed."""
    seen = set()
    keep = []
    removed = 0
    for c in doc.cards:
        cid = c.get("id")
        if isinstance(cid, str) and cid.startswith("seed:"):
            if cid in seen:
                removed += 1
                continue
            seen.add(cid)
        keep.append(c)
    if removed:
        with doc.txn():
            doc.cards[:] = keep
            doc._mutate()
    return removed


def populate_test_data(doc: Document) -> int:
    """Idempotently add the 11-card fixture, then dedupe (app.mjs:202-224).
    Returns the number of cards added."""
    added = 0
    with doc.txn():
        existing = {c["id"] for c in doc.cards}
        for cid, title, a, b in TEST_ITEMS:
            if cid not in existing:
                doc.add_card(title, (a, b), card_id=cid, created_by="seed")
                added += 1
    dedupe_seeds(doc)
    return added


def hard_reset(doc: Document, mode: Optional[str] = None) -> None:
    """app.mjs:225-237: clear pos:*, cards, centroids; iteration=0; set
    mode; re-seed Jessica; drop prevSnapshot."""
    with doc.txn():
        for k in [k for k in doc.meta if str(k).startswith("pos:")]:
            del doc.meta[k]
        doc.cards.clear()
        doc.centroids.clear()
        doc.meta["iteration"] = 0
        doc._last_iter = 0
        doc.meta["mode"] = mode or doc.meta.get("mode") or "learn"
        doc.meta["seededJessica"] = False
        doc.add_card(
            JESSICA["title"],
            (JESSICA["traits"][0], JESSICA["traits"][1]),
            card_id=JESSICA["id"],
            created_by="seed",
        )
        doc.meta["seededJessica"] = True
        doc.meta.pop("prevSnapshot", None)
        doc._mutate()
