"""Export/import JSON — byte-compatible with the reference (SURVEY.md §5.4).

A copy of ``kmeans_tpu/session/schema.py``: JAX-free,
but importing it would run ``kmeans_tpu/__init__.py``, which imports JAX.

The reference's checkpoint format (app.mjs:263-282) is the full domain state:

    { "cards": [...], "centroids": [...], "meta": {...} }

serialized with ``JSON.stringify(data, null, 2)`` to a file named
``kmeans-room-<room>.json``.  Import replaces both arrays wholesale, merges
``meta`` key-by-key, then runs ``dedupeSeeds`` (app.mjs:268-282).

JS JSON quirk preserved: ``JSON.stringify`` writes non-finite numbers as
``null``, so an ``Infinity`` balance ratio in ``prevSnapshot`` becomes
``null`` on export; import maps it back to ``inf`` where the schema expects a
number (the reference would simply carry the null).
"""

from __future__ import annotations

import json
import math
from typing import Any, Optional

from kmeans_tpu_torch.session.document import Document
from kmeans_tpu_torch.session.seeds import dedupe_seeds

__all__ = [
    "export_json", "export_filename", "import_json", "parse_import",
    "to_plain",
]


def parse_import(text_or_obj):
    """Decode an import payload to its parsed object (the one place the
    reference's "Import failed" JSON-decode wrapping lives — the HTTP
    handler reuses it to pre-check the card cap before importing)."""
    if isinstance(text_or_obj, (str, bytes)):
        try:
            return json.loads(text_or_obj)
        except json.JSONDecodeError as e:
            raise ValueError(f"Import failed: {e}") from e
    return text_or_obj


def export_filename(room: str) -> str:
    """app.mjs:266 — ``kmeans-room-<room>.json``."""
    return f"kmeans-room-{room}.json"


def _js_safe(v: Any) -> Any:
    """Mimic JSON.stringify: non-finite numbers → null, recursively."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _js_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_js_safe(x) for x in v]
    return v


def to_plain(doc: Document) -> dict:
    """The export object (app.mjs:264)."""
    return {
        "cards": _js_safe(doc.cards),
        "centroids": _js_safe(doc.centroids),
        "meta": _js_safe(doc.meta),
    }


def export_json(doc: Document, *, indent: int = 2) -> str:
    """Serialize exactly like ``JSON.stringify(data, null, 2)``."""
    return json.dumps(to_plain(doc), indent=indent, ensure_ascii=False)


def _validated_cards(cards) -> list:
    """Element-shape validation for untrusted imports: every card must be an
    object with a string id; the other reference fields are defaulted so a
    partial card can't poison later reads (the reference trusts its input,
    app.mjs:275 — server-side we cannot)."""
    if not isinstance(cards, list):
        return []
    out = []
    for i, c in enumerate(cards):
        if not isinstance(c, dict) or not isinstance(c.get("id"), str):
            raise ValueError(
                f"Import failed: cards[{i}] must be an object with a string id"
            )
        traits = c.get("traits")
        if not isinstance(traits, list):
            traits = ["", ""]
        card = dict(c)
        card["traits"] = [str(t) if t is not None else "" for t in traits[:2]]
        while len(card["traits"]) < 2:
            card["traits"].append("")
        card.setdefault("title", card["id"])
        card.setdefault("assignedTo", None)
        card.setdefault("createdBy", "import")
        out.append(card)
    return out


def _validated_centroids(cents) -> list:
    if not isinstance(cents, list):
        return []
    out = []
    for i, c in enumerate(cents):
        if not isinstance(c, dict) or not isinstance(c.get("id"), str):
            raise ValueError(
                f"Import failed: centroids[{i}] must be an object with a "
                "string id"
            )
        cent = dict(c)
        cent.setdefault("name", cent["id"])
        cent.setdefault("color", "#9aa7d6")
        cent["locked"] = bool(cent.get("locked"))
        out.append(cent)
    return out


def _restore_ratio(meta: dict) -> None:
    snap = meta.get("prevSnapshot")
    if isinstance(snap, dict):
        bal = snap.get("balance")
        if isinstance(bal, dict) and bal.get("ratio") is None:
            bal["ratio"] = math.inf


def import_json(doc: Document, text_or_obj) -> None:
    """Replace arrays, merge meta, dedupe seeds (app.mjs:268-282).

    Accepts a JSON string or an already-parsed object.  Malformed input
    raises ``ValueError`` (the reference alerts "Import failed").
    """
    obj = parse_import(text_or_obj)
    if not isinstance(obj, dict):
        raise ValueError("Import failed: top-level JSON must be an object")

    cards = _validated_cards(obj.get("cards"))
    centroids = _validated_centroids(obj.get("centroids"))

    with doc.txn():
        doc.cards.clear()
        doc.centroids.clear()
        doc.cards.extend(cards)
        doc.centroids.extend(centroids)
        meta = obj.get("meta")
        if isinstance(meta, dict):
            _restore_ratio(meta)
            for k, v in meta.items():
                doc.meta[k] = v
            if "iteration" in meta:
                doc._last_iter = meta["iteration"]
        doc._mutate()
    dedupe_seeds(doc)


def save(doc: Document, path: Optional[str] = None) -> str:
    """Write the export file; returns the path used."""
    path = path or export_filename(doc.room)
    with open(path, "w", encoding="utf-8") as f:
        f.write(export_json(doc))
    return path


def load(doc: Document, path: str) -> None:
    with open(path, "r", encoding="utf-8") as f:
        import_json(doc, f.read())
