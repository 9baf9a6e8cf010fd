"""Cluster metrics with exact reference semantics (the dashboard's math).

A copy of ``kmeans_tpu/session/metrics.py``: JAX-free,
but importing it would run ``kmeans_tpu/__init__.py``, which imports JAX.

Behavioral contract from app.mjs:435-496 (SURVEY.md §5.5):

* ``norm_tokens``   — app.mjs:436-443: split traits on ``/ , & • + |`` and the
  standalone word "and" (case-insensitive), trim, drop empties, lowercase.
* ``tokens_for_card`` — app.mjs:445-449: set-union of tokens from BOTH traits.
* ``trait_counts_for`` — app.mjs:450-461: token → {label: titleCase, count}.
* ``cohesion_for``  — app.mjs:462-475: fraction of cards sharing ≥1 token
  with some *other* card in the cluster; n ≤ 1 → 1.0.
* ``suggestion_from_counts`` — app.mjs:476-480: top-2 tokens by (count desc,
  label asc) joined as "A + B"; single token → its label; empty → None.
* ``snapshot_metrics`` — app.mjs:481-496: per-centroid counts + cohesion,
  balance {max, min, gap, ratio} with ratio = max/min, ∞ when min == 0 < max,
  1 when all empty; avgCohesion (1.0 when there are no centroids).
* deltas vs the previous snapshot — app.mjs:510-528,544: gap delta, avg- and
  per-centroid cohesion deltas in whole percentage points, count deltas.

These run at teaching-game scale (dozens of cards) in pure Python; the
numeric engine's large-N metrics live in the ops layer.  The O(n²·tokens)
cohesion here is the reference's own cost envelope (SURVEY.md CS-D).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

__all__ = [
    "norm_tokens",
    "title_case",
    "tokens_for_card",
    "trait_counts_for",
    "cohesion_for",
    "suggestion_from_counts",
    "snapshot_metrics",
    "metrics_deltas",
]

# app.mjs:439 — the split regex: chars / , & • + |, or " and " with
# surrounding whitespace, case-insensitive.
_SPLIT_RE = re.compile(r"[/,&•+]|(?:\s+and\s+)|\|", re.IGNORECASE)
_WORD_RE = re.compile(r"\w\S*")


def norm_tokens(s: Optional[str]) -> List[str]:
    if not s:
        return []
    parts = _SPLIT_RE.split(str(s))
    return [p.strip().lower() for p in parts if p and p.strip()]


def title_case(s: str) -> str:
    """app.mjs:444 — capitalize the first char of each word, rest unchanged."""
    return _WORD_RE.sub(lambda m: m.group(0)[0].upper() + m.group(0)[1:], s)


def _trait(card: Mapping, i: int) -> Optional[str]:
    traits = card.get("traits") if isinstance(card, Mapping) else None
    if not traits or len(traits) <= i:
        return None
    return traits[i]


def tokens_for_card(card: Mapping) -> set:
    """Union of tokens from BOTH traits, dedup within the card."""
    return set(norm_tokens(_trait(card, 0)) + norm_tokens(_trait(card, 1)))


def trait_counts_for(cards: Iterable[Mapping]) -> Dict[str, dict]:
    """token → {"label": display label, "count": cards containing it}."""
    out: Dict[str, dict] = {}
    for c in cards:
        for t in tokens_for_card(c):
            prev = out.get(t)
            if prev is None:
                prev = {"label": title_case(t), "count": 0}
                out[t] = prev
            prev["count"] += 1
    return out


def cohesion_for(cards: Sequence[Mapping]) -> float:
    n = len(cards)
    if n <= 1:
        return 1.0
    sets = [tokens_for_card(c) for c in cards]
    share = 0
    for i in range(n):
        for j in range(n):
            if i != j and sets[i] & sets[j]:
                share += 1
                break
    return share / n


def suggestion_from_counts(counts: Mapping[str, Mapping]) -> Optional[str]:
    arr = sorted(counts.values(), key=lambda v: (-v["count"], v["label"]))
    if not arr:
        return None
    if len(arr) >= 2:
        return f"{arr[0]['label']} + {arr[1]['label']}"
    return arr[0]["label"]


def snapshot_metrics(
    cards: Sequence[Mapping], centroids: Sequence[Mapping]
) -> dict:
    counts: Dict[str, int] = {}
    coh: Dict[str, float] = {}
    for cent in centroids:
        cid = cent["id"]
        cs = [c for c in cards if c.get("assignedTo") == cid]
        counts[cid] = len(cs)
        coh[cid] = cohesion_for(cs)
    vals = list(counts.values())
    mx = max(vals) if vals else 0
    mn = min(vals) if vals else 0
    gap = mx - mn
    ratio = (mx / mn) if mn else (math.inf if mx else 1)
    avg_c = (sum(coh.values()) / len(coh)) if coh else 1
    return {
        "counts": counts,
        "cohesion": coh,
        "balance": {"max": mx, "min": mn, "gap": gap, "ratio": ratio},
        "avgCohesion": avg_c,
    }


def metrics_deltas(prev: Optional[Mapping], now: Mapping) -> Optional[dict]:
    """Per-iteration deltas as the dashboard renders them (app.mjs:523-544).

    Returns None when there is no previous snapshot.  Cohesion deltas are in
    whole percentage points (``round((now-prev)*100)``), the gap delta is a
    raw difference (non-positive = "tighter").
    """
    if not prev:
        return None
    d_gap = now["balance"]["gap"] - prev["balance"]["gap"]
    d_avg = round((now["avgCohesion"] - prev["avgCohesion"]) * 100)
    per_centroid = {}
    for cid, cnt in now["counts"].items():
        p_cnt = prev["counts"].get(cid)
        p_coh = prev["cohesion"].get(cid)
        per_centroid[cid] = {
            "count": None if p_cnt is None else cnt - p_cnt,
            "cohesion_pp": (
                None if p_coh is None
                else round((now["cohesion"][cid] - p_coh) * 100)
            ),
        }
    return {
        "gap": d_gap,
        "tighter": d_gap <= 0,
        "avgCohesion_pp": d_avg,
        "per_centroid": per_centroid,
    }
