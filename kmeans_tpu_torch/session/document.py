"""The session document: the Yjs-doc analog (SURVEY.md §7 stage 3).

A copy of ``kmeans_tpu/session/document.py``: JAX-free,
but importing it would run ``kmeans_tpu/__init__.py``, which imports JAX.

The reference keeps all shared state in a Yjs CRDT document with three roots
(app.mjs:30-33): ``cards`` (Y.Array of plain card objects),
``centroids`` (Y.Array), and ``meta`` (Y.Map holding ``mode``, ``iteration``,
``seededJessica``, per-card ``pos:<id>`` board positions, and
``prevSnapshot``).  Mutations are plain delete+reinsert inside transactions;
observers re-render after every transaction (SURVEY.md §1 data flow).

This Document reproduces that model server-side:

* same entity shapes and meta keys (round-trips the reference's export JSON,
  :mod:`kmeans_tpu_torch.session.schema`),
* same mutation semantics (each mutator below cites its app.mjs source),
* transactions (:meth:`txn`) batch notifications exactly like
  ``ydoc.transact`` — one version bump + one listener fire per transaction,
* listeners replace Yjs observers; the serve layer turns them into SSE
  events, which replaces the WebRTC broadcast (SURVEY.md §2.6).

Unlike the reference's delete+reinsert idiom, mutations here are applied
under a per-document lock, so the field-level lost-update race the reference
accepts (SURVEY.md §8.3) cannot occur server-side.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from kmeans_tpu_torch.config import COLORS, MAX_CENTROIDS, clamp_pos
from kmeans_tpu_torch.session.metrics import snapshot_metrics
from kmeans_tpu_torch.utils.rooms import new_card_id, new_centroid_id

__all__ = ["Document", "CentroidLimitError"]


class CentroidLimitError(ValueError):
    """Raised at the reference's max-3-centroids cap (app.mjs:127)."""


class Document:
    """In-memory session document with transaction batching and listeners."""

    def __init__(self, room: str = "LOCAL", rng: Optional[random.Random] = None):
        self.room = room
        self.cards: List[dict] = []
        self.centroids: List[dict] = []
        self.meta: Dict[str, Any] = {}
        self.version = 0
        self._rng = rng or random.Random()
        self._lock = threading.RLock()
        self._listeners: List[Callable[["Document"], None]] = []
        self._txn_depth = 0
        self._dirty = False
        self._last_iter = self.meta.get("iteration")

    # ------------------------------------------------------------------ txn
    def on_change(self, fn: Callable[["Document"], None]) -> Callable[[], None]:
        self._listeners.append(fn)
        return lambda: self._listeners.remove(fn)

    def read_lock(self):
        """Hold the document lock for a consistent multi-field read (server
        threads read while mutators run; see serve/server.py)."""
        return self._lock

    def txn(self):
        """Context manager: batch mutations into one version bump + notify,
        the ``ydoc.transact`` analog (app.mjs:124)."""
        doc = self

        class _Txn:
            def __enter__(self):
                doc._lock.acquire()
                doc._txn_depth += 1
                return doc

            def __exit__(self, et, ev, tb):
                doc._txn_depth -= 1
                fire = doc._txn_depth == 0 and doc._dirty and et is None
                if fire:
                    doc._dirty = False
                    doc.version += 1
                doc._lock.release()
                if fire:
                    doc._notify()
                return False

        return _Txn()

    def _mutate(self):
        """Mark the doc dirty; bump/notify immediately if not inside txn()."""
        if self._txn_depth:
            self._dirty = True
            return
        self.version += 1
        self._notify()

    def _notify(self):
        for fn in list(self._listeners):
            fn(self)

    # ----------------------------------------------------------- centroids
    def next_color(self) -> str:
        """First unused palette color, random fallback (app.mjs:125)."""
        used = {c.get("color") for c in self.centroids}
        for c in COLORS:
            if c not in used:
                return c
        return self._rng.choice(COLORS)

    def add_centroid(self, name: str = "", *, locked: bool = False) -> dict:
        """app.mjs:126-129; raises :class:`CentroidLimitError` at the cap."""
        with self.txn():
            if len(self.centroids) >= MAX_CENTROIDS:
                raise CentroidLimitError(
                    f"You can have at most {MAX_CENTROIDS} centroids."
                )
            cent = {
                "id": new_centroid_id(self._rng),
                "name": name or f"Centroid {len(self.centroids) + 1}",
                "color": self.next_color(),
                "locked": bool(locked),
            }
            self.centroids.append(cent)
            self._mutate()
            return cent

    def remove_centroid(self, cid: str) -> None:
        """Unassign its cards (+ drop their pos), then delete (app.mjs:130-142)."""
        with self.txn():
            changed = False
            for card in self.cards:
                if card.get("assignedTo") == cid:
                    card["assignedTo"] = None
                    self.meta.pop(f"pos:{card['id']}", None)
                    changed = True
            idx = next(
                (i for i, c in enumerate(self.centroids) if c["id"] == cid), -1
            )
            if idx >= 0:
                del self.centroids[idx]
                changed = True
            if changed:
                self._mutate()

    def rename_centroid(self, cid: str, name: str) -> None:
        """Editable zone name / "Use" suggestion (app.mjs:331-339, 571-573)."""
        with self.txn():
            for c in self.centroids:
                if c["id"] == cid:
                    c["name"] = name
                    self._mutate()
                    return

    def set_locked(self, cid: str, locked: bool) -> None:
        """Lock/Unlock toggle (app.mjs:341-347); drops are refused while
        locked (app.mjs:360) — enforced in :meth:`assign_card`."""
        with self.txn():
            for c in self.centroids:
                if c["id"] == cid:
                    c["locked"] = bool(locked)
                    self._mutate()
                    return

    def get_centroid(self, cid: str) -> Optional[dict]:
        return next((c for c in self.centroids if c["id"] == cid), None)

    # --------------------------------------------------------------- cards
    def add_card(
        self,
        title: str,
        traits: Tuple[str, str] = ("", ""),
        *,
        card_id: Optional[str] = None,
        assigned_to: Optional[str] = None,
        created_by: str = "anon",
    ) -> dict:
        """app.mjs:143-145 (+ the id format from the add-card control,
        app.mjs:246-253)."""
        with self.txn():
            card = {
                "id": card_id or new_card_id(self._rng),
                "title": title,
                "traits": [traits[0], traits[1]],
                "assignedTo": assigned_to,
                "createdBy": created_by,
            }
            self.cards.append(card)
            self._mutate()
            return card

    def get_card(self, card_id: str) -> Optional[dict]:
        return next((c for c in self.cards if c["id"] == card_id), None)

    def update_card_assign(
        self, card_id: str, centroid_id: Optional[str]
    ) -> None:
        """app.mjs:146-156: reassign; clear pos when unassigning."""
        with self.txn():
            card = self.get_card(card_id)
            if card is None:
                return
            card["assignedTo"] = centroid_id
            if not centroid_id:
                self.meta.pop(f"pos:{card_id}", None)
            self._mutate()

    def assign_card(
        self,
        card_id: str,
        centroid_id: Optional[str],
        pos: Optional[Tuple[float, float]] = None,
    ) -> bool:
        """The drop handler's transaction (app.mjs:358-372): refuse when the
        zone is locked, clamp the position, assign + set pos atomically.
        Returns False when refused."""
        with self.txn():
            if centroid_id is not None:
                cent = self.get_centroid(centroid_id)
                if cent is None or cent.get("locked"):
                    return False
            self.update_card_assign(card_id, centroid_id)
            if centroid_id is not None and pos is not None:
                self.set_card_pos(card_id, *pos)
            return True

    def set_card_pos(self, card_id: str, x: float, y: float) -> None:
        """app.mjs:157 with the drop clamp of app.mjs:362-367."""
        cx, cy = clamp_pos(float(x), float(y))
        with self.txn():
            self.meta[f"pos:{card_id}"] = {"x": cx, "y": cy}
            self._mutate()

    def get_card_pos(self, card_id: str) -> Optional[dict]:
        return self.meta.get(f"pos:{card_id}")

    def delete_card(self, card_id: str) -> None:
        """app.mjs:179-185."""
        with self.txn():
            idx = next(
                (i for i, c in enumerate(self.cards) if c["id"] == card_id), -1
            )
            changed = False
            if idx >= 0:
                del self.cards[idx]
                changed = True
            if self.meta.pop(f"pos:{card_id}", None) is not None:
                changed = True
            if changed:
                self._mutate()

    def shuffle_unassigned(self) -> None:
        """Fisher–Yates the unassigned cards; array becomes
        [assigned..., shuffled-unassigned...] (app.mjs:159-166)."""
        with self.txn():
            assigned = [c for c in self.cards if c.get("assignedTo")]
            unassigned = [c for c in self.cards if not c.get("assignedTo")]
            self._rng.shuffle(unassigned)
            self.cards[:] = assigned + unassigned
            self._mutate()

    def restart_all(self) -> None:
        """Unassign everything, drop every pos:* (app.mjs:167-178)."""
        with self.txn():
            for c in self.cards:
                if c.get("assignedTo"):
                    c["assignedTo"] = None
            for k in [k for k in self.meta if str(k).startswith("pos:")]:
                del self.meta[k]
            self._mutate()

    # ---------------------------------------------------------------- meta
    def set_mode(self, mode: str) -> None:
        """app.mjs:287.  Stored/synced but intentionally not branched on —
        the reference treats ``mode`` as a vestigial knob (SURVEY.md §8.7)."""
        with self.txn():
            self.meta["mode"] = mode
            self._mutate()

    def set_iteration(self, iteration: int) -> None:
        """app.mjs:288 + the observer at app.mjs:499-508: when the iteration
        value actually changes, the *current* metrics snapshot is saved as
        ``prevSnapshot`` — the baseline the dashboard deltas compare against.
        """
        with self.txn():
            cur = self.meta.get("iteration")
            if iteration != self._last_iter or cur != iteration:
                if iteration != self._last_iter:
                    self.meta["prevSnapshot"] = self.snapshot()
                    self._last_iter = iteration
                self.meta["iteration"] = iteration
                self._mutate()

    def snapshot(self) -> dict:
        return snapshot_metrics(self.cards, self.centroids)

    @property
    def unassigned_count(self) -> int:
        return sum(1 for c in self.cards if not c.get("assignedTo"))
