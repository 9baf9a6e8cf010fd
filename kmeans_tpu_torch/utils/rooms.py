"""Room codes, entity ids and presence initials.

A copy of ``kmeans_tpu/utils/rooms.py``: JAX-free,
but importing it would run ``kmeans_tpu/__init__.py``, which imports JAX.

Behavioral parity with the reference:

* ``code4`` — 4-char room code from the 32-char alphabet with no I/O/0/1
  (app.mjs:19).
* ``initials`` — up-to-2-word initials for avatar chips (app.mjs:27);
  empty/whitespace input falls back to "??".
* ``new_card_id`` / ``new_centroid_id`` — the ``card:<ts>-<rand>`` /
  ``c:<ts>-<rand>`` id formats (app.mjs:251, 128).
"""

from __future__ import annotations

import random
import time

from kmeans_tpu_torch.config import ROOM_ALPHABET, ROOM_CODE_LEN

__all__ = ["code4", "initials", "new_card_id", "new_centroid_id"]


def code4(rng: random.Random | None = None) -> str:
    r = rng or random
    return "".join(r.choice(ROOM_ALPHABET) for _ in range(ROOM_CODE_LEN))


def initials(name: str | None) -> str:
    words = (name or "??").strip().split()
    out = "".join(w[0].upper() for w in words[:2] if w)
    return out or "??"


def _rand_suffix(rng: random.Random | None) -> str:
    r = rng or random
    return f"{r.randrange(16**6):06x}"


def new_card_id(rng: random.Random | None = None, now_ms: int | None = None) -> str:
    ts = now_ms if now_ms is not None else int(time.time() * 1000)
    return f"card:{ts}-{_rand_suffix(rng)}"


def new_centroid_id(rng: random.Random | None = None, now_ms: int | None = None) -> str:
    ts = now_ms if now_ms is not None else int(time.time() * 1000)
    return f"c:{ts}-{_rand_suffix(rng)}"
