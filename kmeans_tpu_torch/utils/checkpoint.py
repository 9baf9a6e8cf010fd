"""Verified array checkpoints: atomic writes, digest-checked loads.

Counterpart of the array layer of ``kmeans_tpu/utils/checkpoint.py``, in
its format on disk, so each package reads the other's bundles:

    <path>/arrays.npz        the arrays
    <path>/meta.json         step, config, rng key data, format tag,
                             per-array SHA-256 digests (format v2)

Saves are atomic (a ``<path>.tmp`` dir, then a rename swap); loads verify
every array against the digest manifest, and a final dir that is corrupt
(not merely missing) falls back to the ``.old`` dir kept during the swap
and then to the ``keep=N`` step-tagged retention dirs, newest first.
Pre-digest (v1) checkpoints load unverified.  Each write-side step is a
fault-injection site (``ckpt.*``, :mod:`kmeans_tpu_torch.utils.faults`).

Known differences from the reference:

* The port writes and reads ``npz`` bundles only.  Where orbax is
  installed the reference writes an orbax PyTree instead; orbax imports
  JAX, so the port refuses such a bundle with :class:`UnsupportedFormatError`
  rather than serve nothing or fall back to an older copy.
* ``key`` is the PRNG key's raw data (a uint32 array, as the reference's
  ``jax.random.key_data`` gives it) and comes back as ``meta["key_data"]``;
  there is no ``meta["key"]``.
* Arrays come back as numpy arrays, and ``meta["config_obj"]`` is the
  port's :class:`~kmeans_tpu_torch.config.KMeansConfig`.

On that layer sit the step-paced runner's state checkpoints
(:func:`save_checkpoint` / :func:`load_checkpoint`: the ``KMeansState``
field layout, so a runner of either package resumes from the other's
directory) and the streamed fits' resume helpers
(:func:`resolve_resume_params`, :class:`PeriodicSaver`).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import shutil
import sys
from typing import Optional, Tuple

import numpy as np

from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.obs import counter as _obs_counter
from kmeans_tpu_torch.obs import tracing as _tracing
from kmeans_tpu_torch.utils import faults

__all__ = ["save_checkpoint", "load_checkpoint", "save_array_checkpoint",
           "load_array_checkpoint", "latest_step", "resolve_resume_params",
           "PeriodicSaver", "CorruptCheckpointError",
           "UnsupportedFormatError"]

#: The reference's checkpoint counters, same names and labels.  ``role``
#: classifies the candidate dir: final, the ``.old`` swap survivor, or a
#: step-tagged retention sibling.
_CKPT_SAVES_TOTAL = _obs_counter(
    "kmeans_tpu_checkpoint_saves_total",
    "Checkpoints written (atomic tmp+rename swaps completed)",
)
_CKPT_VERIFY_FAILURES_TOTAL = _obs_counter(
    "kmeans_tpu_checkpoint_verify_failures_total",
    "Candidate checkpoint dirs rejected at load (torn/corrupt/unreadable)",
    labels=("role",),
)
_CKPT_FALLBACK_LOADS_TOTAL = _obs_counter(
    "kmeans_tpu_checkpoint_fallback_loads_total",
    "Loads served by a fallback dir because the final dir was missing "
    "or corrupt",
    labels=("role",),
)

_META = "meta.json"


class CorruptCheckpointError(ValueError):
    """Checkpoint data exists at the path but no candidate dir verifies."""


class UnsupportedFormatError(ValueError):
    """A checkpoint in a format the port does not read (orbax)."""


def resolve_resume_params(ck: dict, specs) -> dict:
    """Shared resume-parameter reconciliation for the streamed fits.

    ``specs`` is a list of ``(name, ck_key, explicit, default)``: an
    explicitly passed value (``explicit is not None``) that contradicts the
    checkpoint raises; otherwise the checkpoint's value is adopted (or the
    default when the checkpoint predates the key).  Returns
    ``{name: resolved_value}``, each value cast to the default's type.
    """
    resolved = {}
    for name, ck_key, explicit, default in specs:
        current = explicit if explicit is not None else default
        cast = type(default)          # str for names, int/float for numbers
        if ck_key in ck:
            if explicit is not None and cast(ck[ck_key]) != cast(explicit):
                raise ValueError(
                    f"resume {name}={explicit} contradicts the "
                    f"checkpoint's {name}={ck[ck_key]}; drop the argument "
                    "or restart without resume"
                )
            resolved[name] = cast(ck[ck_key])
        else:
            resolved[name] = current
    return resolved


class PeriodicSaver:
    """Cadence and dedup for periodic checkpoint saves: fires every
    ``every`` steps (and on ``force=True``), never twice for one step."""

    def __init__(self, path: Optional[str], every: int):
        self.path = path
        self.every = every
        self._last = -1

    def maybe(self, step: int, save, *, force: bool = False) -> None:
        if not self.path or step == self._last:
            return
        if not force and (self.every < 1 or step % self.every != 0):
            return
        self._last = step
        save()


def _candidate_role(dirpath: str) -> str:
    """final | old | step: the metrics label for one candidate dir."""
    if dirpath.endswith(".old"):
        return "old"
    if ".step-" in os.path.basename(dirpath):
        return "step"
    return "final"


def _fsync_path(path: str) -> None:
    """fsync one file or directory by path.  The rename swap only orders
    the writes; without fsync a power cut could publish a dir whose
    arrays or manifest are empty.  Directory fsync is best-effort: some
    filesystems refuse O_RDONLY directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:   # allow-silent-except: directory fsync unsupported on this filesystem; the rename ordering still holds
        pass
    finally:
        os.close(fd)


def _digest(v: np.ndarray) -> str:
    """SHA-256 over (dtype, shape, bytes), the reference's: torn or
    bit-flipped array data cannot verify, nor can a shape or dtype
    reinterpretation."""
    v = np.ascontiguousarray(v)
    h = hashlib.sha256()
    h.update(str(v.dtype).encode())
    h.update(str(v.shape).encode())
    h.update(v.tobytes())
    return h.hexdigest()


def _step_dirs(path: str) -> list:
    """Step-tagged retention dirs for ``path``, newest step first."""
    out = []
    # glob.escape: a path with glob metacharacters ("run[1]/ck") must not
    # silently disable retention and fallback.
    for p in glob.glob(glob.escape(path) + ".step-*"):
        try:
            out.append((int(p.rsplit(".step-", 1)[1]), p))
        except ValueError:
            continue
    return [p for _, p in sorted(out, reverse=True)]


def _meta_step(dirpath: str) -> Optional[int]:
    try:
        with open(os.path.join(dirpath, _META), "r", encoding="utf-8") as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError):
        return None


def save_array_checkpoint(
    path: str,
    arrays: dict,
    *,
    step: int = 0,
    config: Optional[KMeansConfig] = None,
    key=None,
    extra: Optional[dict] = None,
    keep: int = 0,
) -> str:
    """Write a checkpoint of a flat dict of arrays; returns ``path``.

    Everything is written into ``<path>.tmp`` first and then swapped into
    place, so ``<path>`` always holds a complete (arrays, meta) pair, and
    ``meta.json`` carries a SHA-256 digest per array.  ``key`` is a PRNG
    key's raw data (uint32).  With ``keep >= 1`` the displaced previous
    checkpoint survives as ``<path>.step-<NNNNNNNN>``, at most ``keep`` of
    them, newest first.  The write and swap run under one
    ``checkpoint_save`` span.
    """
    with _tracing.span("checkpoint_save", category="checkpoint",
                       step=int(step)):
        return _save_array_checkpoint(path, arrays, step=step,
                                      config=config, key=key, extra=extra,
                                      keep=keep)


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _state_arrays(state) -> dict:
    return {
        "centroids": _host(state.centroids),
        "labels": _host(state.labels),
        "inertia": _host(state.inertia),
        "n_iter": _host(state.n_iter),
        "converged": _host(state.converged),
        "counts": _host(state.counts),
    }


def save_checkpoint(
    path: str,
    state,
    *,
    step: int = 0,
    config: Optional[KMeansConfig] = None,
    key=None,
    extra: Optional[dict] = None,
    keep: int = 0,
) -> str:
    """Write a resumable ``KMeansState`` checkpoint; returns ``path``.  A
    thin wrapper over :func:`save_array_checkpoint` with the state's field
    layout (the reference's format on disk)."""
    return save_array_checkpoint(
        path, _state_arrays(state), step=step, config=config, key=key,
        extra=extra, keep=keep,
    )


def _save_array_checkpoint(path, arrays, *, step, config, key, extra,
                           keep) -> str:
    final_path = path
    path = path + ".tmp"

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    faults.check("ckpt.pre_write")
    arrays = {k: _host(v) for k, v in arrays.items()}
    # Zero-size arrays are recorded by shape and dtype and rebuilt at load,
    # as the reference does (orbax refuses them, and the format is shared).
    empty = {
        k: {"shape": list(v.shape), "dtype": str(v.dtype)}
        for k, v in arrays.items() if v.size == 0
    }
    arrays = {k: v for k, v in arrays.items() if v.size > 0}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    _fsync_path(os.path.join(path, "arrays.npz"))

    faults.check("ckpt.pre_meta")
    key_data = (None if key is None
                else np.asarray(key, dtype=np.uint32).tolist())
    meta = {
        "format": "npz",
        "version": 2,
        "step": int(step),
        "config": dataclasses.asdict(config) if config else None,
        "key_data": key_data,
        "empty_arrays": empty,
        "digests": {k: _digest(v) for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(path, _META), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        # The manifest arbitrates the whole dir's integrity.
        os.fsync(f.fileno())
    # Contents durable before the rename publishes the dir.
    _fsync_path(path)

    # A crash mid-swap can leave <path>.old / .tmp / .step-* litter but
    # never a torn <path>: loads resolve final -> .old -> step-tagged, each
    # digest-verified.
    old = final_path + ".old"
    faults.check("ckpt.pre_rename")
    if os.path.exists(final_path):
        prev_step = _meta_step(final_path) if keep > 0 else None
        if prev_step is not None:
            dest = f"{final_path}.step-{prev_step:08d}"
            shutil.rmtree(dest, ignore_errors=True)
            os.rename(final_path, dest)
        else:
            # Clear a stale .old only here, where the displaced final
            # replaces it at once: when final_path is missing (a crash at
            # ckpt.mid_swap left .old as the only good copy) .old must
            # survive until the new final lands.
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final_path, old)
    faults.check("ckpt.mid_swap")
    os.rename(path, final_path)
    _fsync_path(os.path.dirname(os.path.abspath(final_path)))
    faults.check("ckpt.post_rename")
    shutil.rmtree(old, ignore_errors=True)
    if keep > 0:
        for stale in _step_dirs(final_path)[keep:]:
            shutil.rmtree(stale, ignore_errors=True)
    _CKPT_SAVES_TOTAL.inc()
    return final_path


def _load_raw(dirpath: str) -> Tuple[dict, dict]:
    """``(numpy arrays, meta)`` from one candidate dir; raises on any
    problem, :class:`UnsupportedFormatError` for an orbax bundle."""
    with open(os.path.join(dirpath, _META), "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta["format"] != "npz":
        raise UnsupportedFormatError(
            f"checkpoint {dirpath!r} is in the {meta['format']!r} format; "
            "the port reads npz bundles only.  Re-export it as npz with "
            "the reference (save_array_checkpoint where orbax is not "
            "importable writes npz)")
    with np.load(os.path.join(dirpath, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, meta


def _read_verified(dirpath: str) -> Optional[Tuple[dict, dict]]:
    """Load and digest-verify one candidate dir; None when absent or
    corrupt.  A v1 checkpoint (no ``digests``) loads unverified."""
    if not os.path.exists(os.path.join(dirpath, _META)):
        return None
    try:
        arrays, meta = _load_raw(dirpath)
        digests = meta.get("digests")
        if digests is not None:
            if set(digests) != set(arrays):
                raise CorruptCheckpointError(
                    f"{dirpath}: array set {sorted(arrays)} does not match "
                    f"the digest manifest {sorted(digests)}"
                )
            for name, want in digests.items():
                got = _digest(arrays[name])
                if got != want:
                    raise CorruptCheckpointError(
                        f"{dirpath}: array {name!r} digest mismatch"
                    )
        return arrays, meta
    except UnsupportedFormatError:
        # A format this package cannot read is not corruption: calling it
        # corrupt would fall back to stale state.
        raise
    except Exception as e:
        # Any read, parse or verify failure means this candidate is torn;
        # the caller falls back to the next one.  When every copy is bad
        # this line is the only diagnosis of which one failed and why.
        _CKPT_VERIFY_FAILURES_TOTAL.labels(
            role=_candidate_role(dirpath)).inc()
        print(f"kmeans_tpu.checkpoint: candidate {dirpath!r} failed "
              f"verification: {e}", file=sys.stderr)
        return None


def _candidates(path: str) -> list:
    """Load-resolution order: final, ``.old`` and the step-tagged dirs,
    newest recorded step first; ties keep final → ``.old`` → step-tagged.
    A candidate with no readable step sorts last."""
    cands = [path, path + ".old"] + _step_dirs(path)
    steps = {c: s for c in cands if (s := _meta_step(c)) is not None}
    return sorted(cands, key=lambda c: -steps.get(c, -1))


def load_array_checkpoint(path: str) -> Tuple[dict, dict]:
    """Returns ``(arrays, meta)``, arrays as numpy arrays.

    Every candidate dir, newest recorded step first, is digest-checked and
    the first complete one wins.  Raises :class:`FileNotFoundError` when
    nothing exists at the path, :class:`CorruptCheckpointError` when data
    exists but no candidate verifies, and :class:`UnsupportedFormatError`
    for an orbax bundle.
    """
    chosen = None
    for cand in _candidates(path):
        got = _read_verified(cand)
        if got is not None:
            chosen = (cand, got)
            break
    if chosen is None:
        # Checkpoint data means a meta.json somewhere; a bare pre-created
        # dir is "nothing was written here", not corruption.
        if not any(os.path.exists(os.path.join(c, _META))
                   for c in _candidates(path)):
            raise FileNotFoundError(
                f"no checkpoint at {path!r} (nor .old / step-tagged "
                "fallbacks)"
            )
        raise CorruptCheckpointError(
            f"checkpoint at {path!r} exists but no candidate dir passes "
            "digest verification — all copies are torn or corrupt"
        )
    cand, (arrays, meta) = chosen
    if cand != path:
        _CKPT_FALLBACK_LOADS_TOTAL.labels(role=_candidate_role(cand)).inc()
        print(f"kmeans_tpu.checkpoint: {path!r} is missing or corrupt; "
              f"loaded verified fallback {cand!r} (step {meta.get('step')})",
              file=sys.stderr)
    for name, spec in (meta.get("empty_arrays") or {}).items():
        arrays[name] = np.zeros(spec["shape"], dtype=spec["dtype"])
    if meta.get("key_data") is not None:
        meta["key_data"] = np.asarray(meta["key_data"], dtype=np.uint32)
    if meta.get("config"):
        meta["config_obj"] = KMeansConfig(**meta["config"])
    return arrays, meta


def load_checkpoint(path: str) -> Tuple[object, dict]:
    """Returns ``(KMeansState, meta)``: the ``KMeansState`` view of
    :func:`load_array_checkpoint`, its fields CPU tensors.  A verified
    bundle of another kind raises ``ValueError`` in the reference's
    words."""
    import torch

    from kmeans_tpu_torch.models.lloyd import KMeansState

    arrays, meta = load_array_checkpoint(path)
    fields = ("centroids", "labels", "inertia", "n_iter", "converged",
              "counts")
    missing = [f for f in fields if f not in arrays]
    if missing:
        # A digest-valid bundle of the wrong kind (e.g. the elastic
        # engine's centroids-only checkpoint) must be a clear refusal,
        # not a KeyError from the middle of state reconstruction.
        engine = (meta.get("extra") or {}).get("engine")
        saved_by = f"; it was saved by {engine}" if engine else ""
        raise ValueError(
            f"checkpoint at {path!r} is not a step-paced runner "
            f"checkpoint (missing {', '.join(missing)}){saved_by}")
    state = KMeansState(*(torch.from_numpy(np.array(arrays[f]))
                          for f in fields))
    return state, meta


def latest_step(path: str) -> Optional[int]:
    """Step of the first candidate dir with readable metadata, or None.
    Metadata only, no hashing: an existence probe before a resume;
    :func:`load_array_checkpoint` does the verified resolution."""
    for cand in _candidates(path):
        step = _meta_step(cand)
        if step is not None:
            return step
    return None
