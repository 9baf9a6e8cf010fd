"""The comparison that decides ``correct`` for fitting cells.

Once the window has closed, the fits the driver drew from the seed are
judged against the plain reference (:mod:`benchmark.reference.kmeans`) at
the timed sizes: their k-means++ centres round by round, their last sweep
(the final centroids against one Lloyd step from the centroids that sweep
started from), their final labels and inertia, and, where a fit says it
converged, one more Lloyd step.  Every number compared has a limit of its
own, set in ``limits/<cell>.json`` from the readings of sound runs and of
the control (``control.py``); the cell's numbers are the worst over the
judged fits.  Two counts are held at 0: window fits whose result is not a
fit (:func:`benchmark.drivers.fit.is_fit`), and judged fits whose seeding
(in a seeding mix) or last sweep the harness did not see.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from benchmark.reference.kmeans import judge_final, judge_seeding

__all__ = ["Sample", "judge_precision", "label_tie", "readings", "decide",
           "CONVERGED_ONLY"]

#: Numbers read only from fits that say they converged: a fit that stops
#: at ``max_iter`` promises no small next step.
CONVERGED_ONLY = ("step_ratio",)


class Sample(NamedTuple):
    """One judged fit's inputs and outputs, as the window ran it."""
    index: int
    seed: int
    seeds: Optional[torch.Tensor]      # its k-means++ centres, if seen
    prev: Optional[torch.Tensor]       # the centroids its last sweep began at
    centroids: torch.Tensor
    labels: torch.Tensor
    inertia: float
    n_iter: int
    converged: bool


def judge_precision(config: dict) -> str:
    """The precision the configuration states for the product ``x·c``."""
    cd = config.get("compute_dtype") or config["storage_dtype"]
    return "bfloat16" if cd == "bfloat16" else "exact"


def label_tie(limits: Optional[dict]) -> float:
    """The label gap a fit's label is allowed (its ``label_gap`` limit):
    within it, the next Lloyd step counts the row for the fit's label."""
    if limits is None or "label_gap" not in limits["numbers"]:
        return 0.0
    return float(limits["numbers"]["label_gap"]["limit"])


def readings(x: torch.Tensor, sample: Sample, config: dict,
             seeding: bool, tie: float = 0.0) -> dict:
    """The numbers of one judged fit (``seeding``: the mix seeds with
    k-means++, so its centres are judged too).  ``last_step``: the squared
    gap, summed over the centroids, between the fit's final centroids and
    one exact Lloyd step from the centroids its last sweep began at, over
    the fit's ``tol``; ``step_ratio``: one more Lloyd step's squared shift
    over ``tol``, read where the fit says it converged (its last step moved
    its centroids by at most ``tol``)."""
    out = {"unseen": int(sample.prev is None
                         or (seeding and sample.seeds is None))}
    if seeding and sample.seeds is not None:
        out.update(judge_seeding(x, sample.seeds, sample.seed))
    tol = float(config["fit"]["tol"])
    res = judge_final(x, sample.centroids, sample.labels, sample.inertia,
                      judge_precision(config), tie, prev=sample.prev)
    next_sq = res.pop("next_shift_sq")
    if sample.converged:
        out["step_ratio"] = next_sq / tol
    if "last_step_sq" in res:
        out["last_step"] = res.pop("last_step_sq") / tol
    out.update(res)
    return out


def _worst(values):
    vals = [float(v) for v in values]
    return math.inf if any(math.isnan(v) for v in vals) else max(vals)


def decide(per_fit: list, limits: Optional[dict], bad_fits: int):
    """``(correct, checks, failed)`` from the judged fits' readings.

    ``checks`` maps each compared number to ``{"value", "limit"}`` (the
    worst reading over the judged fits); ``exact`` numbers and the two
    counts have the limit 0.  A number of :data:`CONVERGED_ONLY` is left
    out of a run where no judged fit converged; any other number missing
    from every judged fit fails the run.  ``failed`` counts judged fits
    over any limit plus the window's fits that were not fits.  With no
    limits file nothing is compared and the run is not correct."""
    checks = {"bad_fits": {"value": bad_fits, "limit": 0},
              "unseen": {"value": sum(r["unseen"] for r in per_fit),
                         "limit": 0}}
    failed = bad_fits
    if limits is None:
        return False, checks, failed + len(per_fit)
    numbers = dict(limits["numbers"])
    numbers.update({n: {"limit": 0} for n in limits.get("exact", [])})
    missing = False
    for name, spec_ in numbers.items():
        vals = [r[name] for r in per_fit if name in r]
        if not vals:
            if name not in CONVERGED_ONLY:
                checks[name] = {"value": None, "limit": spec_["limit"]}
                missing = True
            continue
        checks[name] = {"value": _worst(vals), "limit": spec_["limit"]}
    for r in per_fit:
        over = r["unseen"] > 0 or any(
            not (float(r[n]) <= float(numbers[n]["limit"]))
            for n in numbers if n in r)
        failed += int(over)
    return failed == 0 and not missing, checks, failed
