"""A run with the timed path broken underneath comes out as not correct.

Each test skips the harness's look for a card and drives the rest of a run
(``run_cell`` on the CPU, the kernels' plain versions, a tiny cell) with
one fault planted in the program: a sweep that returns its state
unchanged; half of the rows left out of the fold, each mean taken over the
rest; an answer altered where it is produced (a final label, a k-means++
centre).  The exchange between chips has no place on one chip."""

import copy

import pytest

from benchmark.faults import FAULTS
from benchmark.run import run_cell

CELLS = ("imagenet-fit", "glove-fit", "imagenet-refit")


#: (cell, fault) pairs: every fault a cell can have (a warm-started mix
#: runs no seeding to alter).
CASES = [(cell, fault) for cell in CELLS for fault in sorted(FAULTS)
         if not (cell == "imagenet-refit" and fault == "seed_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_not_correct(bench, tiny, monkeypatch, cell,
                                         fault):
    wl, cfg, traffic, limits = tiny(cell)
    FAULTS[fault](monkeypatch.setattr)
    result, lines = run_cell(bench, wl, 5, 0.2, False, device="cpu",
                             config=cfg, traffic=traffic, limits=limits)
    assert not result["correct"], lines
    assert result["failed"] >= 1


def _short(cfg, max_iter):
    cfg = copy.deepcopy(cfg)
    cfg["fit"]["max_iter"] = max_iter
    return cfg


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "half_batch", "state_unchanged"])
def test_fits_that_stop_at_max_iter_are_judged_too(bench, tiny, monkeypatch,
                                                    cell, fault):
    """Fits cut at two sweeps never converge: the sound ones are correct,
    and a broken update is caught without the converged fits' step."""
    wl, cfg, traffic, limits = tiny(cell)
    if fault:
        FAULTS[fault](monkeypatch.setattr)
    result, lines = run_cell(bench, wl, 6, 0.2, False, device="cpu",
                             config=_short(cfg, 2), traffic=traffic,
                             limits=limits)
    checks = result["checks"]
    if fault is None:
        assert result["correct"], lines
        assert "step_ratio" not in checks
        assert checks["last_step"]["value"] <= checks["last_step"]["limit"]
    else:
        assert not result["correct"], lines
