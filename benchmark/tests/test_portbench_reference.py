"""The plain reference against the port's plain versions at small sizes,
and the control: the reference in the precision below the configuration's,
put in the program's place, comes out as not correct."""

import pytest
import torch

from benchmark.control import cell_readings
from benchmark.data import make_dataset
from benchmark.drivers.fit import (SeedingTap, Traffic, UpdateTap, fit_once,
                                   sample_of)
from benchmark.judge import decide, judge_precision, label_tie, readings
from benchmark.reference import kmeans as ref

CELLS = ("imagenet-fit", "glove-fit", "imagenet-refit")


def _port_fit(cfg, traffic, seed):
    ds = make_dataset(cfg, traffic, seed, "cpu")
    call = Traffic(traffic, cfg, ds, seed).call(0)
    with SeedingTap(timed=False) as seeding, UpdateTap() as update:
        km, _ = fit_once(call, ds.x, cfg, "cpu", (seeding, update))
    assert update.count == km.n_iter_
    return ds, call, km, sample_of(0, call, km, seeding, update)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_fit_agrees_with_the_port_on_the_cpu(tiny, cell):
    _, cfg, traffic, _ = tiny(cell)
    ds, call, km, sample = _port_fit(cfg, traffic, 11)
    res = ref.fit(ds.x, cfg["k"], seed=call.seed, init=call.init,
                  precision=judge_precision(cfg),
                  max_iter=cfg["fit"]["max_iter"], tol=cfg["fit"]["tol"])
    if call.init is None:
        assert torch.equal(res["seeds"], sample.seeds)
    assert res["n_iter"] == km.n_iter_
    torch.testing.assert_close(res["prev"], sample.prev, rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(res["labels"], km.labels_)
    torch.testing.assert_close(res["centroids"], km.cluster_centers_,
                               rtol=1e-5, atol=1e-4)
    assert res["inertia"] == pytest.approx(km.inertia_, rel=1e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_judge_passes_the_ports_fit_and_fails_a_moved_one(tiny, cell):
    _, cfg, traffic, limits = tiny(cell)
    ds, call, km, good = _port_fit(cfg, traffic, 12)
    seeding = call.init is None
    r = readings(ds.x, good, cfg, seeding, label_tie(limits))
    if seeding:
        assert r["seed_gap"] == 0.0 and r["not_rows"] == 0
    assert r["unseen"] == 0 and "last_step" in r
    assert decide([r], limits, 0)[0]
    moved = good._replace(centroids=good.centroids + 0.5)
    assert not decide([readings(ds.x, moved, cfg, seeding)], limits, 0)[0]
    unseen = good._replace(prev=None)
    assert not decide([readings(ds.x, unseen, cfg, seeding)], limits, 0)[0]


def test_seeding_judge_replays_the_draws_and_flags_a_foreign_centre(tiny):
    _, cfg, traffic, _ = tiny("imagenet-fit")
    ds, call, _, sample = _port_fit(cfg, traffic, 13)
    seeds = sample.seeds
    assert ref.judge_seeding(ds.x, seeds, call.seed)["seed_gap"] == 0.0
    other = ref.judge_seeding(ds.x, seeds, call.seed + 1)
    assert other["seed_gap"] > 0 and other["rounds_off"] > 0
    foreign = seeds.clone()
    foreign[3] += 0.25
    bad = ref.judge_seeding(ds.x, foreign, call.seed)
    assert bad["not_rows"] == 1 and bad["seed_gap"] == float("inf")


def test_last_step_excuses_a_row_tied_at_the_last_sweeps_centroids():
    """Row 2 lies as near centroid 0 as centroid 1 of ``prev``: a fit may
    fold it into either, and only a fold that no tie explains reads."""
    x = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [2.0, 0.0],
                      [2.0, 1.0]], dtype=torch.float64)
    prev = torch.tensor([[0.0, 0.5], [2.0, 0.5]], dtype=torch.float32)
    labels = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    as_second = torch.stack([x[[0, 1]].mean(0), x[[2, 3, 4]].mean(0)])
    strict = ref.judge_final(x, as_second, labels, 0.0, "exact", 0.0,
                             prev=prev)
    tied = ref.judge_final(x, as_second, labels, 0.0, "exact", 1e-6,
                           prev=prev)
    assert strict["last_step_sq"] > 0.1
    assert tied["last_step_sq"] == pytest.approx(0.0, abs=1e-12)
    wrong = as_second + torch.tensor([[0.0, 0.3], [0.0, 0.0]])
    assert ref.judge_final(x, wrong, labels, 0.0, "exact", 1e-6,
                           prev=prev)["last_step_sq"] > 0.05


@pytest.mark.parametrize("precision", ref.PRECISIONS)
def test_round_operand_keeps_products_exact_in_f32(precision):
    t = torch.randn(64, 40, generator=torch.Generator().manual_seed(1)) * 5
    v, scale = ref.round_operand(t, precision)
    back = v.double() * scale
    err = float(((back - t.double()).abs() / t.double().abs()).max())
    assert err <= {"exact": 0, "bfloat16": 2 ** -8, "tf32": 2 ** -11,
                   "fp8_e4m3": 2 ** -3}[precision]
    if precision in ("bfloat16", "fp8_e4m3"):
        assert v.dtype == torch.bfloat16


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_as_not_correct(tiny, cell):
    """The control of ``control.py`` at a size a test holds: its readings
    fail the cell's limits on every seed."""
    wl, cfg, traffic, limits = tiny(cell)
    out = cell_readings(wl, cfg, traffic, [21, 22, 23], 3, "cpu",
                        emit=lambda s: None, limits=limits)
    for r in out["sound"]:
        assert decide([r], limits, 0)[0], r
    for r in out["control"]:
        assert not decide([r], limits, 0)[0], r
