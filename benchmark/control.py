"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/control.py --workload imagenet-fit --seeds 101-112 --control-seeds 3
    python3 benchmark/control.py --workload imagenet-fit --seeds 201-203 --fault half_batch

For each seed, the rows of a run of that seed, then the window's first fits
exactly as a run makes them (the timed path, at the timed size), judged as
a run judges its fits: the *sound* readings.  For the first
``--control-seeds`` seeds also the *control*: the plain reference fit
(:func:`benchmark.reference.kmeans.fit`) put in the program's place, from
the same seed or starting centroids, with its products in the precision
below the configuration's (``control`` in the configuration file: fp8
e4m3 below bfloat16, TF32 below f32 with TF32 off), judged the same way.
It prints one JSON line a fit and a last line with, for each number, the
largest sound reading (the lower end of its limit) and the smallest
control reading (the upper end).

With ``--fault`` the program runs with that fault planted
(:mod:`benchmark.faults`) in place of the sound and control sides, and
each seed's line also says whether the cell's limits find the run
correct, as a run would decide it.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.data import make_dataset  # noqa: E402
from benchmark.drivers.fit import (SeedingTap, Traffic, UpdateTap,  # noqa: E402
                                   fit_once, is_fit, sample_of)
from benchmark.faults import FAULTS, planted  # noqa: E402
from benchmark.judge import Sample, decide, label_tie, readings  # noqa: E402
from benchmark.reference import kmeans as ref  # noqa: E402

#: Readings that are counts or flags, not numbers with a limit.
_COUNTS = ("rounds_off", "not_rows", "unseen", "labels_off",
           "seed_gap_raw")
_INFO = ("seed", "side", "n_iter", "converged", "fit_s", "judge_s",
         "is_fit")


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def _worst(fits: list) -> dict:
    """A seed's reading of each number: the worst over its judged fits, as
    a run takes it."""
    out = {}
    for r in fits:
        for name, v in r.items():
            if name not in _INFO:
                out[name] = max(out.get(name, v), v)
    return out


def cell_readings(wl: dict, config: dict, traffic: dict, seeds: list,
                  control_seeds: int, device: str, emit=print,
                  limits=None, fault=None) -> dict:
    """Sound readings on ``seeds`` and control readings on the first
    ``control_seeds`` of them, each seed's the worst over as many fits as
    a run judges (the window's first calls), with the label gap the
    cell's ``limits`` allow; returns ``{"sound": [...], "control": [...]}``,
    a reading dict a seed.  With ``fault``, the program with that fault
    planted instead, under ``"fault"``, each seed's also with the
    ``correct`` that ``limits`` decide."""
    tie = label_tie(limits)
    max_iter = int(config["fit"]["max_iter"])
    out = {"sound": [], "control": [], "fault": []}
    for n_seed, seed in enumerate(seeds):
        ds = make_dataset(config, traffic, seed, device)
        gen = Traffic(traffic, config, ds, seed)
        seeding = not gen.warm_start
        sides = (["fault"] if fault else
                 ["sound"] + (["control"] if n_seed < control_seeds else []))
        for side in sides:
            fits, bad = [], 0
            for i in range(gen.check_fits):
                call = gen.call(i)
                t = time.perf_counter()
                if side == "control":
                    res = ref.fit(ds.x, int(config["k"]), seed=call.seed,
                                  init=call.init,
                                  precision=config["control"],
                                  max_iter=max_iter,
                                  tol=float(config["fit"]["tol"]))
                    sample = Sample(i, call.seed, res["seeds"], res["prev"],
                                    res["centroids"], res["labels"],
                                    res["inertia"], res["n_iter"],
                                    res["converged"])
                    ok = True
                else:
                    with contextlib.ExitStack() as stack:
                        if side == "fault":
                            stack.enter_context(planted(fault))
                        taps = (stack.enter_context(SeedingTap(timed=False)),
                                stack.enter_context(UpdateTap()))
                        km, _ = fit_once(call, ds.x, config, device, taps)
                        ok = is_fit(km, taps[1].count, max_iter)
                        sample = sample_of(i, call, km, *taps)
                    del km
                bad += int(not ok)
                _sync(device)
                fit_s = time.perf_counter() - t
                t = time.perf_counter()
                r = readings(ds.x, sample, config, seeding, tie)
                _sync(device)
                r.update(seed=seed, side=side, n_iter=sample.n_iter,
                         converged=sample.converged, fit_s=fit_s,
                         judge_s=time.perf_counter() - t, is_fit=ok)
                emit(json.dumps(r))
                fits.append(r)
                del sample
            worst = _worst(fits)
            worst.update(seed=seed, side=side)
            if side == "fault":
                correct, checks, failed = decide(fits, limits, bad)
                worst.update(correct=correct, failed=failed)
                emit(json.dumps({"seed": seed, "fault": fault,
                                 "correct": correct, "failed": failed,
                                 "checks": checks}))
            out[side].append(worst)
        del ds, gen
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def summary(out: dict) -> dict:
    """Per number: the largest sound reading (``lower``), the smallest
    control reading (``upper``) and the smallest under a fault, over the
    seeds that read it."""
    rows = out["sound"] + out["control"] + out["fault"]
    names = sorted({k for r in rows for k in r}
                   - set(_COUNTS) - set(_INFO) - {"correct", "failed"})
    res = {}
    for n in names:
        lo = [r[n] for r in out["sound"] if n in r]
        up = [r[n] for r in out["control"] if n in r]
        fa = [r[n] for r in out["fault"] if n in r]
        res[n] = {"lower": max(lo) if lo else None,
                  "upper": min(up) if up else None,
                  "fault": min(fa) if fa else None,
                  "sound_seeds": len(lo), "control_seeds": len(up)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112,200")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py runs on the card", file=sys.stderr)
        return 2
    bench = spec.load()
    wl = spec.workload(bench, args.workload)
    config = spec.config_for(bench, wl)
    traffic = spec.traffic_for(wl["traffic"])
    out = cell_readings(wl, config, traffic, _seeds(args.seeds),
                        args.control_seeds, "cuda",
                        limits=spec.limits_for(wl["name"]), fault=args.fault)
    print(json.dumps({"workload": wl["name"], "card":
                      torch.cuda.get_device_name(), "fault": args.fault,
                      "correct": [r["correct"] for r in out["fault"]],
                      "summary": summary(out),
                      "seconds": time.perf_counter() - _T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
