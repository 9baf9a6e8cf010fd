"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload imagenet-fit --seed 7 --seconds 51 --trace 0

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The system under test is ``kmeans_tpu_torch``; the cell's
configuration, traffic mix, per-layer metrics and limits are found by name
(:mod:`benchmark.spec`), and so is the driver its traffic mix names
(``drivers/<driver>.py``), which owns the calls of that kind of traffic,
their end-to-end readings and their judging.

A run: the driver's session makes its inputs on the card from ``--seed``
and warms up with one call of the cell's own traffic; then the measured
window, in which the driver makes its calls until ``--seconds`` have
passed; ``setup_s`` is everything before the window.  With ``--trace 1``
a few more calls of the same traffic run after the window under
``torch.profiler``; the line then carries the per-layer metrics
(``metrics/<name>.py``) and the trace's ``breakdown``.  Once the window
has closed and the peak memory is read, the driver judges the calls it
kept against the plain reference, and each number compared is printed
beside its limit, on standard error and as the line's last key.

Exit codes: 0 with a result line; 2 with no usable card; 3 when JAX or the
JAX package was loaded into the process.
"""

import time

_T0 = time.perf_counter()   # set-up is timed from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple, Optional  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.roofline import power_limit_w  # noqa: E402
from benchmark.trace import Profiler  # noqa: E402

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "kmeans_tpu")
#: Seconds of calls a traced run profiles after its window (at least one).
TRACE_SECONDS = 6.0


class Run(NamedTuple):
    """What a per-layer metric's ``read(run)`` is given."""
    config: dict
    traffic: dict
    workload: dict
    records: list               # the driver's record of every window call
    window_s: float
    trace: object               # benchmark.trace.TraceSummary, or None
    peak_window_bytes: int      # max_memory_allocated over the window


def forbidden_modules() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench: dict, wl: dict, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda", t0: Optional[float] = None,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None, driver=None):
    """One run of cell ``wl``: ``(result, check_lines)``.  ``config``,
    ``traffic``, ``limits`` and ``driver`` default to the files the cell
    names."""
    t0 = time.perf_counter() if t0 is None else t0
    config = config or spec.config_for(bench, wl)
    traffic = traffic or spec.traffic_for(wl["traffic"])
    limits = limits if limits is not None else spec.limits_for(wl["name"])
    driver = driver or spec.driver_for(traffic)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    summary = None
    with driver.Session(config, traffic, seed, device, trace) as sess:
        sess.warm()
        setup_s = time.perf_counter() - t0
        peak_setup = 0
        if on_card:
            peak_setup = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        sess.window(seconds)
        window_s = time.perf_counter() - w0
        peak_window = torch.cuda.max_memory_allocated() if on_card else 0
        if trace:
            prof = Profiler()
            prof.start()
            sess.traced(min(TRACE_SECONDS, seconds))
            summary = prof.stop()
    peak = max(peak_setup,
               torch.cuda.max_memory_allocated() if on_card else 0)
    if on_card:
        torch.cuda.empty_cache()
    correct, checks, failed, lines = sess.judge(limits)
    lines += [f"check {name}: {c['value']} (limit {c['limit']})"
              for name, c in checks.items()]
    run = Run(config, traffic, wl, sess.records, window_s, summary,
              peak_window)
    values = dict(sess.end_to_end(window_s), setup_s=setup_s)
    metrics = _metrics(bench, wl, run, trace, values)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if on_card else None}
    result = {"correct": bool(correct), "attempted": sess.attempted,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result, lines


def _metrics(bench, wl, run, trace, values: dict) -> dict:
    """The cell's end-to-end metrics from the driver's ``values`` (a name
    the cell reports and the driver does not give is a fault of the
    driver), or with ``trace`` the readings of its per-layer metrics: those
    that move an end-to-end metric the cell reports."""
    e2e = spec.metrics_for(bench["end_to_end"], wl["name"])
    if not trace:
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in e2e}
    out = {}
    for m in spec.metrics_for(bench["per_layer"], wl["name"]):
        if m["moves"] not in {e["name"] for e in e2e}:
            continue
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    wl = spec.workload(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(wl["chips"])):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(bench, wl, args.seed, args.seconds,
                             bool(args.trace), t0=_T0)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
