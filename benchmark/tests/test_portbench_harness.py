"""A tiny cell run end to end on the CPU (the kernels' plain versions),
and the pieces of a run: the result line, the trace's reduction, the
per-layer metrics' readers, the data and the traffic."""

import json
import math
import sys

import pytest
import torch

from benchmark import spec
from benchmark.data import derive_seed, make_dataset
from benchmark.drivers.fit import FitRecord, Traffic
from benchmark.run import Run, forbidden_modules, run_cell
from benchmark.trace import Kernel, TraceSummary, base_name, reduce_trace

CELLS = ("imagenet-fit", "glove-fit", "imagenet-refit")
BIG_SEED = 2 ** 31 + 12345


def _valid_line(result: dict, trace: bool, cell: str, bench: dict):
    text = json.dumps(result)
    assert json.loads(text) == result
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["attempted"] >= 1
    dev = result["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in dev
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"]
               for m in spec.metrics_for(bench[section], cell)}
    for name, m in result["metrics"].items():
        assert allowed[name] == m["unit"]
        assert math.isfinite(m["value"])
    if not trace:
        assert set(result["metrics"]) == set(allowed)
        assert result["metrics"]["fit_s"]["value"] > 0
    else:
        assert dev["window_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_end_to_end_on_the_cpu(bench, tiny, cell, trace):
    wl, cfg, traffic, limits = tiny(cell)
    result, lines = run_cell(bench, wl, BIG_SEED, 0.5, bool(trace),
                             device="cpu", config=cfg, traffic=traffic,
                             limits=limits)
    _valid_line(result, bool(trace), cell, bench)
    assert result["correct"], lines
    assert result["failed"] == 0
    checks = result["checks"]
    assert set(limits["numbers"]) <= set(checks)
    for c in checks.values():
        assert c["value"] <= c["limit"]
    assert any(line.startswith("check ") for line in lines)
    if trace:
        m = result["metrics"]
        assert m["sweeps_per_fit"]["value"] >= 1
        assert 0 < m["recompute_frac"]["value"] <= 1
        assert ("seed_s" in m) == (traffic["init"] == "k-means++")
    assert forbidden_modules() == []


def test_a_run_without_limits_is_not_correct(bench, tiny):
    wl, cfg, traffic, _ = tiny("glove-fit")
    result, _ = run_cell(bench, wl, 3, 0.2, False, device="cpu", config=cfg,
                         traffic=traffic, limits={"numbers": {
                             "label_gap": {"limit": 1.0},
                             "missing_number": {"limit": 1.0}}})
    assert not result["correct"]
    assert result["checks"]["missing_number"]["value"] is None


@pytest.mark.parametrize("cell", CELLS)
def test_the_same_seed_gives_the_same_rows_and_calls(tiny, cell):
    _, cfg, traffic, _ = tiny(cell)
    a = make_dataset(cfg, traffic, BIG_SEED, "cpu")
    b = make_dataset(cfg, traffic, BIG_SEED, "cpu")
    c = make_dataset(cfg, traffic, BIG_SEED + 1, "cpu")
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert a.x.dtype == {"bfloat16": torch.bfloat16,
                         "float32": torch.float32}[cfg["storage_dtype"]]
    assert tuple(a.x.shape) == (cfg["n"], cfg["d"])
    ta, tb = Traffic(traffic, cfg, a, BIG_SEED), Traffic(traffic, cfg, b,
                                                          BIG_SEED)
    for i in (-1, 0, 5):
        ca, cb = ta.call(i), tb.call(i)
        assert ca.seed == cb.seed
        assert (ca.init is None) == (traffic["init"] == "k-means++")
        if ca.init is not None:
            assert torch.equal(ca.init, cb.init)
            assert tuple(ca.init.shape) == (cfg["k"], cfg["d"])
    assert ta.call(0).seed != ta.call(1).seed


def test_derive_seed_takes_any_whole_number():
    for s in (0, 1, 2 ** 31 + 7, 2 ** 40, -5):
        v = derive_seed(s, 3, 1)
        assert 0 <= v < 2 ** 63
    assert derive_seed(7, 1) != derive_seed(7, 2)


def test_base_name_of_demangled_kernels():
    assert base_name("void (anonymous namespace)::core_score_kernel<"
                     "__nv_bfloat16, false, false>(CUtensorMap, float const*,"
                     " int)") == "core_score_kernel"
    assert base_name("void at::native::vectorized_elementwise_kernel<4, "
                     "at::native::FillFunctor<float>, at::detail::Array<"
                     "char*, 1> >(int, at::native::FillFunctor<float>)") == \
        "vectorized_elementwise_kernel"
    assert base_name("fold_kernel") == "fold_kernel"


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def test_trace_reduction_busy_ops_and_gaps():
    events = [
        _ev("bench.window", "user_annotation", 0, 100),
        _ev("bench.fit", "user_annotation", 0, 100),
        _ev("aten::item", "cpu_op", 30, 20),
        _ev("void ns::k_a<int>(int)", "kernel", 10, 20, tid=7, stream=7),
        _ev("void ns::k_b(float)", "kernel", 25, 5, tid=7, stream=7),
        _ev("Memcpy DtoH", "gpu_memcpy", 60, 10, tid=7, stream=7),
        _ev("void ns::k_a<int>(int)", "kernel", 90, 30, tid=7, stream=7),
    ]
    s = reduce_trace(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((20 + 10 + 10) * 1e-6)
    assert s.device_ops[0] == ["k_a", pytest.approx(50e-6)]
    gaps = dict((n, v) for n, v in s.idle_gaps)
    assert gaps["aten::item"] == pytest.approx(30e-6)     # 30..60
    assert gaps["bench.fit"] == pytest.approx(30e-6)      # 0..10, 70..90


def _run(**kw):
    base = dict(config={"n": 1000, "d": 64, "k": 10,
                        "storage_dtype": "bfloat16",
                        "compute_dtype": "bfloat16"},
                traffic={"init": "k-means++"}, workload={}, records=[],
                window_s=1.0, trace=None, peak_window_bytes=0)
    base.update(kw)
    return Run(**base)


def test_every_metric_reader_returns_nothing_with_nothing_to_read(bench):
    for m in bench["per_layer"]:
        assert spec.metric_reader(m["name"])(_run()) is None, m["name"]


def test_k2_roofline_counts_k2_calls_by_their_epilogue():
    k = [Kernel("core_score_kernel", 0, 100, 7, "kernel"),
         Kernel("core_delta_finish_kernel", 100, 10, 7, "kernel"),
         Kernel("sort_hist_kernel", 110, 5, 7, "kernel"),
         Kernel("fold_kernel", 115, 5, 7, "kernel"),
         Kernel("vectorized_elementwise_kernel", 120, 50, 7, "kernel"),
         Kernel("core_score_kernel", 200, 100, 7, "kernel"),   # a K1 call
         Kernel("tiled_merge_kernel", 300, 10, 7, "kernel")]
    trace = TraceSummary(k, 1.0, 0.5, [], [])
    read = spec.metric_reader("k2_roofline")
    from benchmark.roofline import k2_least_seconds
    cfg = _run().config
    least = k2_least_seconds(1000, 64, 10, "bfloat16", "bfloat16")
    assert read(_run(trace=trace)) == pytest.approx(
        100 * least / 120e-6)
    assert cfg["n"] == 1000


def test_host_metrics_read_the_window_fits():
    fits = [FitRecord(0, 2.0, 10, {"recompute_rows": 50.0,
                                   "rows_seen": 100.0}, 1.0),
            FitRecord(1, 4.0, 30, {"recompute_rows": 150.0,
                                   "rows_seen": 200.0}, 1.0)]
    run = _run(records=fits)
    assert spec.metric_reader("sweeps_per_fit")(run) == 20
    assert spec.metric_reader("recompute_frac")(run) == pytest.approx(
        200 / 300)
    assert spec.metric_reader("seed_s")(run) == 1.0
    assert spec.metric_reader("sweep_ms")(run) == pytest.approx(
        1e3 * (1.0 / 10 + 3.0 / 30) / 2)
    mfu = spec.metric_reader("fit_mfu")(run)
    ops = 2 * 64 * 10 * ((50 + 2000) + (150 + 2000))
    assert mfu == pytest.approx(100 * ops / (6.0 * 989e12))


class _CountingSession:
    """A driver of another kind of traffic, as a later change would add it
    in ``drivers/<name>.py``: its own calls, end-to-end reading and judge."""

    def __init__(self, config, traffic, seed, device, trace):
        self.records = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def warm(self):
        pass

    def window(self, seconds):
        self.records += [1, 2, 3]

    def traced(self, seconds):
        pass

    @property
    def attempted(self):
        return len(self.records)

    def end_to_end(self, window_s):
        return {"calls_per_s": len(self.records) / window_s}

    def judge(self, limits):
        return True, {"wrong_calls": {"value": 0, "limit": 0}}, 0, []


def test_a_new_kind_of_traffic_needs_only_its_driver_and_entries(bench):
    bench = dict(bench, end_to_end=bench["end_to_end"] + [
        {"name": "calls_per_s", "unit": "1/s", "better": "higher",
         "bound": 0.05, "source": "host_clock", "workloads": ["count"]}])
    wl = {"name": "count", "config": "glove-6b-300d", "traffic": "count",
          "chips": 1, "why": "a stand-in"}
    driver = type("driver", (), {"Session": _CountingSession})
    result, lines = run_cell(bench, wl, 1, 0.1, False, device="cpu",
                             config={"name": "x"}, traffic={"driver": "x"},
                             limits={"numbers": {}}, driver=driver)
    assert set(result["metrics"]) == {"calls_per_s", "setup_s"}
    assert result["correct"] and result["attempted"] == 3
    assert lines == ["check wrong_calls: 0 (limit 0)"]


def test_traffic_names_its_driver_by_file(bench):
    import benchmark.drivers.fit as fit_driver
    for w in bench["workloads"]:
        assert spec.driver_for(spec.traffic_for(w["traffic"])) is fit_driver
    with pytest.raises(ValueError):
        spec.driver_for({"driver": "../fit"})


def test_no_forbidden_module_in_this_process():
    assert not {m.split(".", 1)[0] for m in sys.modules} & {
        "jax", "jaxlib", "flax", "kmeans_tpu"}
