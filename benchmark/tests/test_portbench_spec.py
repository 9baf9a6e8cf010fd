"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
from pathlib import Path

import pytest

from benchmark import spec

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths(bench):
    assert set(bench) == TOP_KEYS
    assert len(json.dumps(bench).encode()) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert len(p) <= 200 and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_budget_fits_twenty_four_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", CONFIG_KEYS), ("workloads", CELL_KEYS),
    ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)])
def test_entries_have_just_the_contract_keys(bench, section, keys):
    entries = bench[section]
    assert 1 <= len(entries)
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - keys
        assert set(e) >= keys and extra <= {"workloads"}, e["name"]
        if section in ("configs", "workloads"):
            assert "workloads" not in e
        assert spec.NAME.fullmatch(e["name"]), e["name"]


def test_names_units_and_lines(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(spec.NAME.fullmatch(r) for r in c["reduced"])
    for w in bench["workloads"]:
        assert _line(w["why"])
        assert spec.NAME.fullmatch(w["config"])
        assert spec.NAME.fullmatch(w["traffic"])


def test_end_to_end_metrics_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_enough(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        reported = {m["name"] for m in spec.metrics_for(bench["end_to_end"],
                                                        w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.metrics_for(bench["per_layer"], w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in reported
    assert len(pairs) == len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
        assert m["moves"] in e2e if "moves" in m else True


def test_configs_found_and_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert c["name"] in used
        path = spec.ROOT / c["file"]
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert path.is_file() and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in ("n", "d", "k", "storage_dtype", "data", "fit",
                    "control", "assumed"):
            assert key in cfg


def test_traffic_metric_and_limit_files_found(bench):
    for w in bench["workloads"]:
        t = spec.traffic_for(w["traffic"])
        assert (spec.BENCH_DIR / "drivers" / f"{t['driver']}.py").is_file()
        assert spec.limits_for(w["name"]) is not None, w["name"]
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(spec.ROOT).as_posix()
            assert all(spec.NAME.fullmatch(part) for part in rel.split("/"))


def test_paths_hold_only_the_benchmark(bench):
    """The benchmark's folder is new and holds nothing of the program."""
    for p in bench["paths"]:
        assert not p.endswith("_torch")
        assert not (spec.ROOT / p / "__main__.py").exists()
    assert Path(spec.BENCH_DIR).name == "benchmark"
