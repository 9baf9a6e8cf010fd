"""Each cell run on the card as the driver runs it: a short window, both
trace modes, one valid last line with ``correct`` true.  Skips without a
card (decided inside the test)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import spec

pytestmark = pytest.mark.cuda

CELLS = ("imagenet-fit", "glove-fit", "imagenet-refit")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], proc.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name()
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
