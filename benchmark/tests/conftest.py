"""Fixtures of the benchmark's own tests.  These import no JAX: run them
with ``python -m pytest benchmark/tests -q`` from the root of the
repository; the card's tests (marker ``cuda``) skip without a card."""

import copy

import pytest

from benchmark import spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the port's CUDA kernels); "
        "skips without a card")


#: A cell's configuration cut to what a CPU test holds.  n stays above the
#: adaptive loop's AUTO_MIN_ROWS, so the default fit runs the same loop as
#: the cells do (delta periods and yinyang probes).
TINY = dict(n=20000, k=16)
TINY_D = {"bfloat16": 32, "float32": 20}
TINY_DATA = dict(k_gen=16, latent_r=6, cluster_std=1.5)


def tiny_config(config: dict) -> dict:
    cfg = copy.deepcopy(config)
    cfg.update(TINY, d=TINY_D[cfg["storage_dtype"]])
    cfg["data"].update(TINY_DATA)
    return cfg


@pytest.fixture(scope="session")
def bench():
    return spec.load()


@pytest.fixture
def tiny(bench):
    """``tiny(cell)``: (workload, tiny config, traffic, limits)."""
    def make(cell):
        wl = spec.workload(bench, cell)
        return (wl, tiny_config(spec.config_for(bench, wl)),
                spec.traffic_for(wl["traffic"]), spec.limits_for(cell))
    return make
