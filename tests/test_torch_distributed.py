"""The port's multi-process bootstrap (``kmeans_tpu_torch.parallel.
distributed``) against the reference's contract (``tests/test_distributed.
py``): a no-op without configuration, bounded retries of the rendezvous
race with the half-made group torn down between attempts and after the
last, a group made outside the module left alone, and a two-process fit
through the environment rendezvous (``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK``) equal to the single-device fit.  The
``torch.distributed`` calls are monkeypatched where a real rendezvous
would have to fail.
"""

import os
import sys

import numpy as np
import pytest
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_worker import run_world  # noqa: E402

from kmeans_tpu_torch.parallel import distributed as D  # noqa: E402
from kmeans_tpu_torch.utils.retry import RetryError, RetryPolicy  # noqa

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture()
def fresh(monkeypatch):
    """A process that has joined nothing, with no rendezvous in its
    environment."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(D, "_initialized", False)
    return D


def _fake(monkeypatch, calls, fail_until, guard=True):
    """``init_process_group`` failing with a connection error until its
    ``fail_until``-th call; with ``guard``, a re-dial without a
    ``destroy_process_group`` in between dies on torch's "twice" guard (so
    a missing teardown fails the test)."""
    def init(**kw):
        calls["init"] += 1
        calls["kw"] = kw
        if guard and calls["destroy"] < calls["init"] - 1:
            raise ValueError(
                "trying to initialize the default process group twice!")
        if calls["init"] < fail_until:
            raise RuntimeError("connection refused: store unavailable")

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a, **k: calls.__setitem__(
                            "destroy", calls["destroy"] + 1))


def test_ensure_initialized_noop_without_config(fresh, monkeypatch):
    calls = {"init": 0, "destroy": 0}
    _fake(monkeypatch, calls, 0)
    fresh.ensure_initialized()
    fresh.ensure_initialized()
    assert calls["init"] == 0 and fresh._initialized
    info = fresh.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert not fresh.is_multiprocess()
    fresh.heartbeat()


def test_ensure_initialized_retries_and_resets_partial_init(fresh,
                                                            monkeypatch):
    calls = {"init": 0, "destroy": 0}
    _fake(monkeypatch, calls, 3)
    monkeypatch.setattr(fresh, "_INIT_RETRY", RetryPolicy(
        max_attempts=4, base_delay=0.01, max_delay=0.02,
        retryable=fresh._transient_init_error))
    fresh.ensure_initialized("tcp://127.0.0.1:1", 2, 1, backend="gloo",
                             timeout=5.0)
    assert (calls["init"], calls["destroy"]) == (3, 2)
    assert fresh._initialized
    kw = calls["kw"]
    assert kw["world_size"] == 2 and kw["rank"] == 1
    assert kw["backend"] == "gloo" and kw["init_method"] == \
        "tcp://127.0.0.1:1"
    assert kw["timeout"].total_seconds() == 5.0


def test_ensure_initialized_cleans_up_after_exhaustion(fresh, monkeypatch):
    calls = {"init": 0, "destroy": 0}
    _fake(monkeypatch, calls, 3)
    monkeypatch.setattr(fresh, "_INIT_RETRY", RetryPolicy(
        max_attempts=2, base_delay=0.01, max_delay=0.02,
        retryable=fresh._transient_init_error))
    with pytest.raises(RetryError):
        fresh.ensure_initialized("tcp://127.0.0.1:1", 2, 1,
                                 backend="gloo")
    assert (calls["init"], calls["destroy"]) == (2, 2)   # between + after
    assert not fresh._initialized
    # The rendezvous comes back: the same process can now join.
    fresh.ensure_initialized("tcp://127.0.0.1:1", 2, 1, backend="gloo")
    assert fresh._initialized and calls["init"] == 3


def test_ensure_initialized_leaves_foreign_init_intact(fresh, monkeypatch):
    """A group made outside this module: the "twice" guard is not retried
    and the live group is not torn down."""
    calls = {"init": 0, "destroy": 0}

    def init(**kw):
        calls["init"] += 1
        raise ValueError(
            "trying to initialize the default process group twice!")

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a, **k: calls.__setitem__(
                            "destroy", calls["destroy"] + 1))
    with pytest.raises(ValueError, match="twice"):
        fresh.ensure_initialized("tcp://127.0.0.1:1", 2, 1,
                                 backend="gloo")
    assert calls == {"init": 1, "destroy": 0}


def test_env_configuration_is_read(fresh, monkeypatch):
    calls = {"init": 0, "destroy": 0}
    _fake(monkeypatch, calls, 0)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    fresh.ensure_initialized(backend="gloo")
    kw = calls["kw"]
    assert kw["init_method"] == "env://" and kw["world_size"] == 4 \
        and kw["rank"] == 3
    assert kw["timeout"].total_seconds() == fresh.INIT_TIMEOUT_S


def test_fault_site_fires_on_each_attempt(fresh, monkeypatch):
    from kmeans_tpu_torch.utils import faults

    calls = {"init": 0, "destroy": 0}
    _fake(monkeypatch, calls, 0)
    with faults.active("dist.init:raise@1"):
        monkeypatch.setattr(fresh, "_INIT_RETRY", RetryPolicy(
            max_attempts=3, base_delay=0.01, max_delay=0.02,
            retryable=fresh._transient_init_error))
        fresh.ensure_initialized("tcp://127.0.0.1:1", 2, 0, backend="gloo")
    # The injected fault (an OSError) is retried like the race.
    assert calls["init"] == 1 and calls["destroy"] == 1


def test_two_process_fit_through_the_environment():
    """Two processes joined by ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``: the sharded fit every rank returns equals
    the port's single-device fit."""
    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.models.lloyd import fit_lloyd

    rng = np.random.default_rng(3)
    centres = rng.normal(size=(4, 8)).astype(np.float32) * 4
    x = (centres[rng.integers(0, 4, 301)]
         + 0.5 * rng.normal(size=(301, 8))).astype(np.float32)
    c0 = x[:4].copy()
    res = run_world(2, [("fit", "fit", dict(
        x=x, k=4, init=c0, tol=1e-10, max_iter=20,
        config=dict(k=4, update="delta")))])["fit"]
    assert "error" not in res, res
    want = fit_lloyd(x, 4, init=c0, tol=1e-10, max_iter=20, device="cpu",
                     config=KMeansConfig(k=4, update="delta"))
    np.testing.assert_array_equal(res["labels"], want.labels.numpy())
    np.testing.assert_allclose(res["centroids"], want.centroids.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert res["n_iter"] == int(want.n_iter)
