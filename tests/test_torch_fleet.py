"""The port's serving fleet against the JAX package's, on the CPU.

``tests/test_fleet.py``'s supervisor tests run once per package (``side``):
the constructor contracts, the heartbeat line protocol, the fast
boot-serve-drain representative, and the four multi-process drills, which
keep the reference's ``slow`` mark (worker kill mid-load, fleet-wide
hot-swap, rolling replace, the command line under SIGTERM).  The port's
workers run with ``device="cpu"`` (the kernels' plain versions); the
reference's under JAX on the CPU.  Its admission and readiness tests already
run once per server in ``tests/test_torch_server.py``.

Across the packages: the two line protocols give the same lines and parse
them the same way, and ``python -m kmeans_tpu_torch.cli serve --workers 2
--device cpu`` answers ``POST /api/assign`` with the reference fleet's
bytes on one model directory, reloads a newly published generation, and
drains on SIGTERM with exit 0.  The port's own surface: no card without
``device="cpu"`` raises, and a worker is a fresh interpreter given the
device on its command line.

Model directories hold npz bundles (orbax hidden from the reference, as in
``tests/test_torch_server.py``), which both packages' workers read.  Every
wait has a timeout: a port worker takes seconds to import torch here.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kmeans_tpu.config import ServeConfig as RefServeConfig
from kmeans_tpu.continuous.registry import ModelRegistry as RefRegistry
from kmeans_tpu.serve import fleet as RF
from kmeans_tpu_torch.config import ServeConfig
from kmeans_tpu_torch.continuous.registry import ModelRegistry
from kmeans_tpu_torch.serve import assign as A
from kmeans_tpu_torch.serve import fleet as PF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ["ref", "port"]
#: Seconds a fleet may take to boot, and any one HTTP call or join.
BOOT_S = 60.0
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def npz_format(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _cfg(side, **kw):
    base = (RefServeConfig if side == "ref" else ServeConfig)(
        host="127.0.0.1", port=0, tracing=False)
    return dataclasses.replace(base, **kw)


def _supervisor(side, config, workers, **kw):
    if side == "ref":
        return RF.FleetSupervisor(config, workers=workers, **kw)
    return PF.FleetSupervisor(config, workers=workers, device="cpu", **kw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet_cfg(side, model_dir, port, **kw):
    """Drill-speed fleet config: tight heartbeats so death detection and
    reload push land within a test-sized window."""
    knobs = dict(model_dir=model_dir, assign_batching=False,
                 metrics=False, fleet_heartbeat_s=0.1,
                 fleet_heartbeat_timeout_s=1.0, fleet_backoff_base_s=0.05,
                 fleet_reload_poll_s=0.05)
    knobs.update(kw)
    return _cfg(side, port=port, **knobs)


def _publish(side, model_dir, k=4, d=3):
    reg = (RefRegistry if side == "ref" else ModelRegistry)(path=model_dir)
    c = (np.arange(k * d, dtype=np.float32).reshape(k, d)) * 10.0
    reg.publish(c, trigger="initial")
    return reg, c


def _get(base, path, timeout=WAIT_S):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _assign(base, rows, timeout=WAIT_S):
    req = urllib.request.Request(
        base + "/api/assign",
        data=json.dumps({"points": rows}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _raw(base, data, ctype, timeout=WAIT_S):
    """``(status, content type, body bytes)`` of one ``/api/assign``."""
    req = urllib.request.Request(base + "/api/assign", data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


# ---------------------------------------------------------------------------
# Supervisor surface: constructor contracts + line protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_supervisor_rejects_ephemeral_port(side):
    with pytest.raises(ValueError, match="fixed port"):
        _supervisor(side, _cfg(side, port=0), 2)


@pytest.mark.parametrize("side", SIDES)
def test_supervisor_rejects_zero_workers(side):
    with pytest.raises(ValueError, match="workers"):
        _supervisor(side, _cfg(side, port=8787), 0)


@pytest.mark.parametrize("side", SIDES)
def test_supervisor_forces_reuse_port(side):
    sup = _supervisor(side, _cfg(side, port=_free_port()), 1)
    assert sup.config.reuse_port is True


@pytest.mark.parametrize("side", SIDES)
def test_heartbeat_line_protocol_roundtrip(side):
    F = RF if side == "ref" else PF
    line = F._kv_line("FLEET_READY", pid=123, port=8787, gen=7)
    assert line == "FLEET_READY pid=123 port=8787 gen=7"
    assert F._parse_kv(line) == {"pid": "123", "port": "8787", "gen": "7"}
    assert F._parse_kv("FLEET_HB") == {}


@pytest.mark.parametrize("tag,kv", [
    ("FLEET_READY", dict(pid=4242, port=8787, gen=3, obs=40001)),
    ("FLEET_HB", dict(ts=1712345678.123456, gen=12)),
    ("FLEET_GEN", dict(gen=0, ts=0.5)),
    ("FLEET_DRAINED", dict(ts=3.25)),
    ("FLEET_HB", {}),
])
def test_line_protocols_agree(tag, kv):
    """Both packages write the same line and read it back alike, so
    either supervisor understands either worker."""
    line = PF._kv_line(tag, **kv)
    assert line == RF._kv_line(tag, **kv)
    assert PF._parse_kv(line) == RF._parse_kv(line) == {
        k: str(v) for k, v in kv.items()}
    assert PF._parse_kv(line + " torn") == RF._parse_kv(line + " torn")


def test_port_supervisor_needs_a_card_or_the_cpu():
    """The card by default: without one the constructor raises, naming
    ``device='cpu'``, before anything is spawned."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PF.FleetSupervisor(_cfg("port", port=_free_port()), workers=1)
    sup = PF.FleetSupervisor(_cfg("port", port=_free_port()), workers=1,
                             device="cpu")
    cmd = sup._worker_cmd()
    assert cmd[:4] == [sys.executable, "-m", "kmeans_tpu_torch.serve.fleet",
                       "--worker"]
    assert cmd[4:] == ["--device", "cpu"]


def test_port_worker_entry_refuses_without_a_supervisor(monkeypatch, capsys):
    monkeypatch.delenv(PF._CONFIG_ENV, raising=False)
    assert PF.main(["--worker", "--device", "cpu"]) == 2
    assert PF.main([]) == 2
    assert "FleetSupervisor" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Fleet drills: real worker processes under the supervisor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_fleet_boots_serves_and_drains_clean(side, tmp_path):
    """Two workers share one port, serve the published generation, and a
    graceful stop drains both with zero in-flight drops."""
    tmp = str(tmp_path)
    _publish(side, tmp)
    port = _free_port()
    sup = _supervisor(side, _fleet_cfg(side, tmp, port), 2)
    base = f"http://127.0.0.1:{port}"
    try:
        sup.start()
        assert sup.wait_ready(timeout=BOOT_S), sup.events
        st, out = _get(base, "/healthz")
        assert st == 200 and out["ok"] is True
        st, out = _assign(base, [[0.0, 0.0, 0.0]])
        assert st == 200 and out["generation"] == 1
        results = []
        lock = threading.Lock()

        def go():
            st, _ = _assign(base, [[100.0, 110.0, 120.0]])
            with lock:
                results.append(st)

        threads = [threading.Thread(target=go) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert len(results) == 8 and all(st == 200 for st in results)
        clean = sup.stop(graceful=True)
        assert clean, sup.events
        assert len(sup.events_of("drained")) == 2, sup.events
        assert all(e["returncode"] == 0 for e in sup.events_of("exit"))
    finally:
        sup.stop(graceful=False)


@pytest.mark.slow
@pytest.mark.parametrize("side", SIDES)
def test_fleet_worker_kill_mid_load_recovers(side, tmp_path):
    """fleet.heartbeat:kill@2 on slot 1's first incarnation: the slot
    respawns within the RTO window, the hammer sees only in-flight
    connection errors, and the replacement serves."""
    tmp = str(tmp_path)
    _publish(side, tmp)
    port = _free_port()
    cfg = _fleet_cfg(side, tmp, port, fleet_heartbeat_s=0.25)
    sup = _supervisor(
        side, cfg, 2,
        worker_env={1: {"KMEANS_TPU_FAULTS": "fleet.heartbeat:kill@2"}})
    base = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    good, errors = [], []

    def hammer():
        while not stop.is_set():
            try:
                st, _ = _assign(base, [[0.0, 0.0, 0.0]], timeout=3.0)
                good.append(st)
            except Exception as e:  # allow-silent-except: counted below
                errors.append(type(e).__name__)
            stop.wait(0.02)

    t = threading.Thread(target=hammer)
    try:
        sup.start()
        assert sup.wait_ready(timeout=BOOT_S), sup.events
        t.start()
        deadline = time.monotonic() + BOOT_S
        exit_ev = ready_after = None
        while time.monotonic() < deadline and ready_after is None:
            exits = [e for e in sup.events_of("exit") if e["slot"] == 1]
            if exits:
                exit_ev = exits[0]
                ready_after = next(
                    (e for e in sup.events_of("ready")
                     if e["slot"] == 1 and e["ts"] > exit_ev["ts"]),
                    None)
            time.sleep(0.05)
        stop.set()
        t.join(timeout=WAIT_S)
        assert exit_ev is not None, sup.events
        assert exit_ev["returncode"] == 137
        assert exit_ev["incarnation"] == 1
        assert ready_after is not None, sup.events
        rto = ready_after["ts"] - exit_ev["ts"]
        assert rto <= 5.0, f"RTO {rto:.2f}s"
        assert len(sup.events_of("respawn")) >= 1
        assert len(errors) <= 5, errors
        assert good and all(st == 200 for st in good)
        st, out = _assign(base, [[0.0, 0.0, 0.0]])
        assert st == 200 and out["generation"] == 1
    finally:
        stop.set()
        sup.stop(graceful=False)


@pytest.mark.slow
@pytest.mark.parametrize("side", SIDES)
def test_fleet_hot_swap_generation_consistency(side, tmp_path):
    """Publishes land mid-load, the supervisor pushes RELOAD, and every
    worker reports the final generation, with no request error."""
    tmp = str(tmp_path)
    reg, c = _publish(side, tmp)
    port = _free_port()
    sup = _supervisor(side, _fleet_cfg(side, tmp, port), 2)
    base = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    seen_gens, errors = set(), []

    def hammer():
        while not stop.is_set():
            try:
                st, out = _assign(base, [[0.0, 0.0, 0.0]], timeout=3.0)
                if st == 200:
                    seen_gens.add(out["generation"])
                else:
                    errors.append(st)
            except Exception as e:  # allow-silent-except: counted below
                errors.append(type(e).__name__)
            stop.wait(0.02)

    t = threading.Thread(target=hammer)
    try:
        sup.start()
        assert sup.wait_ready(timeout=BOOT_S), sup.events
        t.start()
        for gen in (2, 3):
            time.sleep(0.3)
            reg.publish(c + float(gen), trigger="drift")
        final = reg.generation
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            gens = sup.worker_generations()
            if all(g == final for g in gens.values()):
                break
            time.sleep(0.05)
        stop.set()
        t.join(timeout=WAIT_S)
        assert all(g == final for g in sup.worker_generations().values()), \
            (sup.worker_generations(), sup.events)
        assert not errors, errors
        assert seen_gens and seen_gens <= {1, 2, 3}
        assert len(sup.events_of("reload_detected")) >= 1
        assert len(sup.events_of("reload_push")) >= 2
        st, out = _assign(base, [[0.0, 0.0, 0.0]])
        assert st == 200 and out["generation"] == final
    finally:
        stop.set()
        sup.stop(graceful=False)


@pytest.mark.slow
@pytest.mark.parametrize("side", SIDES)
def test_fleet_rolling_replace_zero_downtime(side, tmp_path):
    """rolling_replace(): every slot's pid changes, no accepted request
    fails mid-roll, and no replacement counts as a crash."""
    tmp = str(tmp_path)
    _publish(side, tmp)
    port = _free_port()
    sup = _supervisor(side, _fleet_cfg(side, tmp, port), 2)
    base = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    errors = []

    def hammer():
        while not stop.is_set():
            try:
                st, _ = _assign(base, [[0.0, 0.0, 0.0]], timeout=3.0)
                if st != 200:
                    errors.append(st)
            except Exception as e:  # allow-silent-except: counted below
                errors.append(type(e).__name__)
            stop.wait(0.02)

    t = threading.Thread(target=hammer)
    try:
        sup.start()
        assert sup.wait_ready(timeout=BOOT_S), sup.events
        pids_before = {e["slot"]: e["pid"] for e in sup.events_of("spawn")}
        t.start()
        sup.rolling_replace()
        stop.set()
        t.join(timeout=WAIT_S)
        # At most a couple of connection-level errors (a connection queued
        # on a closing listener is reset), never an HTTP failure.
        assert len(errors) <= 3, errors
        assert all(isinstance(e, str) for e in errors), errors
        rolled = {e["slot"]: e["pid"] for e in sup.events_of("rolled")}
        assert set(rolled) == {0, 1}
        assert all(rolled[s] != pids_before[s] for s in rolled)
        assert not sup.events_of("sigkill"), sup.events
        assert all(e["drained"] for e in sup.events_of("exit"))
        st, _ = _assign(base, [[0.0, 0.0, 0.0]])
        assert st == 200
    finally:
        stop.set()
        sup.stop(graceful=False)


def _cli_fleet(side, tmp_path, model_dir, port, *extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KMEANS_TPU_FAULTS", None)
    env.setdefault("JAX_PLATFORMS", "cpu")
    cmd = ([sys.executable, "-m", "kmeans_tpu.cli", "serve"]
           if side == "ref" else
           [sys.executable, "-m", "kmeans_tpu_torch.cli", "serve",
            "--device", "cpu"])
    cmd += ["--persist-dir", str(tmp_path / "rooms")]
    return subprocess.Popen(
        cmd + ["--workers", "2", "--port", str(port), "--model-dir",
               model_dir, *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_up(base, proc):
    deadline = time.monotonic() + BOOT_S
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate(timeout=WAIT_S)[0]
        try:
            if _get(base, "/readyz", timeout=1.0)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("fleet never became ready")


@pytest.mark.slow
@pytest.mark.parametrize("side", SIDES)
def test_fleet_cli_sigterm_drains_and_exits_zero(side, tmp_path):
    """``serve --workers 2`` under SIGTERM: the supervisor latches a
    drain, workers finish in flight and exit 0, and the command line
    returns 0."""
    tmp = str(tmp_path / "model")
    _publish(side, tmp)
    port = _free_port()
    proc = _cli_fleet(side, tmp_path, tmp, port, "--no-assign-batching",
                      "--no-metrics")
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_up(base, proc)
        st, out = _assign(base, [[0.0, 0.0, 0.0]])
        assert st == 200 and out["generation"] == 1
        proc.send_signal(signal.SIGTERM)
        out_text = proc.communicate(timeout=BOOT_S)[0]
        assert proc.returncode == 0, out_text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _wait_gen(sup_or_base, gen, row=(0.0, 0.0, 0.0)):
    """Until every worker of an in-process supervisor, or the fleet at a
    base URL, answers generation ``gen``."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if isinstance(sup_or_base, str):
            # Fresh connections spread over the workers; ten in a row.
            if all(_assign(sup_or_base, [list(row)])[1]["generation"]
                   == gen for _ in range(10)):
                return
        elif all(g == gen for g in sup_or_base.worker_generations()
                 .values()):
            return
        time.sleep(0.05)
    raise AssertionError(f"the fleet never served generation {gen}")


def test_cli_fleet_answers_the_reference_fleets_bytes(tmp_path):
    """``python -m kmeans_tpu_torch.cli serve --workers 2 --device cpu``
    and the reference's fleet over one model directory: the same status,
    content type and body bytes for JSON and binary requests, before and
    after a generation published mid-run (the supervisors push RELOAD);
    then SIGTERM drains the port's fleet and it exits 0."""
    path = str(tmp_path / "model")
    rng = np.random.default_rng(3)
    c = (rng.normal(size=(6, 8)) * 20).astype(np.float32)
    ModelRegistry(path=path).publish(c, generation=1)
    x = (c[rng.integers(0, 6, 40)]
         + rng.normal(size=(40, 8))).astype(np.float32)
    p_port, r_port = _free_port(), _free_port()
    proc = _cli_fleet("port", tmp_path, path, p_port)
    ref = RF.FleetSupervisor(_fleet_cfg("ref", path, r_port,
                                        assign_batching=True), workers=2)
    bases = (f"http://127.0.0.1:{p_port}", f"http://127.0.0.1:{r_port}")
    requests = [
        (json.dumps({"points": x[:5].tolist()}).encode(),
         "application/json"),
        (A.encode_points(x), A.WIRE_POINTS_CONTENT_TYPE),
        (A.encode_points(x[:7, :5]), A.WIRE_POINTS_CONTENT_TYPE),
        (json.dumps({"points": [[1.0, 2.0]]}).encode(), "application/json"),
    ]
    try:
        ref.start()
        _wait_up(bases[0], proc)
        assert ref.wait_ready(timeout=BOOT_S), ref.events
        for gen in (1, 2):
            if gen == 2:
                reg = ModelRegistry(path=path)
                reg.load_latest()
                reg.publish(c[::-1].copy(), generation=2, trigger="drift")
                _wait_gen(ref, 2)
                _wait_gen(bases[0], 2, row=x[0].tolist())
            for data, ctype in requests:
                got = [_raw(b, data, ctype) for b in bases]
                assert got[0] == got[1], (gen, ctype, got)
            st, _, body = _raw(bases[0], *requests[1])
            lab, _, g, k = A.decode_labels(body)
            cg = c if gen == 1 else c[::-1]
            want = ((x[:, None] - cg[None]) ** 2).sum(-1).argmin(1)
            assert st == 200 and (g, k) == (gen, 6)
            np.testing.assert_array_equal(lab, want)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=BOOT_S)[0]
        assert proc.returncode == 0, out
        assert "fleet: 2 workers" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        ref.stop(graceful=False)
