"""Fault-tolerant serving fleet: a supervising parent over N
``SO_REUSEPORT`` worker processes.

A port of ``kmeans_tpu/serve/fleet.py``.  One
:class:`~kmeans_tpu_torch.serve.server.KMeansServer` process is one
interpreter lock and a single point of failure.  The fleet keeps the
server itself unchanged and multiplies it: the supervisor starts N worker
processes, each a fresh interpreter (``python -m
kmeans_tpu_torch.serve.fleet --worker``, never a fork, so no CUDA context
crosses into a worker) with its own ``AssignEngine`` on the card, that
bind the same ``(host, port)`` with ``SO_REUSEPORT`` (the kernel spreads
accepted connections over their listen queues); it watches them and keeps
the population at N:

* **Heartbeat pipes**: each worker's stdout is its heartbeat pipe: a
  ``FLEET_HB`` line every ``ServeConfig.fleet_heartbeat_s``, plus
  ``FLEET_READY`` / ``FLEET_GEN`` / ``FLEET_DRAINED`` state lines.  A
  worker is dead when its process exits (pipe EOF, seen within one
  monitor tick) or its heartbeat goes silent past
  ``fleet_heartbeat_timeout_s`` (a hung worker, which the supervisor
  SIGKILLs before replacing).
* **Exponential-backoff respawn**: a crashed worker's slot respawns
  after ``fleet_backoff_base_s · 2**(failures-1)`` (capped at
  ``fleet_backoff_max_s``); surviving past the heartbeat timeout resets
  the slot's failure count.  Every unexpected death increments
  ``kmeans_tpu_fleet_restarts_total``.
* **Push-based hot-swap**: the supervisor watches the model registry's
  directory (``utils.checkpoint.latest_step``) and pushes ``RELOAD`` to
  every worker's stdin when a newer generation lands; each worker
  ``load_latest()``s and reports the generation back on its pipe.  A
  failed push (the ``fleet.reload_push`` fault site) retries on the next
  watcher tick.
* **Drain-then-replace**: SIGTERM/SIGINT latch a drain (a second signal
  escalates), then every worker gets ``DRAIN``: it stops accepting,
  finishes in-flight requests, stops its engine after the last batch,
  waits for the card, and exits 0, with SIGKILL only past
  ``fleet_drain_s``.  SIGHUP performs a rolling replace: each slot spawns
  its successor, waits for READY, then drains the predecessor.

On the card the supervisor builds the kernel library (``nvcc`` only, no
card) before the first spawn, so no worker compiles inside its boot grace.

Fault-injection sites: ``fleet.worker_spawn`` (supervisor, before each
spawn), ``fleet.heartbeat`` (worker, before each heartbeat write;
``fleet.heartbeat:kill@2`` is the worker-kill drill) and
``fleet.reload_push`` (supervisor, before each per-worker push).

The supervisor serves no request traffic itself.  With
``ServeConfig.fleet_obs_port`` set it runs the fleet's observability
endpoint (:class:`~kmeans_tpu_torch.obs.fleetview.FleetObsServer`):
``/metrics`` aggregates every live worker's private obs endpoint
(announced as ``obs=`` on ``FLEET_READY``) under a ``worker`` label plus
fleet rollups, with the supervisor's own registry as ``worker="sup"``;
``/api/trace`` serves the merged span spool; ``/readyz`` gates on the
supervisor's SLO monitor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from kmeans_tpu_torch import obs
from kmeans_tpu_torch.config import ServeConfig
from kmeans_tpu_torch.device import resolve_device
from kmeans_tpu_torch.obs import tracing as _tracing
from kmeans_tpu_torch.utils import faults

__all__ = ["FleetSupervisor", "main"]

_FLEET_WORKERS = obs.gauge(
    "kmeans_tpu_fleet_workers",
    "Fleet worker processes by state (starting = spawned, READY line "
    "not yet seen; live = ready with a fresh heartbeat; draining = "
    "DRAIN sent, exit pending) — set by the supervisor's monitor loop",
    labels=("state",),
)
_FLEET_RESTARTS_TOTAL = obs.counter(
    "kmeans_tpu_fleet_restarts_total",
    "Worker respawns after UNEXPECTED deaths (crash, kill, hung "
    "heartbeat) — graceful drains and rolling replaces do not count",
)

#: Environment variable carrying the worker's ServeConfig as JSON (the
#: supervisor serializes, the worker entrypoint deserializes — one
#: config object end to end, no flag re-parsing drift).
_CONFIG_ENV = "KMEANS_TPU_FLEET_CONFIG"

#: Monitor loop cadence: fast enough that pipe-EOF death detection is a
#: negligible slice of the ≤2 s RTO drill gate.
_MONITOR_TICK_S = 0.05

#: Hang budget for a worker that has not yet sent READY.  Boot is
#: dominated by interpreter + import time, not heartbeats, so the
#: heartbeat timeout does not apply until the worker is live — a tight
#: ``fleet_heartbeat_timeout_s`` must not SIGKILL workers mid-import.
#: A worker never compiles the kernels inside it: the supervisor builds
#: the library before the first spawn (:meth:`FleetSupervisor.start`).
_BOOT_GRACE_S = 30.0


def _now() -> float:
    return time.monotonic()


def _kv_line(tag: str, **kv) -> str:
    return tag + "".join(f" {k}={v}" for k, v in kv.items())


def _parse_kv(line: str) -> Dict[str, str]:
    out = {}
    for part in line.split()[1:]:
        k, _, v = part.partition("=")
        out[k] = v
    return out


class _WorkerHandle:
    """Supervisor-side state of one worker slot's current process."""

    def __init__(self, slot: int, proc: subprocess.Popen,
                 incarnation: int):
        self.slot = slot
        self.proc = proc
        self.incarnation = incarnation
        self.state = "starting"        # starting | live | draining | dead
        self.spawned_ts = _now()
        self.ready_ts: Optional[float] = None
        self.last_hb = self.spawned_ts
        self.generation = 0
        self.obs_port: Optional[int] = None  # worker's private obs endpoint
        self.gen_ts: Optional[float] = None
        self.pushed_step = 0           # newest step RELOAD was delivered for
        self.drained = False
        self.eof = False
        self._stdin_lock = threading.Lock()

    def send(self, command: str) -> None:
        """One control line down the worker's stdin (RELOAD / DRAIN).
        Raises on a dead pipe — callers treat that as 'worker dying,
        the monitor will deal with it'."""
        with self._stdin_lock:
            self.proc.stdin.write(command + "\n")
            self.proc.stdin.flush()


class FleetSupervisor:
    """Supervise ``workers`` SO_REUSEPORT server processes.

    ``config`` is the ONE ServeConfig every worker runs (the supervisor
    forces ``reuse_port=True`` into the copy it ships); ``device`` is where
    every worker's assignment engine scores: None is the card, and with no
    card the constructor raises (pass ``device="cpu"`` to run the plain
    versions); each worker gets it as ``--device`` on its command line and
    raises the same way if it finds no card.  ``worker_env``
    optionally adds environment variables to specific slots' FIRST
    incarnation only — the fault-drill hook (a ``fleet.heartbeat:kill@2``
    plan must kill the original worker, not every respawn after it).

    Embedding protocol (tests, loadgen, soak): :meth:`start` /
    :meth:`stop`; the CLI's blocking entry is :meth:`run`, which also
    owns the signal handlers.  ``events`` is an append-only in-memory
    log of ``{"ts", "kind", "slot", ...}`` dicts (spawn / ready / exit /
    reload_detected / reload_push / gen / drained / sigkill) — the
    drills' measurement surface.
    """

    def __init__(self, config: ServeConfig, workers: int = 2, *,
                 device=None,
                 worker_env: Optional[Dict[int, Dict[str, str]]] = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if config.port == 0:
            # Port 0 would give every worker its OWN ephemeral port —
            # the opposite of a fleet.  Callers pick a free port first.
            raise ValueError("a fleet needs a fixed port (port=0 would "
                             "scatter workers across ephemeral ports)")
        self.config = dataclasses.replace(config, reuse_port=True)
        self.device = resolve_device(device)
        self.n_workers = int(workers)
        self.worker_env = dict(worker_env or {})
        self.events: List[dict] = []
        self._events_lock = threading.Lock()
        self._workers: Dict[int, _WorkerHandle] = {}
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._drain_evt = threading.Event()
        self._fails: Dict[int, int] = {}       # slot -> consecutive fails
        self._next_spawn: Dict[int, float] = {}  # slot -> earliest respawn
        self._incarnation: Dict[int, int] = {}
        self._target_step = 0
        self._threads: List[threading.Thread] = []
        self._started = False
        #: The fleet observability pane (``obs.fleetview.FleetObsServer``)
        #: and its SLO monitor — created in :meth:`start` when
        #: ``config.fleet_obs_port`` is not None.
        self.obs_server = None
        self.slo_monitor = None

    # ------------------------------------------------------- observability
    def _obs_targets(self) -> List[tuple]:
        """Live workers' ``(lane, obs_port)`` scrape targets — re-read
        from the worker table on every scrape, so respawns/drains are
        picked up without re-wiring."""
        with self._lock:
            return [(str(slot), h.obs_port)
                    for slot, h in sorted(self._workers.items())
                    if h.state == "live" and h.obs_port
                    and h.proc.poll() is None]

    def _obs_lane_names(self) -> Dict[int, str]:
        """pid -> human lane name for the merged fleet trace."""
        with self._lock:
            return {h.proc.pid: f"worker {slot}"
                    for slot, h in self._workers.items()}

    def _obs_ready(self) -> tuple:
        live = self.live_count()
        return live >= 1, {"role": "supervisor", "live_workers": live,
                           "target_workers": self.n_workers}

    def _start_obs(self) -> None:
        if self.config.fleet_obs_port is None:
            return
        from kmeans_tpu_torch.obs.fleetview import FleetObsServer

        if self.config.slo:
            from kmeans_tpu_torch.obs.slo import SLOMonitor

            # The supervisor's SLO is fed by its per-worker scrape
            # outcomes (FleetObsServer records each scrape's latency
            # and failure), so its /readyz catches slow-but-alive
            # workers the per-request worker SLOs cannot see from
            # outside.
            self.slo_monitor = SLOMonitor(
                latency_target_s=float(self.config.slo_latency_target_s),
                latency_objective=float(self.config.slo_latency_objective),
                availability_objective=float(
                    self.config.slo_availability_objective),
                windows_s=tuple(self.config.slo_windows_s),
                burn_thresholds=tuple(self.config.slo_burn_thresholds),
                min_samples=int(self.config.slo_min_samples),
                eval_s=float(self.config.slo_eval_s),
            )
        self.obs_server = FleetObsServer(
            targets_fn=self._obs_targets,
            host=self.config.host or "127.0.0.1",
            port=int(self.config.fleet_obs_port),
            trace_dir=self.config.trace_dir,
            lane_names_fn=self._obs_lane_names,
            slo=self.slo_monitor,
            ready_fn=self._obs_ready,
        ).start()
        self._event("obs_up", port=self.obs_server.port)

    @property
    def obs_port(self) -> Optional[int]:
        """The fleet observability endpoint's bound port (None when
        disabled via ``fleet_obs_port=None``)."""
        return self.obs_server.port if self.obs_server else None

    # ------------------------------------------------------------ events
    def _event(self, kind: str, slot: Optional[int] = None, **detail):
        ev = {"ts": _now(), "kind": kind, **detail}
        if slot is not None:
            ev["slot"] = slot
        with self._events_lock:
            self.events.append(ev)

    def events_of(self, kind: str) -> List[dict]:
        with self._events_lock:
            return [e for e in self.events if e["kind"] == kind]

    # ----------------------------------------------------------- spawning
    def _worker_cmd(self) -> List[str]:
        # A fresh interpreter, never a fork: no CUDA context crosses into
        # a worker.
        return [sys.executable, "-m", "kmeans_tpu_torch.serve.fleet",
                "--worker", "--device", str(self.device)]

    def _spawn(self, slot: int) -> _WorkerHandle:
        faults.check("fleet.worker_spawn")
        inc = self._incarnation.get(slot, 0) + 1
        self._incarnation[slot] = inc
        env = dict(os.environ)
        # The supervisor's own fault plan must not leak into workers —
        # drills inject worker-side faults via worker_env, scoped to
        # one slot's FIRST incarnation (a kill drill's replacement must
        # come back clean, or it dies the same death forever).
        env.pop("KMEANS_TPU_FAULTS", None)
        if inc == 1 and slot in self.worker_env:
            env.update(self.worker_env[slot])
        env[_CONFIG_ENV] = json.dumps(dataclasses.asdict(self.config))
        with _tracing.span("fleet.spawn", category="fleet", slot=slot,
                           incarnation=inc):
            proc = subprocess.Popen(
                self._worker_cmd(), env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=None, text=True, bufsize=1,
            )
        handle = _WorkerHandle(slot, proc, inc)
        t = threading.Thread(target=self._reader, args=(handle,),
                             daemon=True, name=f"fleet-reader-{slot}")
        t.start()
        self._event("spawn", slot, pid=proc.pid, incarnation=inc)
        return handle

    def _reader(self, h: _WorkerHandle) -> None:
        """Per-worker heartbeat-pipe reader: parses the FLEET_* line
        protocol into handle state.  EOF = the pipe died with the
        process; the monitor turns that into a respawn."""
        try:
            for line in h.proc.stdout:
                line = line.strip()
                if line.startswith("FLEET_HB"):
                    h.last_hb = _now()
                elif line.startswith("FLEET_READY"):
                    kv = _parse_kv(line)
                    h.ready_ts = _now()
                    h.last_hb = h.ready_ts
                    h.generation = int(kv.get("gen", 0))
                    h.obs_port = int(kv.get("obs", 0)) or None
                    if h.state == "starting":
                        h.state = "live"
                    self._event("ready", h.slot, pid=h.proc.pid,
                                generation=h.generation,
                                obs_port=h.obs_port)
                elif line.startswith("FLEET_GEN"):
                    kv = _parse_kv(line)
                    h.generation = int(kv.get("gen", 0))
                    h.gen_ts = _now()
                    h.last_hb = h.gen_ts
                    self._event("gen", h.slot, generation=h.generation)
                elif line.startswith("FLEET_DRAINED"):
                    h.drained = True
                    # unanswered: accepted requests the drain gave up on
                    # (0 unless it ran out of fleet_drain_s).
                    self._event("drained", h.slot, pid=h.proc.pid,
                                unanswered=int(_parse_kv(line).get(
                                    "unanswered", 0)))
        except (OSError, ValueError):
            pass
        finally:
            h.eof = True

    # ------------------------------------------------------------ control
    def start(self) -> None:
        """Spawn the fleet and the monitor + registry-watcher threads."""
        if self._started:
            raise RuntimeError("fleet already started")
        self._started = True
        if self.device.type == "cuda":
            # nvcc only, no card: on a cold cache each worker would
            # otherwise compile for itself inside its boot grace.
            from kmeans_tpu_torch.ops import _build

            built = _build.build()
            self._event("build", seconds=built["seconds"],
                        built=built["built"])
        if self.config.model_dir:
            from kmeans_tpu_torch.utils.checkpoint import latest_step

            self._target_step = latest_step(self.config.model_dir) or 0
        with self._lock:
            for slot in range(self.n_workers):
                self._workers[slot] = self._spawn(slot)
        self._start_obs()
        self._threads = [
            threading.Thread(target=self._monitor_loop, daemon=True,
                             name="fleet-monitor"),
            threading.Thread(target=self._watch_loop, daemon=True,
                             name="fleet-watch"),
        ]
        for t in self._threads:
            t.start()

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Block until every slot's worker has sent READY (drills wait
        on this before opening load)."""
        deadline = _now() + timeout
        while _now() < deadline:
            with self._lock:
                handles = list(self._workers.values())
            if (len(handles) == self.n_workers
                    and all(h.ready_ts is not None for h in handles)):
                return True
            time.sleep(0.02)
        return False

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for h in self._workers.values()
                       if h.state == "live" and h.proc.poll() is None)

    def worker_generations(self) -> Dict[int, int]:
        """slot -> newest generation that worker reported serving (the
        fleet-wide consistency drill's measurement)."""
        with self._lock:
            return {s: h.generation for s, h in self._workers.items()}

    # ------------------------------------------------------------ monitor
    def _monitor_loop(self) -> None:
        timeout = float(self.config.fleet_heartbeat_timeout_s)
        while not self._stop_evt.is_set():
            now = _now()
            with self._lock:
                handles = dict(self._workers)
            counts = {"starting": 0, "live": 0, "draining": 0}
            for slot, h in handles.items():
                exited = h.proc.poll() is not None
                hung = (
                    (h.state == "live" and now - h.last_hb > timeout)
                    or (h.state == "starting"
                        and now - h.spawned_ts > _BOOT_GRACE_S))
                if hung and not exited:
                    # A silent worker is dead by contract — SIGKILL it
                    # so the slot can respawn (its listener would
                    # otherwise keep absorbing kernel-balanced
                    # connections it never answers).
                    self._event("sigkill", slot, pid=h.proc.pid,
                                reason="heartbeat_timeout")
                    h.proc.kill()
                    exited = True
                if exited:
                    if h.state != "dead":
                        h.state = "dead"
                        self._event(
                            "exit", slot, pid=h.proc.pid,
                            returncode=h.proc.poll(),
                            drained=h.drained,
                            incarnation=h.incarnation)
                        if not (h.drained or self._drain_evt.is_set()):
                            fails = self._fails.get(slot, 0) + 1
                            self._fails[slot] = fails
                            delay = min(
                                float(self.config.fleet_backoff_base_s)
                                * (2.0 ** (fails - 1)),
                                float(self.config.fleet_backoff_max_s))
                            self._next_spawn[slot] = now + delay
                            _FLEET_RESTARTS_TOTAL.inc()
                    if (not self._drain_evt.is_set()
                            and slot in self._next_spawn
                            and now >= self._next_spawn[slot]):
                        del self._next_spawn[slot]
                        with self._lock:
                            self._workers[slot] = self._spawn(slot)
                        self._event("respawn", slot)
                    continue
                if (h.state == "live" and self._fails.get(slot)
                        and now - h.spawned_ts > timeout):
                    # Survived a full timeout window: the crash streak
                    # is over, respawns go back to the base backoff.
                    self._fails[slot] = 0
                counts[h.state] = counts.get(h.state, 0) + 1
            for state, n in counts.items():
                _FLEET_WORKERS.labels(state=state).set(n)
            self._stop_evt.wait(_MONITOR_TICK_S)

    # ------------------------------------------------------- reload push
    def _watch_loop(self) -> None:
        """Watch the model dir for newer persisted generations and push
        RELOAD to every worker that hasn't been told yet.  Per-worker
        delivery state means a failed push (the ``fleet.reload_push``
        site, or a worker mid-respawn) retries next tick instead of
        being lost — a worker can LAG a swap by a tick, never miss it."""
        if not self.config.model_dir:
            return
        from kmeans_tpu_torch.utils.checkpoint import latest_step

        poll_s = max(0.01, float(self.config.fleet_reload_poll_s))
        while not self._stop_evt.is_set():
            try:
                step = latest_step(self.config.model_dir) or 0
            except OSError:
                step = 0
            if step > self._target_step:
                self._target_step = step
                self._event("reload_detected", step=step)
            if self._target_step:
                self._push_reload(self._target_step)
            self._stop_evt.wait(poll_s)

    def _push_reload(self, step: int) -> None:
        with self._lock:
            handles = [h for h in self._workers.values()
                       if h.state == "live" and h.pushed_step < step]
        for h in handles:
            try:
                faults.check("fleet.reload_push")
                with _tracing.span("fleet.reload_push", category="fleet",
                                   slot=h.slot, step=step):
                    h.send("RELOAD")
                h.pushed_step = step
                self._event("reload_push", h.slot, step=step)
            except OSError:
                # Dead pipe or injected fault: the worker is dying (the
                # monitor owns that) or the push is being drilled —
                # either way the per-worker pushed_step stays behind
                # and the next watcher tick retries.
                pass

    def notify_publish(self, step: Optional[int] = None) -> None:
        """Push-path entry for an IN-PROCESS publisher (a continuous
        pipeline embedded next to the supervisor): bump the target step
        without waiting a watcher tick.  Cross-process publishers are
        covered by the disk watcher."""
        if step is not None:
            self._target_step = max(self._target_step, int(step))
        elif self.config.model_dir:
            from kmeans_tpu_torch.utils.checkpoint import latest_step

            self._target_step = max(
                self._target_step,
                latest_step(self.config.model_dir) or 0)
        if self._target_step:
            self._push_reload(self._target_step)

    # -------------------------------------------------------------- drain
    def _drain_worker(self, h: _WorkerHandle) -> None:
        h.state = "draining"
        try:
            h.send("DRAIN")
        except (OSError, ValueError):
            pass                      # already dying; monitor cleans up

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful fleet shutdown: DRAIN every worker, wait for clean
        exits, SIGKILL stragglers past the budget.  Returns True when
        every worker exited by itself (the zero-drop path)."""
        self._drain_evt.set()
        budget = (float(self.config.fleet_drain_s) if timeout is None
                  else float(timeout))
        with self._lock:
            handles = list(self._workers.values())
        with _tracing.span("fleet.drain", category="fleet",
                           workers=len(handles)):
            for h in handles:
                if h.proc.poll() is None:
                    self._drain_worker(h)
            deadline = _now() + budget
            clean = True
            for h in handles:
                left = max(0.0, deadline - _now())
                try:
                    h.proc.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    clean = False
                    self._event("sigkill", h.slot, pid=h.proc.pid,
                                reason="drain_timeout")
                    h.proc.kill()
                    h.proc.wait()
        return clean

    def rolling_replace(self) -> None:
        """SIGHUP semantics: one slot at a time, spawn the successor,
        wait until it is READY (both listeners coexist under
        SO_REUSEPORT), then drain the predecessor — a restart with zero
        downtime and zero graceful drops."""
        for slot in range(self.n_workers):
            with self._lock:
                old = self._workers.get(slot)
            new = self._spawn(slot)
            deadline = _now() + 30.0
            while new.ready_ts is None and new.proc.poll() is None \
                    and _now() < deadline:
                time.sleep(0.02)
            with self._lock:
                self._workers[slot] = new
            self._event("rolled", slot, pid=new.proc.pid)
            if old is not None and old.proc.poll() is None:
                self._drain_worker(old)
                try:
                    old.proc.wait(
                        timeout=float(self.config.fleet_drain_s))
                except subprocess.TimeoutExpired:
                    self._event("sigkill", slot, pid=old.proc.pid,
                                reason="drain_timeout")
                    old.proc.kill()
                    old.proc.wait()

    def stop(self, *, graceful: bool = True) -> bool:
        """Tear the fleet down.  ``graceful`` drains first (zero
        in-flight drops); False is the hard path (tests of the crash
        machinery)."""
        clean = True
        if graceful:
            clean = self.drain()
        self._drain_evt.set()
        self._stop_evt.set()
        if self.obs_server is not None:
            self.obs_server.stop()
            self.obs_server = None
        with self._lock:
            handles = list(self._workers.values())
        for h in handles:
            if h.proc.poll() is None:
                h.proc.kill()
                h.proc.wait()
            try:
                h.proc.stdin.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        return clean

    # ----------------------------------------------------------- blocking
    def run(self) -> int:
        """The CLI's blocking entry: start, install the signal
        handlers (main thread only), supervise
        until SIGTERM/SIGINT, drain, exit.  SIGHUP = rolling replace."""
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("FleetSupervisor.run() must own the main "
                               "thread (signal handlers)")
        hup_evt = threading.Event()

        def _term(signum, frame):
            if self._drain_evt.is_set():
                # Second signal: the operator means NOW.
                raise KeyboardInterrupt
            self._drain_evt.set()

        def _hup(signum, frame):
            hup_evt.set()

        prev = {
            signal.SIGTERM: signal.signal(signal.SIGTERM, _term),
            signal.SIGINT: signal.signal(signal.SIGINT, _term),
            signal.SIGHUP: signal.signal(signal.SIGHUP, _hup),
        }
        try:
            self.start()
            while not self._drain_evt.is_set():
                if hup_evt.is_set():
                    hup_evt.clear()
                    self.rolling_replace()
                time.sleep(0.1)
            return 0 if self.stop(graceful=True) else 1
        finally:
            for sig, handler in prev.items():
                signal.signal(sig, handler)


# ---------------------------------------------------------------------------
# Worker entrypoint: ``python -m kmeans_tpu_torch.serve.fleet --worker
# --device DEV`` with the ServeConfig in $KMEANS_TPU_FLEET_CONFIG.  The
# server itself is the stock KMeansServer — the fleet changes NOTHING about
# request handling.
# ---------------------------------------------------------------------------

def _worker_main(device: str) -> int:
    cfg_json = os.environ.get(_CONFIG_ENV)
    if not cfg_json:
        print(f"error: {_CONFIG_ENV} not set (the fleet supervisor "
              "spawns workers; this is not a user entrypoint)",
              file=sys.stderr)
        return 2
    cfg_dict = json.loads(cfg_json)
    cfg_dict["tenant_classes"] = tuple(
        tuple(t) for t in cfg_dict.get("tenant_classes") or ())
    # dataclasses.asdict turned the tuple knobs into JSON lists;
    # restore the tuples the dataclass declares.
    for knob in ("slo_windows_s", "slo_burn_thresholds"):
        if cfg_dict.get(knob) is not None:
            cfg_dict[knob] = tuple(cfg_dict[knob])
    config = ServeConfig(**cfg_dict)

    from kmeans_tpu_torch.serve.server import KMeansServer

    # No card under a CUDA device raises here: the worker exits non-zero.
    server = KMeansServer(config, device=device)
    server.start(background=True)

    # The private per-worker obs endpoint: the serving port is shared
    # (SO_REUSEPORT), so the supervisor needs a per-process address to
    # scrape.  Ephemeral port, announced on the FLEET_READY line.
    obs_srv = None
    if config.fleet_obs_port is not None:
        from kmeans_tpu_torch.obs.fleetview import WorkerObsServer

        try:
            obs_srv = WorkerObsServer().start()
        except OSError as e:      # pragma: no cover - bind exhaustion
            print(f"fleet worker: obs endpoint failed: {e}",
                  file=sys.stderr)

    drain_evt = threading.Event()
    # SIGTERM only latches the drain: a serving worker's safe boundary
    # is "after in-flight requests finish".
    signal.signal(signal.SIGTERM, lambda s, f: drain_evt.set())

    out = sys.stdout
    out_lock = threading.Lock()

    def emit(tag: str, **kv) -> None:
        try:
            with out_lock:
                print(_kv_line(tag, **kv), file=out, flush=True)
        except OSError:
            # The heartbeat pipe's read end is gone — the supervisor
            # died or dropped us.  An orphan listener on the shared
            # port would silently absorb traffic, so drain instead.
            drain_evt.set()

    commands: "queue.Queue[str]" = queue.Queue()

    def _stdin_reader() -> None:
        for line in sys.stdin:
            commands.put(line.strip())
        commands.put("DRAIN")          # supervisor died: drain, don't orphan

    threading.Thread(target=_stdin_reader, daemon=True,
                     name="fleet-stdin").start()

    def _gen() -> int:
        g = server.current_model()
        return g.generation if g is not None else 0

    emit("FLEET_READY", pid=os.getpid(), port=config.port, gen=_gen(),
         obs=obs_srv.port if obs_srv is not None else 0)
    hb_s = max(0.01, float(config.fleet_heartbeat_s))
    next_hb = time.monotonic() + hb_s
    while not drain_evt.is_set():
        try:
            cmd = commands.get(timeout=max(0.01,
                                           next_hb - time.monotonic()))
        except queue.Empty:
            cmd = None
        if cmd == "DRAIN":
            break
        if cmd == "RELOAD" and server.model_registry is not None:
            try:
                server.model_registry.load_latest()
            except Exception as e:
                # A torn/corrupt checkpoint mid-watch: keep serving the
                # generation we have (the registry contract — disk is
                # never behind memory, so current() stays valid) and
                # tell the operator; the next publish retries.
                print(f"fleet worker: reload failed: {e}",
                      file=sys.stderr)
            emit("FLEET_GEN", gen=_gen(), ts=round(time.time(), 6))
        if time.monotonic() >= next_hb:
            # The kill-drill site: fleet.heartbeat:kill@2 ends the
            # process HERE, at its second heartbeat — deterministically
            # mid-load, exactly like a preempted host.
            faults.check("fleet.heartbeat")
            emit("FLEET_HB", ts=round(time.time(), 6), gen=_gen())
            next_hb = time.monotonic() + hb_s
    # Graceful drain: stop accepting (the kernel reroutes new
    # connections to the surviving listeners), let in-flight handlers
    # finish, stop the engine after its last batch, wait for the card,
    # then report and exit 0.
    server.stop()
    if server.device.type == "cuda":
        import torch

        torch.cuda.synchronize(server.device)
    if obs_srv is not None:
        obs_srv.stop()
    emit("FLEET_DRAINED", ts=round(time.time(), 6),
         unanswered=server.drain_unanswered)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--worker" in argv:
        i = argv.index("--device") + 1 if "--device" in argv else 0
        return _worker_main(argv[i] if 0 < i < len(argv) else "cuda")
    print("usage: python -m kmeans_tpu_torch.serve.fleet --worker "
          "[--device DEV]  (spawned by FleetSupervisor; use `python -m "
          "kmeans_tpu_torch.cli serve --workers N` to run a fleet)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
