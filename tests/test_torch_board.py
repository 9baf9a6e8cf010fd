"""The port's board (rooms, SSE, persistence, ``autoAssign``, the ``train``
op) against the JAX package's, on the CPU.

Mirrors the board tests of ``tests/test_server.py`` and the
``auto_assign`` tests of ``tests/test_bridge.py``.

* Parity: a reference and a port server run on port 0 over one
  ``persist_dir``; the same request to both gets the same status, the same
  presence of ``Retry-After``, the same content type (and
  ``Content-Disposition``) and the same body, every op and error
  included, with the generated card and centroid ids mapped between the
  two (first appearance order) and the train op's ``run_id`` /
  ``trace_id`` left out.  Each room's shuffle generator is seeded alike.
* A room saved by either package revives in the other with the same
  ``/api/state`` bytes; a port server killed with SIGKILL revives in both.
* ``auto_assign``'s write-back equals the reference's when the port's
  k-means++ draws are replayed through the reference as ``init=`` (board
  positions as features: tie-free).
* The ``train`` op's families run on the port (``lloyd`` streams an event
  an iteration, with live centroids at d = 2), fuzzy, gmm, balanced and
  the pairwise kmedoids, kernel and spectral among them, with the
  reference's work caps (balanced; kmedoids and kernel: n ≤ 20,000 and
  n²·d·max_iter ≤ 8e10) and its answers to a bad shape.
* ``stop()`` ends the SSE streams and returns promptly.

The port runs with ``device="cpu"``.  Every server is stopped in teardown,
every socket read has a timeout, and no test sleeps except to poll.
"""

import dataclasses
import http.client
import json
import os
import queue
import random
import re
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
import torch

from kmeans_tpu.config import ServeConfig as RefServeConfig
from kmeans_tpu.serve.server import KMeansServer as RefServer
from kmeans_tpu_torch.config import MODES, ServeConfig, zone_min_height_px
from kmeans_tpu_torch.data.synthetic import generator_for
from kmeans_tpu_torch.models.init import init_centroids
from kmeans_tpu_torch.serve import server as port_server
from kmeans_tpu_torch.serve.server import KMeansServer
from kmeans_tpu_torch.session import (Document, auto_assign, export_json,
                                      populate_test_data)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Seconds any one HTTP call, socket read or train job may take.
WAIT_S = 20.0
SIDES = ["ref", "port"]
_ID = re.compile(r"\b(?:card|c):\d{10,}-[0-9a-f]{6}\b")


def _start(side, **kw):
    if side == "ref":
        s = RefServer(dataclasses.replace(RefServeConfig(port=0, tracing=False),
                                          **kw))
    else:
        s = KMeansServer(dataclasses.replace(ServeConfig(port=0,
                                                         tracing=False),
                                             **kw), device="cpu")
    s.base = f"http://127.0.0.1:{s.start().server_address[1]}"
    return s


@pytest.fixture()
def servers():
    """``start(side, **config)`` -> a started server; all stopped after."""
    started = []

    def start(side, **kw):
        s = _start(side, **kw)
        started.append(s)
        return s

    yield start
    for s in started:
        s.stop()


@pytest.fixture()
def pair(servers, tmp_path):
    """A reference and a port server over one persist_dir."""
    d = str(tmp_path / "rooms")
    return [servers(side, persist_dir=d, persist_debounce_s=0.05)
            for side in SIDES]


def _call(base, path, data=None, ctype="application/json", headers=None,
          method=None):
    """``(status, headers, body bytes)`` of one request."""
    hdrs = dict(headers or {})
    if data is not None:
        hdrs["Content-Type"] = ctype
    req = urllib.request.Request(base + path, data=data, headers=hdrs,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(base, path, obj):
    st, _, body = _call(base, path, json.dumps(obj).encode())
    return st, json.loads(body)


def _mutate(base, room, op, args=None):
    return _post(base, f"/api/mutate?room={room}", {"op": op,
                                                    "args": args or {}})


def _norm(body, ctype):
    """A JSON body with the generated ids numbered by first appearance and
    the per-run ids left out; any other body as bytes."""
    if not (ctype or "").startswith("application/json"):
        return body
    seen = {}
    text = _ID.sub(lambda m: seen.setdefault(m.group(0), f"<id{len(seen)}>"),
                   body.decode())
    obj = json.loads(text)
    if isinstance(obj, dict):
        obj.pop("run_id", None)
        obj.pop("trace_id", None)
    return obj


def _same(pair, method, path, data=None, ctype="application/json",
          headers=None):
    """The request on both servers (``data`` may be a function of the
    side's index); asserts the same answer and returns both parsed
    bodies."""
    out = []
    for i, s in enumerate(pair):
        body = data(i) if callable(data) else data
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        out.append(_call(s.base, path, body, ctype, headers, method))
    (rs, rh, rb), (ps, ph, pb) = out
    what = (method, path, rb[:300], pb[:300])
    assert rs == ps, what
    assert rh.get("Content-Type") == ph.get("Content-Type"), what
    assert ("Retry-After" in rh) == ("Retry-After" in ph), what
    assert rh.get("Content-Disposition") == ph.get("Content-Disposition")
    assert _norm(rb, rh.get("Content-Type")) == \
        _norm(pb, ph.get("Content-Type")), what
    return [json.loads(b) if h.get("Content-Type", "").startswith(
        "application/json") else b for _, h, b in out]


def _step(pair, room, op, args=None):
    """One mutate op on both, then the room's state and export on both."""
    out = _same(pair, "POST", f"/api/mutate?room={room}",
                lambda i: {"op": op, "args": args(i) if callable(args)
                           else (args or {})})
    _same(pair, "GET", f"/api/state?room={room}")
    _same(pair, "GET", f"/api/export?room={room}")
    return out


def _seed_rooms(pair, room, seed=5):
    for s in pair:
        s.room(room).doc._rng = random.Random(seed)


# ---------------------------------------------------------------------------
# Parity: the same request, the same answer
# ---------------------------------------------------------------------------

def test_every_op_and_error_gets_the_references_answer(pair):
    room = "PAR1"
    _seed_rooms(pair, room)
    _same(pair, "GET", f"/api/state?room={room}")
    _step(pair, room, "populate")
    ids = [[], []]
    for name in ("Sweet", "", "Third"):
        out = _step(pair, room, "addCentroid", {"name": name})
        for i in (0, 1):
            ids[i].append(out[i]["id"])
    _step(pair, room, "addCentroid")                           # 409, cap
    _step(pair, room, "renameCentroid",
          lambda i: {"id": ids[i][0], "name": "Zesty"})
    _step(pair, room, "assign", lambda i: {
        "id": "seed:t1", "centroid": ids[i][0], "pos": {"x": 0.5, "y": 0.5}})
    _step(pair, room, "setIteration", {"iteration": 1})
    _step(pair, room, "assign", lambda i: {"id": "seed:t10",
                                           "centroid": ids[i][0]})
    _step(pair, room, "setLocked", lambda i: {"id": ids[i][1],
                                              "locked": True})
    _step(pair, room, "assign", lambda i: {"id": "seed:t2",
                                           "centroid": ids[i][1]})
    _step(pair, room, "setPos", {"id": "seed:t1", "x": 0.3, "y": 2.0})
    added = _step(pair, room, "addCard", {"title": "Eve", "traitA": "Kiwi",
                                          "traitB": "Sour", "by": "Ada"})
    _step(pair, room, "addCard", {"title": "  "})             # 400
    _step(pair, room, "deleteCard", lambda i: {"id": added[i]["id"]})
    _step(pair, room, "shuffleUnassigned")
    _step(pair, room, "setMode", {"mode": "playtest"})
    _step(pair, room, "hello", {"name": "Ada"})
    _same(pair, "POST", f"/api/hello?room={room}", {"name": "Bob"})
    _step(pair, room, "removeCentroid", lambda i: {"id": ids[i][2]})
    _step(pair, room, "removeCentroid")                        # KeyError
    _step(pair, room, "frobnicate")
    _same(pair, "POST", f"/api/mutate?room={room}", b"{nope")
    _step(pair, room, "autoAssign", {"outliers": -1})
    for args in ({"n": 2, "k": 10}, {"model": "dbscan"},
                 {"init": "spectral"}, {"trim_fraction": 0.3},
                 {"model": "trimmed", "trim_fraction": 1.5},
                 {"n": 100_000, "d": 512}):
        _step(pair, room, "train", args)
    _step(pair, room, "setIteration", {"iteration": 2})
    _step(pair, room, "restartAll")
    _step(pair, room, "hardReset", {"mode": "custom"})
    for path in ("/healthz", "/nope", "/api/state?room=bad%20code!!"):
        _same(pair, "GET", path)


def test_auto_assign_answers_alike_where_the_fit_is_forced(pair):
    """One open zone (the other locked): every unlocked card lands in it,
    whatever the draws, and an empty locked zone gives an infinite balance
    ratio, sent as JSON null (the reference's two HTTP tests)."""
    room = "AUTO"
    _seed_rooms(pair, room)
    _step(pair, room, "populate")
    ids = [[], []]
    for name in ("Frozen", "Open"):
        out = _step(pair, room, "addCentroid", {"name": name})
        for i in (0, 1):
            ids[i].append(out[i]["id"])
    _step(pair, room, "setLocked", lambda i: {"id": ids[i][0],
                                              "locked": True})
    out = _step(pair, room, "autoAssign")
    assert out[1]["metrics"]["balance"]["ratio"] is None
    state = json.loads(_call(pair[1].base, f"/api/state?room={room}")[2])
    assert state["metrics"]["counts"][ids[1][0]] == 0
    assert state["metrics"]["counts"][ids[1][1]] == 12


def test_export_import_round_trip_and_its_errors(pair):
    room = "FFFF"
    _seed_rooms(pair, room)
    _step(pair, room, "populate")
    _step(pair, room, "addCentroid", {"name": "Zesty"})
    exported = _same(pair, "GET", f"/api/export?room={room}")
    assert {c["id"] for c in exported[1]["cards"]} >= {"seed:t1", "seed:t11"}
    _same(pair, "POST", "/api/import?room=GGGG",
          lambda i: json.dumps(exported[i]).encode())
    st = _same(pair, "GET", "/api/state?room=GGGG")[1]
    assert st["centroids"][0]["name"] == "Zesty"
    # The client's restore-from-cache: a cached /api/state payload imports.
    _same(pair, "POST", "/api/import?room=FRSH", lambda i: {
        k: st[k] for k in ("cards", "centroids", "meta")})
    for raw in (b"[1, 2]", b'{"cards": ["x"], "centroids": [], "meta": {}}',
                b"{torn", b""):
        _same(pair, "POST", "/api/import?room=KKKK", raw)
    n = pair[1].config.max_render_cards + 1
    cards = [{"id": f"card:{i}", "title": f"c{i}", "traits": ["a", "b"],
              "assignedTo": None, "createdBy": "t"} for i in range(n)]
    out = _same(pair, "POST", "/api/import?room=KKKK",
                {"cards": cards, "centroids": [], "meta": {}})
    assert str(n - 1) in out[1]["error"]
    _same(pair, "GET", "/api/state?room=KKKK")


def _raw_post(base, path, body=None, length=None):
    """``(status, body)`` of a POST sent on a raw connection: a body over
    the cap (the server answers 413 from the headers and closes), or a
    forged Content-Length."""
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT_S)
    try:
        try:
            conn.putrequest("POST", path)
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length",
                           str(len(body) if length is None else length))
            conn.endheaders()
            if body:
                conn.send(body)
        except (BrokenPipeError, ConnectionResetError):
            pass
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_oversized_and_forged_bodies(pair):
    cap = pair[1].config.max_import_bytes
    cases = [("/api/import?room=AAAA",
              b'{"cards": [' + b" " * (cap + 1) + b"]}", None),
             ("/api/mutate?room=AAAA",
              b'{"op": "' + b"x" * (cap + 1) + b'"}', None),
             ("/api/mutate?room=AAAA", None, -1)]
    for path, body, length in cases:
        got = [_raw_post(s.base, path, body, length) for s in pair]
        assert got[0] == got[1], got
        assert got[1][0] == (400 if length == -1 else 413)
    _same(pair, "GET", "/api/state?room=AAAA")


def test_static_files_are_the_references_bytes(pair):
    ref_dir = os.path.join(REPO, "kmeans_tpu", "serve", "static")
    for name in ("index.html", "app.js"):
        mine = (port_server._STATIC / name).read_bytes()
        assert mine == open(os.path.join(ref_dir, name), "rb").read()
    for path in ("/", "/index.html", "/app.js"):
        body = _same(pair, "GET", path)[1]
        assert body == (port_server._STATIC / (
            "app.js" if path == "/app.js" else "index.html")).read_bytes()
    _, headers, _ = _call(pair[1].base, "/")
    assert headers["X-Frame-Options"] == "DENY"
    assert "frame-ancestors 'none'" in headers["Content-Security-Policy"]


def test_board_constants_are_the_references():
    from kmeans_tpu import config as ref_config

    assert MODES == ref_config.MODES
    for n in (0, 1, 2, 5, 40):
        assert zone_min_height_px(n) == ref_config.zone_min_height_px(n)


# ---------------------------------------------------------------------------
# SSE: hello, change events, ids, Last-Event-ID replay
# ---------------------------------------------------------------------------

class _Stream:
    """A raw-socket SSE subscription (urllib buffers a stream forever)."""

    def __init__(self, base, room, last_event_id=None, header=False):
        host, port = base.replace("http://", "").split(":")
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=WAIT_S)
        q = f"/api/events?room={room}"
        extra = ""
        if last_event_id is not None and header:
            extra = f"Last-Event-ID: {last_event_id}\r\n"
        elif last_event_id is not None:
            q += f"&lastEventId={last_event_id}"
        self.sock.sendall(f"GET {q} HTTP/1.1\r\nHost: {host}\r\n"
                          f"Accept: text/event-stream\r\n{extra}\r\n"
                          .encode())
        self.buf = b""
        head = self._until(b"\r\n\r\n")
        self.headers = head.decode()

    def _until(self, mark):
        while mark not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError("stream closed")
            self.buf += chunk
        out, self.buf = self.buf.split(mark, 1)
        return out

    def frame(self):
        """The next frame's lines (an event or a comment)."""
        return self._until(b"\n\n").decode().split("\n")

    def event(self):
        """``(id or None, data)`` of the next data frame."""
        while True:
            lines = self.frame()
            data = [ln[6:] for ln in lines if ln.startswith("data: ")]
            if data:
                ids = [ln[4:] for ln in lines if ln.startswith("id: ")]
                return (int(ids[0]) if ids else None), json.loads(data[0])

    def closed(self):
        """Whether the server closed the stream (EOF) within WAIT_S."""
        try:
            while self.sock.recv(65536):
                pass
            return True
        except OSError:
            return False

    def close(self):
        self.sock.close()


def test_sse_hello_change_and_replay_equal_the_references(pair):
    streams = [_Stream(s.base, "SSE1") for s in pair]
    heads = [sorted(h for h in st.headers.split("\r\n")[1:]
                    if not h.startswith(("Date", "Server", "X-Trace-Id")))
             for st in streams]
    assert heads[0] == heads[1]
    assert streams[1].headers.split("\r\n")[0] == "HTTP/1.1 200 OK"
    got = []
    for st, s in zip(streams, pair):
        first = st.event()
        s.room("SSE1").broadcast_event({"type": "train", "iteration": 1})
        _mutate(s.base, "SSE1", "addCentroid")
        got.append([first, st.event(), st.event()])
        st.close()
    assert got[0] == got[1]
    assert got[1][0] == (None, {"type": "hello", "version": 1, "peers": 0})
    assert got[1][2][1]["type"] == "change" and got[1][2][0] == 2
    for s in pair:
        for i in (3, 4):
            s.room("SSE1").broadcast_event({"type": "train", "iteration": i})
    # A closed stream stays subscribed until a write to it fails (here at
    # event 3 or 4, else at the idle keepalive), and the hello counts it
    # as a peer: wait until both rooms have dropped the first streams, and
    # hold each replay stream open, so that every hello counts live
    # streams only.
    deadline = time.monotonic() + WAIT_S
    while any(s.room("SSE1").peer_count() for s in pair):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    held = []
    for header in (False, True):
        replay = []
        for s in pair:
            st = _Stream(s.base, "SSE1", last_event_id=2, header=header)
            replay.append([st.event() for _ in range(3)])
            held.append(st)
        assert replay[0] == replay[1]
        assert [e[0] for e in replay[1]] == [None, 3, 4]
        assert replay[1][0][1]["peers"] == int(header)
        assert replay[1][2][1] == {"type": "train", "iteration": 4}
    for st in held:
        st.close()


def test_sse_keepalive_on_an_idle_stream(servers, monkeypatch):
    monkeypatch.setattr(port_server, "_SSE_IDLE_S", 0.05)
    s = servers("port")
    st = _Stream(s.base, "KEEP")
    try:
        assert st.event()[1]["type"] == "hello"
        frames = [st.frame() for _ in range(3)]
        assert frames[0] == [": keepalive"] and frames[1] == [": keepalive"]
        ping = json.loads(frames[2][0][6:])
        assert ping == {"type": "ping", "version": 1, "peers": 0}
    finally:
        st.close()


def test_slow_subscribers_stay_live_and_leave_no_thread(servers):
    """Subscribers that stop reading while a burst overflows their queues
    stay live (a later change reaches each), and their threads go when
    they disconnect (the reference's soak test, smaller)."""
    s = servers("port")
    before = threading.active_count()
    streams = [_Stream(s.base, "SOAK") for _ in range(4)]
    for st in streams:
        st.event()
    assert s.room("SOAK").peer_count() == 4
    for i in range(80):
        _mutate(s.base, "SOAK", "addCard", {"title": f"card {i}"})
    _mutate(s.base, "SOAK", "addCentroid")
    version = s.room("SOAK").doc.version
    for st in streams:
        while True:
            _, ev = st.event()
            if ev.get("version") == version:
                break
        st.close()
    deadline = time.monotonic() + WAIT_S
    while s.room("SOAK").peer_count() or \
            threading.active_count() > before + 1:
        assert time.monotonic() < deadline
        _mutate(s.base, "SOAK", "addCard", {"title": "nudge"})
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# The room table and the capacity 503s
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_room_table_is_bounded(side):
    cls, cfg = ((RefServer, RefServeConfig) if side == "ref"
                else (lambda c: KMeansServer(c, device="cpu"), ServeConfig))
    s = cls(cfg(port=0))
    for i in range(port_server._MAX_ROOMS):
        s.room(f"R{i}")
    s.room("FRESH")
    assert len(s.rooms) == port_server._MAX_ROOMS
    assert "FRESH" in s.rooms and "R0" not in s.rooms
    assert s.room("ab c!").code == "ABC"


def test_full_table_and_train_slots_answer_503_alike(pair):
    for s in pair:
        for i in range(port_server._MAX_ROOMS):
            s.room(f"T{i}").subscribers[-1] = queue.Queue()
    try:
        out = _same(pair, "POST", "/api/hello?room=ZFUL", {"name": "Ada"})
        assert "room table full" in out[1]["error"]
        _same(pair, "GET", "/api/state?room=ZFUL")
    finally:
        for s in pair:
            for r in list(s.rooms.values()):
                r.subscribers.pop(-1, None)
    for s in pair:
        for _ in range(s.config.max_concurrent_train):
            assert s._train_sem.acquire(blocking=False)
    try:
        out = _same(pair, "POST", "/api/mutate?room=CAPA",
                    {"op": "train", "args": {"n": 100, "d": 2, "k": 2}})
        assert "capacity" in out[1]["error"]
        st, hdrs, _ = _call(pair[1].base, "/api/mutate?room=CAPA",
                            b'{"op": "train"}')
        assert st == 503
        lo = int(pair[1].config.retry_after_s)
        assert lo <= int(hdrs["Retry-After"]) <= lo + int(
            pair[1].config.retry_after_jitter_s)
    finally:
        for s in pair:
            for _ in range(s.config.max_concurrent_train):
                s._train_sem.release()


# ---------------------------------------------------------------------------
# Persistence across packages and across a kill -9
# ---------------------------------------------------------------------------

def _wait_for(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.02)


def _board(base, room):
    for op, args in (("populate", {}), ("addCentroid", {"name": "Z1"}),
                     ("addCard", {"title": "Alice", "traitA": "Mint"}),
                     ("setIteration", {"iteration": 1})):
        assert _mutate(base, room, op, args)[0] == 200
    _, cid = _mutate(base, room, "addCentroid", {"name": "Z2"})
    _mutate(base, room, "assign", {"id": "seed:t3", "centroid": cid["id"],
                                   "pos": {"x": 0.4, "y": 0.6}})


@pytest.mark.parametrize("saver", SIDES)
def test_a_room_saved_by_either_revives_in_the_other(saver, tmp_path):
    d = str(tmp_path / "rooms")
    s = _start(saver, persist_dir=d, persist_debounce_s=30.0)
    try:
        _board(s.base, "DURA")
    finally:
        s.stop()                      # the pending save is flushed here
    saved = json.loads(open(os.path.join(d, "DURA.json")).read())
    assert {c["title"] for c in saved["cards"]} >= {"Alice", "Jessica"}
    bodies = []
    for side in SIDES:
        s = _start(side, persist_dir=d)
        try:
            assert "DURA" in s.rooms          # loaded at boot
            bodies.append(_call(s.base, "/api/state?room=DURA")[2])
        finally:
            s.stop()
    assert bodies[0] == bodies[1]
    st = json.loads(bodies[1])
    assert st["persisted"] is True and len(st["centroids"]) == 2


def test_evicted_room_revives_from_disk_not_fresh(servers, tmp_path):
    s = servers("port", persist_dir=str(tmp_path), persist_debounce_s=0.0)
    path = tmp_path / "EVIC.json"
    _mutate(s.base, "EVIC", "addCard", {"title": "Carol"})
    _wait_for(lambda: path.exists() and "Carol" in path.read_text())
    del s.rooms["EVIC"]
    st = json.loads(_call(s.base, "/api/state?room=EVIC")[2])
    assert {c["title"] for c in st["cards"]} >= {"Carol", "Jessica"}
    _mutate(s.base, "EVIC", "addCard", {"title": "Dan"})
    _wait_for(lambda: "Dan" in path.read_text()
              and "Carol" in path.read_text())


_WORKER = (
    "import sys\n"
    "from kmeans_tpu_torch.config import ServeConfig\n"
    "from kmeans_tpu_torch.serve.server import KMeansServer\n"
    "s = KMeansServer(ServeConfig(port=0, persist_dir=sys.argv[1],\n"
    "                             persist_debounce_s=0.05), device='cpu')\n"
    "print(s.start().server_address[1], flush=True)\n"
    "sys.stdin.read()\n"
)


def test_room_survives_kill_dash_nine(tmp_path):
    """SIGKILL a port server process mid-session: once the debounce has
    passed, the board revives in either package as it was (the document
    version counts anew in the new process)."""
    d = str(tmp_path / "rooms")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen([sys.executable, "-c", _WORKER, d], cwd=REPO,
                         env=env, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{int(p.stdout.readline())}"
        _board(base, "KILL")
        before = json.loads(_call(base, "/api/state?room=KILL")[2])
        path = os.path.join(d, "KILL.json")
        _wait_for(lambda: os.path.exists(path) and "seed:t3" in
                  open(path).read() and '"iteration": 1' in open(path).read())
        time.sleep(0.2)               # past the debounce of the last bump
    finally:
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=WAIT_S)
    before.pop("version")
    for side in SIDES:
        s = _start(side, persist_dir=d)
        try:
            after = json.loads(_call(s.base, "/api/state?room=KILL")[2])
        finally:
            s.stop()
        after.pop("version")
        assert after == before, side


def test_trained_board_survives_restart(servers, tmp_path):
    s = servers("port", persist_dir=str(tmp_path), persist_debounce_s=0.05)
    done = _train(s, "TDUR", {"n": 150, "d": 2, "k": 3, "max_iter": 8})
    assert done["type"] == "train_done"
    path = tmp_path / "TDUR.json"
    _wait_for(lambda: path.exists() and "card:tpu-149" in path.read_text())
    s2 = servers("ref", persist_dir=str(tmp_path))
    st = json.loads(_call(s2.base, "/api/state?room=TDUR")[2])
    assert len(st["cards"]) == 150 and len(st["centroids"]) == 3


# ---------------------------------------------------------------------------
# The train op on the port
# ---------------------------------------------------------------------------

def _train(s, room, args):
    """Start a train op with a subscriber attached; returns the last event
    (``train_done`` or ``train_error``) with the events before it in
    ``["events"]``."""
    st = _Stream(s.base, room)
    try:
        st.event()                                    # hello
        code, out = _mutate(s.base, room, "train", args)
        assert code == 200 and out["started"], out
        events = []
        while True:
            _, ev = st.event()
            if ev["type"] in ("train_done", "train_error"):
                return dict(ev, events=events)
            if ev["type"] == "train":
                events.append(ev)
    finally:
        st.close()


def test_train_lloyd_streams_an_event_an_iteration(servers):
    s = servers("port")
    done = _train(s, "ANIM", {"n": 2000, "d": 2, "k": 3, "max_iter": 12})
    assert done["type"] == "train_done" and done["model"] == "lloyd"
    iters = done["events"]
    assert [e["iteration"] for e in iters] == \
        list(range(1, done["n_iter"] + 1))
    assert all(e["run_id"] == done["run_id"] for e in iters)
    for e in iters:
        assert len(e["centroids"]) == 3
        assert all(0.0 <= v <= 1.0 for p in e["centroids"] for v in p)
    st = json.loads(_call(s.base, "/api/state?room=ANIM")[2])
    assert len(st["cards"]) == 2000 and len(st["centroids"]) == 3
    assert st["unassigned"] == 0
    done = _train(s, "AND3", {"n": 200, "d": 3, "k": 3, "max_iter": 5})
    assert not any("centroids" in e for e in done["events"])


@pytest.mark.parametrize("model,args,check", [
    ("accelerated", {"n": 200, "d": 2, "k": 8, "max_iter": 15},
     dict(k=8, unassigned=0)),
    ("minibatch", {"n": 300, "d": 2, "k": 3, "max_iter": 7},
     dict(n_iter=7, unassigned=0)),
    ("trimmed", {"n": 200, "d": 2, "k": 3, "max_iter": 10,
                 "trim_fraction": 0.05}, dict(k=3, unassigned=10)),
    ("trimmed", {"n": 200, "d": 2, "k": 6, "max_iter": 10},
     dict(k=6, unassigned=10)),
    ("spherical", {"n": 200, "d": 2, "k": 3, "max_iter": 10},
     dict(k=3, unassigned=0)),
    ("bisecting", {"n": 300, "d": 2, "k": 5, "max_iter": 10},
     dict(k=5, n_iter=4, unassigned=0)),
    ("xmeans", {"n": 300, "d": 2, "k": 8, "max_iter": 10},
     dict(unassigned=0)),
    ("gmeans", {"n": 300, "d": 2, "k": 8, "max_iter": 10},
     dict(unassigned=0)),
    ("fuzzy", {"n": 300, "d": 2, "k": 3, "max_iter": 10},
     dict(k=3, unassigned=0)),
    ("gmm", {"n": 300, "d": 2, "k": 3, "max_iter": 10},
     dict(k=3, unassigned=0)),
    ("balanced", {"n": 240, "d": 2, "k": 3, "max_iter": 5},
     dict(k=3, unassigned=0)),
])
def test_train_one_shot_families_reach_the_board(servers, model, args,
                                                 check):
    s = servers("port")
    done = _train(s, "FAM", dict(args, model=model))
    assert done["type"] == "train_done" and done["model"] == model, done
    assert [e["iteration"] for e in done["events"]] == [0]
    for key in ("k", "n_iter"):
        if key in check:
            assert done[key] == check[key]
    st = json.loads(_call(s.base, "/api/state?room=FAM")[2])
    assert len(st["cards"]) == args["n"]
    assert 1 <= len(st["centroids"]) <= 3
    assert st["unassigned"] == check["unassigned"]


@pytest.mark.parametrize("model", ["kmedoids", "kernel", "spectral"])
def test_train_pairwise_families_reach_the_board(pair, model):
    """A pairwise family's ``train`` op: a start marker, then
    ``train_done`` with the fitted k (kernel and spectral carry it in
    their counts: they have no input-space centers) and the board's
    cards; a shape below k answers the reference's 400, before any fit."""
    ref_s, s = pair
    done = _train(s, "PWF", dict(model=model, n=300, d=2, k=3,
                                 max_iter=10))
    assert done["type"] == "train_done" and done["model"] == model, done
    assert done["k"] == 3 and done["n_iter"] >= 1
    assert [e["iteration"] for e in done["events"]] == [0]
    st = json.loads(_call(s.base, "/api/state?room=PWF")[2])
    assert len(st["cards"]) == 300 and st["unassigned"] == 0
    assert 1 <= len(st["centroids"]) <= 3
    bad = {"model": model, "n": 2, "k": 10}
    got = [_mutate(x.base, "PWB", "train", bad) for x in (ref_s, s)]
    assert got[0] == got[1] and got[0][0] == 400, got
    assert s._train_inflight == 0


@pytest.mark.parametrize("model,args", [
    ("kmedoids", {"n": 20_001, "d": 1, "max_iter": 1}),
    ("kernel", {"n": 20_000, "d": 3, "max_iter": 100}),
    ("kmedoids", {"n": 10_000, "d": 9, "max_iter": 100}),
])
def test_train_pairwise_work_cap_is_the_references(pair, model, args):
    """k-medoids' and kernel k-means' O(n²) cap (n ≤ 20,000, then
    n²·d·max_iter ≤ 8e10): both servers answer 400 with one error, before
    any fit."""
    got = [_mutate(x.base, "CAPP", "train", dict(args, model=model))
           for x in pair]
    assert got[0] == got[1] and got[0][0] == 400, got


@pytest.mark.parametrize("model", ["xmeans", "gmeans", "balanced"])
def test_train_auto_k_work_cap_is_the_references(pair, model):
    """The auto-k families' work cap (48·n·d·k·max_iter ≤ 8e10) and the
    balanced one (n·k·max_iter·400 ≤ 8e10) answer both servers' 400 with
    the same error, before any fit."""
    args = {"model": model, "n": 100_000, "d": 80, "k": 100,
            "max_iter": 100}
    got = [_mutate(s.base, "CAP", "train", args) for s in pair]
    assert got[0] == got[1] and got[0][0] == 400, got
    assert "work too large" in got[0][1]["error"]
    assert all(s._train_inflight == 0 for s in pair)


def test_train_telemetry_and_metric_families(servers, tmp_path):
    tel = str(tmp_path / "train.jsonl")
    s = servers("port", telemetry_path=tel)
    done = _train(s, "TELE", {"n": 300, "d": 2, "k": 3, "max_iter": 4,
                              "model": "trimmed"})
    lloyd = _train(s, "TELE", {"n": 300, "d": 2, "k": 3, "max_iter": 4})
    events = [json.loads(ln) for ln in open(tel)]
    assert [e["event"] for e in events if e["run_id"] == done["run_id"]] \
        == ["train_done"]
    kinds = [e["event"] for e in events if e["run_id"] == lloyd["run_id"]]
    assert kinds[0] == "run_start" and kinds[-1] == "run_done"
    assert all(e["room"] == "TELE" for e in events)
    body = _call(s.base, "/metrics")[2].decode()
    for family in ("kmeans_tpu_train_started_total",
                   "kmeans_tpu_train_errors_total", "kmeans_tpu_rooms",
                   "kmeans_tpu_train_slots_in_use",
                   "kmeans_tpu_sse_subscribers"):
        assert f"# TYPE {family} " in body, family
    assert 'kmeans_tpu_train_started_total{model="trimmed"}' in body
    assert json.loads(_call(s.base, "/healthz")[2]) == {"ok": True,
                                                         "rooms": 1}


def test_stop_returns_promptly_with_subscribers_attached(servers):
    s = servers("port", fleet_drain_s=30.0)
    streams = [_Stream(s.base, "STOP") for _ in range(3)]
    for st in streams:
        st.event()
    t0 = time.monotonic()
    s.stop()
    assert time.monotonic() - t0 < 5.0
    assert s.drain_unanswered == 0
    assert all(st.closed() for st in streams)
    for st in streams:
        st.close()


@pytest.mark.parametrize("how", ["signal", "interrupt_main"])
def test_a_foreground_ctrl_c_lands_outside_the_serve_loop(monkeypatch, how):
    """``start(background=False)`` runs the serve loop on a thread of its
    own: a SIGINT (or ``_thread.interrupt_main``, which wakes no untimed
    wait) raises KeyboardInterrupt from the caller's wait, never between
    an accept and its handler, and a request sent after it is answered by
    ``stop()``'s drain."""
    import _thread

    loops = []
    looping = threading.Event()
    serve_forever = port_server._BackloggedHTTPServer.serve_forever

    def recorded(self, *args, **kwargs):
        loops.append(threading.current_thread())
        looping.set()
        return serve_forever(self, *args, **kwargs)

    monkeypatch.setattr(port_server._BackloggedHTTPServer, "serve_forever",
                        recorded)
    s = KMeansServer(ServeConfig(port=0, tracing=False), device="cpu")
    main = threading.main_thread()
    assert threading.current_thread() is main
    answers, unwoken = [], []
    woke = threading.Event()

    def interrupt():
        if looping.wait(WAIT_S):
            port = s.httpd.server_address[1]
            answers.append(_call(f"http://127.0.0.1:{port}", "/healthz")[0])
        if how == "interrupt_main":
            _thread.interrupt_main()
            if woke.wait(WAIT_S):
                return
            unwoken.append(how)        # a hang would end no test: signal
        signal.pthread_kill(main.ident, signal.SIGINT)

    helper = threading.Thread(target=interrupt)
    prior = signal.signal(signal.SIGINT, signal.default_int_handler)
    try:
        helper.start()
        with pytest.raises(KeyboardInterrupt):
            s.start(background=False)
        woke.set()
    finally:
        signal.signal(signal.SIGINT, prior)
        helper.join(WAIT_S)
    assert answers == [200] and not unwoken
    assert len(loops) == 1 and loops[0] is not main
    assert not loops[0].is_alive()
    # The loop has stopped: this connection waits in the accept queue
    # until stop() hands it to a handler.
    sock = socket.create_connection(s.httpd.server_address, timeout=WAIT_S)
    sock.sendall(b"GET /healthz HTTP/1.1\r\nHost: localhost\r\n\r\n")
    s.stop()
    reply = b""
    while chunk := sock.recv(65536):
        reply += chunk
    sock.close()
    assert reply.split(b"\r\n", 1)[0].split(b" ")[1] == b"200"
    assert s.drain_unanswered == 0 and s.httpd._busy == 0


# ---------------------------------------------------------------------------
# auto_assign (tests/test_bridge.py's, on the port)
# ---------------------------------------------------------------------------

def _fixture_doc(room="AA", zones=("A", "B")):
    doc = Document(room=room)
    populate_test_data(doc)
    cents = [doc.add_centroid(z) for z in zones]
    return doc, cents


def test_auto_assign_clusters_the_fixture():
    doc, _ = _fixture_doc()
    snap = auto_assign(doc, seed=0, device="cpu")
    assert doc.unassigned_count == 0
    assert sum(snap["counts"].values()) == 11


def test_auto_assign_respects_locked_zones():
    doc, (a, _) = _fixture_doc()
    doc.update_card_assign("seed:t10", a["id"])
    doc.set_locked(a["id"], True)
    auto_assign(doc, seed=0, device="cpu")
    assert doc.get_card("seed:t10")["assignedTo"] == a["id"]
    assert sum(c["assignedTo"] == a["id"] for c in doc.cards) == 1


def test_auto_assign_without_zones_is_a_noop():
    doc, _ = _fixture_doc(zones=())
    snap = auto_assign(doc, device="cpu")
    assert snap["counts"] == {} and doc.unassigned_count == 11


def test_auto_assign_outliers_leave_cards_unassigned():
    doc, cents = _fixture_doc(zones=("A", "B", "C"))
    auto_assign(doc, seed=0, outliers=2, device="cpu")
    unassigned = [c for c in doc.cards if c.get("assignedTo") is None]
    assert len(unassigned) == 2
    assert all(f"pos:{c['id']}" not in doc.meta for c in unassigned)
    ids = {c["id"] for c in cents}
    assert all(c["assignedTo"] in ids for c in doc.cards
               if c.get("assignedTo") is not None)
    auto_assign(doc, seed=0, outliers=0, device="cpu")
    assert all(c.get("assignedTo") for c in doc.cards)


def test_auto_assign_outliers_respect_a_locked_zone():
    doc, (keep, _, _) = _fixture_doc(zones=("Keep", "A", "B"))
    first = doc.cards[0]["id"]
    doc.assign_card(first, keep["id"])
    doc.set_locked(keep["id"], True)
    auto_assign(doc, seed=0, outliers=3, device="cpu")
    assert doc.get_card(first)["assignedTo"] == keep["id"]
    unassigned = [c for c in doc.cards if c.get("assignedTo") is None]
    assert len(unassigned) == 3 and first not in {c["id"] for c in
                                                  unassigned}


@pytest.mark.parametrize("outliers", [0, 2])
@pytest.mark.parametrize("seed", [0, 3])
def test_auto_assign_equals_the_reference_on_replayed_draws(
        outliers, seed, monkeypatch):
    """The port's write-back equals the reference's ``auto_assign`` run
    with the port's k-means++ draws as its ``init`` (board positions as
    features: tie-free), a locked zone included."""
    import jax.numpy as jnp

    import kmeans_tpu.models as ref_models
    from kmeans_tpu.session import Document as RefDocument
    from kmeans_tpu.session import auto_assign as ref_auto_assign
    from kmeans_tpu.session import import_json as ref_import_json

    rng = np.random.default_rng(seed + 10)
    doc, (keep, _, _) = _fixture_doc(zones=("Keep", "A", "B"))
    for c in doc.cards:
        doc.set_card_pos(c["id"], *rng.uniform(0.1, 0.9, size=2))
    doc.assign_card(doc.cards[2]["id"], keep["id"])
    doc.set_locked(keep["id"], True)
    text = export_json(doc)
    ref_doc = RefDocument(room="AA")
    ref_import_json(ref_doc, text)

    cpu = torch.device("cpu")

    def replayed(fit):
        def call(x, k, *, key=None, config=None, weights=None, **kw):
            c0 = init_centroids(
                generator_for(seed, cpu), torch.from_numpy(np.asarray(x)),
                k, weights=None if weights is None
                else torch.from_numpy(np.asarray(weights)))
            return fit(x, k, key=key, config=config, weights=weights,
                       init=jnp.asarray(c0.numpy()), **kw)
        return call

    monkeypatch.setattr(ref_models, "fit_lloyd",
                        replayed(ref_models.fit_lloyd))
    monkeypatch.setattr(ref_models, "fit_trimmed",
                        replayed(ref_models.fit_trimmed))
    got = auto_assign(doc, seed=seed, features="pos", outliers=outliers,
                      device="cpu")
    want = ref_auto_assign(ref_doc, seed=seed, features="pos",
                           outliers=outliers)
    assert [c["assignedTo"] for c in doc.cards] == \
        [c["assignedTo"] for c in ref_doc.cards]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert sum(c["assignedTo"] is None for c in doc.cards) == outliers
    assert export_json(doc) == export_json(ref_doc)
