/* Front-end for the TPU k-means serving shim.
 *
 * A from-scratch implementation of the reference UI's behaviors
 * (schusto/k-means-demo): room codes, presence chips, centroid zones with
 * lock/remove/rename, drag & drop with grab-offset + clamped normalized
 * positions, per-card assignment select, the metrics dashboard with
 * per-iteration deltas and auto-naming suggestions, export/import/reset.
 * State sync is server-authoritative over SSE instead of the reference's
 * WebRTC CRDT gossip; every mutation is a POST /api/mutate op.
 */
"use strict";

const $id = (id) => document.getElementById(id);

// ---------- room ----------
const url = new URL(location.href);
let room = (url.searchParams.get("room") || "").toUpperCase();
if (!room) {
  const cs = "ABCDEFGHJKLMNPQRSTUVWXYZ23456789";
  room = Array.from({ length: 4 }, () => cs[Math.floor(Math.random() * cs.length)]).join("");
  url.searchParams.set("room", room);
  history.replaceState(null, "", url.toString());
}
$id("room").textContent = `Room: ${room}`;

// ---------- presence ----------
const LS_NAME = "icekmeans:name";
let myName = localStorage.getItem(LS_NAME) || `Guest ${room}`;
$id("name").value = myName;
const initials = (n) => {
  const out = (n || "??").trim().split(/\s+/).slice(0, 2)
    .map((s) => (s[0] || "").toUpperCase()).join("");
  return out || "??";
};

// ---------- server API ----------
const api = (path) => `${path}?room=${encodeURIComponent(room)}`;
const LS_STATE = `icekmeans:state:${room}`;
let state = null;
let peers = 0;
// Degraded/solo mode (reference parity: the P2P app keeps a usable board
// when every tracker is down — app.mjs initP2P's try/catch). Here: when the
// server is unreachable, the last-known board renders read-only from a
// localStorage cache and recovers on SSE reconnect.
let degraded = false;

async function fetchState() {
  try {
    const r = await fetch(api("/api/state"));
    if (!r.ok) { renderAll(); return; }   // server up but erroring: keep
    state = await r.json();               // the last good board + cache
    degraded = false;
    // Durability on reconnect (reference parity with the CRDT design: a
    // surviving peer replays full state, app.mjs:96): if the server doc
    // is FRESH (a restart without persistence — just the Jessica seed)
    // and our cache holds a richer board, restore the cache into the
    // room instead of letting the fresh doc overwrite it.
    const restore = await maybeRestoreCache();
    if (restore === "restored") return;     // refetches after the import
    // A FAILED or DECLINED restore must leave the cache untouched (it is
    // the only surviving replica; caching the fresh seed doc here would
    // destroy it with no retry possible).
    if (restore !== "failed" && restore !== "declined") {
      try { localStorage.setItem(LS_STATE, JSON.stringify(state)); } catch {}
    }
  } catch {
    if (!state) {
      try { state = JSON.parse(localStorage.getItem(LS_STATE)); } catch {}
    }
    degraded = true;
  }
  renderAll();
}

let restoringCache = false;
// Returns "none" (no restore applicable), "restored", "declined" (the
// user kept the server board; the cache must survive for a retry), or
// "failed" (a restore was ATTEMPTED and did not land — the caller must
// not overwrite the cache in that case).
async function maybeRestoreCache() {
  if (restoringCache) return "none";
  // Fresh server doc = version <=1 (the Jessica seed bump only).
  if (!state || state.version > 1) return "none";
  let cached = null;
  try { cached = JSON.parse(localStorage.getItem(LS_STATE)); } catch {}
  if (!cached || !Array.isArray(cached.cards)) return "none";
  const richer = cached.cards.length > (state.cards || []).length
    || (cached.centroids || []).length > (state.centroids || []).length;
  if (!richer) return "none";
  // Durability-aware gate: when the server persists rooms, a fresh doc is
  // deliberate (new room, or an operator reset) — ask before resurrecting
  // the local cache for every peer. Without persistence the cache is the
  // only surviving replica and restores silently (the designed degraded-
  // durability path).
  if (state.persisted
      && !confirm("The server has a fresh board but this browser holds a "
                  + "cached copy. Restore the cached board for everyone?")) {
    // Declined is NOT "none": the cache is still the only replica of the
    // richer board, and returning "none" would let fetchState overwrite
    // it with the fresh seed doc — unrecoverable after one wrong click.
    return "declined";
  }
  restoringCache = true;
  try {
    const r = await fetch(api("/api/import"), {
      method: "POST",
      body: JSON.stringify({
        cards: cached.cards,
        centroids: cached.centroids || [],
        meta: cached.meta || {},
      }),
    });
    if (!r.ok) return "failed";
    await fetchState();
    return "restored";
  } catch {
    return "failed";
  } finally {
    restoringCache = false;
  }
}
const MUTATE_MAX_RETRIES = 4;
async function mutate(op, args = {}, attempt = 0) {
  if (degraded) {
    alert("Server unreachable — showing the cached board read-only.");
    return null;
  }
  let r;
  try {
    r = await fetch(api("/api/mutate"), {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ op, args }),
    });
  } catch {
    // Probe the server rather than assuming it's down: fetchState is the
    // one place degraded flips on/off, so a transient blip self-heals.
    fetchState();
    return null;
  }
  const out = await r.json();
  const t = $id("trainStatus");
  if (r.status === 503 && op === "train" && attempt < MUTATE_MAX_RETRIES) {
    // Train capacity exhausted: the server says WHEN to come back via
    // Retry-After — honor it with a growing backoff instead of failing
    // the request on the user.  Only the train op retries: it has a
    // status line to narrate the wait, while a silent multi-second stall
    // on a board mutation would read as a dead click.
    // The server already jitters the header (ServeConfig.retry_after_jitter_s,
    // whole seconds — RFC 9110 delay-seconds is integer-only); a bounded
    // client-side jitter on top decorrelates tabs that received the SAME
    // response via a shared cache — no cohort of rejected clients ever
    // returns in lockstep.
    const ra = parseFloat(r.headers.get("Retry-After")) || 2;
    const waitS = (ra + Math.random() * 0.5) * (attempt + 1);
    if (t) {
      // The chip ships display:none and is normally unhidden by the
      // first train SSE event — which hasn't happened when the very
      // first click hits capacity, so unhide it here too.
      t.style.display = "";
      t.textContent = `server busy — retrying in ${waitS.toFixed(1)}s…`;
    }
    await new Promise((res) => setTimeout(res, waitS * 1000));
    return mutate(op, args, attempt + 1);
  }
  if (!r.ok) {
    // Don't leave a stale "retrying…" line contradicting the alert when
    // the retry budget is exhausted.
    if (t && attempt > 0) { t.textContent = ""; t.style.display = "none"; }
    alert(out.error || "Request failed");
    return null;
  }
  // The versioned SSE "change" event triggers exactly one state fetch per
  // version bump — but only while the stream is open; during a reconnect
  // window a successful mutation must still render.
  if (!es || es.readyState !== EventSource.OPEN) fetchState();
  return out;
}
async function hello() {
  await fetch(api("/api/hello"), {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ name: myName }),
  });
}

let es = null;

function connectEvents() {
  // Server events carry id: fields, so EventSource's automatic reconnect
  // sends Last-Event-ID and the server replays whatever the drop skipped
  // from its per-room event ring — a reconnect during a train stream
  // loses no train_* events.  Between events the server emits periodic
  // ": keepalive" comments so idle connections survive proxies.
  es = new EventSource(api("/api/events"));
  es.onmessage = (ev) => {
    const msg = JSON.parse(ev.data);
    if (typeof msg.peers === "number") { peers = msg.peers; setStatusChip(); }
    if (msg.type === "hello") {
      // (Re)connected: replay presence and resync if the server's version
      // moved while we were away (or the server restarted).
      hello().catch(() => {});
      if (degraded || !state || msg.version !== state.version) fetchState();
    }
    // change events AND pings carry the version: a change event dropped on
    // a full server queue self-heals at the next 15s ping.
    if ((msg.type === "change" || msg.type === "ping")
        && typeof msg.version === "number"
        && (!state || msg.version !== state.version)) fetchState();
    if (msg.type === "train" || msg.type === "train_done" || msg.type === "train_error") {
      const t = $id("trainStatus");
      t.style.display = "";
      if (msg.type === "train") {
        // Non-lloyd families send a start marker without inertia/seconds.
        t.textContent = msg.inertia === undefined
          ? `training ${msg.model || ""}…`
          : `iter ${msg.iteration}: inertia ${msg.inertia.toFixed(1)} (${(msg.seconds * 1000).toFixed(0)}ms)`;
        // d=2 lloyd fits stream normalized centroid positions: animate
        // them over the board so the Lloyd loop is WATCHABLE.
        if (Array.isArray(msg.centroids)) renderTrainOverlay(msg.centroids);
      } else if (msg.type === "train_done") {
        t.textContent = `done: ${msg.n_iter} iters, k=${msg.k ?? "?"}, inertia ${msg.inertia.toFixed(1)}${msg.converged ? " ✓" : ""}`;
        // Board refetch replaces the overlay with the imported result;
        // fade the trajectory out after a beat.
        setTimeout(clearTrainOverlay, 2500);
      } else t.textContent = `train failed: ${msg.error}`;
    }
  };
  es.onerror = () => {
    // EventSource auto-reconnects; meanwhile flip to the cached read-only
    // board so the room stays usable (fetchState flips degraded on/off by
    // actually probing the server).
    fetchState();
    setStatusChip(true);
  };
  return es;
}

// ---------- live training overlay ----------
// One absolutely-positioned dot per centroid over the board; positions are
// normalized [0,1]² server-side, and the CSS transition makes consecutive
// SSE train events read as smooth movement.
function renderTrainOverlay(centroids) {
  const root = $id("canvas");
  if (!root) return;
  // (document.getElementById, not $id: the overlay is created
  // dynamically and is deliberately outside the static id contract.)
  let layer = document.getElementById("trainOverlay");
  if (!layer) {
    root.style.position = "relative";
    layer = document.createElement("div");
    layer.id = "trainOverlay";
    layer.style.cssText =
      "position:absolute;inset:0;pointer-events:none;z-index:5;";
    root.appendChild(layer);
  }
  while (layer.children.length > centroids.length)
    layer.removeChild(layer.lastChild);
  centroids.forEach(([cx, cy], i) => {
    let dot = layer.children[i];
    if (!dot) {
      dot = document.createElement("div");
      dot.style.cssText =
        "position:absolute;width:14px;height:14px;border-radius:50%;" +
        "margin:-7px 0 0 -7px;border:2px solid #fff;opacity:.9;" +
        "box-shadow:0 0 6px rgba(0,0,0,.5);" +
        "transition:left .25s linear,top .25s linear;";
      dot.style.background = `hsl(${(i * 137.5) % 360} 70% 55%)`;
      layer.appendChild(dot);
    }
    dot.style.left = `${(cx * 100).toFixed(2)}%`;
    dot.style.top = `${((1 - cy) * 100).toFixed(2)}%`;
  });
}
function clearTrainOverlay() {
  const layer = document.getElementById("trainOverlay");
  if (layer) layer.remove();
}

// ---------- status / presence ----------
function setStatusChip(err) {
  const s = $id("status");
  s.textContent = degraded
    ? "offline — cached board (read-only)"
    : err ? "reconnecting…" : `Peers: ${peers} | Server: 1/1`;
  s.classList.toggle("ok", !degraded && !err && peers > 0);
  s.classList.toggle("warn", degraded || !!err || peers === 0);
}
function renderPresence() {
  const box = $id("presence");
  box.innerHTML = "";
  const names = [myName, ...(state?.presence || []).filter((n) => n !== myName)];
  for (const n of names.slice(0, 6)) {
    const a = document.createElement("span");
    a.className = "avatar";
    a.title = n;
    a.textContent = initials(n);
    box.appendChild(a);
  }
}

// ---------- rendering ----------
const dragCtx = { id: null, dx: 0, dy: 0 };

function renderAll() {
  document.body.classList.toggle("degraded", degraded);
  if (!state) { setStatusChip(); return; }
  setStatusChip();
  renderPresence();
  renderCanvas();
  renderUnassigned();
  renderKMeans();
  syncMeta();
}
function syncMeta() {
  const m = state.meta || {};
  if (m.mode) $id("mode").value = m.mode;
  if (typeof m.iteration === "number") $id("iter").value = String(m.iteration);
}

function computeMinHeightPx(n) { return Math.max(260, 64 + n * (110 + 10)); }

function cardEl(card) {
  const el = document.createElement("div");
  el.className = "card";
  el.draggable = true;
  const t = document.createElement("div");
  t.className = "t"; t.textContent = card.title;
  const tr = document.createElement("div");
  tr.className = "traits";
  tr.textContent = `${card.traits?.[0] || ""} • ${card.traits?.[1] || ""}`;
  const row = document.createElement("div");
  row.className = "row";
  const sel = document.createElement("select");
  const optU = document.createElement("option");
  optU.value = ""; optU.textContent = "Unassigned";
  sel.appendChild(optU);
  for (const c of state.centroids) {
    const o = document.createElement("option");
    o.value = c.id; o.textContent = c.name;
    sel.appendChild(o);
  }
  sel.value = card.assignedTo || "";
  sel.addEventListener("change", () =>
    mutate("assign", { id: card.id, centroid: sel.value || null }));
  const del = document.createElement("button");
  del.className = "btn danger"; del.textContent = "Delete";
  del.addEventListener("click", () => {
    if (confirm(`Delete "${card.title}"?`)) mutate("deleteCard", { id: card.id });
  });
  row.append(sel, del);
  el.append(t, tr, row);
  el.addEventListener("dragstart", (ev) => {
    dragCtx.id = card.id;
    const r = el.getBoundingClientRect();
    dragCtx.dx = ev.clientX - r.left;
    dragCtx.dy = ev.clientY - r.top;
    ev.dataTransfer.setData("text/plain", card.id);
  });
  return el;
}

function renderCanvas() {
  const root = $id("canvas");
  root.innerHTML = "";
  if (!state.centroids.length) {
    const hint = document.createElement("div");
    hint.className = "empty-hint";
    hint.textContent = "Add a centroid to start clustering (max 3).";
    root.appendChild(hint);
    return;
  }
  for (const cent of state.centroids) {
    const zone = document.createElement("div");
    zone.className = "centroid";
    const assigned = state.cards.filter((c) => c.assignedTo === cent.id);
    zone.style.minHeight = computeMinHeightPx(assigned.length) + "px";

    const head = document.createElement("div");
    head.className = "zhead";
    const sw = document.createElement("span");
    sw.className = "swatch"; sw.style.background = cent.color;
    const name = document.createElement("input");
    name.className = "zname"; name.value = cent.name;
    name.addEventListener("change", () =>
      mutate("renameCentroid", { id: cent.id, name: name.value }));
    const lock = document.createElement("button");
    lock.className = "btn ghost";
    lock.textContent = cent.locked ? "Unlock" : "Lock";
    lock.addEventListener("click", () =>
      mutate("setLocked", { id: cent.id, locked: !cent.locked }));
    const rm = document.createElement("button");
    rm.className = "btn danger"; rm.textContent = "✕";
    rm.addEventListener("click", () => {
      if (confirm(`Remove centroid "${cent.name}"?`))
        mutate("removeCentroid", { id: cent.id });
    });
    head.append(sw, name, lock, rm);
    zone.appendChild(head);

    zone.addEventListener("dragover", (ev) => {
      ev.preventDefault();
      zone.classList.add("drop-target");
    });
    zone.addEventListener("dragleave", () => zone.classList.remove("drop-target"));
    zone.addEventListener("drop", (ev) => {
      ev.preventDefault();
      zone.classList.remove("drop-target");
      if (cent.locked || !dragCtx.id) return;
      const r = zone.getBoundingClientRect();
      let x = (ev.clientX - dragCtx.dx - r.left) / r.width;
      let y = (ev.clientY - dragCtx.dy - r.top) / r.height;
      x = Math.min(Math.max(x, 0.02), 0.92);
      y = Math.min(Math.max(y, 0.10), 0.92);
      mutate("assign", { id: dragCtx.id, centroid: cent.id, pos: { x, y } });
    });

    for (const card of assigned) {
      const el = cardEl(card);
      const pos = state.meta[`pos:${card.id}`];
      if (pos) {
        el.classList.add("float");
        el.style.left = (pos.x * 100) + "%";
        el.style.top = (pos.y * 100) + "%";
      }
      zone.appendChild(el);
    }
    root.appendChild(zone);
  }
}

function renderUnassigned() {
  const root = $id("unassigned");
  root.innerHTML = "";
  for (const card of state.cards.filter((c) => !c.assignedTo)) {
    root.appendChild(cardEl(card));
  }
  if (!root.dataset.dropWired) {        // wire once (reference bug §8.2 fixed)
    root.dataset.dropWired = "1";
    root.addEventListener("dragover", (ev) => {
      ev.preventDefault(); root.classList.add("drop-target");
    });
    root.addEventListener("dragleave", () => root.classList.remove("drop-target"));
    root.addEventListener("drop", (ev) => {
      ev.preventDefault();
      root.classList.remove("drop-target");
      if (dragCtx.id) mutate("assign", { id: dragCtx.id, centroid: null });
    });
  }
}

function chip(text, tip) {
  const el = document.createElement("span");
  el.className = "chip"; el.textContent = text;
  if (tip) el.title = tip;
  return el;
}
function deltaSpan(text, good) {
  const el = document.createElement("span");
  el.className = "delta" + (good ? "" : " bad");
  el.textContent = text;
  return el;
}

function renderKMeans() {
  const root = $id("kmeans");
  root.innerHTML = "";
  const m = state.metrics, d = state.deltas;
  const bar = document.createElement("div");
  bar.className = "km-metrics";
  bar.append(
    chip(`k = ${state.centroids.length}`,
      "k = number of clusters (centroids). Pick it before you start."),
    chip(`balance gap = ${m.balance.gap}`,
      "Largest cluster size minus smallest. Closer to 0 is more balanced."),
    chip(`avg cohesion = ${Math.trunc(m.avgCohesion * 100)}%`,
      "Share of cards that share ≥1 trait with another card in the same cluster."),
    chip(`unassigned = ${state.unassigned}`,
      "Cards not yet assigned. Many unassigned may indicate outliers.")
  );
  if (d) {
    bar.append(deltaSpan(
      d.tighter ? ` (↑ tighter ${Math.abs(d.gap)})` : ` (↓ looser ${d.gap})`,
      d.tighter));
    const pp = d.avgCohesion_pp;
    bar.append(deltaSpan(pp === 0 ? " (±0)" : (pp > 0 ? ` (+${pp}pp)` : ` (${pp}pp)`),
      pp >= 0));
  }
  root.appendChild(bar);

  const total = state.cards.length || 1;
  for (const cent of state.centroids) {
    const row = document.createElement("div");
    row.className = "kmrow";
    const count = m.counts[cent.id] || 0;
    row.append(chip(`${cent.name}: ${count}`));
    const barEl = document.createElement("div");
    barEl.className = "bar";
    const fill = document.createElement("div");
    fill.className = "fill";
    fill.style.width = Math.round((count / total) * 100) + "%";
    fill.style.background = cent.color;
    barEl.appendChild(fill);
    row.append(barEl);
    const coh = Math.round((m.cohesion[cent.id] || 0) * 100);
    row.append(chip(`cohesion ${coh}%`));
    if (d && d.per_centroid[cent.id]?.cohesion_pp != null) {
      const pp = d.per_centroid[cent.id].cohesion_pp;
      row.append(deltaSpan(pp === 0 ? "(±0)" : (pp > 0 ? `(+${pp}pp)` : `(${pp}pp)`),
        pp >= 0));
    }
    const sug = state.suggestions[cent.id];
    if (sug?.top?.length) {
      const t = document.createElement("span");
      t.className = "traits-inline";
      t.textContent = "Top: " + sug.top.map((x) => `${x.label} (${x.count})`).join(", ");
      row.append(t);
    }
    if (sug?.suggested) {
      const s = document.createElement("span");
      s.className = "suggest-inline";
      s.textContent = `Suggested: ${sug.suggested}`;
      const use = document.createElement("button");
      use.className = "btn ghost"; use.textContent = "Use";
      use.addEventListener("click", () =>
        mutate("renameCentroid", { id: cent.id, name: sug.suggested }));
      row.append(s, use);
    }
    root.appendChild(row);
  }
}

// ---------- controls ----------
$id("copy").addEventListener("click", async () => {
  try {
    await navigator.clipboard.writeText(location.href);
    const b = $id("copy");
    b.textContent = "Copied!";
    setTimeout(() => { b.textContent = "Copy link"; }, 1200);
  } catch { alert("Copy failed. Use the address bar."); }
});
$id("populate").addEventListener("click", () => mutate("populate"));
$id("addCentroid").addEventListener("click", () => {
  const i = $id("centroidName");
  mutate("addCentroid", { name: i.value.trim() });
  i.value = "";
});
$id("addCard").addEventListener("click", () => {
  const t = $id("flavorTitle"), a = $id("traitA"), b = $id("traitB");
  if (!t.value.trim()) return;
  mutate("addCard", {
    title: t.value.trim(), traitA: a.value.trim(), traitB: b.value.trim(),
    by: myName || "anon",
  });
  t.value = a.value = b.value = "";
});
$id("coin").addEventListener("click", () =>
  alert(Math.random() < 0.5 ? "Heads" : "Tails"));
$id("d12").addEventListener("click", () =>
  alert(`d12 → ${1 + Math.floor(Math.random() * 12)}`));
$id("shuffle").addEventListener("click", () => {
  const names = state.cards.map((c) => c.title);
  for (let i = names.length - 1; i > 0; i--) {
    const j = Math.floor(Math.random() * (i + 1));
    [names[i], names[j]] = [names[j], names[i]];
  }
  alert("Suggested order:\n\n" + names.join("\n"));
});
$id("shuffleUnassigned").addEventListener("click", () => mutate("shuffleUnassigned"));
$id("restartAll").addEventListener("click", () => mutate("restartAll"));
$id("tpuAssign").addEventListener("click", () => mutate("autoAssign", {
  outliers: Math.max(0, parseInt($id("trimOutliers").value, 10) || 0),
}));
$id("tpuTrain").addEventListener("click", () => {
  // Scale controls (server-validated against the work caps: n·d <= 8e6,
  // O(n²) families tighter): the one place the TPU scale story is
  // exercisable from the reference's own UI.
  const n = Math.max(10, parseInt($id("trainN").value, 10) || 500);
  const d = Math.max(1, parseInt($id("trainD").value, 10) || 2);
  const k = Math.max(1, parseInt($id("trainK").value, 10) || 3);
  clearTrainOverlay();
  mutate("train", { n, d, k, model: $id("trainModel").value });
});
$id("saveName").addEventListener("click", () => {
  myName = $id("name").value.trim() || myName;
  localStorage.setItem(LS_NAME, myName);
  hello().then(fetchState).catch(() => {});
});
$id("mode").addEventListener("change", () =>
  mutate("setMode", { mode: $id("mode").value }));
$id("iter").addEventListener("change", () =>
  mutate("setIteration", { iteration: parseInt($id("iter").value || "0") || 0 }));
$id("export").addEventListener("click", () => {
  location.href = api("/api/export");
});
$id("import").addEventListener("change", async (ev) => {
  const f = ev.target.files?.[0];
  if (!f) return;
  try {
    const r = await fetch(api("/api/import"), { method: "POST", body: await f.text() });
    if (!r.ok) throw new Error((await r.json()).error);
    await fetchState();
  } catch (e) { alert("Import failed: " + e.message); }
  finally { ev.target.value = ""; }
});
$id("reset").addEventListener("click", () => {
  if (confirm("Reset board and re-seed Jessica?"))
    mutate("hardReset", { mode: $id("mode").value });
});

// ---------- boot ----------
(async () => {
  try { await hello(); } catch {}   // server may be down: boot from cache
  await fetchState();
})();
connectEvents();
setInterval(() => hello().catch(() => {}), 10_000);
