"""Live observability plane: a stdlib-only telemetry HTTP daemon.

Snapshot files leave serving processes observable only post-hoc;
a scraper could not poll a live process and an operator could not pull
one request's span tree mid-incident.  This module serves the existing
exporters over ``http.server.ThreadingHTTPServer`` — no third-party
dependency, per the container constraint:

- ``GET /metrics``       Prometheus text exposition (render_prometheus)
- ``GET /metrics.json``  self-contained metrics+traces JSON document
                         (render_json — the same file format
                         tools/telemetry_dump.py consumes offline)
- ``GET /traces``        retained trace ids + one-line summaries
                         (name, e2e ms, retained_by, failed reason)
- ``GET /traces/<id>``   one request's full span tree
- ``GET /healthz``       liveness: uptime, a wall-clock ``scrape_ts``
                         (orders snapshots across ranks), queue depth +
                         occupancy summed over live engines,
                         trace-store size, firing-alert count
- ``GET /alerts``        every SLO rule's state machine (alerts.py):
                         firing first, with value/detail/annotations
- ``GET /history``       windowed time-series queries over the
                         in-process recorder ring (recorder.py):
                         ``?series=<name>[&labels=k=v,..][&window=S]
                         [&q=0.99]`` returns the samples plus exact
                         delta / per-second rate (and the windowed
                         quantile for histogram series)
- ``GET /events``        Server-Sent Events stream pushing alert
                         transitions, kept traces, and flight-recorder
                         dumps as they happen (see below)

SSE contract (``/events``): the stream opens with ``retry: 3000`` (the
client's reconnect delay) and replays nothing by default.  Every event
carries an incrementing ``id:``; a reconnecting client sends the
standard ``Last-Event-ID`` header and the server replays every event
still in its bounded replay ring (256), or emits ``event: reset`` when
the id has already been evicted so the client knows events were lost.
A ``: keep-alive`` comment goes out every 15 s (``?keepalive=<secs>``
overrides) so idle proxies don't reap the connection; the response is
close-delimited (``Connection: close``) — reconnect-and-resume IS the
recovery path, never a half-resumed stream.

Start it explicitly (``telemetry.start_server(port)``) or let the
``MXNET_TELEMETRY_PORT`` env knob start it — at telemetry import for
any process, or lazily at ServingEngine construction, in which case
``ServingEngine.close()`` releases it (refcounted across co-resident
engines) so reload-in-a-loop neither leaks the port nor the thread.

Concurrency: every request handler renders from a point-in-time
``Registry.collect()`` snapshot (instrument locks are held per-value,
never across the render), so a scrape racing engine mutation can never
observe a torn exposition document — tests parse every response under
a pounding thread to hold that line.  SSE frames are written whole per
event under the per-handler socket, so a concurrent subscriber sees
complete frames or a clean disconnect.
"""
from __future__ import annotations

import collections
import json
import queue as _queue
import threading
import time

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

from ..base import MXNetError
from ..locks import named_lock

__all__ = ["TelemetryServer", "start_server", "stop_server",
           "server_address", "publish_event", "event_hub",
           "register_healthz_section", "unregister_healthz_section"]


# -- pluggable /healthz sections ---------------------------------------------
#
# Subsystems outside the metrics registry (the replica supervisor,
# future control planes) contribute a named block to every /healthz
# document by registering a provider callable here — server.py stays
# ignorant of the serving package (no import cycle, no heavyweight
# import at scrape time).  A raising provider reports itself instead
# of failing the probe.

_SECTIONS_LOCK = named_lock("telemetry.healthz")
_HEALTHZ_SECTIONS = {}


def register_healthz_section(name, fn):
    """Register ``fn() -> dict-or-None`` to render as ``name`` in
    every /healthz document (None = omit this scrape).
    Re-registration replaces."""
    with _SECTIONS_LOCK:
        _HEALTHZ_SECTIONS[name] = fn


def unregister_healthz_section(name):
    with _SECTIONS_LOCK:
        _HEALTHZ_SECTIONS.pop(name, None)


class _EventHub(object):
    """Process-wide SSE fan-out: bounded replay ring + per-subscriber
    bounded queues.  Publishers (alert transitions, kept traces,
    flight dumps) pay one lock + deque append; a subscriber that stops
    draining has its queue closed (sentinel) instead of back-pressuring
    the publisher — observability must never slow the observed."""

    def __init__(self, replay=256, sub_capacity=1024):
        self._lock = named_lock("telemetry.events")
        self._seq = 0
        self._replay = collections.deque(maxlen=replay)
        self._subs = []
        self._sub_capacity = sub_capacity

    def publish(self, event, data):
        """Enqueue one event to every subscriber and the replay ring.
        ``data`` must be JSON-able; returns the event id.

        Every frame carries a wall-clock ``ts`` stamped at publish —
        additive (a publisher's own ``ts`` wins), and stamped BEFORE
        the replay ring so Last-Event-ID replays deliver the original
        publish time, not the replay time: consumers can order frames
        across ranks whose connections opened at different moments."""
        if isinstance(data, dict) and "ts" not in data:
            data = dict(data, ts=time.time())
        payload = json.dumps(data, sort_keys=True, default=str)
        with self._lock:
            self._seq += 1
            ev = (self._seq, event, payload)
            self._replay.append(ev)
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(ev)
            except _queue.Full:
                # slow consumer: close it out rather than drop silently
                # — drain one slot so the close sentinel always fits
                # (the queue was full, so nothing else could have made
                # room between these two calls)
                try:
                    q.get_nowait()
                except _queue.Empty:
                    pass
                try:
                    q.put_nowait(None)
                except _queue.Full:
                    pass
                self.unsubscribe(q)
        return self._seq

    def subscribe(self, last_event_id=None):
        """(queue, replayed events, reset) — ``reset`` True when the
        requested resume point predates the replay ring (the client
        lost events and should resync via /alerts + /traces)."""
        q = _queue.Queue(maxsize=self._sub_capacity)
        replayed, reset = [], False
        with self._lock:
            if last_event_id is not None:
                try:
                    last = int(last_event_id)
                except (TypeError, ValueError):
                    last = None
                if last is not None:
                    oldest = self._replay[0][0] if self._replay \
                        else self._seq + 1
                    if last + 1 < oldest and last < self._seq:
                        reset = True
                    replayed = [ev for ev in self._replay if ev[0] > last]
            self._subs.append(q)
        return q, replayed, reset

    def unsubscribe(self, q):
        with self._lock:
            try:
                self._subs.remove(q)
            except ValueError:
                pass

    def kick_all(self):
        """Wake every subscriber with a close sentinel (server stop)."""
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(None)
            except _queue.Full:
                pass

    def subscribers(self):
        with self._lock:
            return len(self._subs)


_HUB = _EventHub()


def event_hub():
    """The process-wide SSE hub ``GET /events`` subscribers drain."""
    return _HUB


def publish_event(event, data):
    """Publish one event (``alert`` / ``trace`` / ``flight`` / custom)
    to every live ``/events`` subscriber and the replay ring."""
    return _HUB.publish(event, data)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    # the server sets .telemetry_server on the class instance (see
    # TelemetryServer.__init__); keep HTTP/1.1 so scrapers reuse
    # connections
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # noqa: A003 - stdlib signature
        pass                             # scrapes must not spam stderr

    # ------------------------------------------------------------ responses
    def _send(self, code, body, content_type):
        data = body.encode("utf-8") if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code, obj):
        self._send(code, json.dumps(obj, indent=1, sort_keys=True),
                   "application/json")

    # ------------------------------------------------------------- routing
    def do_GET(self):                    # noqa: N802 - stdlib signature
        try:
            u = urlparse(self.path)
            path = u.path.rstrip("/") or "/"
            query = {k: v[-1] for k, v in parse_qs(u.query).items()}
            if path == "/events":
                self._serve_events(query)
            else:
                self._route(path, query)
        except (BrokenPipeError, ConnectionResetError):
            pass                         # scraper hung up mid-response
        except Exception as e:           # never kill the handler thread
            try:
                self._send_json(500, {"error": str(e)})
            except Exception:
                pass

    def _route(self, path, query):
        from . import render_prometheus, render_json, tracing
        if path == "/metrics":
            self._send(200, render_prometheus(), PROM_CONTENT_TYPE)
        elif path == "/metrics.json":
            self._send(200, render_json(), "application/json")
        elif path == "/traces":
            self._send_json(200, _trace_index())
        elif path.startswith("/traces/"):
            tid = path[len("/traces/"):]
            tree = tracing.get_trace(tid)
            if tree is None:
                self._send_json(404, {
                    "error": "trace %r not found (evicted or never "
                             "retained)" % tid,
                    "stored": len(tracing.recent_trace_ids())})
            else:
                self._send_json(200, tree)
        elif path == "/alerts":
            self._send_json(200, _alerts_doc())
        elif path == "/history":
            code, doc = _history_doc(query)
            self._send_json(code, doc)
        elif path == "/timeline":
            code, doc = _timeline_doc(query)
            self._send_json(code, doc)
        elif path in ("/", "/healthz"):
            self._send_json(200, _healthz(self.server.telemetry_server))
        else:
            self._send_json(404, {
                "error": "unknown route %r" % path,
                "routes": ["/metrics", "/metrics.json", "/traces",
                           "/traces/<id>", "/alerts", "/history",
                           "/timeline", "/events", "/healthz"]})

    # ---------------------------------------------------------------- SSE
    def _serve_events(self, query):
        """Server-Sent Events: alert transitions + kept traces +
        flight-recorder dumps, pushed as they happen (module docstring
        has the keep-alive/reconnect contract)."""
        srv = self.server.telemetry_server
        try:
            keepalive = max(0.01, float(query.get("keepalive", 15.0)))
        except (TypeError, ValueError):
            keepalive = 15.0
        q, replayed, reset = _HUB.subscribe(
            self.headers.get("Last-Event-ID"))
        self.close_connection = True
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            w = self.wfile
            w.write(b"retry: 3000\n\n")
            if reset:
                w.write(b"event: reset\ndata: "
                        b"{\"reason\": \"replay window exceeded\"}\n\n")
            for ev in replayed:
                w.write(self._sse_frame(ev))
            w.flush()
            while not srv._stopping.is_set():
                try:
                    ev = q.get(timeout=keepalive)
                except _queue.Empty:
                    w.write(b": keep-alive\n\n")
                    w.flush()
                    continue
                if ev is None:           # hub kicked us (stop / overflow)
                    break
                w.write(self._sse_frame(ev))
                w.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass                         # subscriber hung up: normal
        finally:
            _HUB.unsubscribe(q)

    @staticmethod
    def _sse_frame(ev):
        seq, event, payload = ev
        return ("id: %d\nevent: %s\ndata: %s\n\n"
                % (seq, event, payload)).encode("utf-8")


def _trace_index():
    """One summary row per retained trace, oldest first — enough to
    pick a trace id without pulling every tree."""
    from . import tracing
    rows = []
    for tid, tree in tracing.all_traces().items():
        root = tree.get("root", {})
        row = {"trace_id": tid, "name": root.get("name"),
               "dur_ms": root.get("dur_ms")}
        if tree.get("retained_by"):
            row["retained_by"] = tree["retained_by"]
        for child in root.get("children", ()):
            if child.get("name") == "failed":
                row["failed"] = (child.get("meta") or {}).get("reason")
                break
        rows.append(row)
    return {"count": len(rows), "traces": rows}


def _alerts_doc():
    """Every rule's state row (firing first) + evaluation metadata:
    whether a recorder is actually sampling and at what interval — a
    rule table nobody evaluates must be visibly dead, not quietly
    green."""
    from .alerts import default_manager
    from .recorder import get_recorder
    mgr = default_manager()
    rec = get_recorder()
    now = time.monotonic()
    return {
        "alerts": mgr.states(),
        "firing": mgr.firing(),
        "rules": len(mgr),
        "evaluating": bool(rec is not None and rec.alerts is mgr),
        "interval_s": rec.interval_s if rec is not None else None,
        "last_eval_age_s": (round(now - mgr.last_eval, 3)
                            if mgr.last_eval is not None else None),
        "scrape_ts": time.time(),
    }


def _timeline_doc(query):
    """(status, doc) for one ``GET /timeline`` query: the fleet-event
    window (``?window=`` trailing seconds, whole ring by default),
    either as the self-contained timeline document or — with
    ``?format=chrome`` — pre-rendered as Chrome ``trace_event`` JSON
    an operator can drop straight into Perfetto."""
    from . import timeline
    if not timeline.enabled():
        return 503, {"error": "timeline plane disabled (set "
                              "MXNET_TELEMETRY_TIMELINE=1 and "
                              "MXNET_TELEMETRY_ON=1)"}
    window_s = None
    if query.get("window") is not None:
        try:
            window_s = float(query["window"])
        except (TypeError, ValueError):
            return 400, {"error": "bad window=%r (want seconds)"
                                  % query.get("window")}
    doc = timeline.get().snapshot(window_s)
    doc["scrape_ts"] = time.time()
    doc["scrape_monotonic"] = time.monotonic()
    if query.get("format") == "chrome":
        rank = query.get("rank")
        return 200, timeline.export_chrome_trace(
            doc["events"], rank=int(rank) if rank is not None else None)
    return 200, doc


def _history_doc(query):
    """(status, doc) for one ``/history`` query: the windowed sample
    points of a series plus the derived delta / per-second rate —
    computed from the SAME ring samples the response carries, so a
    client can re-derive (and a test hand-check) every number."""
    from .recorder import get_recorder
    rec = get_recorder()
    if rec is None:
        return 503, {"error": "no history recorder running (set "
                              "MXNET_TELEMETRY_HISTORY_SECS > 0 or call "
                              "telemetry.start_recorder())"}
    name = query.get("series")
    if not name:
        return 400, {"error": "pass ?series=<metric family name>",
                     "series": rec.series_names()}
    labels = None
    if query.get("labels"):
        labels = {}
        for part in query["labels"].split(","):
            if "=" not in part:
                return 400, {"error": "labels must be k=v[,k=v...], "
                                      "got %r" % query["labels"]}
            k, v = part.split("=", 1)
            labels[k.strip()] = v.strip()
    window_s = None
    if query.get("window"):
        try:
            window_s = float(query["window"])
        except ValueError:
            return 400, {"error": "window must be seconds, got %r"
                                  % query["window"]}
    kind = rec.kind(name)
    if kind is None:
        return 404, {"error": "series %r not in recorded history" % name,
                     "series": rec.series_names()}
    doc = {"series": name, "kind": kind, "labels": labels,
           "window_s": window_s, "interval_s": rec.interval_s,
           "samples_stored": len(rec), "scrape_ts": time.time()}
    if kind == "histogram":
        pts = rec.hist_points(name, labels, window_s)
        doc["samples"] = [[t, v] for t, v in pts]
        if query.get("q"):
            try:
                doc["quantile"] = {
                    "q": float(query["q"]),
                    "value": rec.quantile(name, float(query["q"]),
                                          labels, window_s)}
            except ValueError:
                return 400, {"error": "q must be a float in [0, 1], "
                                      "got %r" % query["q"]}
    else:
        pts = rec.points(name, labels, window_s)
        doc["samples"] = [[t, v] for t, v in pts]
    doc["delta"] = (pts[-1][1] - pts[0][1]) if len(pts) >= 2 else None
    dt = (pts[-1][0] - pts[0][0]) if len(pts) >= 2 else 0.0
    doc["rate_per_s"] = (doc["delta"] / dt
                         if doc["delta"] is not None and dt > 0 else None)
    return 200, doc


def _healthz(server):
    """Liveness + the two numbers an operator checks first: how deep
    the admission queues are and how full dispatched batches run.
    Derived from the registry (collect() runs the engine refresh
    callbacks), so it is exactly what /metrics would report.
    ``scrape_ts`` (wall clock) + ``scrape_monotonic`` stamp WHEN this
    document was rendered: multi-rank aggregation needs an orderable
    timestamp, which per-process uptime alone cannot give."""
    from . import registry, tracing
    from .alerts import default_manager
    from .recorder import get_recorder
    doc = registry().collect()
    qd = doc.get("mxnet_serve_queue_depth", {}).get("series", [])
    occ = doc.get("mxnet_serve_batch_occupancy", {}).get("series", [])
    occ_count = sum(s.get("count") or 0 for s in occ)
    occ_sum = sum(s.get("sum") or 0.0 for s in occ)
    out = {
        "status": "ok",
        "uptime_s": round(time.monotonic() - server.t_start, 3),
        "scrape_ts": time.time(),
        "scrape_monotonic": time.monotonic(),
        "port": server.port,
        "engines": len(qd),
        "queue_depth": sum(s.get("value") or 0 for s in qd),
        "batch_occupancy": (occ_sum / occ_count if occ_count else 0.0),
        "batches": occ_count,
        "traces_stored": len(tracing.recent_trace_ids()),
    }
    # continuous-batching decode engines: pool occupancy + throughput
    # counters (serving/decode.py), present only when one is live
    dec_slots = doc.get("mxnet_serve_decode_slots", {}).get("series", [])
    if dec_slots:
        def _total(name):
            return sum(s.get("value") or 0
                       for s in doc.get(name, {}).get("series", []))
        out["decode"] = {
            "engines": len(dec_slots),
            "slots": _total("mxnet_serve_decode_slots"),
            "slots_occupied": _total("mxnet_serve_decode_slots_occupied"),
            "tokens": _total("mxnet_serve_decode_tokens_total"),
            "steps": _total("mxnet_serve_decode_steps_total"),
            "joins": _total("mxnet_serve_decode_joins_total"),
            "leaves": _total("mxnet_serve_decode_leaves_total"),
            "evictions": _total("mxnet_serve_decode_evictions_total"),
        }
    # replica plane (serving/replica.py): one block per engine with a
    # row per device replica — health, in-flight load, traffic, and
    # failure counts joined across the mxnet_serve_replica_* families
    # (present only when a replica-aware engine is live)
    rep_health = doc.get("mxnet_serve_replica_healthy", {}) \
                    .get("series", [])
    if rep_health:
        def _by_replica(name):
            out_map = {}
            for s in doc.get(name, {}).get("series", []):
                lab = s.get("labels") or {}
                out_map[(lab.get("engine"), lab.get("replica"))] = \
                    s.get("value")
            return out_map
        inflight = _by_replica("mxnet_serve_replica_inflight")
        failures = _by_replica("mxnet_serve_replica_failures_total")
        batches = _by_replica("mxnet_serve_replica_batches_total")
        occupied = _by_replica("mxnet_serve_decode_slots_occupied")
        shards = _by_replica("mxnet_serve_replica_shards")
        blocks, unhealthy = {}, 0
        for s in rep_health:
            lab = s.get("labels") or {}
            eng, rep = lab.get("engine"), lab.get("replica")
            healthy = bool(s.get("value"))
            if not healthy:
                unhealthy += 1
            row = {"replica": rep, "healthy": healthy,
                   "inflight": inflight.get((eng, rep), 0) or 0,
                   "failures": failures.get((eng, rep), 0) or 0}
            if (eng, rep) in batches:
                row["batches"] = batches[(eng, rep)]
            if (eng, rep) in occupied:
                row["slots_occupied"] = occupied[(eng, rep)]
            if (eng, rep) in shards:
                # per-shard identity under the replica label: >1 =
                # this replica's programs span a pjit device group
                row["shards"] = int(shards[(eng, rep)] or 1)
            blocks.setdefault(eng, []).append(row)
        for rows in blocks.values():
            rows.sort(key=lambda r: str(r["replica"]))
        out["replicas"] = {
            "engines": blocks,
            "total": len(rep_health),
            "unhealthy": unhealthy,
        }
    # training processes: step count + live MFU per instrumented loop
    steps = doc.get("mxnet_train_steps_total", {}).get("series", [])
    if steps:
        out["train_steps"] = sum(s.get("value") or 0 for s in steps)
        out["train_mfu"] = {
            s["labels"].get("loop", "?"): s.get("value") or 0.0
            for s in doc.get("mxnet_train_mfu", {}).get("series", [])}
    # alerting plane: rule/firing counts + whether anything evaluates
    mgr = default_manager()
    if len(mgr):
        rec = get_recorder()
        out["alerts"] = {"rules": len(mgr), "firing": mgr.firing(),
                         "evaluating": bool(rec is not None
                                            and rec.alerts is mgr)}
    # pluggable sections (register_healthz_section): the replica
    # supervisor's probation table lives here
    with _SECTIONS_LOCK:
        sections = list(_HEALTHZ_SECTIONS.items())
    for name, fn in sections:
        try:
            block = fn()
        except Exception as e:
            block = {"error": repr(e)}
        if block is not None:
            out[name] = block
    return out


class TelemetryServer(object):
    """One daemonized ThreadingHTTPServer bound at construction (so
    ``port`` is final immediately, including the port-0 ephemeral
    case) and serving until :meth:`stop`."""

    def __init__(self, port, host=""):
        try:
            self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        except OSError as e:
            raise MXNetError(
                "telemetry server: cannot bind %s:%s (%s)"
                % (host or "0.0.0.0", port, e))
        self._httpd.daemon_threads = True
        self._httpd.telemetry_server = self
        self.host = host
        self.port = self._httpd.server_address[1]
        self.t_start = time.monotonic()
        self._stopping = threading.Event()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="mxnet-telemetry-http", daemon=True)
        self._thread.start()

    def stop(self):
        """Shut down and release the port; joins the acceptor thread so
        a caller can rebind the same port immediately after.  SSE
        subscriber loops are kicked first so their handler threads exit
        instead of idling out their keep-alive timers."""
        self._stopping.set()
        _HUB.kick_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# -- process-wide singleton + engine refcounting ----------------------------
#
# Two owners exist: an EXPLICIT start_server() (operator code / the
# import-time MXNET_TELEMETRY_PORT autostart), which only stop_server()
# ends, and ENGINE-ACQUIRED servers — the first ServingEngine to find
# MXNET_TELEMETRY_PORT set with no server running starts one, every
# engine holds a reference, and the last close() stops it.  That makes
# engine-reload loops leak-free without letting one engine's close tear
# down a server the operator started deliberately.

_LOCK = named_lock("telemetry.server")
_SERVER = None
_MANUAL = False          # True: outlives engine refcounting
_ENGINE_REFS = 0


def start_server(port=None, host=""):
    """Start (or replace) the process-wide telemetry HTTP server.
    ``port`` defaults to ``MXNET_TELEMETRY_PORT``; 0 binds an ephemeral
    port (read it back off the returned server's ``.port``)."""
    global _SERVER, _MANUAL, _ENGINE_REFS
    if port is None:
        from .. import config
        port = config.get("MXNET_TELEMETRY_PORT")
    if port is None or int(port) < 0:
        raise MXNetError(
            "telemetry server: no port (pass one or set "
            "MXNET_TELEMETRY_PORT >= 0; 0 = ephemeral)")
    with _LOCK:
        if _SERVER is not None:
            # clear BEFORE binding the replacement: if the new bind
            # fails, the module must know no server is live (a stale
            # reference would report a dead address and stop engines
            # from ever restarting the endpoint)
            _SERVER.stop()
            _SERVER = None
            _MANUAL = False
            _ENGINE_REFS = 0
        _SERVER = TelemetryServer(port, host)
        _MANUAL = True
        return _SERVER


def stop_server():
    """Stop the process-wide server (no-op when none is running)."""
    global _SERVER, _MANUAL, _ENGINE_REFS
    with _LOCK:
        if _SERVER is not None:
            _SERVER.stop()
        _SERVER = None
        _MANUAL = False
        _ENGINE_REFS = 0


def server_address():
    """``(host, port)`` of the live server, or ``None``."""
    with _LOCK:
        if _SERVER is None:
            return None
        return (_SERVER.host or "0.0.0.0", _SERVER.port)


def engine_acquire():
    """ServingEngine construction hook: ensure a server is running when
    ``MXNET_TELEMETRY_PORT`` asks for one.  Returns True when this
    engine now holds a reference (its close() must call
    :func:`engine_release`); False when no server is configured or an
    explicitly-started server already covers the process."""
    global _SERVER, _ENGINE_REFS
    with _LOCK:
        if _SERVER is not None:
            if _MANUAL:
                return False             # operator-owned: engines hands off
            _ENGINE_REFS += 1
            return True
        from .. import config
        port = config.get("MXNET_TELEMETRY_PORT")
        if port < 0:
            return False
        try:
            _SERVER = TelemetryServer(port)
        except MXNetError as e:
            # a taken port must degrade observability, never break
            # engine construction
            import warnings
            warnings.warn(str(e))
            return False
        _ENGINE_REFS = 1
        return True


def engine_release():
    """Drop one engine reference; the last one out stops the server
    (releasing port AND acceptor thread — engine-reload loops must not
    accumulate either)."""
    global _SERVER, _ENGINE_REFS
    with _LOCK:
        if _MANUAL or _SERVER is None:
            return
        _ENGINE_REFS = max(0, _ENGINE_REFS - 1)
        if _ENGINE_REFS == 0:
            _SERVER.stop()
            _SERVER = None
