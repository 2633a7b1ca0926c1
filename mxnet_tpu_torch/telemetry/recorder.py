"""In-process time-series history + heartbeats + black-box flight recorder.

Every signal the telemetry plane exposed before this module was
point-in-time: a ``/metrics`` scrape, a ``/healthz`` probe, a rank
snapshot — each one a single ``Registry.collect()`` instant.  Rates,
deltas, and "is p99 getting worse" could only be answered by an
EXTERNAL Prometheus that fleet deployments cannot assume, and
a wedged engine (the failure mode the donated-buffer hardening in
serving/decode.py exists to prevent) died silently with zero
diagnostics.  This module adds the time dimension and the failure
dimension in-process:

- :class:`HistoryRecorder` — a sampler thread that snapshots the
  metrics registry into a bounded in-memory ring (``deque(maxlen=N)``:
  memory is bounded by construction) of flattened samples, giving true
  ``rate()`` / ``delta()`` / windowed-quantile queries over any
  counter/gauge/histogram series with zero external infra.  The live
  endpoint serves them at ``GET /history?series=&window=``;
- **heartbeats** — engine worker loops stamp ``last_progress``
  timestamps the recorder polls, so a wedged dispatch or a starved
  queue is *named* (``serve.<engine>`` / ``decode.<engine>``), not
  inferred from second-order silence;
- :class:`FlightRecorder` — the black box: on any alert firing
  (telemetry/alerts.py, including the zero-progress watchdog rules the
  engines register) it atomically dumps a post-mortem bundle — the
  trailing history window, every rule's state, retained trace trees,
  per-engine ``stats()``, heartbeats, and all-thread stacks via
  ``faulthandler`` — under ``MXNET_FLIGHT_RECORDER_DIR``.  Fatal
  signals (SIGSEGV/SIGFPE/SIGABRT) are covered by a
  ``faulthandler.enable`` file in the same directory, installed at
  telemetry import.  ``tools/telemetry_dump.py bundle`` reads bundles
  back.

Lifecycle mirrors the HTTP endpoint (server.py): an explicit
``start_recorder()`` is operator-owned; otherwise the first
ServingEngine/DecodeEngine built with telemetry enabled and
``MXNET_TELEMETRY_HISTORY_SECS`` > 0 starts the process singleton, every
engine holds a reference, and the last ``close()`` stops the sampler
thread — reload-in-a-loop leaks neither the thread nor the ring.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
import weakref

from ..base import MXNetError
from ..locks import named_lock

__all__ = ["HistoryRecorder", "FlightRecorder", "start_recorder",
           "stop_recorder", "get_recorder", "recorder_acquire",
           "recorder_release", "register_heartbeat",
           "unregister_heartbeat", "heartbeats", "register_engine",
           "unregister_engine", "engine_stats", "flight_recorder",
           "series_key"]


def series_key(name, labels=None):
    """Canonical string key for one labeled series — the form history
    exports and ``/history`` queries use."""
    if not labels:
        return name
    items = sorted(labels.items() if isinstance(labels, dict) else labels)
    return "%s{%s}" % (name, ",".join("%s=%s" % kv for kv in items))


def _label_tuple(labels):
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _matches(labelkey, want):
    """Subset match: every (k, v) the query names must appear in the
    series' label tuple (a rule matching ``{engine: 0}`` must see the
    retraces series whatever its ``hazards`` label says)."""
    if not want:
        return True
    have = dict(labelkey)
    return all(have.get(k) == str(v) for k, v in want)


class _Sample(object):
    """One flattened registry snapshot: scalar series by family name,
    histogram series by family name.  Tuples, not live instruments —
    the ring must be immutable history, not views into moving state."""
    __slots__ = ("t", "wall", "scalars", "hists")

    def __init__(self, t, wall, scalars, hists):
        self.t = t              # time.monotonic()
        self.wall = wall        # time.time() — cross-process ordering
        self.scalars = scalars  # {name: {labeltuple: float}}
        self.hists = hists      # {name: {labeltuple: (counts, sum, cnt)}}


class HistoryRecorder(object):
    """Bounded ring of registry samples + windowed queries over it.

    ``interval_s`` is the sampler period (and therefore the alert
    evaluation interval); ``window`` the ring capacity in samples.
    ``alerts`` optionally attaches an
    :class:`~mxnet_tpu_torch.telemetry.alerts.AlertManager` evaluated after
    every sample.  ``start=False`` builds a recorder tests drive by
    hand with :meth:`sample_now` — queries behave identically.
    """

    def __init__(self, interval_s=1.0, window=600, registry=None,
                 alerts=None, start=True):
        if interval_s <= 0:
            raise MXNetError("HistoryRecorder interval_s must be > 0")
        if int(window) < 2:
            raise MXNetError("HistoryRecorder window must hold >= 2 "
                             "samples (deltas need two endpoints)")
        self.interval_s = float(interval_s)
        self.window = int(window)
        self._registry = registry
        self.alerts = alerts
        self._ring = collections.deque(maxlen=self.window)
        self._kinds = {}
        self._lock = named_lock("telemetry.recorder")
        self._stop = threading.Event()
        self._thread = None
        self.t_start = time.monotonic()
        if start:
            self._thread = threading.Thread(
                target=self._run, name="mxnet-telemetry-recorder",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ sampling
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from . import registry as _default
        return _default()

    def sample_now(self, evaluate=True):
        """Take one sample (and evaluate the attached alert rules).
        Returns the sample's monotonic timestamp."""
        doc = self._reg().collect()
        t, wall = time.monotonic(), time.time()
        scalars, hists = {}, {}
        for name, fam in doc.items():
            kind = fam.get("kind")
            self._kinds[name] = kind
            for s in fam.get("series", ()):
                lk = _label_tuple(s.get("labels"))
                if kind == "histogram":
                    hists.setdefault(name, {})[lk] = (
                        tuple(s.get("counts") or ()),
                        float(s.get("sum") or 0.0),
                        int(s.get("count") or 0),
                        tuple(s.get("buckets") or ()))
                else:
                    v = s.get("value")
                    if v is not None:
                        scalars.setdefault(name, {})[lk] = float(v)
        with self._lock:
            self._ring.append(_Sample(t, wall, scalars, hists))
        if evaluate and self.alerts is not None:
            try:
                self.alerts.evaluate(self, now=t)
            except Exception:
                pass            # a broken rule must never kill sampling
        return t

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------- queries
    def _window_samples(self, window_s=None, now=None):
        with self._lock:
            samples = list(self._ring)
        if window_s is None or not samples:
            return samples
        now = samples[-1].t if now is None else now
        lo = now - float(window_s)
        return [s for s in samples if s.t >= lo]

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def kind(self, name):
        return self._kinds.get(name)

    def series_names(self):
        return sorted(self._kinds)

    def points(self, name, labels=None, window_s=None, now=None):
        """[(t_monotonic, value)] for the matching scalar series inside
        the window; series matching ``labels`` as a subset are SUMMED
        per sample (the retraces family fans out over a hazards label
        one query should not have to enumerate)."""
        want = _label_tuple(labels) if labels else ()
        out = []
        for s in self._window_samples(window_s, now):
            by_label = s.scalars.get(name)
            if not by_label:
                continue
            vals = [v for lk, v in by_label.items() if _matches(lk, want)]
            if vals:
                out.append((s.t, sum(vals)))
        return out

    def latest(self, name, labels=None):
        """Most recent value of a scalar series (summed across subset-
        matching label sets), or None when absent from the last sample."""
        pts = self.points(name, labels)
        if not pts:
            return None
        with self._lock:
            last_t = self._ring[-1].t if self._ring else None
        if last_t is None or pts[-1][0] != last_t:
            return None
        return pts[-1][1]

    def delta(self, name, labels=None, window_s=None, now=None):
        """last - first over the window; None with < 2 points.  Over a
        counter this is the EXACT event count between the two samples
        (floats are exact integers here), the number ``/history`` rate
        queries are held to."""
        pts = self.points(name, labels, window_s, now)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, name, labels=None, window_s=None, now=None):
        """delta / elapsed seconds between the window's endpoints."""
        pts = self.points(name, labels, window_s, now)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / dt

    def _hist_endpoints(self, name, labels=None, window_s=None, now=None):
        want = _label_tuple(labels) if labels else ()
        found = []
        for s in self._window_samples(window_s, now):
            by_label = s.hists.get(name)
            if not by_label:
                continue
            agg = None
            bounds = None
            for lk, (counts, total, cnt, bnds) in by_label.items():
                if not _matches(lk, want):
                    continue
                if agg is None:
                    agg = [list(counts), total, cnt]
                    bounds = bnds
                elif bnds == bounds:
                    agg[0] = [a + b for a, b in zip(agg[0], counts)]
                    agg[1] += total
                    agg[2] += cnt
            if agg is not None:
                found.append((s.t, agg, bounds))
        return found

    def hist_points(self, name, labels=None, window_s=None, now=None):
        """[(t, cumulative observation count)] for a histogram series."""
        return [(t, agg[2]) for t, agg, _ in
                self._hist_endpoints(name, labels, window_s, now)]

    def quantile(self, name, q, labels=None, window_s=None, now=None):
        """Windowed quantile: the bucket-count DELTA between the
        window's first and last samples is a histogram of exactly the
        observations that landed inside the window; interpolate the
        quantile from it (Prometheus ``histogram_quantile`` semantics:
        linear within the bucket, the +Inf bucket clamps to the top
        finite bound).  None with < 2 samples or zero observations."""
        found = self._hist_endpoints(name, labels, window_s, now)
        if len(found) < 2:
            return None
        (_, first, bounds), (_, last, bounds2) = found[0], found[-1]
        if bounds != bounds2 or not bounds:
            return None
        dcounts = [b - a for a, b in zip(first[0], last[0])]
        total = sum(dcounts)
        if total <= 0:
            return None
        q = min(1.0, max(0.0, float(q)))
        target = q * total
        acc = 0.0
        for i, c in enumerate(dcounts):
            acc += c
            if acc >= target and c > 0:
                if i >= len(bounds):            # +Inf bucket
                    return float(bounds[-1])
                lo = bounds[i - 1] if i > 0 else 0.0
                hi = bounds[i]
                frac = (target - (acc - c)) / c
                return lo + (hi - lo) * frac
        return float(bounds[-1])

    # -------------------------------------------------------------- export
    def export(self, window_s=None):
        """JSON-able trailing history window — what the flight-recorder
        bundle embeds and ``telemetry_dump history`` renders offline."""
        samples = self._window_samples(window_s)
        out = []
        for s in samples:
            scalars = {}
            for name, by_label in s.scalars.items():
                for lk, v in by_label.items():
                    scalars[series_key(name, lk)] = v
            hists = {}
            for name, by_label in s.hists.items():
                for lk, (counts, total, cnt, bnds) in by_label.items():
                    hists[series_key(name, lk)] = {
                        "counts": list(counts), "sum": total,
                        "count": cnt, "buckets": list(bnds)}
            out.append({"t": s.t, "wall": s.wall,
                        "scalars": scalars, "hists": hists})
        return {"interval_s": self.interval_s, "window": self.window,
                "kinds": dict(self._kinds), "samples": out}


# -- heartbeats --------------------------------------------------------------
#
# A heartbeat is a callable returning a small dict with at least
# {"age_s": float, "busy": bool}: age since the worker loop last made
# progress, and whether it HAS work (a quiet engine idle-blocked on its
# queue is healthy however stale its stamp).  Engines register one per
# worker; the watchdog alert rules poll them through the recorder.
# WeakMethod storage: an engine GC'd without close() must drop out of
# the poll instead of being kept alive by its own diagnostics.

_HB_LOCK = named_lock("telemetry.heartbeats")
_HEARTBEATS = {}


def register_heartbeat(name, fn):
    """Register ``fn() -> {"age_s", "busy", ...}`` under ``name``
    (convention: ``<kind>.<engine_label>``).  Re-registration replaces."""
    try:
        ref = weakref.WeakMethod(fn)
    except TypeError:
        ref = lambda f=fn: f        # plain function: strong ref is fine
    with _HB_LOCK:
        _HEARTBEATS[name] = ref


def unregister_heartbeat(name):
    with _HB_LOCK:
        _HEARTBEATS.pop(name, None)


def heartbeats():
    """{name: status dict} polling every live heartbeat; dead weakrefs
    self-evict, a raising callback reports itself instead of breaking
    the watchdog sweep."""
    with _HB_LOCK:
        items = list(_HEARTBEATS.items())
    out, dead = {}, []
    for name, ref in items:
        fn = ref()
        if fn is None:
            dead.append(name)
            continue
        try:
            out[name] = dict(fn())
        except Exception as e:
            out[name] = {"age_s": 0.0, "busy": False, "error": repr(e)}
    if dead:
        with _HB_LOCK:
            for name in dead:
                _HEARTBEATS.pop(name, None)
    return out


# -- live-engine registry (flight-recorder stats() capture) ------------------

_ENG_LOCK = named_lock("telemetry.recorder.engines")
_ENGINES = {}


def register_engine(name, engine):
    with _ENG_LOCK:
        _ENGINES[name] = weakref.ref(engine)


def unregister_engine(name):
    with _ENG_LOCK:
        _ENGINES.pop(name, None)


def engine_stats():
    """{name: engine.stats()} for every live registered engine; a
    wedged engine whose stats() would block behind the worker lock is
    reported as unavailable rather than hanging the dump."""
    with _ENG_LOCK:
        items = list(_ENGINES.items())
    out = {}
    for name, ref in items:
        eng = ref()
        if eng is None:
            continue
        try:
            out[name] = eng.stats()
        except Exception as e:
            out[name] = {"error": repr(e)}
    return out


# -- flight recorder ---------------------------------------------------------

_FLIGHT_SEQ = itertools.count()


class FlightRecorder(object):
    """Atomic post-mortem bundle writer.

    ``dump()`` assembles everything an operator needs when the process
    is about to be unreachable — firing rules, heartbeats (naming the
    wedged worker), per-engine stats, the trailing history window, the
    current metrics snapshot, retained traces, and all-thread stacks
    via ``faulthandler`` — and publishes it with the same
    tmp-file + ``os.replace`` discipline every snapshot writer here
    uses: a reader never observes a torn bundle.  Dumps are rate-
    limited per reason (a flapping alert must not fill the disk) and
    the directory is pruned to ``max_bundles``.
    """

    def __init__(self, directory, max_bundles=16, min_interval_s=30.0):
        self.directory = directory
        self.max_bundles = int(max_bundles)
        self.min_interval_s = float(min_interval_s)
        self._lock = named_lock("telemetry.flight")
        self._last = {}          # reason -> monotonic of last dump

    @staticmethod
    def thread_stacks():
        """All-thread stack dump text via faulthandler (the same
        machinery fatal signals use, so both paths render alike)."""
        import faulthandler
        import tempfile
        try:
            with tempfile.TemporaryFile(mode="w+") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
                f.seek(0)
                return f.read()
        except Exception:
            # no usable fd (embedded interpreters): pure-python fallback
            import sys
            import traceback
            lines = []
            for tid, frame in sys._current_frames().items():
                lines.append("Thread %d:" % tid)
                lines.extend(l.rstrip() for l in
                             traceback.format_stack(frame))
            return "\n".join(lines)

    def dump(self, reason, detail=None, recorder=None, alerts=None,
             window_s=None):
        """Write one bundle; returns its path, or None when rate-
        limited.  Never raises — the black box must not be able to
        crash the process it is recording."""
        try:
            return self._dump(reason, detail, recorder, alerts, window_s)
        except Exception:
            return None

    def _dump(self, reason, detail, recorder, alerts, window_s):
        now = time.monotonic()
        with self._lock:
            t_last = self._last.get(reason)
            if t_last is not None and now - t_last < self.min_interval_s:
                return None
            self._last[reason] = now
        from . import registry, timeline, tracing
        from .export import _finite
        if recorder is None:
            recorder = get_recorder()
        if alerts is None and recorder is not None:
            alerts = recorder.alerts
        # the dump itself is a timeline moment (and the bundle embeds
        # the window below): post-mortems can see every dump in context
        timeline.instant("flight.dump", "alerts", "alerts",
                         args={"reason": str(reason)})
        bundle = {
            "format": "mxnet_tpu.telemetry/flight-1",
            "reason": reason,
            "detail": detail,
            "pid": os.getpid(),
            "wall_time": time.time(),
            "scrape_ts": time.time(),
            "scrape_monotonic": now,
            "alerts": (alerts.states() if alerts is not None else []),
            "heartbeats": heartbeats(),
            "engines": engine_stats(),
            "history": (recorder.export(window_s)
                        if recorder is not None else None),
            "metrics": registry().collect(),
            "traces": tracing.all_traces(),
            "timeline": (timeline.get().snapshot(window_s, limit=4096)
                         if timeline.enabled() else None),
            "thread_stacks": self.thread_stacks(),
        }
        os.makedirs(self.directory, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in str(reason))[:80]
        name = "flight_%s_%06d_%s.json" % (
            time.strftime("%Y%m%dT%H%M%S"), next(_FLIGHT_SEQ), safe)
        path = os.path.join(self.directory, name)
        # dot-prefixed tmp: a reader globbing flight_* (operators,
        # tools/telemetry_dump.py, tests) must never pick up a
        # half-written bundle mid-dump — the atomic-write promise
        # covers the LISTING, not just the final rename
        tmp = os.path.join(self.directory,
                           ".%s.tmp.%d" % (name, os.getpid()))
        try:
            with open(tmp, "w") as f:
                json.dump(_finite(bundle), f, indent=1, sort_keys=True,
                          allow_nan=False)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._prune()
        try:
            from .server import publish_event
            publish_event("flight", {"path": path, "reason": reason})
        except Exception:
            pass
        return path

    def _prune(self):
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.startswith("flight_")
                           and n.endswith(".json"))
            for n in names[:-self.max_bundles]:
                os.unlink(os.path.join(self.directory, n))
        except OSError:
            pass


_FR_LOCK = named_lock("telemetry.flight.global")
_FR = None
_FR_DIR = None


def flight_recorder():
    """The process flight recorder per ``MXNET_FLIGHT_RECORDER_DIR``
    (None when unset) — rebuilt if the knob changes between calls."""
    global _FR, _FR_DIR
    from .. import config
    d = config.get("MXNET_FLIGHT_RECORDER_DIR")
    with _FR_LOCK:
        if not d:
            _FR, _FR_DIR = None, None
        elif _FR is None or _FR_DIR != d:
            _FR = FlightRecorder(d)
            _FR_DIR = d
        return _FR


# -- process-wide singleton + engine refcounting (server.py discipline) ------

_LOCK = named_lock("telemetry.recorder.global")
_REC = None
_MANUAL = False
_REFS = 0
_GEN = 0        # bumps per installed recorder: stale releases can't
                # stop a NEWER recorder other engines still hold


def _build_from_config(interval_s=None, window=None):
    from .. import config
    if interval_s is None:
        interval_s = config.get("MXNET_TELEMETRY_HISTORY_SECS")
    if interval_s is None or float(interval_s) <= 0:
        return None
    if window is None:
        window = config.get("MXNET_TELEMETRY_HISTORY_WINDOW")
    alerts = None
    if config.get("MXNET_TELEMETRY_ALERTS"):
        from .alerts import default_manager, load_rules_file
        alerts = default_manager()
        # operator SLOs from the declarative rules file join the
        # manager the moment something starts evaluating it — a rules
        # file nobody evaluates would be a silently dead SLO surface.
        # Idempotent: already-registered names are skipped.
        try:
            load_rules_file(manager=alerts)
        except Exception:
            pass                # defensive: never block the recorder
    return HistoryRecorder(float(interval_s), int(window), alerts=alerts)


def start_recorder(interval_s=None, window=None):
    """Start (or replace) the process-wide history recorder,
    operator-owned: only :func:`stop_recorder` ends it.  Arguments
    default to the ``MXNET_TELEMETRY_HISTORY_*`` env tier."""
    global _REC, _MANUAL, _REFS, _GEN
    with _LOCK:
        if _REC is not None:
            _REC.stop()
            _REC, _MANUAL, _REFS = None, False, 0
        rec = _build_from_config(interval_s, window)
        if rec is None:
            raise MXNetError(
                "history recorder: no interval (pass interval_s or set "
                "MXNET_TELEMETRY_HISTORY_SECS > 0)")
        _REC, _MANUAL = rec, True
        _GEN += 1
        return rec


def stop_recorder():
    """Stop the process-wide recorder (no-op when none runs)."""
    global _REC, _MANUAL, _REFS
    with _LOCK:
        if _REC is not None:
            _REC.stop()
        _REC, _MANUAL, _REFS = None, False, 0


def get_recorder():
    """The live process-wide recorder, or None."""
    with _LOCK:
        return _REC


def recorder_acquire():
    """Engine construction hook (mirrors server.engine_acquire): ensure
    a recorder is sampling when MXNET_TELEMETRY_HISTORY_SECS asks for
    one.  Returns a truthy generation token when this engine holds a
    reference (pass it to :func:`recorder_release` at close; a stale
    token can never stop a newer recorder other engines still hold),
    False when the engine holds nothing (off, misconfigured, or an
    operator-owned recorder is running)."""
    global _REC, _REFS, _GEN
    with _LOCK:
        if _REC is not None:
            if _MANUAL:
                return False
            _REFS += 1
            return _GEN
        try:
            rec = _build_from_config()
        except Exception as e:
            # a misconfigured knob must not silently disable the whole
            # history/alerting/watchdog plane — the silent-death mode
            # this module exists to eliminate
            import warnings
            warnings.warn("telemetry history recorder disabled: cannot "
                          "build from MXNET_TELEMETRY_HISTORY_* config "
                          "(%s)" % (e,))
            return False
        if rec is None:
            return False
        _REC = rec
        _REFS = 1
        _GEN += 1
        return _GEN


def recorder_release(token=None):
    """Drop one engine reference; the last one out stops the sampler
    thread (reload loops must not accumulate threads or rings).  A
    ``token`` from an older recorder generation (the operator stopped /
    restarted the recorder in between) is a no-op."""
    global _REC, _REFS
    with _LOCK:
        if _MANUAL or _REC is None:
            return
        if token is not None and token != _GEN:
            return
        _REFS = max(0, _REFS - 1)
        if _REFS == 0:
            _REC.stop()
            _REC = None
