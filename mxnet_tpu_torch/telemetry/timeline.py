"""Unified fleet timeline: one wall-aligned event plane for every
observability store.

The planes (metrics, span traces, alerts/flight recorder, FLOPs
ledger) each keep their own store on their own clock — answering "why was request X slow at 3am on replica
2" means mentally joining five tools.  This module is the join: a
process-wide, lock-cheap bounded ring of **dual-stamped** events
(wall-clock epoch seconds + the monotonic stamp the measuring site
actually read) that every plane feeds:

- span begin/end of every *retained* request trace (tracing.py),
- per-replica dispatch intervals (serving/engine.py),
- decode scheduler iterations, slot join/leave/steal/evict marks and
  coalesced prefill-group dispatches (serving/decode.py),
- alert state transitions and flight-bundle dumps (alerts.py,
  recorder.py),
- regulator limit changes (serving/regulator.py),
- supervisor rehab/retire outcomes (serving/supervisor.py),
- injected faults (serving/faults.py).

Discipline: with the plane off
(``MXNET_TELEMETRY_TIMELINE=0`` or telemetry off entirely) feed sites
hold no timeline reference, append NOTHING, and serving output is
bitwise-identical — tests pin both.  The **record path takes no
locks**: events append to a ``collections.deque(maxlen=...)`` (a
GIL-atomic operation).

Clock contract: every site measures with its native monotonic clock
(``perf_counter`` for spans/dispatches, ``monotonic`` for lock holds)
and the module converts to wall time through one anchor captured at
import (``wall_anchor()``).  Wall stamps are therefore *consistent
within a process* to sub-microsecond; across processes they inherit
NTP quality, which is why the cross-rank merge
(tools/telemetry_dump.py) reports a skew estimate instead of
pretending alignment is exact.

Export: :func:`export_chrome_trace` renders a window as Chrome
``trace_event`` JSON — ``pid`` = rank, ``tid`` = lane
(``replica:N``, ``decode:N``, ``locks``, ``alerts`` ...), ``B``/``E``
duration pairs, ``i`` instants for alerts/faults/flight dumps, ``C``
counter tracks (queue depth, occupancy, regulator limit) — loadable
directly in Perfetto / chrome://tracing.  ``GET /timeline`` serves the
same window live; flight bundles embed it; ``tools/request_autopsy.py``
joins it against one request's span tree.
"""
import collections
import itertools
import threading
import time

__all__ = [
    "enabled", "get", "reset", "wall_anchor", "wall_of_perf",
    "wall_of_mono", "Timeline", "export_chrome_trace",
    "complete", "instant", "counter",
]

# one anchor, captured back-to-back at import: converts the monotonic
# stamps sites already hold into wall time without a second clock read
# on the hot path
_WALL0 = time.time()
_PERF0 = time.perf_counter()
_MONO0 = time.monotonic()


def wall_anchor():
    """(wall0, perf0, mono0) — the conversion anchor, for tests and
    cross-rank tooling."""
    return (_WALL0, _PERF0, _MONO0)


def wall_of_perf(t):
    """Wall-clock epoch seconds of one ``time.perf_counter()`` stamp."""
    return _WALL0 + (t - _PERF0)


def wall_of_mono(t):
    """Wall-clock epoch seconds of one ``time.monotonic()`` stamp."""
    return _WALL0 + (t - _MONO0)


def enabled():
    """Master gate of the timeline plane: the telemetry switch AND
    ``MXNET_TELEMETRY_TIMELINE``.  Feed sites hold no timeline (and
    the ring never materializes) when this is off."""
    from . import enabled as _telemetry_on      # lazy: package cycle
    if not _telemetry_on():
        return False
    from .. import config
    return config.get("MXNET_TELEMETRY_TIMELINE")


class Timeline(object):
    """The bounded event ring.

    Events are small dicts (kept plain so export/merge tooling needs
    no class):

    - ``seq``   monotone id; doubles as the lifetime append counter
    - ``ph``    "X" complete (has ``dur``), "i" instant, "C" counter
    - ``name``  event name (``serve.dispatch``, ``alert.firing`` ...)
    - ``cat``   plane (``serve``, ``decode``, ``locks``, ``alerts``,
                ``faults``, ``regulator``, ``supervisor``, ``trace``)
    - ``lane``  Chrome ``tid`` lane (``replica:0``, ``locks``, ...)
    - ``wall``  wall-clock epoch seconds of the event start
    - ``mono``  the native monotonic stamp the site measured with
    - ``dur``   seconds ("X" only)
    - ``value`` number ("C" only)
    - ``args``  small JSON-able dict or absent

    The record path is lock-free: ``deque.append`` with ``maxlen`` is
    atomic under the GIL, and ``next(itertools.count())`` likewise.
    """

    def __init__(self, capacity=16384):
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._seq = itertools.count(1)
        self._last = 0

    # -- record (hot path: no locks, no instruments) ----------------------
    def complete(self, name, cat, lane, t0_perf, t1_perf, args=None):
        """Record one finished interval measured with perf_counter."""
        ev = {"seq": next(self._seq), "ph": "X", "name": name,
              "cat": cat, "lane": lane,
              "wall": _WALL0 + (t0_perf - _PERF0), "mono": t0_perf,
              "dur": t1_perf - t0_perf}
        if args:
            ev["args"] = args
        self._last = ev["seq"]
        self._ring.append(ev)

    def complete_mono(self, name, cat, lane, t0_mono, t1_mono,
                      args=None):
        """Record one finished interval measured with monotonic."""
        ev = {"seq": next(self._seq), "ph": "X", "name": name,
              "cat": cat, "lane": lane,
              "wall": _WALL0 + (t0_mono - _MONO0), "mono": t0_mono,
              "dur": t1_mono - t0_mono}
        if args:
            ev["args"] = args
        self._last = ev["seq"]
        self._ring.append(ev)

    def instant(self, name, cat, lane, args=None, wall=None):
        """Record one point event (alert flip, fault, dump, mark)."""
        t = time.perf_counter()
        ev = {"seq": next(self._seq), "ph": "i", "name": name,
              "cat": cat, "lane": lane,
              "wall": wall if wall is not None
              else _WALL0 + (t - _PERF0), "mono": t}
        if args:
            ev["args"] = args
        self._last = ev["seq"]
        self._ring.append(ev)

    def counter(self, name, cat, lane, value, args=None):
        """Record one counter-track sample (queue depth, occupancy,
        regulator limit)."""
        t = time.perf_counter()
        ev = {"seq": next(self._seq), "ph": "C", "name": name,
              "cat": cat, "lane": lane,
              "wall": _WALL0 + (t - _PERF0), "mono": t,
              "value": value}
        if args:
            ev["args"] = args
        self._last = ev["seq"]
        self._ring.append(ev)

    # -- read -------------------------------------------------------------
    def appended(self):
        """Lifetime append count — the zero-append pin reads this."""
        return self._last

    def dropped(self):
        """Events the bounded ring has already evicted."""
        return max(0, self._last - len(self._ring))

    def events(self, window_s=None):
        """Snapshot of the ring, oldest first, optionally restricted
        to the trailing ``window_s`` seconds of wall time.  The copy
        (``list(deque)``) is safe against concurrent appends."""
        evs = list(self._ring)
        if window_s is not None and evs:
            lo = time.time() - float(window_s)
            evs = [e for e in evs if e["wall"] >= lo]
        return evs

    def snapshot(self, window_s=None, limit=None):
        """Self-contained JSON document of the current window — the
        ``/timeline`` response body and the flight-bundle section."""
        evs = self.events(window_s)
        if limit is not None and len(evs) > limit:
            evs = evs[-int(limit):]
        return {"format": "mxnet_tpu.telemetry/timeline-1",
                "capacity": self.capacity,
                "appended": self.appended(),
                "dropped": self.dropped(),
                "window_s": window_s,
                "wall_anchor": list(wall_anchor()),
                "events": evs}

    def clear(self):
        self._ring.clear()


# ---------------------------------------------------------------- singleton

_TL = None
_TL_LOCK = threading.Lock()     # creation-only; never on a record path


def get():
    """The process-wide timeline (created on first use; capacity from
    ``MXNET_TELEMETRY_TIMELINE_CAP``).  Callers cache the result in
    the ``self._tl = timeline.get() if timeline.enabled() else None``
    idiom so disabled runs hold no reference at all."""
    global _TL
    tl = _TL
    if tl is None:
        with _TL_LOCK:
            if _TL is None:
                from .. import config
                _TL = Timeline(config.get("MXNET_TELEMETRY_TIMELINE_CAP"))
            tl = _TL
    return tl


def peek():
    """The singleton if it exists, else None — read-side helpers that
    must not materialize the ring use this."""
    return _TL


def reset():
    """Drop the singleton (tests).  Outstanding ``self._tl``
    references keep feeding the old ring, which is exactly the
    leak-gate question reload tests ask."""
    global _TL
    with _TL_LOCK:
        _TL = None


# -- module-level feeds for sites that cannot hold a reference -------------

def instant(name, cat, lane, args=None, wall=None):
    """Gated instant-event feed for cold paths (alert transitions,
    flight dumps, supervisor outcomes, regulator moves): one enabled()
    check per call, nothing when the plane is off."""
    if not enabled():
        return
    get().instant(name, cat, lane, args=args, wall=wall)


def complete(name, cat, lane, t0_perf, t1_perf, args=None):
    """Gated complete-event feed (cold paths)."""
    if not enabled():
        return
    get().complete(name, cat, lane, t0_perf, t1_perf, args=args)


def counter(name, cat, lane, value, args=None):
    """Gated counter-track feed (cold paths)."""
    if not enabled():
        return
    get().counter(name, cat, lane, value, args=args)


# ---------------------------------------------------------------- export

def export_chrome_trace(events, rank=None, process_name=None):
    """Render timeline events as a Chrome ``trace_event`` JSON object
    (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
    — the format Perfetto and chrome://tracing load).

    - ``pid`` = ``rank`` (0 when unranked) so a cross-rank merge puts
      each rank in its own process group;
    - ``tid`` = the event's lane (``replica:0``, ``decode.sched``,
      ``locks``, ``alerts`` ...), named via metadata events;
    - complete events emit ``B``/``E`` duration pairs;
    - instants emit ``ph="i"`` with thread scope;
    - counters emit ``ph="C"`` tracks;
    - ``ts`` is **absolute wall-clock microseconds**, so traces from
      several ranks concatenate into one aligned view.
    """
    pid = int(rank) if rank is not None else 0
    out = []
    tids = {}

    def tid_of(lane):
        tid = tids.get(lane)
        if tid is None:
            tid = tids[lane] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": str(lane)}})
        return tid

    out.append({"ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": process_name or
                         ("rank %d" % pid if rank is not None
                          else "mxnet_tpu_torch")}})
    for ev in sorted(events, key=lambda e: e["wall"]):
        ts = ev["wall"] * 1e6
        tid = tid_of(ev.get("lane") or ev.get("cat") or "events")
        base = {"name": ev["name"], "cat": ev.get("cat") or "events",
                "pid": pid, "tid": tid}
        args = ev.get("args")
        ph = ev.get("ph")
        if ph == "X":
            b = dict(base, ph="B", ts=ts)
            if args:
                b["args"] = args
            out.append(b)
            out.append(dict(base, ph="E",
                            ts=ts + max(0.0, ev.get("dur") or 0.0) * 1e6))
        elif ph == "C":
            out.append(dict(base, ph="C", ts=ts,
                            args={"value": ev.get("value")}))
        else:
            i = dict(base, ph="i", ts=ts, s="t")
            if args:
                i["args"] = args
            out.append(i)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"format": "mxnet_tpu.telemetry/timeline-1",
                          "rank": rank}}
