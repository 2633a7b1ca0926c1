"""Profiler: a Chrome-trace ring of host spans, and a device capture.

Counterpart of ``mxnet_tpu/profiler.py``.  Reference:
src/engine/profiler.cc (per-op `OprExecStat` records dumped as Chrome
trace-event JSON, `DumpProfile:147`), python/mxnet/profiler.py:27-55
(`profiler_set_config`, `profiler_set_state`, `dump_profile`), autostart
env `MXNET_PROFILER_AUTOSTART` (profiler.cc:66).

- host-side REGIONS (forward/backward/update/io/eager ops) are recorded
  as Chrome trace-event spans: same dump format, same `dump_profile()`
  contract, loadable in chrome://tracing / perfetto;
- for the device's view, `start_xla_trace(logdir)` / `stop_xla_trace()`
  keep the reference's names and run a `torch.profiler` capture with CPU
  and CUDA activities, written as a Chrome trace under ``logdir``.  A
  capture of a CUDA device that recorded no CUDA event raises: it never
  hands back a host-only trace as if it were the device's.

Spans are cheap (two perf_counter calls + list append when ON, one branch
when OFF).

The event buffer is BOUNDED (serving runs keep the profiler on for
days): at most ``MXNET_PROFILER_MAX_EVENTS`` events are held, oldest
dropped first; the drop count is reported in the dump's
``otherData.dropped_events``.  ``clear()`` empties the buffer without
writing a file.
"""
import atexit
import collections
import json
import os
import threading
import time


def _default_max_events():
    from . import config
    return config.get("MXNET_PROFILER_MAX_EVENTS")


_LOCK = threading.Lock()
_EVENTS = collections.deque(maxlen=_default_max_events())
_DROPPED = 0
_STATE = {"running": False, "filename": "profile.json",
          "continuous_dump": False}
_T0 = time.perf_counter()


def _append(evt):
    """Append under the lock, counting ring-buffer evictions."""
    global _DROPPED
    if len(_EVENTS) == _EVENTS.maxlen:
        _DROPPED += 1
    _EVENTS.append(evt)


_MAX_EVENTS_OVERRIDDEN = False


def set_max_events(n):
    """Re-bound the event buffer (keeps the newest events if shrinking;
    anything discarded counts toward ``dropped_events``).  An explicit
    call pins the bound — profiler_set_state('run') stops re-reading
    MXNET_PROFILER_MAX_EVENTS from the live config."""
    global _EVENTS, _DROPPED, _MAX_EVENTS_OVERRIDDEN
    with _LOCK:
        _MAX_EVENTS_OVERRIDDEN = True
        n = int(n)
        if len(_EVENTS) > n:
            _DROPPED += len(_EVENTS) - n
        _EVENTS = collections.deque(_EVENTS, maxlen=n)


def clear():
    """Drop all buffered events and the eviction counter (long serving
    runs call this after each periodic dump/scrape)."""
    global _DROPPED
    with _LOCK:
        _EVENTS.clear()
        _DROPPED = 0


def dropped_events():
    """Events evicted from the bounded buffer since the last clear."""
    with _LOCK:
        return _DROPPED


def _now_us():
    return (time.perf_counter() - _T0) * 1e6


def profiler_set_config(mode="symbolic", filename="profile.json",
                        continuous_dump=False, **kwargs):
    """Configure output path (ref profiler.py:profiler_set_config).

    ``mode`` is accepted for API parity; all host regions are recorded."""
    _STATE["filename"] = filename
    _STATE["continuous_dump"] = continuous_dump


def set_config(**kwargs):
    profiler_set_config(**kwargs)


def profiler_set_state(state="stop"):
    """'run' starts collecting host spans; 'stop' halts (ref :40)."""
    assert state in ("run", "stop")
    if state == "run" and not _MAX_EVENTS_OVERRIDDEN:
        # honor the live config like every other MXNET_* knob (the
        # import-time default would ignore env changes made after
        # `import mxnet_tpu_torch`); an explicit set_max_events() wins
        global _EVENTS, _DROPPED
        with _LOCK:
            n = _default_max_events()
            if _EVENTS.maxlen != n:
                if len(_EVENTS) > n:
                    _DROPPED += len(_EVENTS) - n
                _EVENTS = collections.deque(_EVENTS, maxlen=n)
    _STATE["running"] = state == "run"


def set_state(state="stop"):
    profiler_set_state(state)


def is_running():
    return _STATE["running"]


class record_span:
    """Context manager: one Chrome trace 'X' (complete) event.

    Categories mirror the reference's lanes: 'forward', 'backward',
    'update', 'io', 'op', 'kvstore'.
    """
    __slots__ = ("name", "cat", "_t0")

    def __init__(self, name, cat="op"):
        self.name = name
        self.cat = cat
        self._t0 = 0.0

    def __enter__(self):
        if _STATE["running"]:
            self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        if _STATE["running"] and self._t0:
            t1 = _now_us()
            with _LOCK:
                _append({
                    "name": self.name, "cat": self.cat, "ph": "X",
                    "ts": self._t0, "dur": t1 - self._t0,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() & 0xffff})
        return False


def add_span_event(name, cat, t0, t1, args=None):
    """Append one already-measured complete ('X') event.  ``t0``/``t1``
    are ``time.perf_counter()`` values — the clock this ring is
    anchored to.  The bridge the telemetry span trees use to land
    request spans (tagged with their trace_id arg) on the same
    chrome://tracing timeline as the host regions."""
    if _STATE["running"]:
        evt = {"name": name, "cat": cat, "ph": "X",
               "ts": (t0 - _T0) * 1e6, "dur": (t1 - t0) * 1e6,
               "pid": os.getpid(),
               "tid": threading.get_ident() & 0xffff}
        if args:
            evt["args"] = dict(args)
        with _LOCK:
            _append(evt)


def instant(name, cat="marker"):
    """Instant event (counter markers, epoch boundaries)."""
    if _STATE["running"]:
        with _LOCK:
            _append({"name": name, "cat": cat, "ph": "i",
                            "ts": _now_us(), "s": "g",
                            "pid": os.getpid(),
                            "tid": threading.get_ident() & 0xffff})


def counter(name, value, cat="counter"):
    """Counter sample (e.g. images/sec, loss)."""
    if _STATE["running"]:
        with _LOCK:
            _append({"name": name, "cat": cat, "ph": "C",
                            "ts": _now_us(), "pid": os.getpid(),
                            "args": {name: value}})


def dump_profile(finished=True):
    """Write the Chrome trace JSON (ref MXDumpProfile / profiler.cc:147)."""
    global _DROPPED
    with _LOCK:
        events = list(_EVENTS)
        dropped = _DROPPED
        capacity = _EVENTS.maxlen
        if finished:
            _EVENTS.clear()
            _DROPPED = 0
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"framework": "mxnet_tpu_torch",
                         "dropped_events": dropped,
                         "max_events": capacity}}
    with open(_STATE["filename"], "w") as f:
        json.dump(doc, f)
    return _STATE["filename"]


def dump(finished=True):
    return dump_profile(finished)


def dumps():
    """In-memory dump.  Carries the same self-describing metadata as
    the file dump: a consumer can tell a truncated trace (ring
    evictions) from a complete one without the file context."""
    with _LOCK:
        return json.dumps({"traceEvents": list(_EVENTS),
                           "otherData": {"framework": "mxnet_tpu_torch",
                                         "dropped_events": _DROPPED,
                                         "max_events": _EVENTS.maxlen}})


def pause():
    _STATE["running"] = False


def resume():
    _STATE["running"] = True


# -- device-side capture (torch.profiler) -----------------------------------

_CAPTURE = None         # (torch.profiler.profile, logdir, device) while open


def start_xla_trace(logdir="profile_trace"):
    """Begin a ``torch.profiler`` capture with CPU and, where a card is
    present, CUDA activities.  The name is the reference's, so its
    callers find it; :func:`stop_xla_trace` writes the capture's Chrome
    trace under ``logdir``."""
    global _CAPTURE
    import torch
    if _CAPTURE is not None:
        raise RuntimeError("a device capture is already open (%s)"
                           % _CAPTURE[1])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _CAPTURE = (prof, logdir, device)
    return logdir


def _device_events(prof):
    return [e for e in prof.events()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]


def stop_xla_trace():
    """End the capture opened by :func:`start_xla_trace`, write its
    Chrome trace as ``<logdir>/trace.json`` and return that path.  With a
    card, a capture that recorded no CUDA event raises ``RuntimeError``
    (the trace is still written, for inspection)."""
    global _CAPTURE
    if _CAPTURE is None:
        raise RuntimeError("stop_xla_trace without start_xla_trace")
    prof, logdir, device = _CAPTURE
    _CAPTURE = None
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if device.type == "cuda" and not _device_events(prof):
        raise RuntimeError("torch.profiler recorded no CUDA event on %s "
                           "(host-only trace at %s)" % (device, path))
    return path


# autostart parity: MXNET_PROFILER_AUTOSTART=1 (profiler.cc:66)
def _maybe_autostart():
    from . import config
    if config.get("MXNET_PROFILER_AUTOSTART"):
        profiler_set_state("run")
        atexit.register(dump_profile)


_maybe_autostart()
