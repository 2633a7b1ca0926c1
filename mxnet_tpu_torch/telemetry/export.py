"""Exporters: Prometheus text exposition, JSON snapshots, periodic dump.

Two machine formats over one ``Registry.collect()`` snapshot:

- ``render_prometheus`` — the text exposition format scrapers ingest
  (``# HELP``/``# TYPE`` headers, cumulative ``_bucket{le=...}``
  histogram series ending in ``+Inf``, ``_sum``/``_count``);
- ``render_json`` — the collect() dict plus the finished-trace store,
  the self-contained document ``tools/telemetry_dump.py`` renders
  offline.

Plus a **snapshot thread**: serving processes run for days with nobody
attached, so a daemon thread periodically writes the current snapshot
to a file (atomic replace — a scraper/tailer never sees a torn write)
or stdout.  Configured by ``MXNET_TELEMETRY_SNAPSHOT_SECS`` / ``_PATH``
/ ``_FORMAT``; started lazily at first telemetry import and stoppable
for tests.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import sys
import threading

from ..base import MXNetError

_TMP_SEQ = itertools.count()

__all__ = ["render_prometheus", "render_json", "write_snapshot",
           "start_snapshotter", "stop_snapshotter", "lint_metric_names",
           "METRIC_NAME_RE"]

# every metric this stack exposes must live in the mxnet_ namespace —
# the exporter/docs drift gate (tests lint the live /metrics output
# against this)
METRIC_NAME_RE = re.compile(r"^mxnet_[a-z0-9_]+$")


def _esc(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _labelstr(labels, extra=None):
    items = list(labels.items()) + (list(extra.items()) if extra else [])
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _esc(v)) for k, v in items)


def _num(v):
    if v != v:                                   # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry=None):
    """Registry snapshot in the Prometheus text exposition format."""
    if registry is None:
        from . import registry as _default
        registry = _default()
    doc = registry.collect()
    lines = []
    for name in sorted(doc):
        fam = doc[name]
        if fam["doc"]:
            lines.append("# HELP %s %s" % (name, _esc(fam["doc"])))
        lines.append("# TYPE %s %s" % (name, fam["kind"]))
        for s in fam["series"]:
            if fam["kind"] == "histogram":
                acc = 0
                for le, c in zip(s["buckets"], s["counts"]):
                    acc += c
                    lines.append("%s_bucket%s %d" % (
                        name, _labelstr(s["labels"], {"le": _num(le)}),
                        acc))
                acc += s["counts"][-1]
                lines.append("%s_bucket%s %d" % (
                    name, _labelstr(s["labels"], {"le": "+Inf"}), acc))
                lines.append("%s_sum%s %s" % (
                    name, _labelstr(s["labels"]), _num(s["sum"])))
                lines.append("%s_count%s %d" % (
                    name, _labelstr(s["labels"]), s["count"]))
            else:
                lines.append("%s%s %s" % (
                    name, _labelstr(s["labels"]), _num(s["value"])))
    return "\n".join(lines) + "\n"


def _finite(obj):
    """Map non-finite floats to null: RFC 8259 JSON has no NaN/Infinity
    tokens, and a diverging model publishing a NaN gauge must not make
    the whole snapshot unparseable to strict consumers (jq,
    JSON.parse) during exactly the incident being debugged."""
    if isinstance(obj, float):
        import math
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def render_json(registry=None, include_traces=True, meta=None):
    """Self-contained JSON document: metrics snapshot + finished
    traces.  This is the format ``tools/telemetry_dump.py`` consumes.
    ``meta`` merges extra top-level keys into the document."""
    if registry is None:
        from . import registry as _default
        registry = _default()
    import time
    # scrape_ts (wall clock) + scrape_monotonic stamp WHEN the snapshot
    # was rendered, so snapshots of several processes can be ordered
    doc = {"format": "mxnet_tpu.telemetry/1",
           "scrape_ts": time.time(),
           "scrape_monotonic": time.monotonic(),
           "metrics": registry.collect()}
    if include_traces:
        from . import tracing
        doc["traces"] = tracing.all_traces()
    from . import timeline
    if timeline.enabled():
        # the fleet-event window rides every JSON snapshot, wall-
        # aligned on the scrape stamps above
        doc["timeline"] = timeline.get().snapshot(limit=8192)
    if meta:
        doc.update(meta)
    return json.dumps(_finite(doc), indent=1, sort_keys=True,
                      allow_nan=False)


def write_snapshot(path=None, fmt=None, registry=None, meta=None):
    """Write one snapshot now.  ``path=None``/empty writes to stdout.
    Returns the rendered text.  File writes go through a same-directory
    temp file + ``os.replace`` so readers never observe a torn
    snapshot."""
    if fmt is None:
        from .. import config
        fmt = config.get("MXNET_TELEMETRY_SNAPSHOT_FORMAT")
    if fmt == "prom":
        text = render_prometheus(registry)
    elif fmt == "json":
        text = render_json(registry, meta=meta)
    else:
        raise MXNetError("unknown telemetry snapshot format %r "
                         "(use 'prom' or 'json')" % (fmt,))
    if not path:
        sys.stdout.write(text)
        return text
    # unique per writer: the snapshot thread and a concurrent
    # dump_state()/atexit write to the same path must not share a temp
    # file, or os.replace could publish interleaved (torn) content
    tmp = "%s.tmp.%d.%d.%d" % (path, os.getpid(),
                               threading.get_ident(), next(_TMP_SEQ))
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        # the snapshot thread retries forever with fresh names — a
        # failed write (disk full) must not strand one tmp per tick
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return text


class _Snapshotter(object):
    def __init__(self, interval_s, path, fmt):
        self.interval_s = float(interval_s)
        self.path = path
        self.fmt = fmt
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="mxnet-telemetry-snapshot",
                                        daemon=True)
        self._thread.start()

    def _write(self):
        write_snapshot(self.path, self.fmt)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._write()
            except Exception:
                pass        # a failed write must never kill the thread

    def stop(self, final=True):
        self._stop.set()
        self._thread.join(timeout=5)
        if final:
            try:
                self._write()
            except Exception:
                pass


_SNAPSHOTTER = None
_SNAP_LOCK = threading.Lock()


def start_snapshotter(interval_s=None, path=None, fmt=None):
    """Start (or replace) the periodic snapshot thread.  Defaults come
    from the MXNET_TELEMETRY_SNAPSHOT_* env tier; ``interval_s`` <= 0
    is a no-op returning None."""
    global _SNAPSHOTTER
    from .. import config
    if interval_s is None:
        interval_s = config.get("MXNET_TELEMETRY_SNAPSHOT_SECS")
    if path is None:
        path = config.get("MXNET_TELEMETRY_SNAPSHOT_PATH") or None
    if fmt is None:
        fmt = config.get("MXNET_TELEMETRY_SNAPSHOT_FORMAT")
    if fmt not in ("prom", "json"):
        # fail fast HERE: the thread swallows per-tick errors (a full
        # disk must not kill it), so a typo'd format would otherwise
        # write nothing, silently, for the life of the process
        raise MXNetError("unknown telemetry snapshot format %r "
                         "(use 'prom' or 'json')" % (fmt,))
    if not interval_s or interval_s <= 0:
        return None
    with _SNAP_LOCK:
        if _SNAPSHOTTER is not None:
            _SNAPSHOTTER.stop(final=False)
        _SNAPSHOTTER = _Snapshotter(interval_s, path, fmt)
        return _SNAPSHOTTER


def stop_snapshotter(final=True):
    """Stop the periodic snapshot thread (writing one last snapshot by
    default)."""
    global _SNAPSHOTTER
    with _SNAP_LOCK:
        if _SNAPSHOTTER is not None:
            _SNAPSHOTTER.stop(final=final)
            _SNAPSHOTTER = None


# -- exporter/docs drift gate -----------------------------------------------

def lint_metric_names(text=None, registry=None):
    """Return every metric family name in a Prometheus exposition that
    does NOT match ``^mxnet_[a-z0-9_]+$`` — the namespace contract the
    docs promise.  ``text`` defaults to rendering ``registry`` (default
    registry), i.e. exactly what ``GET /metrics`` would serve; CI runs
    this over a live scrape so exporter and docs cannot drift."""
    if text is None:
        text = render_prometheus(registry)
    bad = []
    for line in text.splitlines():
        m = re.match(r"# TYPE (\S+) ", line)
        if m and not METRIC_NAME_RE.match(m.group(1)):
            bad.append(m.group(1))
    return bad
