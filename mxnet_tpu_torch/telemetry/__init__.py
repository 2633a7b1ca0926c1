"""mxnet_tpu_torch.telemetry — unified runtime telemetry.

Counterpart of ``mxnet_tpu/telemetry``, under the same metric names,
labels, routes and knobs; the JSON documents keep the reference's
``format`` identifiers, so readers of either package's snapshots read
both.

One instrumentation vocabulary for every layer of the stack (a
production serving stack needs machine-scrapeable signals, not just
Chrome-trace files):

- **metrics** (metrics.py): a process-wide registry of counters,
  gauges, and fixed-bucket histograms with labeled series; Prometheus
  text + JSON exporters and a periodic snapshot thread (export.py);
- **tracing** (tracing.py): request-scoped ``TraceContext`` span trees,
  contextvar-propagated on-thread and carried across the serving
  worker hop, stored retrievably by trace id and bridged into the
  profiler's Chrome-trace ring; serving traces EVERY request via a
  one-timestamp ``LazyTrace`` and retains span trees tail-biased
  (sampling.py: top-K slowest + moving p99 + error keep +
  every-Nth floor);
- **live endpoint** (server.py): a stdlib HTTP daemon
  (``MXNET_TELEMETRY_PORT`` / ``start_server``) serving ``/metrics``,
  ``/metrics.json``, ``/traces``, ``/traces/<id>``, ``/healthz``
  (the reference's cross-host drop point, ``MXNET_TELEMETRY_SHARED_DIR``,
  waits for KVStoreDist, which is not ported);
- **built-in instrumentation**: serving admission/dispatch (queue
  depth, shed/reject/expiry, occupancy, padding waste, program-cache
  hit/miss, retraces keyed by the retrace-linter's hazard
  fingerprints, shape-signature entropy), kvstore push/pull bytes +
  latency, io/dataloader batch latency, monitor tensor gauges, graph
  program builds (``mxnet_xla_traces_total``, the reference's name).

The master switch is ``MXNET_TELEMETRY_ON`` (default on).  Call sites
gate on :func:`enabled` and hold NO instruments when it is off — the
serving hot path then makes zero registry calls per request (asserted
by tests via ``registry().instrument_calls()``).  Use::

    from mxnet_tpu_torch import telemetry
    reqs = telemetry.counter("myapp_requests_total", "requests seen")
    reqs.inc()
    print(telemetry.render_prometheus())

CLI: ``tools/telemetry_dump.py`` renders snapshots and per-request
span breakdowns from :func:`dump_state` files.
"""
from __future__ import annotations

import atexit

from .metrics import (Registry, Counter, Gauge, Histogram, Family,
                      LATENCY_MS_BUCKETS, LATENCY_S_BUCKETS,
                      RATIO_BUCKETS, BYTES_BUCKETS)
from .tracing import (TraceContext, LazyTrace, Span, current_trace,
                      activate, trace, maybe_span, get_trace,
                      recent_trace_ids, all_traces, clear_traces)
from .export import (render_prometheus, render_json, write_snapshot,
                     start_snapshotter, stop_snapshotter,
                     lint_metric_names, METRIC_NAME_RE)
from .sampling import (PeriodicSampler, TailSampler, ErrorSampler,
                       SamplerChain, chain_from_config,
                       persist_tail_state, restore_tail_state)
from .server import (TelemetryServer, start_server, stop_server,
                     server_address, publish_event, event_hub)
from .recorder import (HistoryRecorder, FlightRecorder, start_recorder,
                       stop_recorder, get_recorder, register_heartbeat,
                       unregister_heartbeat, heartbeats, flight_recorder)
from .alerts import (AlertRule, AlertManager, default_manager,
                     register_engine_default_rules, load_rules_file)
from .step import (StepTimer, PHASES, STEP_SECONDS_BUCKETS,
                   PEAKS_TFLOPS, peak_flops_for)
# serving efficiency plane (goodput.py): exported as a submodule —
# its enabled() composes the master switch with MXNET_SERVE_EFFICIENCY
# and would shadow this package's enabled() if flattened
from . import goodput
# unified fleet timeline (timeline.py): same submodule treatment —
# its enabled() composes the master switch with
# MXNET_TELEMETRY_TIMELINE
from . import timeline
from .timeline import export_chrome_trace

__all__ = [
    "Registry", "Counter", "Gauge", "Histogram", "Family",
    "LATENCY_MS_BUCKETS", "LATENCY_S_BUCKETS", "RATIO_BUCKETS",
    "BYTES_BUCKETS",
    "TraceContext", "LazyTrace", "Span", "current_trace", "activate",
    "trace", "maybe_span", "get_trace", "recent_trace_ids",
    "all_traces", "clear_traces",
    "render_prometheus", "render_json", "write_snapshot",
    "start_snapshotter", "stop_snapshotter",
    "lint_metric_names", "METRIC_NAME_RE",
    "PeriodicSampler", "TailSampler", "ErrorSampler", "SamplerChain",
    "chain_from_config", "persist_tail_state", "restore_tail_state",
    "TelemetryServer", "start_server", "stop_server", "server_address",
    "publish_event", "event_hub",
    "HistoryRecorder", "FlightRecorder", "start_recorder",
    "stop_recorder", "get_recorder", "register_heartbeat",
    "unregister_heartbeat", "heartbeats", "flight_recorder",
    "AlertRule", "AlertManager", "default_manager",
    "register_engine_default_rules", "load_rules_file",
    "StepTimer", "PHASES", "STEP_SECONDS_BUCKETS", "PEAKS_TFLOPS",
    "peak_flops_for", "goodput", "timeline", "export_chrome_trace",
    "enabled", "set_enabled", "registry", "counter", "gauge",
    "histogram", "bound", "remove_labeled_series", "reset",
    "dump_state", "trace_sample_every",
]

_REGISTRY = Registry()
_FORCED = None          # set_enabled override; None defers to the env


def registry():
    """The process-wide default registry every built-in instrument
    registers against."""
    return _REGISTRY


def enabled():
    """Master switch.  Reads ``MXNET_TELEMETRY_ON`` through the config
    tier per call (cheap: one environ probe) so tests and operators
    can flip it without reimporting — and so the parse/default can
    never diverge from the documented config surface;
    :func:`set_enabled` pins it programmatically."""
    if _FORCED is not None:
        return _FORCED
    from .. import config
    return config.get("MXNET_TELEMETRY_ON")


def set_enabled(value):
    """Pin telemetry on/off (``None`` restores env-var control)."""
    global _FORCED
    _FORCED = None if value is None else bool(value)


def trace_sample_every():
    """The retention chain's periodic baseline floor: every Nth
    serving request is kept unconditionally, on top of the tail-biased
    and error-keep samplers (sampling.py).  0 disables tracing
    entirely; 1 keeps everything."""
    from .. import config
    return config.get("MXNET_TELEMETRY_TRACE_SAMPLE")


# -- default-registry conveniences ------------------------------------------

def counter(name, doc="", labelnames=()):
    return _REGISTRY.counter(name, doc, labelnames)


def gauge(name, doc="", labelnames=()):
    return _REGISTRY.gauge(name, doc, labelnames)


def histogram(name, doc="", labelnames=(), buckets=LATENCY_MS_BUCKETS):
    return _REGISTRY.histogram(name, doc, labelnames, buckets)


def remove_labeled_series(families, label, position=0):
    """Reclaim every series whose label tuple carries ``label`` at
    ``position`` from each family — the per-engine series-reclaim
    idiom subsystems run at close()/release() so reload loops cannot
    grow scrapes."""
    for fam in families:
        for values, _inst in fam.series():
            if values and values[position] == label:
                fam.remove(*values)


def bound(cache, key, factory):
    """Memoize a bound instrument child in a call-site ``cache`` dict —
    the warm path is one dict probe + one int compare, no registry
    lock.  Entries are versioned by the registry generation so a
    :func:`reset` invalidates them (otherwise hot paths would keep
    writing to orphaned instruments that no scrape can see)."""
    gen = _REGISTRY.generation
    hit = cache.get(key)
    if hit is not None and hit[0] == gen:
        return hit[1]
    inst = factory()
    cache[key] = (gen, inst)
    return inst


def reset():
    """Clear the default registry AND the finished-trace store (tests).
    Engines built before a reset keep their orphaned instruments;
    rebuild them to re-register."""
    _REGISTRY.reset()
    clear_traces()


def dump_state(path):
    """Write the combined metrics+traces JSON document to ``path`` —
    the file ``tools/telemetry_dump.py`` renders offline."""
    write_snapshot(path, fmt="json", registry=_REGISTRY)
    return path


# fatal-signal half of the flight recorder: faulthandler writes every
# thread's stack to a file in the bundle directory on SIGSEGV/SIGFPE/
# SIGABRT — the one failure mode no Python-level hook can narrate.
# Module-global handle: faulthandler holds the fd for the process life.
_FATAL_STACKS_FILE = None


def _maybe_enable_fatal_stacks(config):
    global _FATAL_STACKS_FILE
    fr_dir = config.get("MXNET_FLIGHT_RECORDER_DIR")
    if not fr_dir or _FATAL_STACKS_FILE is not None:
        return
    try:
        import faulthandler
        import os
        os.makedirs(fr_dir, exist_ok=True)
        _FATAL_STACKS_FILE = open(
            os.path.join(fr_dir, "fatal_stacks.log"), "a")
        faulthandler.enable(file=_FATAL_STACKS_FILE, all_threads=True)
    except Exception as e:
        import warnings
        warnings.warn("flight recorder: cannot install fatal-signal "
                      "stack dump (%s)" % e)


# Periodic snapshots and the HTTP endpoint autostart when configured
# (serving processes run unattended for days); a final snapshot lands
# at interpreter exit, and the server socket closes cleanly.
def _maybe_autostart():
    from .. import config
    if not enabled():
        return
    _maybe_enable_fatal_stacks(config)
    if config.get("MXNET_TELEMETRY_SNAPSHOT_PATH"):
        # the TailSampler's moving-p99 window survives a
        # process reload through a snapshot-path sidecar — written at
        # exit here, restored by the first chain_from_config() call
        atexit.register(persist_tail_state)
    if config.get("MXNET_TELEMETRY_SNAPSHOT_SECS") > 0:
        try:
            start_snapshotter()
        except Exception as e:
            # a typo'd MXNET_TELEMETRY_SNAPSHOT_FORMAT must not make
            # `import mxnet_tpu_torch` raise — but it must also not be
            # silent (the thread exists for unattended processes)
            import warnings
            warnings.warn("telemetry snapshot autostart failed: %s" % e)
        else:
            atexit.register(stop_snapshotter)
    if config.get("MXNET_TELEMETRY_PORT") >= 0:
        try:
            start_server()
        except Exception as e:
            # a taken port must not make `import mxnet_tpu_torch` raise —
            # ServingEngine construction retries the acquire later
            import warnings
            warnings.warn("telemetry HTTP server autostart failed: %s" % e)
        else:
            atexit.register(stop_server)


_maybe_autostart()
