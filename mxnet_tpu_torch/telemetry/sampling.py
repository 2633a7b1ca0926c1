"""Trace retention: decide at finish() which span trees to keep.

A count-based sampler gives every Nth request a span tree.
That is exactly backwards for the traffic an operator debugs: an
unbiased sample is dominated by the fast requests that need no
explanation, while the p99 stragglers (the requests a shape-bucketed
serving engine lives or dies by) are kept with probability 1/N like
everything else.

This module inverts the decision: the engine now traces EVERY request
cheaply (a TraceContext is a uuid + a span list; spans are recorded
batch-wise) and retention is decided at ``finish()``, when the e2e
latency is known, by a composable :class:`SamplerChain`:

- :class:`ErrorSampler` — a trace that aborted (rejected, shed,
  expired, cancelled, dispatch error) is always kept;
- :class:`TailSampler` — *retroactively* keep a trace whose latency
  lands in the current top-K slowest (``MXNET_TELEMETRY_TRACE_TAIL_K``)
  or exceeds a moving p99 estimate over a sliding window, so every
  tail request has a span tree;
- :class:`PeriodicSampler` — the old every-Nth sampler survives as the
  baseline floor (``MXNET_TELEMETRY_TRACE_SAMPLE``), so uniform fast
  traffic still leaves a trickle of exemplars.

``MXNET_TELEMETRY_TRACE_SAMPLE=0`` remains the tracing kill switch: it
disables the whole chain (no per-request TraceContext at all), which
keeps deterministic-run tests and zero-overhead expectations intact.

Retention outcomes are themselves observable:
``mxnet_telemetry_traces_retained_total{reason}`` /
``mxnet_telemetry_traces_dropped_total`` — the /traces endpoint and
``telemetry_dump top`` lean on the ``retained_by`` tag each kept tree
carries.
"""
from __future__ import annotations

import heapq
import itertools
import json
import os
import threading

__all__ = ["PeriodicSampler", "TailSampler", "ErrorSampler",
           "SamplerChain", "chain_from_config",
           "persist_tail_state", "restore_tail_state",
           "tail_state_path"]

# sliding latency window backing the moving p99 estimate; recomputed
# every _P99_REFRESH observations (sorting 512 floats ~10 us, amortized
# to nothing)
_P99_WINDOW = 512
_P99_REFRESH = 64
# the p99 rule only arms once the window has enough mass for the 99th
# percentile to mean something (below this every request "exceeds p99")
_P99_MIN_SAMPLES = 100


class PeriodicSampler(object):
    """Every-Nth baseline floor (the count-based sampler, demoted to one link
    of the chain).  ``itertools.count`` is atomic under the GIL, so the
    hot path is lock-free."""

    reason = "periodic"

    def __init__(self, every_n):
        self.every_n = int(every_n)
        self._seq = itertools.count()

    def decide(self, dur_ms, failed_reason):
        if self.every_n <= 0:
            return None
        if next(self._seq) % self.every_n == 0:
            return self.reason
        return None


class TailSampler(object):
    """Always-keep-slowest reservoir + moving-p99 trigger.

    A trace is kept when its e2e latency (a) lands in the current
    top-``k`` slowest seen so far (min-heap reservoir — early traffic
    fills the heap, then only genuine tail latencies displace entries),
    or (b) exceeds the current p99 estimate over a sliding window of
    recent latencies (so a long-running engine whose top-K saturated on
    startup transients still traces fresh stragglers).
    """

    def __init__(self, k):
        self.k = int(k)
        self._lock = threading.Lock()
        self._heap = []                    # k smallest of the largest
        self._window = []                  # ring buffer of recent ms
        self._widx = 0
        self._nobs = 0
        self._p99 = None

    # -- persistence (the moving-p99 estimate must survive
    # a serving-process reload, or every restart re-traces the first
    # ~100+top-K requests as "tail" while the window re-warms) --------
    def state(self):
        """JSON-able snapshot of the sliding window + top-K reservoir."""
        with self._lock:
            return {"k": self.k, "window": list(self._window),
                    "widx": self._widx, "nobs": self._nobs,
                    "p99": self._p99, "heap": list(self._heap)}

    def restore(self, state):
        """Adopt a snapshot from :meth:`state` (trimmed to this
        sampler's window/K bounds); malformed fields are ignored —
        restoring stale state must never break trace retention."""
        try:
            window = [float(x) for x in state.get("window", [])]
            heap = sorted(float(x) for x in state.get("heap", []))
            p99 = state.get("p99")
            p99 = float(p99) if p99 is not None else None
            nobs = int(state.get("nobs", 0))
            widx = int(state.get("widx", 0))
        except (AttributeError, TypeError, ValueError):
            return      # every conversion happens BEFORE any mutation
        with self._lock:
            self._window = window[-_P99_WINDOW:]
            self._widx = widx % _P99_WINDOW \
                if len(self._window) >= _P99_WINDOW else 0
            self._nobs = max(nobs, 0)
            self._p99 = p99
            self._heap = heap[-self.k:]
            heapq.heapify(self._heap)

    def decide(self, dur_ms, failed_reason):
        if self.k <= 0 or dur_ms is None:
            return None
        with self._lock:
            # window + periodic p99 refresh (always observe, even when
            # the top-K verdict below is negative — the estimate must
            # reflect ALL traffic, not just retained traffic)
            if len(self._window) < _P99_WINDOW:
                self._window.append(dur_ms)
            else:
                self._window[self._widx] = dur_ms
                self._widx = (self._widx + 1) % _P99_WINDOW
            self._nobs += 1
            if self._nobs % _P99_REFRESH == 0 and \
                    len(self._window) >= _P99_MIN_SAMPLES:
                s = sorted(self._window)
                self._p99 = s[min(len(s) - 1,
                                  int(round(0.99 * (len(s) - 1))))]
            if len(self._heap) < self.k:
                heapq.heappush(self._heap, dur_ms)
                return "tail_topk"
            if dur_ms > self._heap[0]:
                heapq.heapreplace(self._heap, dur_ms)
                return "tail_topk"
            if self._p99 is not None and dur_ms >= self._p99:
                return "tail_p99"
        return None


class ErrorSampler(object):
    """Abort-triggered keep: rejected / shed / expired / cancelled /
    dispatch-failed requests are exactly the traffic an operator
    debugs; their span trees must never be sampled away."""

    reason = "error"

    def decide(self, dur_ms, failed_reason):
        return self.reason if failed_reason is not None else None


class SamplerChain(object):
    """Run every sampler on every finished trace; keep on ANY vote.

    Every sampler sees every observation (a periodic hit must not hide
    the latency from the tail reservoir, or its p99 estimate would be
    biased by retention), and the FIRST affirmative reason tags the
    kept tree (``retained_by``).  Outcomes are counted in the registry
    when instruments were bound (telemetry enabled at build time).
    """

    def __init__(self, samplers, retained_counter=None,
                 dropped_counter=None):
        self.samplers = tuple(samplers)
        self._retained = retained_counter
        self._dropped = dropped_counter

    def decide(self, dur_ms, failed_reason):
        """(keep, reason) for one finished trace."""
        reason = None
        for s in self.samplers:
            r = s.decide(dur_ms, failed_reason)
            if r is not None and reason is None:
                reason = r
        if reason is not None:
            if self._retained is not None:
                self._retained.labels(reason=reason).inc()
            return True, reason
        if self._dropped is not None:
            self._dropped.inc()
        return False, None


def chain_from_config():
    """The serving engine's retention chain, built from the
    MXNET_TELEMETRY_TRACE_* env tier.  Returns ``None`` when tracing is
    disabled outright (``MXNET_TELEMETRY_TRACE_SAMPLE=0``) — the engine
    then creates no TraceContext at all, the kill-switch contract.

    A freshly built TailSampler is seeded from the last persisted
    window (:func:`restore_tail_state`, auto-loaded once per process
    from the snapshot-path sidecar) and tracked so
    :func:`persist_tail_state` can serialize it at shutdown.
    """
    from .. import config
    every_n = config.get("MXNET_TELEMETRY_TRACE_SAMPLE")
    if not every_n:
        return None
    samplers = [ErrorSampler()] \
        if config.get("MXNET_TELEMETRY_TRACE_ERRORS") else []
    tail_k = config.get("MXNET_TELEMETRY_TRACE_TAIL_K")
    if tail_k > 0:
        ts = TailSampler(tail_k)
        st = _restored_tail_state()
        if st:
            ts.restore(st)
            _consume_restored()     # first chain after start only
        _LIVE_TAIL.append(ts)
        if len(_LIVE_TAIL) > 8:
            # bounded strong refs (the atexit persist must still see a
            # sampler after its fit()-local timer is GC'd) — evict the
            # LEAST-observed, not the oldest: a reload loop churning
            # fresh chains must never push the warmed long-lived
            # window out of persistence reach
            _LIVE_TAIL.remove(min(_LIVE_TAIL, key=lambda t: t._nobs))
        samplers.append(ts)
    samplers.append(PeriodicSampler(every_n))
    from . import registry
    reg = registry()
    return SamplerChain(
        samplers,
        retained_counter=reg.counter(
            "mxnet_telemetry_traces_retained_total",
            "finished traces kept by the retention chain, by the first "
            "affirmative sampler (error / tail_topk / tail_p99 / "
            "periodic)", labelnames=("reason",)),
        dropped_counter=reg.counter(
            "mxnet_telemetry_traces_dropped_total",
            "finished traces discarded by the retention chain (traced "
            "cheaply, not retained — fast uniform traffic)"))


# -- moving-p99 persistence across reloads ----------------------------------
#
# The TailSampler's p99 estimate needs ~100 observations to arm; a
# reload loop that rebuilds the chain every restart spends that whole
# warmup keeping everything "tail".  The window is serialized as a
# sidecar of the snapshot path (atomic replace, same discipline as
# every snapshot write) at interpreter exit and restored into the
# first chain built after start.

_LIVE_TAIL = []         # TailSamplers built by chain_from_config (kept
#                         strongly, bounded to the 8 newest: a fit()'s
#                         StepTimer dies with fit, but its window must
#                         still be serializable at interpreter exit)
_RESTORED = None        # loaded state, adopted by the next TailSampler
_AUTOLOAD_DONE = False


def tail_state_path(path=None):
    """Explicit ``path`` wins; else the MXNET_TELEMETRY_SNAPSHOT_PATH
    sidecar ``<path>.tailstate.json``; None when neither is set."""
    if path:
        return path
    from .. import config
    base = config.get("MXNET_TELEMETRY_SNAPSHOT_PATH")
    return (base + ".tailstate.json") if base else None


def _live_tail_sampler():
    """The sampler worth persisting: the one that has observed the
    most traffic — NOT simply the newest, or a just-built toy chain
    (a 3-step fit in a serving process) would overwrite the long-lived
    chain's warmed window in the sidecar at exit."""
    if not _LIVE_TAIL:
        return None
    return max(_LIVE_TAIL, key=lambda t: t._nobs)


def persist_tail_state(path=None):
    """Serialize the MOST-OBSERVED live TailSampler's window/heap/p99
    to the sidecar file (see :func:`_live_tail_sampler`).  Returns the
    path written, or None (no live sampler, no path, or a failed
    write — persistence is advisory)."""
    p = tail_state_path(path)
    ts = _live_tail_sampler()
    if not p or ts is None:
        return None
    tmp = "%s.tmp.%d" % (p, os.getpid())
    try:
        with open(tmp, "w") as f:
            json.dump(ts.state(), f)
        os.replace(tmp, p)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return p


def restore_tail_state(path=None):
    """Load a persisted window so the NEXT TailSampler built (the next
    chain_from_config call) starts warm.  Returns the loaded state or
    None.  Called automatically (once, from the default sidecar) the
    first time a chain is built; call explicitly to restore from a
    non-default path or to re-arm after telemetry.reset()."""
    global _RESTORED, _AUTOLOAD_DONE
    _AUTOLOAD_DONE = True
    p = tail_state_path(path)
    if not p or not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            _RESTORED = json.load(f)
    except (OSError, ValueError):
        return None
    return _RESTORED


def _restored_tail_state():
    if not _AUTOLOAD_DONE:
        restore_tail_state()
    return _RESTORED


def _consume_restored():
    """Adopt-once: a chain built hours into the process must NOT be
    re-seeded from the boot-time sidecar (its window would reset the
    p99 estimate backward to pre-warmup traffic)."""
    global _RESTORED
    _RESTORED = None
