"""Request-scoped tracing: one span tree per traced request.

Metrics (metrics.py) aggregate; they cannot answer "where did THIS
request's 40 ms go?".  A :class:`TraceContext` carries a trace id plus
a span stack through a request's whole life — admission, coalescing,
padding, program dispatch, unpadding — across the thread hop from the
submitting client to the serving worker:

- on the *submitting* thread the context is contextvar-propagated, so
  nested code (executor forward, cached-op dispatch) can attach spans
  without plumbing arguments;
- across the *worker* hop it rides the queued ``Request`` object and
  the engine records batch-stage spans onto every member trace
  explicitly (contextvars do not cross threads by design).

Finished traces land in a bounded in-process store retrievable by
trace id (``MXNET_TELEMETRY_TRACE_CAPACITY``, oldest evicted) — the
source ``tools/telemetry_dump.py`` and the live ``/traces`` endpoint
render span breakdowns from — and every span is bridged into the
:mod:`mxnet_tpu_torch.profiler` Chrome-trace ring as a categorized event
carrying its ``trace_id`` arg, so one perfetto timeline shows requests
and host regions interleaved.

A TraceContext built with a ``retention`` chain (sampling.py) defers
the keep/drop decision to ``finish()``, when the end-to-end latency is
known: dropped traces are never stored nor bridged (they cost one
discarded object), kept traces carry a ``retained_by`` tag.  Without a
chain, ``finish()`` stores unconditionally — the explicit
``telemetry.trace(...)`` entry point keeps its contract.

Span timestamps use ``time.perf_counter()`` — the same clock the
profiler ring is anchored to.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import random
import threading
import time

__all__ = ["Span", "TraceContext", "LazyTrace", "current_trace",
           "activate", "trace", "maybe_span", "get_trace",
           "recent_trace_ids", "all_traces", "clear_traces",
           "store_capacity"]

_CURRENT = contextvars.ContextVar("mxnet_tpu_torch_trace", default=None)

_STORE_LOCK = threading.Lock()
_STORE = collections.OrderedDict()      # trace_id -> finished tree dict

# Trace ids: 24 random bits fixed per process + a 40-bit atomic counter
# (itertools.count is GIL-atomic), formatted to the same 16 hex chars as
# the old uuid4 prefix.  uuid4 costs a urandom syscall (~70 us on this
# class of host) — unaffordable now that EVERY serving request carries
# a TraceContext and retention is decided at finish.
_ID_BASE = random.getrandbits(24)
_ID_SEQ = itertools.count()


def _new_trace_id():
    return "%06x%010x" % (_ID_BASE, next(_ID_SEQ) & 0xFFFFFFFFFF)


def store_capacity():
    from .. import config
    return config.get("MXNET_TELEMETRY_TRACE_CAPACITY")


class Span(object):
    """One timed region.  ``t0``/``t1`` are perf_counter seconds;
    ``meta`` holds small JSON-able annotations (bucket size, compile
    flag)."""
    __slots__ = ("name", "cat", "t0", "t1", "children", "meta")

    def __init__(self, name, cat="span", t0=None):
        self.name = name
        self.cat = cat
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1 = None
        self.children = []
        self.meta = None

    @property
    def dur_ms(self):
        if self.t1 is None:
            return None
        return (self.t1 - self.t0) * 1e3

    def to_dict(self, origin):
        d = {"name": self.name, "cat": self.cat,
             "start_ms": round((self.t0 - origin) * 1e3, 4),
             "dur_ms": (None if self.t1 is None
                        else round((self.t1 - self.t0) * 1e3, 4))}
        if self.meta:
            d["meta"] = dict(self.meta)
        if self.children:
            d["children"] = [c.to_dict(origin) for c in self.children]
        return d


class TraceContext(object):
    """Trace id + span stack for one logical request.

    Mutations are lock-guarded: a trace is touched by at most one
    thread at a time, but by *different* threads over its life
    (client submit -> engine worker), and the lock makes the handoff
    safe without any happens-before choreography at the call sites.
    """
    __slots__ = ("trace_id", "root", "_stack", "_lock", "finished",
                 "retention", "failed_reason")

    def __init__(self, name="request", cat="trace", retention=None):
        self.trace_id = _new_trace_id()
        self.root = Span(name, cat)
        self._stack = [self.root]
        self._lock = threading.Lock()
        self.finished = False
        # sampling.SamplerChain (or None = always keep): consulted once
        # at finish(), when the e2e latency is known
        self.retention = retention
        self.failed_reason = None

    # -- structured recording ---------------------------------------------
    @contextlib.contextmanager
    def span(self, name, cat="span", meta=None):
        """Nested timed region on the current thread's stack."""
        sp = self.begin(name, cat, meta)
        try:
            yield sp
        finally:
            self.end(sp)

    def begin(self, name, cat="span", meta=None):
        sp = Span(name, cat)
        if meta:
            sp.meta = dict(meta)
        with self._lock:
            self._stack[-1].children.append(sp)
            self._stack.append(sp)
        return sp

    def end(self, sp, t1=None):
        t1 = time.perf_counter() if t1 is None else t1
        with self._lock:
            sp.t1 = t1
            # tolerate out-of-order ends (cross-thread handoff): pop
            # only through the span being closed
            if sp in self._stack:
                while self._stack[-1] is not sp:
                    dangling = self._stack.pop()
                    if dangling.t1 is None:
                        dangling.t1 = t1
                self._stack.pop()

    def add(self, name, t0, t1, cat="span", meta=None):
        """Record an already-measured interval as a child of the
        current open span (the cross-thread path: the engine worker
        measured the batch stage once and attributes it to every
        member request's trace)."""
        sp = Span(name, cat, t0=t0)
        sp.t1 = t1
        if meta:
            sp.meta = dict(meta)
        with self._lock:
            self._stack[-1].children.append(sp)
        return sp

    # -- lifecycle ---------------------------------------------------------
    def abort(self, reason):
        """Finish a trace whose request never completed (rejected,
        shed, expired, cancelled, dispatch error): a zero-length
        'failed' child records why, so overloaded/slow traffic — the
        traffic an operator is debugging — still leaves a record."""
        if self.finished:
            return
        self.failed_reason = str(reason)
        t = time.perf_counter()
        self.add("failed", t, t, "serve", meta={"reason": str(reason)})
        self.finish(t)

    def finish(self, t1=None, retained_by=None):
        """Close the root; when the retention chain (if any) votes
        keep, publish the tree to the bounded store and bridge every
        span into the profiler ring (when running) — a dropped trace
        inserts nothing and bridges nothing.  ``retained_by`` tags the
        stored tree when the keep decision was made EXTERNALLY
        (:class:`LazyTrace` decides before this object even exists).
        """
        with self._lock:
            if self.finished:
                return
            self.finished = True
            t1 = time.perf_counter() if t1 is None else t1
            for sp in self._stack[::-1]:
                if sp.t1 is None:
                    sp.t1 = t1
            self._stack = [self.root]
        if self.retention is not None:
            keep, retained_by = self.retention.decide(
                (t1 - self.root.t0) * 1e3, self.failed_reason)
            if not keep:
                return
        tree = self.to_dict()
        if retained_by is not None:
            tree["retained_by"] = retained_by
        with _STORE_LOCK:
            _STORE[self.trace_id] = tree
            cap = store_capacity()
            while len(_STORE) > cap:
                _STORE.popitem(last=False)
        self._bridge_to_profiler()
        self._feed_timeline()
        # push the keep to live /events subscribers (SSE): only the
        # retained minority reaches this line, so the dropped-path
        # cost stays zero; a hub failure must never fail a request
        try:
            from .server import publish_event
            root = tree.get("root", {})
            publish_event("trace", {
                "trace_id": self.trace_id, "name": root.get("name"),
                "dur_ms": root.get("dur_ms"),
                "retained_by": tree.get("retained_by"),
                "failed": self.failed_reason})
        except Exception:
            pass

    def to_dict(self):
        from . import timeline
        root = self.root.to_dict(self.root.t0)
        # wall anchor of the root: every span's start_ms offsets from
        # here, which is how request_autopsy joins the tree against
        # wall-stamped timeline events
        root["t0_wall"] = timeline.wall_of_perf(self.root.t0)
        return {"trace_id": self.trace_id, "root": root}

    def _bridge_to_profiler(self):
        from .. import profiler
        if not profiler.is_running():
            return
        args = {"trace_id": self.trace_id}

        def walk(sp):
            profiler.add_span_event(sp.name, sp.cat, sp.t0,
                                    sp.t1 if sp.t1 is not None else sp.t0,
                                    args=args)
            for c in sp.children:
                walk(c)
        walk(self.root)

    def _feed_timeline(self):
        """Mirror the retained tree into the fleet timeline — only the
        kept minority pays, and a dropped trace appends nothing."""
        from . import timeline
        if not timeline.enabled():
            return
        tl = timeline.get()
        args = {"trace": self.trace_id}

        def walk(sp):
            tl.complete(sp.name, sp.cat, "trace", sp.t0,
                        sp.t1 if sp.t1 is not None else sp.t0,
                        args=args)
            for c in sp.children:
                walk(c)
        walk(self.root)


class LazyTrace(object):
    """The cost-free way to trace EVERY serving request: one timestamp
    at submit, one retention decision at finish — a real
    :class:`TraceContext` (spans, store insert, profiler bridge) is
    built ONLY for the kept minority, retroactively, from timestamps
    the engine already holds.

    The serving hot path pays ~one object allocation plus the sampler
    chain's decision per dropped request; everything else (trace id,
    span objects, locks, tree rendering) is deferred behind the keep
    verdict.  Quacks like TraceContext where the engine and admission
    controller touch it: ``abort(reason)`` on every failure path, and
    ``finish(t1, build)`` where ``build(tc)`` attaches the batch-stage
    spans to the freshly materialized context.
    """
    __slots__ = ("t0", "retention", "finished", "name", "cat")

    def __init__(self, retention, name="serve.request", cat="serve"):
        self.t0 = time.perf_counter()
        self.retention = retention
        self.finished = False
        self.name = name
        self.cat = cat

    def _materialize(self):
        tc = TraceContext(self.name, self.cat)
        tc.root.t0 = self.t0
        return tc

    def finish(self, t1=None, build=None):
        """Decide retention; when kept, materialize the TraceContext,
        let ``build(tc)`` attach spans, and publish."""
        if self.finished:
            return
        self.finished = True
        t1 = time.perf_counter() if t1 is None else t1
        keep, why = self.retention.decide((t1 - self.t0) * 1e3, None)
        if not keep:
            return
        tc = self._materialize()
        if build is not None:
            build(tc)
        tc.finish(t1, retained_by=why)

    def abort(self, reason):
        """Failure path (rejected/shed/expired/cancelled/dispatch
        error): decide with the failure reason — the error sampler
        keeps these unconditionally — and record why."""
        if self.finished:
            return
        self.finished = True
        t1 = time.perf_counter()
        keep, why = self.retention.decide((t1 - self.t0) * 1e3,
                                          str(reason))
        if not keep:
            return
        tc = self._materialize()
        tc.failed_reason = str(reason)
        tc.add("failed", t1, t1, "serve", meta={"reason": str(reason)})
        tc.finish(t1, retained_by=why)


# -- contextvar propagation (same-thread nesting) ---------------------------

def current_trace():
    """The TraceContext active on this thread's context, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def activate(tc):
    """Make ``tc`` the current trace for the enclosed block (does not
    finish it — ownership stays with the caller)."""
    token = _CURRENT.set(tc)
    try:
        yield tc
    finally:
        _CURRENT.reset(token)


@contextlib.contextmanager
def trace(name="request", cat="trace"):
    """Create, activate, and on exit finish a TraceContext — the
    entry point for tracing an eager/training region by hand::

        with telemetry.trace("step") as tc:
            ...
        tree = telemetry.get_trace(tc.trace_id)
    """
    tc = TraceContext(name, cat)
    with activate(tc):
        try:
            yield tc
        finally:
            tc.finish()


@contextlib.contextmanager
def maybe_span(name, cat="span", meta=None):
    """Span on the current trace when one is active; no-op otherwise.
    The cheap hook library code (executor, cached_op) uses."""
    tc = _CURRENT.get()
    if tc is None or tc.finished:
        yield None
        return
    with tc.span(name, cat, meta) as sp:
        yield sp


# -- finished-trace store ---------------------------------------------------

def get_trace(trace_id):
    """Span tree dict for a finished trace, or None if unknown/evicted."""
    with _STORE_LOCK:
        return _STORE.get(trace_id)


def recent_trace_ids():
    """Trace ids currently in the store, oldest first."""
    with _STORE_LOCK:
        return list(_STORE)


def all_traces():
    """{trace_id: tree} snapshot of the store (for dump files)."""
    with _STORE_LOCK:
        return dict(_STORE)


def clear_traces():
    with _STORE_LOCK:
        _STORE.clear()
