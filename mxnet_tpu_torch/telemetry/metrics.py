"""Process-wide metrics registry: counters, gauges, histograms.

The reference framework has no scrapeable runtime signal at all — its
profiler writes Chrome-trace files for a human.  A production serving
stack needs the other half: machine-readable
*series* a scraper polls, with stable names and label sets, so the
claims this repo makes (compile-once, bounded queues, padding waste)
become monitorable invariants instead of test-only assertions.

Design constraints, in order:

- **lock-cheap hot path**: one instrument = one tiny ``threading.Lock``
  around a couple of scalar updates (CPython lock acquire ~0.1 us).
  Counters must be *exact* — ``+=`` on a Python float is a
  read-modify-write that drops increments under thread switches, and
  the acceptance cross-checks totals against ``ServingEngine.stats()``
  bitwise.  Label resolution on warm series is a plain dict probe.
- **near-zero cost when disabled**: instrumented call sites gate on
  :func:`mxnet_tpu_torch.telemetry.enabled` and hold no instruments when it
  is off — zero registry calls, zero allocations per request (asserted
  by tests via :func:`Registry.instrument_calls`).
- **fixed histogram buckets**: boundaries are declared at registration
  and never adapt, so two identical runs produce bitwise-identical
  bucket counts and a scraper can aggregate across processes.

No dependency on any metrics client library (stdlib only); the
Prometheus text exposition lives in
:mod:`mxnet_tpu_torch.telemetry.export`.
"""
from __future__ import annotations

import bisect
import threading

from ..base import MXNetError
from ..locks import named_lock

__all__ = ["Counter", "Gauge", "Histogram", "Family", "Registry",
           "LATENCY_MS_BUCKETS", "LATENCY_S_BUCKETS", "RATIO_BUCKETS",
           "BYTES_BUCKETS"]

# Shared fixed boundaries (upper-inclusive, Prometheus `le` convention).
# Latencies in ms spanning sub-queue-wait to multi-second program builds:
LATENCY_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)
# The same span in SECONDS, for the *_seconds families the decode
# latency histograms use (TTFT/TPOT follow the OpenMetrics base-unit
# convention, and per-token gaps live well under a millisecond):
LATENCY_S_BUCKETS = tuple(b / 1e3 for b in LATENCY_MS_BUCKETS)
# Ratios in [0, 1] (batch occupancy, padding waste):
RATIO_BUCKETS = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# Payload sizes (kvstore push/pull):
BYTES_BUCKETS = (256.0, 4096.0, 65536.0, 1048576.0, 16777216.0,
                 268435456.0)


class Counter(object):
    """Monotonically increasing value (events, bytes, requests)."""
    __slots__ = ("_lock", "_value", "_calls")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._calls = 0

    def inc(self, amount=1):
        if amount < 0:
            raise MXNetError("Counter.inc: amount must be >= 0")
        with self._lock:
            self._value += amount
            self._calls += 1

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(object):
    """Point-in-time value (queue depth, entropy, tensor stat)."""
    __slots__ = ("_lock", "_value", "_calls")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._calls = 0

    def set(self, value):
        with self._lock:
            self._value = float(value)
            self._calls += 1

    def inc(self, amount=1):
        with self._lock:
            self._value += amount
            self._calls += 1

    def dec(self, amount=1):
        self.inc(-amount)

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram(object):
    """Fixed-boundary histogram: cumulative-style export, exact counts.

    ``bounds`` are upper-inclusive bucket edges; one implicit +Inf
    bucket catches the tail.  ``observe`` is a bisect + three scalar
    updates under the instrument lock.
    """
    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count", "_calls")

    def __init__(self, bounds):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise MXNetError("Histogram bounds must be a sorted, "
                             "non-empty, duplicate-free sequence")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)      # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._calls = 0

    def observe(self, value):
        value = float(value)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._calls += 1

    def snapshot(self):
        """(per-bucket counts, sum, count) — a consistent view."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family(object):
    """One metric name: a set of label-distinguished instrument children.

    A label-less family IS its single child — ``inc``/``set``/``observe``
    delegate, so call sites never special-case.  Children are created on
    first ``labels(...)`` under the registry lock and cached; the warm
    path is one dict probe.
    """
    __slots__ = ("name", "kind", "doc", "labelnames", "buckets",
                 "_children", "_lock")

    def __init__(self, name, kind, doc, labelnames=(), buckets=None):
        self.name = name
        self.kind = kind
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets else None
        self._children = {}
        self._lock = named_lock("telemetry.family")
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return Histogram(self.buckets or LATENCY_MS_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, *values, **kv):
        """Resolve (and memoize) the child for one label-value tuple."""
        if kv:
            if values:
                raise MXNetError("pass label values positionally or by "
                                 "name, not both")
            if set(kv) != set(self.labelnames):
                raise MXNetError(
                    "metric %s takes labels %s, got %s"
                    % (self.name, list(self.labelnames), sorted(kv)))
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise MXNetError(
                "metric %s takes labels %s, got %d value(s)"
                % (self.name, list(self.labelnames), len(values)))
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._new_child()
                    self._children[values] = child
        return child

    def remove(self, *values, **kv):
        """Drop one labeled series (no-op if absent): short-lived label
        values (per-engine ordinals) must be reclaimable or scrape
        output and memory grow with every construction."""
        if kv:
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    # label-less convenience: the family acts as its sole child
    def _solo(self):
        if self.labelnames:
            raise MXNetError("metric %s is labeled %s: resolve a child "
                             "via .labels(...)"
                             % (self.name, list(self.labelnames)))
        return self._children[()]

    def inc(self, amount=1):
        self._solo().inc(amount)

    def dec(self, amount=1):
        self._solo().dec(amount)

    def set(self, value):
        self._solo().set(value)

    def observe(self, value):
        self._solo().observe(value)

    @property
    def value(self):
        return self._solo().value

    def series(self):
        """[(label-values tuple, instrument)] sorted for stable export."""
        with self._lock:
            return sorted(self._children.items())


class Registry(object):
    """Process-wide named collection of metric families.

    Registration is idempotent (same name + same kind returns the
    existing family; a kind clash raises).  ``collect()`` renders a
    point-in-time JSON-able snapshot; gauge *callbacks* registered via
    :meth:`register_callback` run first, so derived values (shape
    entropy, cache hit totals mirrored from engine state) are fresh at
    every scrape without a sampler thread.
    """

    def __init__(self):
        self._lock = named_lock("telemetry.registry")
        self._families = {}
        self._callbacks = []
        # bumped by reset(): lets call sites memoize bound instrument
        # children (no registry lock on the warm path) yet notice a
        # reset and re-resolve instead of writing to orphans
        self.generation = 0

    # -- registration ------------------------------------------------------
    def _register(self, name, kind, doc, labelnames, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise MXNetError(
                        "metric %r already registered as %s%s"
                        % (name, fam.kind, list(fam.labelnames)))
                if kind == "histogram" and buckets is not None \
                        and fam.buckets != tuple(float(b) for b in buckets):
                    # silently returning the old family would land new
                    # observations in the wrong `le` boundaries — the
                    # fixed-buckets-at-registration invariant must hold
                    raise MXNetError(
                        "histogram %r already registered with buckets "
                        "%s, re-registered with %s"
                        % (name, fam.buckets, tuple(buckets)))
                return fam
            fam = Family(name, kind, doc, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, doc="", labelnames=()):
        return self._register(name, "counter", doc, labelnames)

    def gauge(self, name, doc="", labelnames=()):
        return self._register(name, "gauge", doc, labelnames)

    def histogram(self, name, doc="", labelnames=(),
                  buckets=LATENCY_MS_BUCKETS):
        return self._register(name, "histogram", doc, labelnames, buckets)

    def register_callback(self, fn):
        """``fn(registry)`` runs at the top of every ``collect()``; use
        it to refresh gauges derived from external state.  Exceptions
        are swallowed (a broken callback must not break scraping).
        Pair with :meth:`unregister_callback` when the backing state
        has a shorter life than the process."""
        with self._lock:
            self._callbacks.append(fn)
        return fn

    def unregister_callback(self, fn):
        """Remove a collect-time callback (no-op if absent)."""
        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    # -- introspection -----------------------------------------------------
    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def families(self):
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def instrument_calls(self):
        """Total instrument-method invocations across every series —
        the overhead-discipline probe: with telemetry disabled this
        must not move across a serving request (tests assert it)."""
        total = 0
        for fam in self.families():
            for _, inst in fam.series():
                with inst._lock:
                    total += inst._calls
        return total

    def collect(self):
        """JSON-able snapshot of every family and series."""
        for cb in list(self._callbacks):
            try:
                cb(self)
            except Exception:
                pass
        out = {}
        for fam in self.families():
            series = []
            for values, inst in fam.series():
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    counts, total, count = inst.snapshot()
                    series.append({"labels": labels,
                                   "buckets": list(inst.bounds),
                                   "counts": counts,
                                   "sum": total, "count": count})
                else:
                    series.append({"labels": labels, "value": inst.value})
            out[fam.name] = {"kind": fam.kind, "doc": fam.doc,
                             "labelnames": list(fam.labelnames),
                             "series": series}
        return out

    def reset(self):
        """Drop every family and callback (tests; a fresh process view).
        Instruments already handed out keep working but are orphaned —
        they no longer appear in collect()."""
        with self._lock:
            self._families.clear()
            self._callbacks[:] = []
            self.generation += 1
