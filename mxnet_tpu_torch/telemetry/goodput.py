"""Serving efficiency plane: per-program FLOPs ledger, MFU/goodput.

Training has a full attribution plane (step.py: phase timers, analytic
MFU from analysis/flops.py) but serving — the system's actual product —
had nothing between ``requests_total`` and the hardware.  This module
is the serving half: every compiled program (one-shot bucket programs,
prefill buckets, persistent decode/spec steps) is **priced once** at
compile/AOT-load time via :func:`mxnet_tpu_torch.analysis.flops.count_flops`
over its concrete padded shapes, and every dispatch then increments
engine/replica-labeled counters from that price, decomposed into four
disjoint classes that sum EXACTLY to total:

- **useful**: live rows x valid lengths — compute a client asked for;
- **padding**: pow2 batch-bucket and seq-pad overhang (one-shot and
  prefill dispatches);
- **dead-slot**: decode slots riding the persistent step masked;
- **spec-rejected**: draft+verify FLOPs for speculative tokens the
  acceptance test discarded (plus the unused tail of the K-token
  window on teacher-forcing slots).

Conservation is exact **by construction**, not by float luck: prices
are integers, each class is an integer floor-share of the price, and
the last class is derived by subtraction — so
``useful + padding + dead_slot + spec_rejected == total`` holds
bitwise on counter values (tests pin it), and counter accumulation
stays exact far below the 2^53 float-integer limit.

On top of the ledger: a live ``mxnet_serve_mfu{engine,replica}`` gauge
(dispatch-window FLOPs / wall / peak, sharing ``step.py``'s
``PEAKS_TFLOPS`` denominator table and its honest-None-on-CPU
discipline — no peak, no series), a ``mxnet_serve_goodput_ratio``
gauge, and a per-**tenant** accounting dimension (``submit(tenant=)``
pass-through on both engines) with a bounded-cardinality guard: the
first ``MXNET_TELEMETRY_TENANTS_MAX`` distinct tenants get their own
label, later ones aggregate into ``tenant="other"`` and each
overflowed request is counted (``tenant="other"`` is therefore a
reserved label value).

Lifecycle law (same as every serving instrument): everything here is
gated on :func:`enabled` — ``MXNET_TELEMETRY_ON`` AND
``MXNET_SERVE_EFFICIENCY`` — engines hold NO :class:`EngineEfficiency`
when it is off (zero instrument calls, zero pricing work, serving
bitwise-identical to the plane never existing), and every series an
engine registered is reclaimed at its ``close()`` so reload loops
cannot grow scrapes.  Pricing itself is **advisory**: a graph the
FLOPs pass cannot price (structural analysis failure) serves exactly
as before and its dispatches count under
``mxnet_serve_unpriced_dispatches_total`` instead of silently
vanishing from the ledger.  So does a graph holding an op of
``UNPRICED_OPS``, a contraction the FLOPs pass has no rule for (the
fused ResNet units, the fused stem, the fused RNN): the pass counts
such an op one FLOP per output element, a fraction of its work, and a
price that low would publish an MFU wrong by that fraction.

``tools/serve_report.py`` renders the decomposition per
engine/replica/tenant from a snapshot, a live ``--url``, or N rank
snapshots (fleet-wide via ``telemetry_dump aggregate``).
"""
from __future__ import annotations

import threading
import time

from .metrics import Counter, Gauge, Histogram, LATENCY_MS_BUCKETS
from .step import peak_flops_for

__all__ = ["enabled", "price_graph", "price_step_program",
           "analytic_flops", "UNPRICED_OPS",
           "efficiency_metric_families", "EngineEfficiency"]

#: ops doing contractions that ``analysis.flops`` has no rule for: its
#: default rule counts them one FLOP per output element (about a third of
#: a fused ResNet-50 step's FLOPs comes out), so a graph holding one is
#: unpriced, with no FLOPs ledger and no MFU, rather than priced low
UNPRICED_OPS = frozenset(["_contrib_FusedBottleneckUnit",
                          "_contrib_BNStemConv", "RNN"])

# unregistered sinks: instrument calls racing a close() land here —
# harmless, invisible to scrapes, and excluded from instrument_calls()
_NULL_COUNTER = Counter()
_NULL_GAUGE = Gauge()
_NULL_HISTOGRAM = Histogram(LATENCY_MS_BUCKETS)

_PRICE_UNSET = object()


def enabled():
    """Master gate of the efficiency plane: the telemetry switch AND
    ``MXNET_SERVE_EFFICIENCY``.  Call sites hold no ledger (and price
    no graphs) when this is off."""
    from . import enabled as _telemetry_on      # lazy: package cycle
    if not _telemetry_on():
        return False
    from .. import config
    return config.get("MXNET_SERVE_EFFICIENCY")


# -- pricing -----------------------------------------------------------------

def analytic_flops(symbol, data_shapes, dtypes=None, training=False):
    """``count_flops(...)["total"]`` of ``symbol``, or None when the
    graph holds an op of ``UNPRICED_OPS``.  Raises what ``count_flops``
    raises."""
    from ..analysis.flops import count_flops
    f = count_flops(symbol, data_shapes, dtypes=dtypes, training=training)
    if UNPRICED_OPS.intersection(f["by_op"]):
        return None
    return f["total"]


def price_graph(symbol, data_shapes, dtypes=None, label_names=None):
    """Advisory integer FLOPs price of ONE execution of ``symbol`` at
    the given concrete (padded) input shapes — the per-dispatch ledger
    quantum.  Loss-head label inputs (``label_names``) get their
    shapes inferred the same way ProgramCache's dummy-label plumbing
    does, or the shapes pass would fail on them.  Returns ``None``
    when the FLOPs pass cannot price the graph: pricing must never
    fail a dispatch, so callers count the dispatch as unpriced
    instead."""
    try:
        shapes = {k: tuple(s) for k, s in dict(data_shapes).items()}
        if label_names:
            from ..predict import _infer_label_shapes
            shapes.update(_infer_label_shapes(symbol, dict(shapes),
                                              list(label_names)))
        total = analytic_flops(symbol, shapes, dtypes=dtypes)
        if total is None:
            return None
        total = int(round(total))
        return total if total > 0 else None
    except Exception:
        return None


def _price_step_sym(symbol, token_name, pos_name, valid_name,
                    state_info, num_slots, host_dtype):
    """Price one step-graph execution at slot-pool shapes — the same
    shape grid the memory preflight and the compiled program use:
    token/pos/valid are ``(num_slots,)`` host vectors, each state is
    ``(num_slots,) + state shape``."""
    arg_names = set(symbol.list_arguments())
    shapes, dtypes = {}, {}
    for extra in (token_name, pos_name, valid_name):
        if extra and extra in arg_names:
            shapes[extra] = (num_slots,)
            dtypes[extra] = host_dtype
    for info in state_info:
        name = info["name"]
        if name in arg_names:
            shapes[name] = (num_slots,) + tuple(info["shape"])
            dtypes[name] = info.get("dtype", host_dtype)
    return price_graph(symbol, shapes, dtypes=dtypes)


def price_step_program(program):
    """Advisory integer FLOPs price of ONE dispatch of a decode
    :class:`~mxnet_tpu_torch.serving.decode.StepProgram`, memoized on the
    program object (priced once per compiled program, like the bucket
    programs).

    A plain program prices as one target step at slot-pool shapes.  A
    speculative program unrolls K = k+1 draft steps AND K target
    steps in-graph (serving/decode.py draft/target chains), so its
    price is ``K * (draft_step + target_step)`` — the accept/commit
    tail is a few elementwise selects, noise against two model
    forwards, and is deliberately not priced.  ``None`` = unpriced
    (either half failed the FLOPs pass)."""
    cached = getattr(program, "_goodput_price", _PRICE_UNSET)
    if cached is not _PRICE_UNSET:
        return cached
    price = None
    try:
        target = _price_step_sym(
            program._serve_sym, program.token_name, program.pos_name,
            program.valid_name, program.state_info, program.num_slots,
            program._dtype)
        spec = getattr(program, "_spec", None)
        if spec is None:
            price = target
        elif target is not None:
            from .. import symbol as sym
            draft = _price_step_sym(
                sym.Group(list(spec.draft_sym)), spec.token_name,
                spec.pos_name, spec.valid_name, spec.draft_state_info,
                program.num_slots, program._dtype)
            if draft is not None:
                price = spec.K * (target + draft)
    except Exception:
        price = None
    try:
        program._goodput_price = price
    except Exception:
        pass
    return price


# -- metric families ----------------------------------------------------------

def efficiency_metric_families(reg):
    """Register (idempotently) every family of the efficiency plane
    against ``reg`` and return them as a dict — the shared-family
    idiom of serving/engine.py's ``aot_metric_families``.  The engine
    ordinal is the FIRST label of every family, so one
    ``remove_labeled_series(fams, engine_label)`` sweep at close()
    reclaims an engine's whole footprint (tenant and outcome children
    included)."""
    return {
        "total": reg.counter(
            "mxnet_serve_flops_total",
            "analytic FLOPs dispatched, priced once per compiled "
            "program (advisory: unpriced programs count under "
            "mxnet_serve_unpriced_dispatches_total instead)",
            ("engine", "replica")),
        "useful": reg.counter(
            "mxnet_serve_flops_useful_total",
            "FLOPs attributable to live rows x valid lengths — the "
            "goodput numerator; the four class counters sum exactly "
            "to mxnet_serve_flops_total",
            ("engine", "replica")),
        "padding": reg.counter(
            "mxnet_serve_flops_padding_total",
            "FLOPs spent on pow2-batch-bucket and seq-pad overhang "
            "(one-shot and prefill dispatches)",
            ("engine", "replica")),
        "dead_slot": reg.counter(
            "mxnet_serve_flops_dead_slot_total",
            "FLOPs spent on vacant decode slots riding the persistent "
            "step masked",
            ("engine", "replica")),
        "spec_rejected": reg.counter(
            "mxnet_serve_flops_spec_rejected_total",
            "draft+verify FLOPs for speculative tokens the acceptance "
            "test discarded",
            ("engine", "replica")),
        "unpriced": reg.counter(
            "mxnet_serve_unpriced_dispatches_total",
            "dispatches of programs the FLOPs pass could not price — "
            "compute missing from the ledger, counted instead of "
            "silently dropped",
            ("engine",)),
        "mfu": reg.gauge(
            "mxnet_serve_mfu",
            "serving model FLOPs utilization over the last scrape "
            "window: dispatched analytic FLOPs / wall / device peak "
            "(step.py PEAKS_TFLOPS); absent on backends without a "
            "peak entry (CPU) — honest None, never a made-up "
            "denominator",
            ("engine", "replica")),
        "goodput": reg.gauge(
            "mxnet_serve_goodput_ratio",
            "useful / total FLOPs over the last scrape window",
            ("engine",)),
        "tenant_useful": reg.counter(
            "mxnet_serve_tenant_useful_flops_total",
            "useful FLOPs attributed per tenant (bounded cardinality: "
            "first MXNET_TELEMETRY_TENANTS_MAX tenants get labels, "
            "the rest aggregate into tenant=\"other\")",
            ("engine", "tenant")),
        "tenant_tokens": reg.counter(
            "mxnet_serve_tenant_tokens_total",
            "generated tokens delivered per tenant (decode engines)",
            ("engine", "tenant")),
        "tenant_requests": reg.counter(
            "mxnet_serve_tenant_requests_total",
            "finished requests per tenant by outcome (ok/eos/length/"
            "deadline/closed/error/cancelled)",
            ("engine", "tenant", "outcome")),
        "tenant_latency": reg.histogram(
            "mxnet_serve_tenant_latency_ms",
            "end-to-end request latency per tenant (submit to future "
            "resolution)",
            ("engine", "tenant"), LATENCY_MS_BUCKETS),
        "tenant_overflow": reg.counter(
            "mxnet_serve_tenant_overflow_total",
            "requests whose tenant id arrived after the cardinality "
            "cap and was aggregated into tenant=\"other\"",
            ("engine",)),
    }


# -- /healthz section ---------------------------------------------------------
# module-level registry of live ledgers: the serve_efficiency healthz
# section is registered with the first ledger and unregistered with the
# last close, so an engine-less process serves no empty section.

_LIVE = []
_LIVE_LOCK = threading.Lock()


def _healthz_section():
    with _LIVE_LOCK:
        effs = list(_LIVE)
    out = {}
    for eff in effs:
        out["%s_engine%s" % (eff.kind, eff.engine_label)] = \
            eff.stats_block()
    return out or None


def _live_add(eff):
    from . import server
    with _LIVE_LOCK:
        first = not _LIVE
        _LIVE.append(eff)
    if first:
        server.register_healthz_section("serve_efficiency",
                                        _healthz_section)


def _live_remove(eff):
    from . import server
    with _LIVE_LOCK:
        try:
            _LIVE.remove(eff)
        except ValueError:
            return
        last = not _LIVE
    if last:
        server.unregister_healthz_section("serve_efficiency")


# -- the per-engine ledger ------------------------------------------------


class EngineEfficiency(object):
    """One engine's FLOPs ledger + MFU/goodput gauges + tenant series.

    Built by the engine alongside its telemetry bundle ONLY when
    :func:`enabled`; the record_* hot-path methods are called from the
    engine's single worker thread (the same plain-int discipline as
    ProgramCache.plan_hits), :meth:`refresh` from the registry's
    collect callback, and tenant finish callbacks from whatever thread
    resolves the future — everything cross-thread goes through
    instrument locks or ``_tlock``.
    """

    def __init__(self, kind, engine_label):
        from . import registry
        self.kind = kind
        self.engine_label = str(engine_label)
        self.closed = False
        self.fams = efficiency_metric_families(registry())
        self._c_unpriced = self.fams["unpriced"].labels(
            engine=self.engine_label)
        self._c_overflow = self.fams["tenant_overflow"].labels(
            engine=self.engine_label)
        self._replicas = {}
        # cumulative plain-int mirrors (stats() and refresh windows)
        self.t_total = 0
        self.t_useful = 0
        self.t_padding = 0
        self.t_dead = 0
        self.t_spec_rejected = 0
        self.t_unpriced = 0
        # refresh-window cursors
        self._win_t = time.monotonic()
        self._win_total = 0
        self._win_useful = 0
        self._goodput_last = None
        # bounded-cardinality tenant guard
        from .. import config
        self._tenants_max = int(config.get("MXNET_TELEMETRY_TENANTS_MAX"))
        self._tenants = set()
        self._tenant_overflowed = 0
        self._tlock = threading.Lock()
        _live_add(self)

    # -- replicas ---------------------------------------------------------
    def add_replica(self, label, ctx=None):
        """Bind this replica's ledger children and resolve its MFU
        peak once (honest None on CPU/unknown device kinds — the MFU
        series is then never published for it)."""
        label = str(label)
        peak = None
        if ctx is not None:
            try:
                peak = peak_flops_for(ctx.device)
            except Exception:
                peak = None
        eng = self.engine_label
        ch = {
            "total": self.fams["total"].labels(engine=eng, replica=label),
            "useful": self.fams["useful"].labels(engine=eng,
                                                 replica=label),
            "padding": self.fams["padding"].labels(engine=eng,
                                                   replica=label),
            "dead_slot": self.fams["dead_slot"].labels(engine=eng,
                                                       replica=label),
            "spec_rejected": self.fams["spec_rejected"].labels(
                engine=eng, replica=label),
            "peak": peak,
            "flops_i": 0,        # cumulative (plain int, worker thread)
            "win_flops": 0,      # refresh-window cursor
            "mfu": None,         # last published window MFU
        }
        if self.closed:          # construction racing close: sink it
            ch = dict(ch, total=_NULL_COUNTER, useful=_NULL_COUNTER,
                      padding=_NULL_COUNTER, dead_slot=_NULL_COUNTER,
                      spec_rejected=_NULL_COUNTER)
        self._replicas[label] = ch
        return ch

    def _channel(self, replica):
        ch = self._replicas.get(str(replica))
        if ch is None:
            ch = self.add_replica(replica)
        return ch

    # -- the ledger (integer conservation by construction) -----------------
    def _inc(self, ch, total, useful=0, padding=0, dead=0,
             spec_rejected=0):
        ch["total"].inc(total)
        if useful:
            ch["useful"].inc(useful)
        if padding:
            ch["padding"].inc(padding)
        if dead:
            ch["dead_slot"].inc(dead)
        if spec_rejected:
            ch["spec_rejected"].inc(spec_rejected)
        ch["flops_i"] += total
        self.t_total += total
        self.t_useful += useful
        self.t_padding += padding
        self.t_dead += dead
        self.t_spec_rejected += spec_rejected

    def record_unpriced(self):
        self.t_unpriced += 1
        (_NULL_COUNTER if self.closed else self._c_unpriced).inc()

    def record_batch(self, replica, price, live_elems, padded_elems):
        """One padded batch dispatch (one-shot bucket or prefill):
        useful is the live-element floor-share of the price, padding
        the exact remainder.  Returns the useful amount (the tenant
        attribution quantum) or None when unpriced."""
        if price is None:
            self.record_unpriced()
            return None
        price = int(price)
        pe = int(padded_elems)
        useful = (price if pe <= 0
                  else min(price, price * int(live_elems) // pe))
        self._inc(self._channel(replica), price, useful=useful,
                  padding=price - useful)
        return useful

    def record_step(self, replica, price, live_slots, num_slots):
        """One plain decode step over the persistent slot pool: the
        vacant slots' floor-share is dead-slot, the rest useful."""
        if price is None:
            self.record_unpriced()
            return None
        price = int(price)
        dead = price * (num_slots - live_slots) // num_slots
        useful = price - dead
        self._inc(self._channel(replica), price, useful=useful,
                  dead=dead)
        return useful

    def record_spec_step(self, replica, price, live_slots, num_slots,
                         committed, window):
        """One speculative draft-k-verify step: the K-token window
        (``window`` = k+1) prices K draft + K target forwards per
        slot; vacant slots are dead, COMMITTED token positions
        (accepted drafts + the one guaranteed token per spec slot +
        one per teacher-forcing slot) are useful, and the remainder —
        rejected drafts plus the unused window tail — is
        spec-rejected, derived by subtraction so the classes conserve
        exactly."""
        if price is None:
            self.record_unpriced()
            return None
        price = int(price)
        dead = price * (num_slots - live_slots) // num_slots
        useful = min(price - dead,
                     price * int(committed) // (num_slots * window))
        self._inc(self._channel(replica), price, useful=useful,
                  dead=dead,
                  spec_rejected=price - dead - useful)
        return useful

    # -- tenants -----------------------------------------------------------
    def tenant_enter(self, tenant):
        """Resolve a request's tenant id onto the bounded label set:
        the first MXNET_TELEMETRY_TENANTS_MAX distinct ids get their
        own label, later ones collapse into the reserved "other"
        (counted per overflowed request).  Resolve ONCE at submit and
        carry the result on the request — every later inc uses the
        resolved label."""
        if tenant is None:
            return None
        t = str(tenant)
        if t in self._tenants:
            return t
        with self._tlock:
            if self.closed:
                return None
            if t in self._tenants:
                return t
            if len(self._tenants) < self._tenants_max and t != "other":
                self._tenants.add(t)
                return t
            self._tenant_overflowed += 1
        self._c_overflow.inc()
        return "other"

    def _tenant_child(self, fam_key, **labels):
        if self.closed:
            return (_NULL_HISTOGRAM if fam_key == "tenant_latency"
                    else _NULL_COUNTER)
        return self.fams[fam_key].labels(engine=self.engine_label,
                                         **labels)

    def tenant_useful(self, label, flops):
        if label is None or not flops or flops <= 0:
            return
        self._tenant_child("tenant_useful", tenant=label).inc(flops)

    def tenant_finish(self, label, outcome, latency_ms=None, tokens=0):
        if label is None:
            return
        self._tenant_child("tenant_requests", tenant=label,
                           outcome=outcome).inc()
        if latency_ms is not None:
            self._tenant_child("tenant_latency",
                               tenant=label).observe(latency_ms)
        if tokens:
            self._tenant_child("tenant_tokens",
                               tenant=label).inc(tokens)

    def tenant_done(self, label, fut, t_enqueue):
        """Future done-callback body: classify the terminal outcome
        (cancelled / error / the DecodeResult finish_reason / plain
        ok), observe end-to-end latency, count delivered tokens.
        Swallows everything — accounting must never poison a future's
        resolution chain."""
        try:
            res = None
            if fut.cancelled():
                outcome = "cancelled"
            elif fut.exception() is not None:
                outcome = "error"
            else:
                res = fut.result()
                outcome = getattr(res, "finish_reason", None) or "ok"
            tokens = (len(getattr(res, "tokens", ()))
                      if res is not None else 0)
            self.tenant_finish(
                label, outcome,
                latency_ms=(time.monotonic() - t_enqueue) * 1e3,
                tokens=tokens)
        except Exception:
            pass

    # -- gauges (collect-time windows) --------------------------------------
    def refresh(self):
        """Publish window MFU per replica and the window goodput
        ratio — called from the engine bundle's collect callback, so
        the scrape interval IS the window.  An idle window publishes
        MFU 0 (the replica really did nothing) but leaves the goodput
        ratio at its last value (0/0 says nothing about waste)."""
        if self.closed:
            return
        now = time.monotonic()
        dt = now - self._win_t
        if dt <= 0:
            return
        eng = self.engine_label
        for label, ch in list(self._replicas.items()):
            if ch["peak"] is not None:
                mfu = (ch["flops_i"] - ch["win_flops"]) / dt / ch["peak"]
                ch["mfu"] = mfu
                self.fams["mfu"].labels(engine=eng,
                                        replica=label).set(mfu)
            ch["win_flops"] = ch["flops_i"]
        d_total = self.t_total - self._win_total
        if d_total > 0:
            self._goodput_last = \
                (self.t_useful - self._win_useful) / d_total
            self.fams["goodput"].labels(engine=eng).set(
                self._goodput_last)
        self._win_total = self.t_total
        self._win_useful = self.t_useful
        self._win_t = now

    # -- reporting -----------------------------------------------------------
    def stats_block(self):
        """The ``stats()["efficiency"]`` / healthz block: cumulative
        class totals (exactly conserved), lifetime goodput, last
        window MFU per replica, tenant-guard occupancy."""
        total = self.t_total
        return {
            "flops": {
                "total": total,
                "useful": self.t_useful,
                "padding": self.t_padding,
                "dead_slot": self.t_dead,
                "spec_rejected": self.t_spec_rejected,
            },
            "goodput_ratio": (self.t_useful / total) if total else None,
            "window_goodput_ratio": self._goodput_last,
            "mfu": {label: ch["mfu"]
                    for label, ch in sorted(self._replicas.items())},
            "unpriced_dispatches": self.t_unpriced,
            "tenants": {
                "distinct": len(self._tenants),
                "max": self._tenants_max,
                "overflowed": self._tenant_overflowed,
            },
        }

    # -- lifecycle -------------------------------------------------------------
    def close(self):
        """Reclaim every series this engine registered (the engine
        ordinal is label position 0 of every family, tenant/outcome
        children included) and drop out of the healthz section.
        Idempotent; racing record/tenant calls fall into unregistered
        null sinks."""
        with self._tlock:
            if self.closed:
                return
            self.closed = True
        _live_remove(self)
        from . import remove_labeled_series
        remove_labeled_series(self.fams.values(), self.engine_label,
                              position=0)
        self._replicas.clear()
