"""ServingEngine: thread-safe batched inference over one frozen graph.

Counterpart of the core of ``mxnet_tpu/serving/engine.py``: clients
``submit`` single examples (no batch dim) and get futures; one worker
thread takes the oldest request's shape group from the admission queue
(waiting at most the batching window for company), pads it up to a
power-of-two bucket, has the bucket's program run on the device, and
hands each client its own row back on the host.  ``warmup`` runs every
bucket once up front.  With no ``ctx`` the engine serves on the first
CUDA card, and raises when there is none; pass ``ctx=cpu()`` for the CPU.

Every program runs on one device thread that lives as long as the
engine, warmup included: cuBLAS handles and cuDNN's execution plans are
kept per thread, so a warmup on any other thread would leave the first
live batches to build them again.

With a policy that buckets a per-example sequence axis
(``BucketPolicy(seq_axis=..., seq_buckets=...)``), requests of any length
along that axis share the programs of their seq bucket: a request pads
up to its bucket, coalesces with the requests of the same bucket, and
gets its outputs back sliced to the shapes the graph infers at its
unpadded input.  ``warmup`` runs the whole (seq bucket x batch bucket)
grid.

Construction runs the analysis preflight (``MXNET_ANALYSIS_ON``): the
verifier, shapes, retrace and padding passes over the graph at the
largest bucket.  A graph that mixes positions along the bucketed seq
axis first gets a masking repair (``MXNET_SERVE_REPAIR``): SequenceMask
nodes driven by a per-request valid-length input, adopted only when
re-analysis says the rewritten graph is row-local; the engine then feeds
each batch its live lengths.  Without a repair, the seq buckets are
dropped and every exact length runs its own program.  A graph that mixes
rows along the batch axis serves one request per batch
(``max_batch=1``).  Either degrade warns, or raises under
``MXNET_ANALYSIS_STRICT=1``; the retrace linter's findings are kept as
``hazard_fingerprints``.  Then the verdict-gated optimizer
(``MXNET_SERVE_OPTIMIZE``) rewrites the graph the ``ProgramCache`` runs,
adopted only when re-analysis is no worse, and the memory preflight
(``MXNET_MEMORY_PLAN``) prices the warm program set against the device
budget before any program runs: over budget warns, naming the program
and its bytes, or raises under strict.

Overload: a full queue rejects (``QueueFullError``) or, under
``overload_policy="shed-oldest"`` (``MXNET_SERVE_OVERLOAD_POLICY``),
fails the oldest queued request with ``ServerOverloadError``.
``MXNET_SERVE_PAD_CHECK=1`` dispatches every batch twice, the second time
with its pad slots set to a sentinel, and fails the batch with
"contamination" when a live output changed.

Telemetry (``MXNET_TELEMETRY_ON``, on by default): the reference's
``mxnet_serve_*`` families and labels (``_EngineTelemetry``), a
tail-biased trace of every request (queue-wait, coalesce, pad, dispatch,
unpad spans), the efficiency plane's FLOPs ledger (``MXNET_SERVE_
EFFICIENCY``), the fleet timeline, a worker heartbeat with the default
alert rules, and the HTTP endpoint (``MXNET_TELEMETRY_PORT``).  With
telemetry off the engine holds no instrument and serves the same bits.
Phases and latencies are host wall time: a dispatch's time includes the
device work only because the outputs are read back to the host inside
it.

Not yet ported: replicas, sharding plans, the AOT program cache, fault
injection, the supervisor and the overload regulator (whose shed counter
registers and stays 0), and their metric families.
"""
from __future__ import annotations

import collections
import itertools
import math
import threading
import time
import warnings
import weakref
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .. import profiler
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import default_context
from ..telemetry import goodput as _goodput
from .admission import (AdmissionController, Request, EngineClosedError,
                        _fail_future)
from .buckets import BucketPolicy, ProgramCache, pad_valid_lengths

__all__ = ["ServingEngine"]


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[k]


# distinct shape signatures tracked as individual label values before
# spilling into the catch-all "other" series (label cardinality bound)
_MAX_SIG_LABELS = 64

# hazard fingerprints carried verbatim in the retraces `hazards` label
# before the explicit overflow marker ("...,+3") takes over
_MAX_HAZARD_LABEL_FPS = 16

# per-process engine ordinal: the `engine` label on point-in-time
# gauges, so co-resident engines get distinct series
_ENGINE_SEQ = itertools.count()

# the one device replica's label: the port serves on one device, and
# keeps the reference's per-replica series under replica="0"
_REPLICA = "0"

# unregistered sink for the submit-vs-close race: a counter nothing
# scrapes, so a racing submit cannot resurrect removed series
_NULL_COUNTER = _telemetry.Counter()


def memory_metric_families(reg):
    """Register (idempotently) the static-memory-planner gauge pair
    both engine kinds share, per engine: the planner's construction-time
    liveness prediction and the allocator's measured high-water mark
    (CUDA devices only — the CPU publishes only the prediction).
    Returns ``(predicted_fam, measured_fam)``."""
    return (reg.gauge(
        "mxnet_serve_memory_predicted_peak_bytes",
        "predicted peak HBM bytes for this engine's warm program set "
        "(params resident + activation high-water over the worst "
        "bucket program, divided along plan-partitioned axes) — the "
        "static memory planner's construction-time liveness watermark, "
        "computed before any compile",
        labelnames=("engine",)),
        reg.gauge(
            "mxnet_serve_memory_measured_peak_bytes",
            "backend allocator peak_bytes_in_use measured at scrape "
            "time (telemetry/devicemem.py probe) — the honest runtime "
            "side of the planner's predicted-vs-measured pair; absent "
            "on backends without memory_stats (CPU)",
            labelnames=("engine",)))


def refresh_memory_gauges(bundle, eng):
    """Scrape-time update of the predicted-vs-measured memory pair
    (shared by both engine bundles): the planner's watermark from the
    engine's construction-time plan, and the allocator's measured peak
    on the engine's device via the shared devicemem probe — probe-once,
    so a CPU engine never grows a dead series."""
    mem = getattr(eng, "memory_plan", None)
    if mem:
        bundle.mem_predicted.set(float(mem.get(
            "predicted_peak_bytes", 0) or 0))
    if bundle._mem_probe_ok:
        from ..telemetry.devicemem import device_memory_peak
        peak = device_memory_peak(eng._ctx.device)
        if peak is None:
            bundle._mem_probe_ok = False
        else:
            if bundle._mem_measured is None:
                bundle._mem_measured = bundle._mem_meas_fam.labels(
                    engine=bundle.engine_label)
            bundle._mem_measured.set(float(peak))


class _EngineTelemetry(object):
    """The engine's instrument bundle against the default telemetry
    registry (the reference's, under the same names and labels, less the
    families of machinery the port lacks: the AOT cache and the replica
    set).  Built once per engine ONLY when telemetry is enabled — with
    ``MXNET_TELEMETRY_ON=0`` the engine holds ``None`` and its hot path
    performs zero instrument calls.

    Families are shared process-wide (a second engine reuses them), so
    counters aggregate across engines; point-in-time gauges carry an
    ``engine`` label so two live engines in one process cannot clobber
    each other's series.
    """

    def __init__(self, engine):
        reg = _telemetry.registry()
        self.engine_label = str(next(_ENGINE_SEQ))
        self.closed = False
        self.requests = reg.counter(
            "mxnet_serve_requests_total", "serving requests submitted")
        self.queue_wait = reg.histogram(
            "mxnet_serve_queue_wait_ms",
            "enqueue -> worker-pop wait per request",
            buckets=_telemetry.LATENCY_MS_BUCKETS)
        self.latency = reg.histogram(
            "mxnet_serve_request_latency_ms",
            "enqueue -> result end-to-end request latency",
            buckets=_telemetry.LATENCY_MS_BUCKETS)
        self.batches = reg.counter(
            "mxnet_serve_batches_total", "batches dispatched")
        self.occupancy = reg.histogram(
            "mxnet_serve_batch_occupancy",
            "live requests / bucket size per dispatched batch, per "
            "engine and device replica",
            labelnames=("engine", "replica"),
            buckets=_telemetry.RATIO_BUCKETS)
        self.dispatch_ms = reg.histogram(
            "mxnet_serve_dispatch_ms",
            "compiled-program dispatch wall time per batch, per engine "
            "and device replica — a replica whose dispatch tail "
            "diverges from its siblings is the straggling device",
            labelnames=("engine", "replica"),
            buckets=_telemetry.LATENCY_MS_BUCKETS)
        self.pad_waste = reg.histogram(
            "mxnet_serve_padding_waste_ratio",
            "padded-but-dead input elements / total padded elements "
            "per batch, by batch bucket",
            labelnames=("bucket",), buckets=_telemetry.RATIO_BUCKETS)
        self.padded_elems = reg.counter(
            "mxnet_serve_padded_elements_total",
            "total input elements dispatched (live + pad slots)",
            labelnames=("bucket",))
        self.live_elems = reg.counter(
            "mxnet_serve_live_elements_total",
            "live (request-backed) input elements dispatched",
            labelnames=("bucket",))
        self.compiles = reg.counter(
            "mxnet_serve_compiles_total",
            "bucket programs built by this process's serving dispatches "
            "(warmup + cold buckets + rebuilds)")
        self.retraces = reg.counter(
            "mxnet_serve_retraces_total",
            "post-warmup program builds on serving dispatches — the "
            "build-once contract demands this stays 0 per device "
            "replica; the hazards label carries the retrace-linter "
            "fingerprints of the graph's statically known hazards, "
            "per engine",
            labelnames=("engine", "replica", "hazards"))
        self.shape_seen = reg.counter(
            "mxnet_serve_shape_signature_total",
            "requests per observed (bucket-padded) input-shape "
            "signature, per engine; drives the shape-entropy gauge",
            labelnames=("engine", "sig"))
        entropy_fam = reg.gauge(
            "mxnet_serve_shape_entropy_bits",
            "Shannon entropy (bits) of one engine's observed shape-"
            "signature distribution — high entropy + retrace hazards "
            "= the traffic most likely to trigger a retrace storm",
            labelnames=("engine",))
        self.entropy = entropy_fam.labels(engine=self.engine_label)
        queue_depth_fam = reg.gauge(
            "mxnet_serve_queue_depth",
            "pending admission-queue depth per engine",
            labelnames=("engine",))
        self.queue_depth = queue_depth_fam.labels(
            engine=self.engine_label)
        self.admitted = reg.counter(
            "mxnet_serve_admitted_total", "requests admitted")
        self.rejected = reg.counter(
            "mxnet_serve_rejected_total",
            "requests rejected with QueueFullError backpressure")
        self.shed = reg.counter(
            "mxnet_serve_shed_total",
            "requests shed under the shed-oldest overload policy")
        self.regulator_shed = reg.counter(
            "mxnet_serve_regulator_shed_total",
            "requests shed cost-aware by the overload regulator's "
            "tightened queue limit — deliberately NOT part of the "
            "queue-saturation burn numerator (the regulator's own "
            "sheds must not re-fire the rule it is resolving)")
        self.expired = reg.counter(
            "mxnet_serve_expired_total",
            "requests expired past their deadline while queued")
        cache_hits_fam = reg.gauge(
            "mxnet_serve_program_cache_hits",
            "dispatch-plan cache hits (warm bucket signatures) per "
            "engine", labelnames=("engine",))
        self.cache_hits = cache_hits_fam.labels(engine=self.engine_label)
        cache_misses_fam = reg.gauge(
            "mxnet_serve_program_cache_misses",
            "dispatch-plan cache misses (first sight of a signature) "
            "per engine", labelnames=("engine",))
        self.cache_misses = cache_misses_fam.labels(
            engine=self.engine_label)
        compile_count_fam = reg.gauge(
            "mxnet_serve_compile_count",
            "bucket programs built so far, per engine",
            labelnames=("engine",))
        self.compile_count = compile_count_fam.labels(
            engine=self.engine_label)
        self.repairs_applied = reg.counter(
            "mxnet_serve_repairs_applied_total",
            "construction-time masking rewrites adopted (verdict "
            "flipped row-local) per padded axis and frontier op — "
            "each count is one SequenceMask splice / mean renorm the "
            "engine now serves through instead of degrading",
            labelnames=("engine", "axis", "op"))
        self.repairs_rejected = reg.counter(
            "mxnet_serve_repairs_rejected_total",
            "construction-time repair attempts whose rewritten graph "
            "did not re-verify row-local: the engine fell back to the "
            "degrade path (exact-length programs / max_batch=1)",
            labelnames=("engine",))
        self.opt_removed = reg.counter(
            "mxnet_serve_opt_nodes_removed_total",
            "graph nodes the construction-time optimizer pipeline "
            "(analysis/optimize.py, MXNET_SERVE_OPTIMIZE) removed from "
            "the served graph, per pass that disconnected them — the "
            "candidate was adopted only after re-analysis verdicts "
            "came back no worse than the input graph's",
            labelnames=("engine", "pass"))
        self.opt_rejected = reg.counter(
            "mxnet_serve_opt_rejected_total",
            "optimizer rewrites planned but thrown away because the "
            "candidate graph's re-analysis verdicts came back worse "
            "(the engine serves the unoptimized graph), per pass that "
            "planned them",
            labelnames=("engine", "pass"))
        self.replica_batches = reg.counter(
            "mxnet_serve_replica_batches_total",
            "batches dispatched per device replica — uniform counts "
            "mean the least-loaded router is actually balancing",
            labelnames=("engine", "replica"))
        mem_pred_fam, mem_meas_fam = memory_metric_families(reg)
        self.mem_predicted = mem_pred_fam.labels(engine=self.engine_label)
        self._mem_meas_fam = mem_meas_fam
        self._mem_measured = None
        self._mem_probe_ok = True
        self._engine_gauge_fams = (queue_depth_fam, cache_hits_fam,
                                   cache_misses_fam, compile_count_fam,
                                   entropy_fam, mem_pred_fam,
                                   mem_meas_fam)
        self._replica_fams = (self.replica_batches, self.dispatch_ms,
                              self.occupancy, self.retraces)
        # bind the replica's children once — the dispatch hot path never
        # pays a labels() registry probe — and pre-touch the retrace
        # series under this graph's hazard label so a healthy engine
        # scrapes an explicit 0
        lab = dict(engine=self.engine_label, replica=_REPLICA)
        self.r_dispatch = self.dispatch_ms.labels(**lab)
        self.r_occupancy = self.occupancy.labels(**lab)
        self.r_retraces = self.retraces.labels(
            hazards=engine._hazard_label, **lab)
        self.r_batches = self.replica_batches.labels(**lab)
        self._engine = weakref.ref(engine)
        reg.register_callback(self._refresh)

    def close(self):
        """Detach from the registry: an engine's bundle must not
        outlive it (constructing engines in a loop would otherwise
        leak one dead callback — and its per-engine series — per
        engine into every future scrape)."""
        self.closed = True      # before removal: see _sig_counter
        _telemetry.registry().unregister_callback(self._refresh)
        self._remove_engine_series()

    def _remove_engine_series(self):
        for fam in self._engine_gauge_fams:
            fam.remove(engine=self.engine_label)
        for fam in (self.shape_seen,
                    self.repairs_applied, self.repairs_rejected,
                    self.opt_removed, self.opt_rejected) \
                + self._replica_fams:
            for values, _inst in fam.series():
                if values[0] == self.engine_label:
                    fam.remove(*values)

    def _refresh(self, reg):
        """Collect-time callback: mirror engine-owned state into gauges
        so every scrape is fresh without a sampler thread."""
        eng = self._engine()
        if eng is None:
            # engine was GC'd without close(): self-evict, series too
            reg.unregister_callback(self._refresh)
            self._remove_engine_series()
            return
        self.cache_hits.set(eng._cache.plan_hits)
        self.cache_misses.set(eng._cache.plan_misses)
        self.compile_count.set(eng.compile_count)
        refresh_memory_gauges(self, eng)
        eff = getattr(eng, "_eff", None)
        if eff is not None:
            eff.refresh()       # window MFU + goodput gauges per scrape
        # entropy over THIS engine's series only (sig children carry
        # the engine label)
        vals = [inst.value for values, inst in self.shape_seen.series()
                if values[0] == self.engine_label]
        total = sum(vals)
        if total > 0:
            ent = -sum((v / total) * math.log2(v / total)
                       for v in vals if v > 0)
            self.entropy.set(ent if ent else 0.0)   # never -0.0



class ServingEngine(object):
    """Thread-safe batched-inference front end over one frozen graph.

    ``data_shapes`` maps each data input to its per-EXAMPLE shape (no
    batch dim); requests are validated against it, except along the
    policy's seq axis, which may vary per request.  ``overload_policy``
    is ``"reject"`` or ``"shed-oldest"`` (default
    ``MXNET_SERVE_OVERLOAD_POLICY``).  ``start=False`` leaves the worker
    stopped so requests can be staged."""

    def __init__(self, symbol, arg_params, aux_params, data_shapes,
                 ctx=None, policy=None, max_queue=None,
                 batch_timeout_ms=None, default_deadline_ms=None,
                 overload_policy=None, dtype=np.float32, start=True):
        from .. import config
        self._ctx = default_context(ctx)
        self._policy = policy or BucketPolicy.from_config()
        if max_queue is None:
            max_queue = config.get("MXNET_SERVE_MAX_QUEUE")
        if batch_timeout_ms is None:
            batch_timeout_ms = config.get("MXNET_SERVE_BATCH_TIMEOUT_MS")
        if default_deadline_ms is None:
            default_deadline_ms = config.get(
                "MXNET_SERVE_DEFAULT_DEADLINE_MS")
        if overload_policy is None:
            overload_policy = config.get("MXNET_SERVE_OVERLOAD_POLICY")
        self._window_s = float(batch_timeout_ms) / 1e3
        self._default_deadline_s = float(default_deadline_ms) / 1e3
        self._sym = symbol
        self._data_shapes = {k: tuple(v) for k, v in dict(data_shapes).items()}
        self._dtype = np.dtype(dtype)
        # static preflight: IR verifier + shapes + retrace + padding over
        # the axes this engine zero-pads; a cross-position seq verdict is
        # repaired or degraded, a cross-position batch verdict refused
        # (strict) or de-fanged (max_batch=1)
        self._serve_sym = symbol         # what the ProgramCache runs
        self.analysis_report = None
        self.repair_plan = None          # accepted RepairPlan, if any
        self._repair_rejected = None     # rejection reason, if attempted
        self._valid_name = None          # a repaired graph's extra input
        self._length_sources = {}        # input name -> per-example axis
        self._hazard_label = "none"
        self.hazard_fingerprints = {}
        self._verdicts = None            # padded-axis verdicts, if analyzed
        self._pad_check = config.get("MXNET_SERVE_PAD_CHECK")
        pre = None
        if config.get("MXNET_ANALYSIS_ON"):
            pre = self._preflight(symbol, config.get("MXNET_ANALYSIS_STRICT"))
        # the verdict-gated optimizer rewrites the graph the ProgramCache
        # runs; its acceptance protocol IS analysis, so both knobs gate it
        self.opt_plan = None
        if config.get("MXNET_SERVE_OPTIMIZE") \
                and config.get("MXNET_ANALYSIS_ON"):
            self._optimize_preflight(arg_params, aux_params, pre)
        # the memory planner prices the warm program set before any
        # program runs; it only diagnoses, so outputs are the same bits
        # with it on or off
        self.memory_plan = None
        if config.get("MXNET_MEMORY_PLAN") \
                and config.get("MXNET_ANALYSIS_ON"):
            self._memory_preflight(arg_params, aux_params,
                                   config.get("MXNET_ANALYSIS_STRICT"))
        data_names = list(self._data_shapes)
        if self._valid_name is not None:
            data_names.append(self._valid_name)
        self._cache = ProgramCache(self._serve_sym, arg_params, aux_params,
                                   data_names, ctx=self._ctx, dtype=dtype)
        self._feed_dtypes = ({self._valid_name: np.float32}
                             if self._valid_name is not None else None)
        # telemetry bundle: None when disabled — every instrumented
        # branch below gates on that, keeping the disabled hot path at
        # zero registry calls per request
        self._tm = _EngineTelemetry(self) if _telemetry.enabled() else None
        # fleet timeline ring, None when the plane is off
        self._tl = (_telemetry.timeline.get()
                    if _telemetry.timeline.enabled() else None)
        # efficiency plane: the FLOPs ledger, MFU/goodput gauges and
        # tenant accounting; the ProgramCache prices each bucket program
        # once, as it builds it
        self._eff = None
        if self._tm is not None and _goodput.enabled():
            self._eff = _goodput.EngineEfficiency(
                "serve", self._tm.engine_label)
            self._eff.add_replica(_REPLICA, ctx=self._ctx)
        if self._tm is not None:
            self._record_repair_telemetry()
            self._record_opt_telemetry()
        # trace-retention chain: every request is traced cheaply and
        # kept or dropped at finish (None = tracing off)
        self._trace_chain = (_telemetry.chain_from_config()
                             if self._tm is not None else None)
        # live HTTP endpoint: the first engine to find
        # MXNET_TELEMETRY_PORT set with no server running starts one;
        # close() releases it (refcounted across co-resident engines)
        self._owns_http_server = (_telemetry.server.engine_acquire()
                                  if self._tm is not None else False)
        self._sig_labels = {}        # group key -> shape-sig counter child
        self._sig_other = None       # shared catch-all child past the cap
        self._sig_lock = threading.Lock()
        self._adm = AdmissionController(max_queue=max_queue,
                                        overload_policy=overload_policy,
                                        telemetry=self._tm)
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mxnet-serve-device",
            initializer=self._bind_device)
        self._lock = threading.Lock()
        self._group_cache = {}           # exact input shapes -> group
        self._batches = 0
        self._warmup_batches = 0
        self._requests_served = 0
        self._occupancy_sum = 0.0
        self._dispatched_keys = set()
        self._retraces = 0
        self._lat_ms = collections.deque(maxlen=4096)
        # history, alerting and the flight recorder: the worker stamps a
        # heartbeat the watchdog rule polls, the engine registers so a
        # flight bundle captures its stats(), and the first engine
        # starts the recorder thread (refcounted).  Registered LAST: a
        # constructor that raises above holds nothing close() must drop.
        self._hb_t = time.monotonic()
        self._hb_busy = False
        self._owns_recorder = False
        self._alert_owner = None
        self._obs_name = None
        if self._tm is not None:
            self._obs_name = "serve.%s" % self._tm.engine_label
            _telemetry.recorder.register_heartbeat(self._obs_name,
                                                   self._heartbeat)
            _telemetry.recorder.register_engine(self._obs_name, self)
            self._owns_recorder = _telemetry.recorder.recorder_acquire()
            if config.get("MXNET_TELEMETRY_ALERTS"):
                self._alert_owner = \
                    _telemetry.register_engine_default_rules(
                        "serve", self._tm.engine_label)
        self._worker = None
        if start:
            self.start()

    def _record_opt_telemetry(self):
        """Mirror the construction-time optimizer outcome into the
        registry (mxnet_serve_opt_*_total), per pass."""
        tm = self._tm
        plan = self.opt_plan
        if plan is None:
            return
        if plan.accepted:
            for p, st in plan.per_pass.items():
                if st.get("nodes_removed"):
                    tm.opt_removed.labels(tm.engine_label, p).inc(
                        st["nodes_removed"])
        else:
            rej = collections.Counter(
                a.pass_name for a in plan.rewrites)
            for p, c in rej.items():
                tm.opt_rejected.labels(tm.engine_label, p).inc(c)

    def _record_repair_telemetry(self):
        """Mirror the construction-time repair outcome into the
        registry (mxnet_serve_repairs_*_total)."""
        tm = self._tm
        if self.repair_plan is not None:
            for a in self.repair_plan.actions:
                tm.repairs_applied.labels(
                    engine=tm.engine_label,
                    axis=self.repair_plan.label, op=a.op).inc()
        if self._repair_rejected is not None:
            tm.repairs_rejected.labels(engine=tm.engine_label).inc()

    @classmethod
    def from_checkpoint(cls, prefix, epoch, data_shapes, **kwargs):
        """Build from ``prefix-symbol.json`` + ``prefix-%04d.params``."""
        from ..model import load_checkpoint
        kwargs["ctx"] = default_context(kwargs.get("ctx"))
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(symbol, arg_params, aux_params, data_shapes, **kwargs)

    # ------------------------------------------------------------ preflight
    def _preflight(self, symbol, strict):
        """Construction-time static analysis (mxnet_tpu_torch.analysis).

        Verifier errors raise under ``MXNET_ANALYSIS_STRICT``.  A graph
        cross-position along the bucketed **seq** axis first gets the
        masking repair (``MXNET_SERVE_REPAIR``); when the repair is
        rejected or off, the engine degrades to stay sound:

        - cross-position along **seq**: the seq buckets are dropped, and
          each exact length runs its own program;
        - cross-position along **batch**: requests stop coalescing
          (``max_batch=1``).

        Under strict a degrade raises instead.  Returns the analysis'
        ``(report, ctx)`` for the optimizer to reuse, or None when a
        repair or degrade changed the graph or the padded shapes."""
        from .. import config
        from ..analysis import (check_serving_graph, repair_serving_graph,
                                AnalysisError)
        verdicts, report, ctx = check_serving_graph(
            symbol, self._data_shapes, self._policy, with_ctx=True)
        self.analysis_report = report
        self._verdicts = dict(verdicts)
        self._harvest_hazards(report)
        if report.errors:
            if strict:
                report.raise_if_errors()    # names the failing passes
            warnings.warn("ServingEngine: graph verification failed:\n%s"
                          % report.format())
        cross = [lb for lb, v in verdicts.items() if v == "cross-position"]
        if not cross:
            return report, ctx
        if "seq" in cross and config.get("MXNET_SERVE_REPAIR") \
                and not report.errors:
            plan = repair_serving_graph(symbol, self._data_shapes,
                                        self._policy,
                                        precomputed=(report, ctx))
            if plan.accepted:
                # serve the rewritten graph from the whole grid; dispatch
                # feeds the live lengths that drive the spliced masks
                self.repair_plan = plan
                self._serve_sym = plan.symbol
                self._valid_name = plan.valid_length_name
                self._length_sources = dict(plan.length_sources)
                cross.remove("seq")
                if not cross:
                    return None
            else:
                self._repair_rejected = plan.reason
        detail = "\n".join(
            "  " + str(d) for d in report.warnings) or "  (see report)"
        if strict:
            raise AnalysisError(
                "[padding] ServingEngine: graph is cross-position along "
                "padded axis(es) %s — zero-pad slots would bleed into "
                "live outputs%s:\n%s"
                % (cross,
                   " (repair rejected: %s)" % self._repair_rejected
                   if self._repair_rejected else "", detail))
        if "seq" in cross:
            warnings.warn(
                "ServingEngine: graph is cross-position along the "
                "bucketed seq axis%s; disabling seq buckets (lengths "
                "still vary per request, but each exact length now "
                "runs its own program):\n%s"
                % (" and the masking repair was rejected (%s)"
                   % self._repair_rejected if self._repair_rejected
                   else "", detail))
            self._policy = BucketPolicy(
                max_batch=self._policy.max_batch,
                seq_axis=self._policy.seq_axis, seq_buckets=())
            self._collect_seq_hazards()
        if "batch" in cross:
            warnings.warn(
                "ServingEngine: graph mixes positions across the BATCH "
                "axis; disabling request coalescing (max_batch=1) so "
                "requests cannot contaminate each other:\n%s" % detail)
            self._policy = BucketPolicy(
                max_batch=1, seq_axis=self._policy.seq_axis,
                seq_buckets=self._policy.seq_buckets)
        return None

    def _harvest_hazards(self, report):
        """Keep the report's retrace-linter warnings under their hazard
        fingerprints (the JAX package labels runtime retraces with the
        same keys)."""
        from ..analysis import hazard_fingerprint
        for d in report.warnings:
            if d.pass_name != "retrace":
                continue
            fp = hazard_fingerprint(d.node, d.op, d.message)
            self.hazard_fingerprints.setdefault(fp, str(d))
        if self.hazard_fingerprints:
            fps = sorted(self.hazard_fingerprints)
            label = fps[:_MAX_HAZARD_LABEL_FPS]
            if len(fps) > _MAX_HAZARD_LABEL_FPS:
                label.append("+%d" % (len(fps) - _MAX_HAZARD_LABEL_FPS))
            self._hazard_label = ",".join(label)

    def _collect_seq_hazards(self):
        """Exact-length degrade mode IS the retrace linter's
        unbucketed-dynamic-dim hazard (one program per observed length):
        re-run the linter with the seq axis declared dynamic so the
        engine's fingerprints name it."""
        from ..analysis import analyze
        shapes = {}
        for name, ex in self._data_shapes.items():
            s = [0 if ax == self._policy.seq_axis else d
                 for ax, d in enumerate(ex)]
            shapes[name] = (self._policy.max_batch,) + tuple(s)
        try:
            report, _ = analyze(self._sym, data_shapes=shapes,
                                policy=self._policy,
                                passes=("verify", "shapes", "retrace"))
        except Exception:
            return                      # advisory only: never block
        self._harvest_hazards(report)

    def _param_dtypes(self, arg_params, aux_params):
        dtypes = {n: self._dtype for n in self._data_shapes}
        if self._valid_name is not None:
            dtypes[self._valid_name] = np.dtype(np.float32)
        for src in (arg_params or {}), (aux_params or {}):
            for k, v in src.items():
                dt = getattr(v, "dtype", None)
                if dt is not None:
                    dtypes.setdefault(k, dt)
        return dtypes

    def _optimize_preflight(self, arg_params, aux_params, pre):
        """Optimize the graph the ProgramCache runs (the repaired graph
        when a repair was adopted).  The candidate is served only when
        the plan's re-analysis verdicts are no worse than the input
        graph's — padded-axis verdicts, output shapes, and output dtypes
        all intact.  Constants fold on the engine's device, so the
        optimized graph computes the unoptimized one's bits there.
        ``pre`` is the preflight's ``(report, ctx)`` over the same graph
        and spec, or None.  A rejected (or crashed) optimization leaves
        the engine serving the unoptimized graph, and says so."""
        from ..analysis import optimize_graph
        from ..analysis.core import same_dtype
        from ..analysis.rewrite import serving_pad_spec
        try:
            full, pad_axes = serving_pad_spec(self._data_shapes,
                                              self._policy)
            valid_lengths = None
            if self._valid_name is not None:
                full[self._valid_name] = (self._policy.max_batch,)
                pad_axes["batch"][self._valid_name] = 0
                valid_lengths = {self.repair_plan.label: self._valid_name}
            dtypes = self._param_dtypes(arg_params, aux_params)
            # the preflight assumed float32 throughout, so any other
            # dtype re-analyzes
            if not all(same_dtype(d, np.float32) for d in dtypes.values()):
                pre = None
            plan = optimize_graph(self._serve_sym, data_shapes=full,
                                  dtypes=dtypes, policy=self._policy,
                                  pad_axes=pad_axes, training=False,
                                  valid_lengths=valid_lengths,
                                  precomputed=pre, device=self._ctx.device)
        except Exception as e:      # optimizer crash must never block
            warnings.warn("ServingEngine: graph optimization crashed "
                          "(%r); serving the unoptimized graph" % (e,))
            return
        self.opt_plan = plan
        if plan.accepted and plan.symbol is not None and plan.rewrites:
            self._serve_sym = plan.symbol
        elif not plan.accepted:
            warnings.warn("ServingEngine: graph optimization rejected "
                          "(%s); serving the unoptimized graph"
                          % plan.reason)

    def _seq_shapes(self):
        """[(seq bucket or None, per-example shapes)] of the warm grid."""
        pol = self._policy
        if pol.seq_axis is None or not pol.seq_buckets:
            return [(None, dict(self._data_shapes))]
        out = []
        for sb in pol.seq_buckets:
            shapes = {}
            for name, ex in self._data_shapes.items():
                s = list(ex)
                s[pol.seq_axis] = sb
                shapes[name] = tuple(s)
            out.append((sb, shapes))
        return out

    def _memory_preflight(self, arg_params, aux_params, strict):
        """The OOM preflight (analysis/memory.py): price the warm program
        set — one program per seq bucket at the largest batch bucket
        (the byte cost grows with every padded extent, so the grid's
        largest batch IS the warm set's watermark) — against the device
        budget before any program runs.  Over budget warns naming the
        program and its bytes; ``MXNET_ANALYSIS_STRICT=1`` raises."""
        from ..analysis import AnalysisError
        from ..analysis.memory import (plan_memory, plan_digest,
                                       device_memory_budget, format_bytes)
        try:
            dtypes = self._param_dtypes(arg_params, aux_params)
            bb = max(self._policy.batch_buckets())
            programs = []
            for sb, shapes in self._seq_shapes():
                full = {name: (bb,) + tuple(ex)
                        for name, ex in shapes.items()}
                if self._valid_name is not None:
                    full[self._valid_name] = (bb,)
                plan, _rep = plan_memory(self._serve_sym, full,
                                         dtypes=dtypes)
                if not plan:
                    continue
                programs.append({
                    "program": ("b%d" % bb) + ("s%d" % sb
                                               if sb is not None else ""),
                    "peak_bytes": plan["peak_bytes"],
                    "param_bytes": plan["param_bytes"],
                    "transient_peak_bytes": plan["transient_peak_bytes"],
                    "inplace_savings_bytes":
                        plan["inplace_savings_bytes"]})
            if not programs:
                return
            worst = max(programs, key=lambda p: p["peak_bytes"])
            mem = {
                "enabled": True,
                "programs": programs,
                "predicted_peak_bytes": worst["peak_bytes"],
                "param_bytes": worst["param_bytes"],
                "offender": worst["program"],
                "sharded": False,
                "donation": None,
            }
            mem["digest"] = plan_digest(
                {k: mem[k] for k in ("programs", "predicted_peak_bytes",
                                     "sharded", "donation")})
            budget = device_memory_budget(self._ctx)
            mem["budget_bytes"] = budget
            mem["budget_ok"] = (None if budget is None
                                else worst["peak_bytes"] <= budget)
            self.memory_plan = mem
            if mem["budget_ok"] is False:
                msg = ("ServingEngine memory preflight: program %r "
                       "predicts peak %s (params %s + transient %s) "
                       "but the device budget is %s — the warm set "
                       "cannot fit; shrink max_batch/seq buckets or "
                       "raise MXNET_MEMORY_BUDGET_BYTES (priced before "
                       "any program runs)"
                       % (worst["program"],
                          format_bytes(worst["peak_bytes"]),
                          format_bytes(worst["param_bytes"]),
                          format_bytes(worst["transient_peak_bytes"]),
                          format_bytes(budget)))
                if strict:
                    raise AnalysisError("[memory] " + msg)
                warnings.warn(msg)
        except AnalysisError:
            raise
        except Exception as e:      # planner crash must never block
            warnings.warn("ServingEngine: memory preflight crashed "
                          "(%r); continuing without a memory plan"
                          % (e,))

    @property
    def served_sym(self):
        """The graph the ProgramCache runs (repaired and optimized when
        adopted)."""
        return self._serve_sym

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._adm.closed:
            raise EngineClosedError(
                "engine is closed; build a new ServingEngine")
        if self._worker is None:
            self._worker = threading.Thread(target=self._run,
                                            name="mxnet-serve-worker",
                                            daemon=True)
            self._worker.start()
        return self

    def close(self, drain=True):
        """Stop admitting; with ``drain`` finish queued work first.
        Closing is permanent."""
        self._adm.close(drain=drain)
        if self._worker is not None:
            self._worker.join(timeout=None if drain else 60)
            if not self._worker.is_alive():
                self._worker = None
        elif drain:
            self._run()          # never started: drain on this thread
        self._device_thread.shutdown(wait=self._worker is None)
        if self._eff is not None:
            self._eff.close()
            self._eff = None
        self._tl = None
        if self._tm is not None:
            self._tm.close()
        if self._obs_name is not None:
            _telemetry.recorder.unregister_heartbeat(self._obs_name)
            _telemetry.recorder.unregister_engine(self._obs_name)
            self._obs_name = None
        if self._alert_owner is not None:
            _telemetry.default_manager().remove_owner(self._alert_owner)
            self._alert_owner = None
        if self._owns_recorder:
            token, self._owns_recorder = self._owns_recorder, False
            _telemetry.recorder.recorder_release(token)
        if self._owns_http_server:
            # last engine out stops the HTTP endpoint
            self._owns_http_server = False
            _telemetry.server.engine_release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -------------------------------------------------------------- client
    def _group_for(self, feeds):
        """Validate one request's inputs and compute its coalescing key
        (bucket-padded per-example shapes, name-sorted), its outputs'
        unpadded shapes and its padded-element cost; memoized on the
        exact input shapes."""
        sig = tuple(sorted((k, v.shape) for k, v in feeds.items()))
        hit = self._group_cache.get(sig)
        if hit is not None:
            return hit
        if set(feeds) != set(self._data_shapes):
            raise MXNetError("inputs %s do not match engine data inputs %s"
                             % (sorted(feeds), sorted(self._data_shapes)))
        group = []
        for name in sorted(feeds):
            x = feeds[name]
            ref = self._data_shapes[name]
            if x.ndim != len(ref):
                raise MXNetError(
                    "input %r: rank %d does not match the engine's %s "
                    "(per-example shapes, no batch dim)"
                    % (name, x.ndim, ref))
            for ax, (got, want) in enumerate(zip(x.shape, ref)):
                if ax == self._policy.seq_axis:
                    continue
                if got != want:
                    raise MXNetError(
                        "input %r: shape %s does not match the engine's "
                        "%s (per-example shapes, no batch dim; only the "
                        "seq axis may vary per request)"
                        % (name, tuple(x.shape), ref))
            group.append((name, self._policy.example_shape(x.shape)))
        if self._length_sources:
            # a repaired graph needs ONE live length per request: refuse
            # the request here, not its whole batch at dispatch
            lens = {feeds[n].shape[ax]
                    for n, ax in self._length_sources.items()}
            if len(lens) > 1:
                raise MXNetError(
                    "repaired-graph request needs ONE live length, but "
                    "its inputs disagree along the repaired axis: %s"
                    % {n: feeds[n].shape[ax]
                       for n, ax in sorted(self._length_sources.items())})
        # with a seq axis, outputs are sliced back to exactly what the
        # graph infers at the UNPADDED input (never guessed from axis
        # sizes: an output axis that equals the pad length is not cut)
        out_rows = None
        if self._policy.seq_axis is not None:
            _, out_shapes, _ = self._sym.infer_shape(
                **{k: (1,) + v.shape for k, v in feeds.items()})
            out_rows = tuple(tuple(s[1:]) for s in out_shapes)
        cost = int(sum(int(np.prod(shape)) if shape else 1
                       for _name, shape in group))
        out = tuple(group), out_rows, cost
        self._group_cache[sig] = out
        return out

    def submit(self, value=None, deadline_ms=None, tenant=None, **feeds):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the per-request output array (a list for
        multi-output graphs).  Raises QueueFullError under backpressure;
        the future fails with DeadlineExceededError on expiry and with
        ServerOverloadError when shed.  ``tenant`` names the caller for
        the efficiency plane's per-tenant accounting (ignored when the
        plane is off)."""
        if value is not None:
            if len(self._data_shapes) != 1 or feeds:
                raise MXNetError("positional submit needs a single-input "
                                 "graph and no named inputs")
            feeds = {next(iter(self._data_shapes)): value}
        if self._adm.closed:
            raise EngineClosedError("serving engine is closed")
        feeds = {k: np.asarray(v, dtype=self._dtype)
                 for k, v in feeds.items()}
        group, out_rows, cost = self._group_for(feeds)
        if deadline_ms is None and self._default_deadline_s > 0:
            deadline_ms = self._default_deadline_s * 1e3
        deadline = None if not deadline_ms else \
            time.monotonic() + float(deadline_ms) / 1e3
        fut = Future()
        trace = None
        if self._tm is not None:
            self._tm.requests.inc()
            self._sig_counter(group).inc()
            if self._trace_chain is not None:
                # trace EVERY request, cheaply: a LazyTrace is one
                # timestamp; the chain decides retention at finish
                trace = _telemetry.LazyTrace(self._trace_chain)
        req = Request(feeds, group, fut, deadline=deadline,
                      out_rows=out_rows, trace=trace, cost=cost)
        if tenant is not None and self._eff is not None:
            req.tenant = self._eff.tenant_enter(tenant)
            if req.tenant is not None:
                fut.add_done_callback(
                    lambda f, _eff=self._eff, _t=req.tenant,
                    _t0=req.t_enqueue: _eff.tenant_done(_t, f, _t0))
        try:
            if profiler.is_running():
                with profiler.record_span("serve.enqueue", "serve"):
                    self._adm.admit(req)
                profiler.counter("serve.queue_depth", len(self._adm))
            else:
                self._adm.admit(req)
        except Exception as e:
            if trace is not None:     # rejected at the door: still record
                trace.abort(type(e).__name__)
            raise
        return fut

    def _sig_counter(self, group):
        """Shape-signature counter child for one coalescing key,
        memoized; past _MAX_SIG_LABELS distinct signatures traffic
        lands on the catch-all 'other' series."""
        child = self._sig_labels.get(group)
        if child is not None:
            return child
        with self._sig_lock:
            child = self._sig_labels.get(group)
            if child is not None:
                return child
            if self._tm.closed:
                # racing a close(): never re-create removed series
                return _NULL_COUNTER
            if len(self._sig_labels) >= _MAX_SIG_LABELS:
                if self._sig_other is None:
                    self._sig_other = self._tm.shape_seen.labels(
                        engine=self._tm.engine_label, sig="other")
                return self._sig_other
            sig = "|".join("%s:%s" % (name, "x".join(map(str, shape)))
                           for name, shape in group)
            child = self._tm.shape_seen.labels(
                engine=self._tm.engine_label, sig=sig)
            self._sig_labels[group] = child
            return child

    def _heartbeat(self):
        """Watchdog probe: age since the worker loop last made
        progress, and whether it has work (an idle engine blocked on an
        empty queue is healthy however stale its stamp)."""
        now = time.monotonic()
        queued = len(self._adm)
        return {"age_s": now - self._hb_t,
                "busy": bool(self._hb_busy or queued),
                "in_dispatch": bool(self._hb_busy),
                "queued": queued, "kind": "serve",
                "engine": (self._tm.engine_label
                           if self._tm is not None else None)}

    def predict(self, value=None, timeout=None, deadline_ms=None, **feeds):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(value, deadline_ms=deadline_ms,
                           **feeds).result(timeout=timeout)

    # -------------------------------------------------------------- worker
    def _bind_device(self):
        if self._ctx.device.type == "cuda":
            torch.cuda.set_device(self._ctx.device)

    def _on_device_thread(self, fn, *args):
        return self._device_thread.submit(fn, *args).result()

    def _run(self):
        while True:
            self._hb_t = time.monotonic()
            self._hb_busy = False
            reqs = self._adm.take(self._policy.max_batch, self._window_s)
            if reqs is None:
                return                     # closed and drained
            if not reqs:
                continue
            self._hb_t = time.monotonic()
            self._hb_busy = True
            t_pop = time.perf_counter()
            if self._tm is not None:
                now_mono = time.monotonic()
                for r in reqs:
                    self._tm.queue_wait.observe(
                        (now_mono - r.t_enqueue) * 1e3)
            if profiler.is_running():
                profiler.counter("serve.coalesce_ms",
                                 (time.monotonic()
                                  - reqs[0].t_enqueue) * 1e3)
            try:
                self._dispatch(reqs, t_pop)
            except Exception as e:         # fail the batch, keep serving
                self._fail_batch(reqs, e)

    @staticmethod
    def _fail_batch(reqs, e):
        for r in reqs:
            if not r.future.done():
                _fail_future(r.future, e)
                if r.trace is not None:
                    r.trace.abort(type(e).__name__)
            elif r.trace is not None:
                r.trace.finish()

    def _dispatch(self, reqs, t_pop=None):
        tm = self._tm
        t_pop = time.perf_counter() if t_pop is None else t_pop
        # claim every future: a running future can no longer be cancelled,
        # and requests the client already cancelled drop out here
        live = []
        for r in reqs:
            if r.future.set_running_or_notify_cancel():
                live.append(r)
            elif r.trace is not None:
                r.trace.abort("cancelled")
        reqs = live
        if not reqs:
            return
        n = len(reqs)
        b = self._policy.batch_bucket(n)
        t_pad0 = time.perf_counter()
        feeds = {}
        live_elems = 0
        for name, ex_shape in reqs[0].group:
            arr = np.zeros((b,) + ex_shape, dtype=self._dtype)
            for i, r in enumerate(reqs):
                x = r.inputs[name]
                arr[(i,) + tuple(slice(0, d) for d in x.shape)] = x
                live_elems += x.size
            feeds[name] = arr
        padded_elems = sum(arr.size for arr in feeds.values())
        if self._valid_name is not None:
            # a repaired graph: each request's live length drives the
            # spliced masks; pad rows carry 0 and are masked whole
            feeds[self._valid_name] = pad_valid_lengths(
                [self._live_length(r) for r in reqs], b)
        key = tuple(sorted((k, v.shape) for k, v in feeds.items()))
        c0 = self.compile_count
        t_disp0 = time.perf_counter()
        with profiler.record_span("serve.dispatch[b=%d,n=%d]" % (b, n),
                                  "serve"):
            if self._pad_check:
                outs = self._on_device_thread(self._pad_probe, feeds, reqs)
            else:
                outs = self._on_device_thread(self._cache.run, feeds, True,
                                              self._feed_dtypes)
        t_disp1 = time.perf_counter()
        compiled = self._count_compiles(c0, key)
        now = time.monotonic()
        # scatter first: unblock the waiting clients before any
        # bookkeeping, trace assembly included
        traced = []
        for i, r in enumerate(reqs):
            t_u0 = time.perf_counter() if r.trace is not None else 0.0
            res = [self._unpad(o[i], r, j) for j, o in enumerate(outs)]
            r.future.set_result(res if len(res) > 1 else res[0])
            if r.trace is not None:
                traced.append((r, t_u0, time.perf_counter()))
        for r, t_u0, t_u1 in traced:
            self._finish_trace(r, t_pop, t_pad0, t_disp0, t_disp1,
                               t_u0, t_u1, b, n, compiled)
        with self._lock:
            self._batches += 1
            self._requests_served += n
            self._occupancy_sum += n / float(b)
            self._lat_ms.extend((now - r.t_enqueue) * 1e3 for r in reqs)
        if tm is not None:
            tm.batches.inc()
            tm.r_batches.inc()
            tm.r_occupancy.observe(n / float(b))
            tm.r_dispatch.observe((t_disp1 - t_disp0) * 1e3)
            for r in reqs:
                tm.latency.observe((now - r.t_enqueue) * 1e3)
            bucket = str(b)
            tm.padded_elems.labels(bucket=bucket).inc(padded_elems)
            tm.live_elems.labels(bucket=bucket).inc(live_elems)
            if padded_elems:
                tm.pad_waste.labels(bucket=bucket).observe(
                    1.0 - live_elems / float(padded_elems))
        tl = self._tl
        if tl is not None:
            lane = "replica:0"
            tl.complete("serve.dispatch", "serve", lane, t_disp0,
                        t_disp1, args={"bucket": b, "live": n,
                                       "compiled": compiled})
            tl.counter("serve.batch_occupancy", "serve", lane,
                       n / float(b))
            tl.counter("serve.queue_depth", "serve", "serve",
                       len(self._adm))
        eff = self._eff
        if eff is not None:
            # FLOPs ledger: the bucket program was priced once as it was
            # built; this dispatch splits its price into useful (the live
            # elements' floor-share) and padding
            useful = eff.record_batch(_REPLICA, self._cache.flops_for(key),
                                      live_elems, padded_elems)
            if useful:
                for r in reqs:
                    if r.tenant is not None and live_elems:
                        r_elems = sum(x.size for x in r.inputs.values())
                        eff.tenant_useful(
                            r.tenant, useful * r_elems // live_elems)
        if profiler.is_running():
            profiler.counter("serve.batch_occupancy", n / float(b))

    def _count_compiles(self, c0, key):
        """A program built for a bucket signature already dispatched is a
        retrace (the program cache lost it); a first sight is a build,
        which exact-length seq mode does by design.  Returns the number
        of programs built during the dispatch."""
        built = self.compile_count - c0
        tm = self._tm
        with self._lock:
            if built:
                if tm is not None:
                    tm.compiles.inc(built)
                if key in self._dispatched_keys:
                    self._retraces += built
                    if tm is not None:
                        tm.r_retraces.inc(built)
            self._dispatched_keys.add(key)
        return built

    def _finish_trace(self, r, t_pop, t_pad0, t_disp0, t_disp1, t_u0,
                      t_u1, b, n, compiled):
        """Finish one request's trace: the batch's stage intervals,
        measured once per batch, are attributed to every member.  Span
        assembly is deferred behind the retention verdict, so a dropped
        trace never builds its tree."""
        def build(tc):
            tc.add("queue-wait", tc.root.t0, t_pop, "serve")
            tc.add("coalesce", t_pop, t_pad0, "serve",
                   meta={"batch": n})
            tc.add("pad", t_pad0, t_disp0, "serve", meta={"bucket": b})
            dsp = tc.add("dispatch", t_disp0, t_disp1, "serve",
                         meta={"bucket": b, "live": n,
                               "compiled": bool(compiled)})
            if compiled:
                sp = _telemetry.Span("compile", "serve", t0=t_disp0)
                sp.t1 = t_disp1
                sp.meta = {"programs": compiled}
                dsp.children.append(sp)
            tc.add("unpad", t_u0, t_u1, "serve")

        r.trace.finish(t_u1, build=build)

    def _live_length(self, req):
        """One request's live extent along the repaired axis, read off its
        unpadded inputs; inputs that disagree fail the batch (they would
        mask the wrong slots)."""
        lengths = {req.inputs[n].shape[ax]
                   for n, ax in self._length_sources.items()}
        if len(lengths) != 1:
            raise MXNetError(
                "repaired-graph dispatch needs ONE live length per "
                "request, but the padded inputs disagree along the "
                "repaired axis: %s"
                % {n: req.inputs[n].shape[ax]
                   for n, ax in sorted(self._length_sources.items())})
        return lengths.pop()

    def _pad_probe(self, feeds, reqs):
        """``MXNET_SERVE_PAD_CHECK``: dispatch twice through the
        ProgramCache's probe and require each request's live output
        region to be bitwise equal (see ``ProgramCache.run_pad_probe``).
        Runs on the device thread; builds no extra program."""
        live_masks = {}
        for name, arr in feeds.items():
            mask = np.zeros(arr.shape, dtype=bool)
            if name == self._valid_name:
                # perturbing the lengths' PAD entries scrambles only pad
                # rows' masks, which a sound repair keeps out of live rows
                mask[:len(reqs)] = True
            else:
                for i, r in enumerate(reqs):
                    x = r.inputs[name]
                    mask[(i,) + tuple(slice(0, d) for d in x.shape)] = True
            live_masks[name] = mask
        base, probed = self._cache.run_pad_probe(
            feeds, live_masks, dtypes=self._feed_dtypes)
        for j, (o0, o1) in enumerate(zip(base, probed)):
            for i, r in enumerate(reqs):
                a = self._unpad(o0[i], r, j)
                bb = self._unpad(o1[i], r, j)
                if not np.array_equal(a, bb, equal_nan=True):
                    raise MXNetError(
                        "padding contamination detected at runtime: "
                        "output %d of request %d changed when pad slots "
                        "were perturbed — the graph is cross-position "
                        "along a padded axis" % (j, i))
        return base

    @staticmethod
    def _unpad(row, req, j):
        """Slice output ``j``'s row back to the shape the graph infers at
        the request's UNPADDED input; a pad-invariant output passes
        through."""
        if req.out_rows is None:
            return row
        want = req.out_rows[j]
        if row.shape == want:
            return row
        return row[tuple(slice(0, d) for d in want)]

    # ------------------------------------------------------------- observe
    def warmup(self):
        """Run every (seq bucket x batch bucket) program once so live
        traffic finds each program (and the kernels) ready.  Returns the
        compile count."""
        c0 = self.compile_count
        for _sb, shapes in self._seq_shapes():
            for bb in self._policy.batch_buckets():
                feeds = {name: np.zeros((bb,) + ex, dtype=self._dtype)
                         for name, ex in shapes.items()}
                if self._valid_name is not None:
                    # all-pad lengths: the same program, outputs dropped
                    feeds[self._valid_name] = pad_valid_lengths([], bb)
                with profiler.record_span("serve.warmup[b=%d]" % bb,
                                          "serve"):
                    self._on_device_thread(self._cache.run, feeds, True,
                                           self._feed_dtypes)
                with self._lock:
                    self._dispatched_keys.add(tuple(sorted(
                        (k, v.shape) for k, v in feeds.items())))
                    self._warmup_batches += 1
        if self._tm is not None:
            self._tm.compiles.inc(self.compile_count - c0)
        return self.compile_count

    @property
    def compile_count(self):
        return self._cache.compile_count

    def stats(self):
        """Admission counters (queue depth, rejected, shed, expired),
        dispatch and occupancy aggregates, the program cache, the
        construction-time repair, optimizer and memory outcomes, and
        request latency percentiles (ms) over the last completions."""
        snap = self._adm.stats()
        mem = _memory_stats_block(self.memory_plan, self._ctx)
        with self._lock:
            lat = sorted(self._lat_ms)
            snap.update({
                "batches": self._batches,
                "warmup_batches": self._warmup_batches,
                "requests_served": self._requests_served,
                "batch_occupancy": (self._occupancy_sum / self._batches
                                    if self._batches else 0.0),
                "compile_count": self.compile_count,
                "retraces": self._retraces,
                "program_cache": {"hits": self._cache.plan_hits,
                                  "misses": self._cache.plan_misses},
                "bucket_keys": len(self._cache.bucket_keys),
                "max_batch": self._policy.max_batch,
                "device": str(self._ctx.device),
                "pad_verdicts": dict(self._verdicts or {}),
                "repairs": {
                    "applied": (len(self.repair_plan.actions)
                                if self.repair_plan is not None else 0),
                    "rejected": 1 if self._repair_rejected else 0,
                    "valid_length_input": self._valid_name,
                    "reason": self._repair_rejected,
                },
                "optimizer": None if self.opt_plan is None else {
                    "accepted": self.opt_plan.accepted,
                    "rewrites": len(self.opt_plan.rewrites),
                    "reason": self.opt_plan.reason,
                },
                "memory": mem,
                "efficiency": (self._eff.stats_block()
                               if self._eff is not None
                               else {"enabled": False}),
            })
        for q in (50, 90, 99):
            snap["latency_p%d_ms" % q] = (
                lat[min(len(lat) - 1, int(len(lat) * q / 100.0))]
                if lat else 0.0)
        return snap


def _memory_stats_block(memory_plan, ctx):
    """One engine's ``stats()["memory"]`` block (both engine kinds): the
    construction-time plan plus the allocator's measured peak on a CUDA
    card (None on the CPU)."""
    if not memory_plan:
        return {"enabled": False}
    from ..telemetry.devicemem import device_memory_peak
    return dict(memory_plan,
                measured_peak_bytes=device_memory_peak(ctx.device))
