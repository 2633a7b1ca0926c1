"""Runtime configuration: the MXNET_* environment variables this package reads.

Counterpart of ``mxnet_tpu/config.py``, keeping only the variables the
ResNet-50 serving and training paths, the image pipeline, the serving
and decode engines, the analysis gates, the telemetry plane and the
profiler read, under the same names, defaults and help text.
"""
from __future__ import annotations

import os

__all__ = ["get", "VARIABLES"]


class _Var(object):
    __slots__ = ("name", "vtype", "default", "doc")

    def __init__(self, name, vtype, default, doc):
        self.name = name
        self.vtype = vtype
        self.default = default
        self.doc = doc

    def read(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        if self.vtype is bool:
            return raw.strip().lower() not in ("", "0", "false", "no")
        return self.vtype(raw)


VARIABLES = {v.name: v for v in [
    _Var("MXNET_CPU_WORKER_NTHREADS", int, 4,
         "Default worker count of host-side pipelines (ImageRecordIter's "
         "preprocess_threads)."),
    _Var("MXNET_MP_START_METHOD", str, "spawn",
         "multiprocessing start method of ImageRecordIter's worker "
         "processes (use_processes=True): spawn, forkserver or fork.  "
         "fork is unsafe in a process that runs threads or holds a CUDA "
         "context."),
    _Var("MXNET_FUSED_UNIT_MIN_FILTER", int, 0,
         "Minimum num_filter for unit_impl='fused' residual units to run "
         "as one fused op (models/resnet.py); narrower units keep the "
         "plain graph.  0 = fuse every eligible unit."),
    _Var("MXNET_FUSED_UNIT_C3", str, "auto",
         "Middle-conv path inside fused units (ops/fused_unit.py): "
         "'auto' and '2d' run the hand-written row-layout 3x3 kernels "
         "(K3, K6) at every width; '4d' runs the hand-written 4D-tile 3x3 "
         "kernels (K4, K7) at every width; 'xla' runs the middle conv as a "
         "plain torch convolution segment instead (the name is kept from "
         "the reference package)."),
    _Var("MXNET_CONV1X1_FUSED_BWD", bool, False,
         "Compute a channels-last stride-1 1x1 convolution's dgrad and "
         "wgrad in one hand-written CUDA kernel (ops/nn.py conv1x1_bwd) "
         "where its H*W <= 256; the forward stays torch's convolution.  "
         "Off by default, as in the reference package."),
    _Var("MXNET_SERVE_MAX_BATCH", int, 8,
         "Largest batch bucket the serving engine coalesces to, rounded "
         "up to a power of two; pending requests pad up to the smallest "
         "bucket that fits."),
    _Var("MXNET_SERVE_MAX_QUEUE", int, 256,
         "Bound on the serving admission queue.  A full queue either "
         "rejects new work (QueueFullError backpressure) or sheds the "
         "oldest pending request, per MXNET_SERVE_OVERLOAD_POLICY."),
    _Var("MXNET_SERVE_OVERLOAD_POLICY", str, "reject",
         "What the serving engine does when the admission queue is "
         "full: 'reject' raises QueueFullError to the submitting "
         "client (backpressure); 'shed-oldest' evicts the longest-"
         "queued request (its future fails with ServerOverloadError) "
         "to admit the new one — graceful degradation under overload."),
    _Var("MXNET_SERVE_SEQ_BUCKETS", str, "",
         "Comma-separated sequence-length buckets (e.g. '32,64,128') "
         "for the serving engine.  When set, per-example axis 0 is "
         "padded up to the next bucket so length-polymorphic traffic "
         "shares programs; outputs are un-padded on the same axis "
         "(model must be row-independent along it).  Empty = off: "
         "every distinct example shape is its own bucket."),
    _Var("MXNET_SERVE_BATCH_TIMEOUT_MS", float, 2.0,
         "Dynamic-batching window: a partial batch waits at most this "
         "long (from its oldest request's enqueue) for company."),
    _Var("MXNET_DECODE_SLOTS", int, 8,
         "Slot-pool capacity of the continuous-batching decode engine "
         "(serving/decode.py DecodeEngine): the step program runs at this "
         "batch extent, per-slot state (KV caches) lives on the device at "
         "this leading dim, and requests join and leave between steps."),
    _Var("MXNET_DECODE_MAX_LEN", int, 128,
         "Per-slot sequence capacity of the decode engine: the fixed "
         "cache layout allocates this many positions per slot up front; "
         "prompt length + generated tokens may not exceed it (requests "
         "finish with reason 'length' at the cap)."),
    _Var("MXNET_DECODE_SPEC_K", int, 0,
         "Speculative draft-k-verify decoding (serving/decode.py + "
         "serving/spec.py): with k > 0 and a draft model (DecodeEngine "
         "draft_sym=), each step drafts k tokens, scores all k+1 "
         "positions with the target model and commits the accepted "
         "prefix (exact greedy prefix match: the same tokens as "
         "greedy_decode).  Accepted cache rows commit through the "
         "_cache_write_rows kernel when the selection adopts it.  0 = "
         "the single-token engine.  DecodeEngine(spec_k=) overrides."),
    _Var("MXNET_DECODE_COALESCE_PREFILL", bool, True,
         "Coalesce concurrent decode joiners through the bucketed "
         "prefill path (serving/decode.py): requests joining in the "
         "same scheduler iteration whose prompts pad to the same pow2 "
         "seq bucket prefill in ONE dispatch (batch padded onto pow2 "
         "batch buckets, output state rows scattered into each "
         "request's slot) instead of one batch-1 dispatch each.  0 = "
         "the serial per-joiner prefill."),
    _Var("MXNET_SERVE_OPTIMIZE", bool, True,
         "Run the verdict-gated optimizing pass pipeline "
         "(analysis/optimize.py: algebraic identities, constant "
         "folding, CSE, dead-node elimination) over the graph the "
         "serving ProgramCache runs, and the kernel-selection pipeline "
         "over the decode engine's step, draft and commit graphs.  A "
         "candidate is adopted ONLY when re-analysis verdicts — output "
         "shapes/dtypes and padded-axis soundness — are no worse than "
         "the input graph's.  Requires MXNET_ANALYSIS_ON (the "
         "acceptance protocol IS analysis); 0 = serve the graph exactly "
         "as handed in."),
    _Var("MXNET_OPT_SELECT_KERNELS", bool, True,
         "The optimizer's fused-op selection (analysis/optimize.py "
         "'select' pass): swap the one-hot-blend KV-cache writes "
         "(O(max_len*d) per token) for the _cache_write_row / "
         "_cache_write_rows kernels (O(d)) behind the same verdict gate "
         "as every other rewrite (re-analysis no worse, slot-axis "
         "row-locality preserved under pad-dirty seeding; a rejected "
         "plan serves the unmodified graph).  Requires "
         "MXNET_SERVE_OPTIMIZE and MXNET_ANALYSIS_ON.  0 = serve the "
         "blends."),
    _Var("MXNET_ANALYSIS_ON", bool, True,
         "Run the static-analysis passes (mxnet_tpu_torch.analysis) at "
         "Predictor/ServingEngine construction: the IR verifier always, "
         "plus the padding-soundness classifier for the engine's padded "
         "axes.  Findings warn by default; see MXNET_ANALYSIS_STRICT."),
    _Var("MXNET_ANALYSIS_STRICT", bool, False,
         "Escalate construction-time analysis findings from warnings to "
         "MXNetError: malformed graphs refuse to build, and a serving "
         "graph classified cross-position along a padded axis refuses "
         "the unsound bucketing instead of degrading it."),
    _Var("MXNET_MEMORY_PLAN", bool, True,
         "Run the static memory planner (analysis/memory.py) at "
         "ServingEngine/DecodeEngine construction: liveness-based "
         "peak-memory prediction over the full warm program set, the "
         "donation/aliasing soundness gate over the decode slot pool, "
         "and the OOM preflight against the device budget — all "
         "BEFORE any program is built.  Requires MXNET_ANALYSIS_ON.  "
         "Findings warn by default (MXNET_ANALYSIS_STRICT=1 raises); "
         "the planner only diagnoses, so served outputs are "
         "bitwise-identical with it on or off."),
    _Var("MXNET_MEMORY_BUDGET_BYTES", int, 0,
         "Per-device memory budget in bytes for the memory planner's "
         "OOM preflight.  0 = the CUDA card's total memory "
         "(torch.cuda.mem_get_info); the CPU has none, so prediction "
         "still runs and capacity refusal is skipped.  Set explicitly "
         "to preflight against a target card from any host."),
    _Var("MXNET_SERVE_REPAIR", bool, True,
         "Attempt an automatic masking repair (analysis/rewrite.py) "
         "before degrading a serving graph the padding pass classifies "
         "cross-position along the bucketed seq axis: SequenceMask "
         "nodes driven by a per-request valid-length input neutralize "
         "pad slots (-inf for softmax, 0 for sums, renormalized count "
         "for mean), and the repair is adopted only when re-analysis "
         "verdicts the rewritten graph row-local.  0 = always degrade "
         "(exact-length programs / max_batch=1)."),
    _Var("MXNET_SERVE_PAD_CHECK", bool, False,
         "Runtime padding-soundness probe (debug; doubles dispatch "
         "cost): every serving batch is dispatched twice — zero pads "
         "and sentinel-filled pads — and live output rows must match "
         "bitwise, catching cross-position contamination the static "
         "pass could not prove (serving/buckets.py run_pad_probe)."),
    _Var("MXNET_SERVE_DEFAULT_DEADLINE_MS", float, 0.0,
         "Default per-request deadline; requests still queued past it "
         "fail with DeadlineExceededError.  0 = no default deadline."),
    _Var("MXNET_PROFILER_AUTOSTART", bool, False,
         "Start the profiler at import and dump on exit "
         "(src/engine/profiler.cc:66)."),
    _Var("MXNET_TELEMETRY_ON", bool, True,
         "Master switch for the runtime telemetry registry "
         "(mxnet_tpu.telemetry): metrics counters/gauges/histograms and "
         "request-scoped tracing across serving, executor, kvstore, and "
         "the input pipeline.  Off = instrumented call sites hold no "
         "instruments and make zero registry calls per request."),
    _Var("MXNET_TELEMETRY_TIMELINE", bool, True,
         "Unified fleet timeline (telemetry/timeline.py): a process-"
         "wide bounded ring of dual-stamped (wall + monotonic) events "
         "fed by every plane — span trees, per-replica dispatches, "
         "decode scheduler iterations and slot churn, lock holds, "
         "alert transitions, flight dumps, regulator limit moves, "
         "supervisor rehab/retire, injected faults.  Exported as "
         "Chrome trace_event JSON (GET /timeline?format=chrome, "
         "tools/telemetry_dump.py timeline, tools/request_autopsy.py)."
         "  Requires MXNET_TELEMETRY_ON; 0 = zero ring appends and "
         "bitwise-identical serving."),
    _Var("MXNET_TELEMETRY_TIMELINE_CAP", int, 16384,
         "Capacity of the timeline event ring (events, process-wide). "
         "Oldest events drop first; the drop count is reported in "
         "every export so a truncated window is never mistaken for a "
         "quiet one."),
    _Var("MXNET_TELEMETRY_SNAPSHOT_SECS", float, 0.0,
         "Interval for the periodic telemetry snapshot thread (0 = "
         "off).  Every interval the current metrics snapshot is "
         "written to MXNET_TELEMETRY_SNAPSHOT_PATH (atomic replace) or "
         "stdout, in MXNET_TELEMETRY_SNAPSHOT_FORMAT."),
    _Var("MXNET_TELEMETRY_SNAPSHOT_PATH", str, "",
         "Destination file for periodic telemetry snapshots; empty "
         "writes to stdout."),
    _Var("MXNET_TELEMETRY_SNAPSHOT_FORMAT", str, "prom",
         "Snapshot format: 'prom' (Prometheus text exposition) or "
         "'json' (metrics + finished traces, the document "
         "tools/telemetry_dump.py renders)."),
    _Var("MXNET_TELEMETRY_TRACE_SAMPLE", int, 64,
         "Baseline-floor period of the serving trace-retention chain "
         "(telemetry/sampling.py): every request is traced cheaply and "
         "retention is decided at finish — every Nth request is kept "
         "unconditionally, on top of the tail-biased and error-keep "
         "samplers.  1 keeps every request; 0 disables tracing "
         "entirely (no per-request TraceContext, no tail/error keeps)."),
    _Var("MXNET_TELEMETRY_TRACE_TAIL_K", int, 8,
         "Tail-biased trace retention: a finished request trace is "
         "retroactively kept when its end-to-end latency lands in the "
         "current top-K slowest or exceeds a moving p99 estimate, so "
         "every tail request has a span tree (the traffic p99 "
         "debugging actually needs).  0 disables the tail sampler, "
         "leaving only the periodic floor and error keep."),
    _Var("MXNET_TELEMETRY_TRACE_ERRORS", bool, True,
         "Keep the span tree of every request that failed (rejected, "
         "shed, expired, cancelled, dispatch error) regardless of the "
         "periodic/tail samplers — overloaded traffic is exactly what "
         "an operator debugs."),
    _Var("MXNET_TELEMETRY_PORT", int, -1,
         "Port for the live telemetry HTTP endpoint "
         "(telemetry/server.py: GET /metrics, /metrics.json, /traces, "
         "/traces/<id>, /healthz).  -1 = off; 0 = bind an ephemeral "
         "port (telemetry.server_address() reads it back).  Started "
         "at import when set, or lazily by ServingEngine construction "
         "— in which case the last engine's close() shuts it down "
         "(port and acceptor thread are released, never leaked)."),
    _Var("MXNET_TELEMETRY_HISTORY_SECS", float, 1.0,
         "Sampling interval of the in-process time-series recorder "
         "(telemetry/recorder.py): every interval the metrics registry "
         "is snapshotted into a bounded in-memory ring, giving true "
         "rate()/delta()/windowed-quantile queries (GET /history) and "
         "the SLO alert evaluation tick with zero external infra.  "
         "Started lazily by the first ServingEngine/DecodeEngine (last "
         "close() stops it) or explicitly via "
         "telemetry.start_recorder().  0 = off."),
    _Var("MXNET_TELEMETRY_HISTORY_WINDOW", int, 600,
         "Ring capacity of the history recorder in samples (memory is "
         "bounded by construction: deque(maxlen=N)).  At the default "
         "1 s interval, 600 samples = a 10-minute trailing window — "
         "enough for the 60 s/600 s multiwindow burn-rate rules."),
    _Var("MXNET_TELEMETRY_ALERTS", bool, True,
         "Evaluate SLO alert rules (telemetry/alerts.py) against the "
         "history ring on every recorder sample.  Engines register "
         "default rules at construction (queue-saturation and "
         "deadline-miss burn rates, per-engine zero-progress watchdog "
         "and retrace-storm) and remove them at close(); rule states "
         "serve at GET /alerts, transitions stream over GET /events.  "
         "0 = rules are neither registered nor evaluated."),
    _Var("MXNET_TELEMETRY_ALERT_RULES", str, "",
         "Path to a declarative SLO alert-rules file: a JSON list (or "
         "{'rules': [...]} document) of AlertRule.from_dict dicts "
         "loaded into the default AlertManager when the history "
         "recorder starts (telemetry/alerts.py load_rules_file) — "
         "operators add burn-rate/threshold/absence/watchdog rules "
         "without redeploying.  Rules whose names are already "
         "registered are skipped (idempotent across engine-driven "
         "recorder rebuilds); a malformed file warns and loads "
         "nothing.  Empty = off."),
    _Var("MXNET_TELEMETRY_WATCHDOG_SECS", float, 30.0,
         "Zero-progress threshold for the engines' default watchdog "
         "alert rules: a worker heartbeat that is BUSY (work queued or "
         "a dispatch in flight) yet stamped no progress for this many "
         "seconds fires <kind>_engine<N>_stalled — a wedged dispatch "
         "or starved queue, named, not inferred."),
    _Var("MXNET_SERVE_EFFICIENCY", bool, True,
         "Serving efficiency plane (telemetry/goodput.py): per-"
         "compiled-program FLOPs ledger priced once at compile/AOT-"
         "load time (analysis/flops.py over the concrete padded "
         "shapes), per-dispatch counters decomposed into useful / "
         "padding / dead-slot / spec-rejected classes that sum "
         "exactly to total, live mxnet_serve_mfu and goodput_ratio "
         "gauges, and per-tenant accounting.  Requires "
         "MXNET_TELEMETRY_ON; 0 = no pricing, no ledger series, zero "
         "instrument calls on the dispatch path, serving "
         "bitwise-identical to the plane never existing."),
    _Var("MXNET_TELEMETRY_TENANTS_MAX", int, 32,
         "Bounded-cardinality guard on the per-tenant accounting "
         "series (telemetry/goodput.py): the first N distinct tenant "
         "ids an engine sees get their own {tenant=...} label; "
         "later tenants aggregate into tenant=\"other\" and each "
         "overflowed request increments "
         "mxnet_serve_tenant_overflow_total so the collapse is "
         "visible, not silent."),
    _Var("MXNET_FLIGHT_RECORDER_DIR", str, "",
         "Black-box post-mortem directory.  When set, any alert "
         "transition to firing (watchdog trips included) atomically "
         "dumps a flight bundle — trailing history window, rule "
         "states, retained traces, per-engine stats(), heartbeats, "
         "all-thread stacks via faulthandler — as flight_*.json under "
         "this directory (rate-limited, pruned to the newest 16), and "
         "fatal signals (SIGSEGV/SIGFPE/SIGABRT) append stacks to "
         "fatal_stacks.log via faulthandler.enable.  Read bundles "
         "back with tools/telemetry_dump.py bundle.  Empty = off."),
    _Var("MXNET_TELEMETRY_TRACE_CAPACITY", int, 256,
         "Bound on the in-process finished-trace store; beyond it the "
         "oldest span trees are evicted (long serving runs must not "
         "grow host memory without limit)."),
    _Var("MXNET_PROFILER_MAX_EVENTS", int, 1000000,
         "Bound on the in-memory profiler event buffer.  Beyond it the "
         "oldest events are dropped (and counted in the dump's "
         "otherData.dropped_events) so always-on profiling of long "
         "serving runs cannot grow host memory without limit."),
]}


def get(name):
    """Typed read of a registered MXNET_* variable."""
    if name not in VARIABLES:
        raise KeyError("unknown config variable %r (known: %s)"
                       % (name, sorted(VARIABLES)))
    return VARIABLES[name].read()
