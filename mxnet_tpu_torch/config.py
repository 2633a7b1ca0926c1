"""Runtime configuration: the MXNET_* environment variables this package reads.

Counterpart of ``mxnet_tpu/config.py``, keeping only the variables the
ResNet-50 serving and training paths, the image pipeline, the serving
and decode engines and the analysis gates read, under the same names and
defaults.
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
]}


def get(name):
    """Typed read of a registered MXNET_* variable."""
    if name not in VARIABLES:
        raise KeyError("unknown config variable %r (known: %s)"
                       % (name, sorted(VARIABLES)))
    return VARIABLES[name].read()
