"""mxnet_tpu_torch.analysis — static analysis over the Symbol IR.

Counterpart of ``mxnet_tpu/analysis``: a pass-based layer that runs
before anything executes (the TVM/Relay idea: a typed graph IR makes
framework-level checking tractable *before* codegen) over the
NNVM-style ``Symbol`` DAG.  The reference framework discovers graph
problems only at bind/dispatch time; these passes find them up front,
each finding pinned to a named node with a dataflow provenance trace.
Every pass reads graphs, shapes and dtypes only (constant folding
aside), so the verdicts, diagnostics, FLOP counts, memory plans and
rewrites are the JAX package's for the same graph.

Pass families (``DEFAULT_PASSES`` order):

- ``verify``  — IR well-formedness: cycles, dangling output edges,
  duplicate argument names, registry/arity consistency, typed attr
  schema validation (verifier.py);
- ``shapes``  — shape/dtype abstract interpretation: the infer_shape
  fixed point over meta tensors, re-run as a diagnosing pass with
  per-node provenance (shapes.py);
- ``retrace`` — retrace-hazard linter + host-sync detector: unbucketed
  dynamic dims, shape-literal attrs downstream of them, cache-busting
  attr values, ops that read device values back on the host
  (retrace.py);
- ``padding`` — padding-soundness: classifies the graph row-local vs
  cross-position along serving's zero-padded axes, tracking the
  constant each axis's pad slots are known to hold (padding.py);
- ``flops``   — analytic per-op FLOP counting over the abstract
  interpreter's per-node concrete shapes (flops.py);
- ``memory``  — static memory planner: liveness/last-use per entry,
  linear-scan peak watermark, donation/aliasing soundness gate,
  in-place opportunity report (memory.py).

Verdicts drive rewrites, not just diagnostics: ``rewrite.py`` splices
valid-length-driven SequenceMask / mean-renorm repairs, accepted only
when re-analysis flips the verdict row-local (``plan_repair`` /
``repair_serving_graph``), and ``optimize.py`` runs the verdict-gated
optimizing pipeline (algebraic identities, constant folding, CSE, DCE,
fusion hints, and the kernel ``select`` pass), each candidate accepted
ONLY when re-analysis verdicts are no worse than the input graph's.

Entry points::

    report, ctx = analysis.analyze(sym, data_shapes={"data": (8, 6)})
    report.raise_if_errors(strict=True)

    # what serving runs at engine construction:
    verdicts, report = analysis.check_serving_graph(
        sym, {"data": (6,)}, policy)

Runtime wiring: ``Predictor`` construction verifies, ``ServingEngine``
classifies its batch and seq axes (repairing a cross-position seq axis,
or degrading), optimizes the graph it serves and prices its warm
programs against the device budget, and ``DecodeEngine`` checks its
step (and draft) graph along the slot axis, selects its cache-write
kernels through the verdict gate and prices its step, draft and prefill
programs with the slot pool's donation gated — all by default
(``MXNET_ANALYSIS_ON``, ``MXNET_MEMORY_PLAN``); findings warn, or raise
with ``MXNET_ANALYSIS_STRICT=1``.

Not ported yet (ROADMAP Queue A): the sharding-plan checks
(``sharding.py``: ``ShardingCheck``, ``check_sharding_plan``,
``audit_sharding_plan``; item 7, with ``parallel/mesh.py``) and the lock
lint (``concurrency.py``: ``analyze_concurrency``; item 4, with the
``graph_lint`` CLI).  Those names are not exported.
"""
from .diagnostics import (Severity, Diagnostic, Report, AnalysisError,
                          hazard_fingerprint)
from .core import (AnalysisContext, AnalysisPass, analyze, register_pass,
                   get_pass, list_passes, DEFAULT_PASSES)
from .graph import GraphView, find_cycle, splice_input, redirect_entries
from .verifier import VerifierPass
from .shapes import ShapeDtypePass
from .retrace import RetraceHazardPass
from .padding import PaddingSoundnessPass, classify_padding, PadViolation
from .flops import FlopsPass, count_flops
from .memory import (MemoryPass, DonationCheck, plan_memory,
                     predict_peak_bytes, check_donation,
                     device_memory_budget)
from .rewrite import RepairPlan, plan_repair, repair_serving_graph
from .optimize import (OptPlan, OptAction, optimize_graph,
                       register_opt_pass, DEFAULT_OPT_PASSES,
                       SELECT_OPT_PASSES)

__all__ = [
    "Severity", "Diagnostic", "Report", "AnalysisError",
    "hazard_fingerprint",
    "AnalysisContext", "AnalysisPass", "analyze", "register_pass",
    "get_pass", "list_passes", "DEFAULT_PASSES",
    "GraphView", "find_cycle", "splice_input", "redirect_entries",
    "VerifierPass", "ShapeDtypePass", "RetraceHazardPass",
    "PaddingSoundnessPass", "classify_padding", "PadViolation",
    "FlopsPass", "count_flops",
    "MemoryPass", "DonationCheck", "plan_memory", "predict_peak_bytes",
    "check_donation", "device_memory_budget",
    "RepairPlan", "plan_repair", "repair_serving_graph",
    "OptPlan", "OptAction", "optimize_graph", "register_opt_pass",
    "DEFAULT_OPT_PASSES", "SELECT_OPT_PASSES",
    "check_serving_graph", "check_decode_step", "verify",
]


def verify(symbol):
    """Run just the IR verifier; returns the Report."""
    report, _ = analyze(symbol, passes=("verify",))
    return report


def check_serving_graph(symbol, data_shapes, policy, training=False,
                        with_ctx=False):
    """The engine-construction check: verify + shapes + padding over the
    axes serving actually zero-pads.

    ``data_shapes`` are per-EXAMPLE shapes (no batch dim), exactly what
    ``ServingEngine`` receives; graph coordinates gain the batch axis at
    0, so the padded axes are batch=0 and, when the policy seq-buckets,
    ``policy.seq_axis + 1``.  Returns ({label: verdict}, Report) with
    labels "batch" and, for a policy with seq buckets, "seq" — plus the
    AnalysisContext when
    ``with_ctx`` (the engine forwards it to the repair path so the
    pre-repair analysis is not repeated).
    """
    from .rewrite import serving_pad_spec
    full, pad_axes = serving_pad_spec(data_shapes, policy)
    # retrace runs too: its warnings (host-sync ops, cache-busting
    # attrs, ...) are the hazard fingerprints the engine labels
    # runtime retraces with — without the pass they could never fire
    report, ctx = analyze(symbol, data_shapes=full, pad_axes=pad_axes,
                          training=training, policy=policy,
                          passes=("verify", "shapes", "retrace",
                                  "padding"))
    if with_ctx:
        return dict(ctx.pad_verdicts), report, ctx
    return dict(ctx.pad_verdicts), report


def check_decode_step(step_sym, data_shapes, state_names=(),
                      valid_name=None, training=False):
    """Soundness lint for a continuous-batching decode STEP graph
    (serving/decode.py): is the step row-local along the SLOT axis?

    The decode engine runs one persistent compiled step over a fixed
    slot pool — axis 0 of every non-parameter input indexes slots, and
    dead slots ride along in every dispatch holding whatever a freed
    request left behind.  Soundness therefore demands more than the
    one-shot engine's padding check: a live slot's outputs must depend
    only on that slot's own row, with NO credit for zero pad slots —
    state inputs (``state_names``) are seeded pad-dirty, so even a
    "harmless" sum over stale garbage is a violation.

    ``data_shapes`` are FULL slot-pool shapes ((num_slots,) + per-slot
    shape) for every per-slot input: token vector, state buffers, and
    any pos/valid vectors.  ``valid_name`` optionally names the
    slot-occupancy vector (the ``__pad_valid_len__`` machinery the
    masked step may key on).  Returns (verdict, Report) where verdict
    is "row-local" / "cross-position" (or None when the graph is
    structurally broken).
    """
    pad_axes = {"slot": {n: 0 for n in data_shapes}}
    report, ctx = analyze(
        step_sym, data_shapes=data_shapes, pad_axes=pad_axes,
        training=training, pad_dirty=state_names,
        valid_lengths={"slot": valid_name} if valid_name else None,
        passes=("verify", "shapes", "padding"))
    return ctx.pad_verdicts.get("slot"), report
