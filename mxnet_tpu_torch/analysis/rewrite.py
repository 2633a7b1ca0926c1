"""Verdict-driven graph repair: masking rewrites that make bucketed
serving sound for cross-position graphs.

Counterpart of ``mxnet_tpu/analysis/rewrite.py``: the same plans and the
same repaired JSON for the same graph.  ``ServingEngine`` calls
:func:`repair_serving_graph` at construction when its graph is
cross-position along the bucketed SEQUENCE axis; a policy without seq
buckets gets only the ``"batch"`` label from :func:`serving_pad_spec`,
and the repair rejects it.

The padding pass (padding.py) CLASSIFIES — row-local vs cross-position
along serving's zero-padded axes — and until now the engine could only
react by degrading: dropping seq buckets (one compiled program per
exact length) or disabling coalescing (``max_batch=1``).  This module
closes the loop the Relay/TVM way (PAPERS.md: analysis verdicts driving
IR rewrites, not just diagnostics): it consumes the pass's structured
:class:`~.padding.PadViolation` records — each cross-position frontier
node with its dataflow provenance and an op-specific repair action —
and produces a :class:`RepairPlan` that splices neutral-element masks
immediately upstream of every frontier:

- softmax/log_softmax over a padded axis  -> mask pad slots to ``-inf``
  (each contributes ``exp(-inf) = 0`` to the partition function);
- sum/nansum/norm over no-longer-zero pads -> mask back to ``0``;
- max/argmax -> ``-inf``; min/argmin -> ``+inf``; prod/nanprod -> ``1``;
- mean -> node replacement ``sum(mask(x, 0)) / max(count, 1)`` where
  ``count`` mirrors the same reduction over a masked ones-tensor, so
  the divisor counts live slots instead of the padded extent.

Masks are ordinary :class:`SequenceMask` nodes driven by ONE new graph
input per repaired axis label (``_pad_valid_len_<label>``, stamped with
a ``__pad_valid_len__`` marker attr so re-analysis recognizes it): a
``(batch,)`` vector of each request's live length, which the serving
engine already knows from the unpadded request shapes and feeds at
dispatch.  Because the mask value is *pinned* by that designated input,
the padding pass's per-axis value domain can prove the frontier exact —
so a repair is accepted ONLY if re-running verify+shapes+padding on the
rewritten symbol flips the verdict to row-local (and leaves every other
padded axis no worse).  A rejected plan carries the reason; the engine
falls back to the degrade path exactly as before.

Layout contract: the valid-length vector is indexed by graph axis 0
(the request/batch axis).  The rewriter therefore refuses to mask axis
0 itself, and checks — via the batch label's abstract state at each
splice point — that the tensor still carries the batch axis at
position 0, undiffused.  Repairs along the batch label itself are out
of scope (masking "past the live batch count" needs a count, not
per-request lengths); cross-position batch graphs keep degrading to
``max_batch=1``.
"""
from __future__ import annotations

import collections

from ..ops import get_op
from ..symbol.symbol import SymNode, copy_graph, _topo
from .core import analyze
from .graph import redirect_entries, splice_input
from .padding import MaskAction, NEG_INF, POS_INF  # noqa: F401

__all__ = ["RepairPlan", "RepairAction", "plan_repair",
           "repair_serving_graph", "VALID_LEN_PREFIX"]

VALID_LEN_PREFIX = "_pad_valid_len_"

_ANALYSIS_PASSES = ("verify", "shapes", "padding")

#: one applied rewrite, as reported on RepairPlan.actions: ``kind`` is
#: "mask" (value spliced along axes of input ``slot``) or "mean"
#: (node rewritten to the sum/count form; ``value`` is None)
RepairAction = collections.namedtuple(
    "RepairAction", ["node", "op", "kind", "value", "axes", "slot"])


def _fmt_val(v):
    if v == NEG_INF:
        return "-inf"
    if v == POS_INF:
        return "+inf"
    return "%g" % v


class RepairPlan(object):
    """Outcome of one repair attempt for one padded-axis label.

    ``accepted`` is True only when the rewritten symbol re-verified:
    the label's verdict flipped to row-local, no analysis errors, and
    no other padded axis got worse.  ``symbol`` is the rewritten graph
    (None when rejected), ``valid_length_name`` the new input the
    caller must feed (per-request live lengths, pad rows 0), and
    ``length_sources`` maps each padded data input to the graph axis
    its live extent is measured along.
    """

    def __init__(self, label):
        self.label = label
        self.accepted = False
        self.reason = None              # why rejected (None if accepted)
        self.symbol = None              # rewritten Symbol when accepted
        self.actions = []               # [(node, op, kind, value, axes, slot)]
        self.valid_length_name = None
        self.length_sources = {}        # input name -> graph axis
        self.verdict_before = None
        self.verdict_after = None
        self.report_before = None
        self.report_after = None

    def _reject(self, reason):
        self.accepted = False
        self.reason = reason
        self.symbol = None
        return self

    def describe(self):
        """Human-readable repair report."""
        head = "repair plan for %r axis: %s" % (
            self.label,
            "ACCEPTED (verdict %s -> %s)" % (self.verdict_before,
                                             self.verdict_after)
            if self.accepted else
            "REJECTED (%s)" % (self.reason or "unknown"))
        lines = [head]
        if self.valid_length_name:
            lines.append("  valid-length input: %r — per-request live "
                         "lengths, shape (batch,), pad rows 0"
                         % self.valid_length_name)
        for a in self.actions:
            plural = "es" if len(a.axes) > 1 else ""
            axes = ",".join(map(str, a.axes))
            if a.kind == "mask":
                lines.append("  - %s (%s): mask input %d along axis%s "
                             "%s with %s" % (a.node, a.op, a.slot,
                                             plural, axes,
                                             _fmt_val(a.value)))
            else:
                lines.append("  - %s (%s): rewrite mean into "
                             "sum(mask(x, 0)) / max(live count, 1) "
                             "over axis%s %s" % (a.node, a.op, plural,
                                                 axes))
        return "\n".join(lines)

    def __repr__(self):
        return "<RepairPlan %s %s>" % (
            self.label, "accepted" if self.accepted else
            "rejected: %s" % self.reason)


def _unique_name(taken, base):
    if base not in taken:
        taken.add(base)
        return base
    i = 0
    while "%s%d" % (base, i) in taken:
        i += 1
    name = "%s%d" % (base, i)
    taken.add(name)
    return name


def _mask_chain(entry, axes, value, vl_entry, taken, stem):
    """Chain one SequenceMask per padded axis onto ``entry``; returns
    the masked entry.  Masking several axes with the same per-request
    lengths is exactly what chained masks compute (each writes every
    past-length slot along its axis, intersections included)."""
    opdef = get_op("SequenceMask")
    for ax in sorted(axes):
        attrs = opdef.normalize({"use_sequence_length": True,
                                 "value": float(value), "axis": int(ax)})
        node = SymNode(opdef, _unique_name(taken, "%s_padfix_mask" % stem),
                       attrs, [tuple(entry), tuple(vl_entry)])
        entry = (node, 0)
    return entry


def _mean_rewrite(symbol, clone, axes, slot, vl_entry, taken):
    """Replace a mean node with sum(mask(x,0)) / max(count, 1) where
    count mirrors the same reduction over a masked ones-tensor.  The
    whole subgraph is rank-only (no literal extents), so one rewritten
    symbol still serves every bucket shape.

    The count deliberately rides the MODEL dtype (ones_like of the
    data): the symbol is dtype-polymorphic, so a float32 count would
    promote the quotient away from the model dtype."""
    entry = clone.inputs[slot]
    masked = _mask_chain(entry, axes, 0.0, vl_entry, taken, clone.name)
    sum_op = get_op("sum")
    rattrs = sum_op.normalize(
        {k: clone.attrs[k] for k in ("axis", "keepdims", "exclude")
         if k in clone.attrs})
    num = SymNode(sum_op, _unique_name(taken, "%s_padfix_sum" % clone.name),
                  dict(rattrs), [masked])
    ones_op = get_op("ones_like")
    ones = SymNode(ones_op,
                   _unique_name(taken, "%s_padfix_ones" % clone.name),
                   ones_op.normalize({}), [tuple(entry)])
    cmask = _mask_chain((ones, 0), axes, 0.0, vl_entry, taken, clone.name)
    cnt = SymNode(sum_op,
                  _unique_name(taken, "%s_padfix_count" % clone.name),
                  dict(rattrs), [cmask])
    clamp_op = get_op("_maximum_scalar")
    clamp = SymNode(clamp_op,
                    _unique_name(taken, "%s_padfix_countc" % clone.name),
                    clamp_op.normalize({"scalar": 1.0}), [(cnt, 0)])
    # sum * (1/count), NOT sum / count: the JAX package's mean lowers
    # its constant divisor to a reciprocal multiply, and the repaired
    # graph is the same graph in both packages
    recip_op = get_op("_rdiv_scalar")
    recip = SymNode(recip_op,
                    _unique_name(taken, "%s_padfix_recip" % clone.name),
                    recip_op.normalize({"scalar": 1.0}), [(clamp, 0)])
    mul_op = get_op("elemwise_mul")
    div = SymNode(mul_op,
                  _unique_name(taken, "%s_padfix_renorm" % clone.name),
                  mul_op.normalize({}), [(num, 0), (recip, 0)])
    redirect_entries(symbol, {(id(clone), 0): (div, 0)})


def plan_repair(symbol, data_shapes, pad_axes, label="seq", policy=None,
                training=False, valid_lengths=None, batch_label="batch",
                precomputed=None):
    """Attempt a masking repair of ``label``'s cross-position verdicts.

    ``data_shapes`` are FULL graph-coordinate shapes (batch axis
    included), ``pad_axes`` the ``{label: {input: axis}}`` spec the
    padding pass consumes — exactly what ``classify_padding`` takes.
    ``precomputed`` may carry an ``(report, ctx)`` pair from an
    ``analyze`` run over the SAME symbol/shapes/spec (the engine and
    the lint CLI both just ran one) so the pre-repair analysis is not
    repeated.  Never raises for an unrepairable graph: the returned
    plan carries ``accepted=False`` and the reason.
    """
    plan = RepairPlan(label)
    # structural rejections first: they need no analysis at all
    if label not in (pad_axes or {}):
        return plan._reject("label %r not in the padded-axis spec" % label)
    if batch_label not in (pad_axes or {}) or batch_label == label:
        return plan._reject(
            "repairs along the %r axis need the %r label in the spec to "
            "establish the request-axis layout; masking along the "
            "request axis itself is unsupported (lengths are indexed "
            "by it) — the engine degrades to max_batch=1 instead"
            % (label, batch_label))
    if precomputed is not None:
        report0, ctx0 = precomputed
    else:
        report0, ctx0 = analyze(symbol, data_shapes=data_shapes,
                                pad_axes=pad_axes, policy=policy,
                                training=training,
                                valid_lengths=valid_lengths,
                                passes=_ANALYSIS_PASSES)
    plan.report_before = report0
    plan.verdict_before = ctx0.pad_verdicts.get(label)
    if report0.errors:
        return plan._reject("graph does not verify (%d error(s)) — fix "
                            "those before repairing" % len(report0.errors))
    if plan.verdict_before != "cross-position":
        return plan._reject("nothing to repair: %r verdict is %s"
                            % (label, plan.verdict_before))
    viols = ctx0.pad_violations.get(label, [])
    bad = [v for v in viols if not v.repairable]
    if bad:
        return plan._reject(
            "no masking rewrite for %s (%s): %s"
            % (bad[0].node, bad[0].op, bad[0].message.split("\n")[0]))
    if not viols:
        return plan._reject("cross-position verdict without violation "
                            "records — please report")

    topo = _topo(symbol._outputs)
    by_name = {}
    for n in topo:
        if n.name in by_name:
            return plan._reject("duplicate node name %r: cannot address "
                                "frontier nodes reliably" % n.name)
        by_name[n.name] = n
    batch_states = ctx0.pad_states.get(batch_label, {})

    # -- pre-validate every action against the layout contract ----------
    for v in viols:
        orig = by_name.get(v.node)
        if orig is None:
            return plan._reject("frontier node %r vanished from the "
                                "graph" % v.node)
        for act in v.actions:
            axes, slot = act.axes, act.slot
            if slot >= len(orig.inputs):
                return plan._reject("frontier %s has no input slot %d"
                                    % (v.node, slot))
            src, six = orig.inputs[slot]
            key = (id(src), six)
            shape = ctx0.shapes.get(key)
            if shape is None:
                return plan._reject(
                    "no inferred shape at the splice point upstream of "
                    "%s — provide full input shapes" % v.node)
            if any(ax == 0 or ax >= len(shape) for ax in axes):
                return plan._reject(
                    "cannot mask axis %s of %s-rank tensor feeding %s: "
                    "axis 0 is the request axis the lengths vector "
                    "indexes" % (sorted(axes), len(shape), v.node))
            st = batch_states.get(key)
            # require EXACTLY {0}: a tensor that dropped the batch pad
            # altogether (e.g. a broadcast of one request's row) is no
            # longer request-indexed either, and per-request lengths
            # would mask the wrong positions
            if st is None or st.diffuse or st.axes != frozenset({0}):
                return plan._reject(
                    "tensor feeding %s does not carry the request axis "
                    "cleanly at position 0 (batch state %s): the "
                    "per-request lengths vector cannot index it"
                    % (v.node, st))

    # -- rebuild: clone, splice masks, rewrite means --------------------
    new_sym, node_map = copy_graph(symbol)
    taken = set(by_name)
    # reuse a designated lengths input when one exists: passed in, or
    # discovered by the padding pass from a __pad_valid_len__ marker
    # (ctx.valid_lengths is written back during classification)
    valid_name = (valid_lengths or {}).get(label) \
        or ctx0.valid_lengths.get(label)
    vl_is_new = valid_name is None or valid_name not in by_name
    if valid_name is None:
        valid_name = _unique_name(taken, VALID_LEN_PREFIX + label)
    if vl_is_new:
        vl_node = SymNode(None, valid_name,
                          {"__pad_valid_len__": label,
                           "__dtype__": "float32"}, [])
    else:
        vl_node = node_map[id(by_name[valid_name])]
    vl_entry = (vl_node, 0)
    plan.valid_length_name = valid_name
    plan.length_sources = dict(pad_axes[label])

    for v in viols:
        clone = node_map[id(by_name[v.node])]
        for act in v.actions:
            if isinstance(act, MaskAction):
                splice_input(clone, act.slot,
                             _mask_chain(clone.inputs[act.slot],
                                         act.axes, act.value, vl_entry,
                                         taken, clone.name))
                plan.actions.append(RepairAction(
                    v.node, v.op, "mask", act.value,
                    tuple(sorted(act.axes)), act.slot))
            else:
                _mean_rewrite(new_sym, clone, act.axes, act.slot,
                              vl_entry, taken)
                plan.actions.append(RepairAction(
                    v.node, v.op, "mean", None,
                    tuple(sorted(act.axes)), act.slot))

    # -- re-verify: the repair must FLIP the verdict --------------------
    batch_extent = None
    for name, ax in pad_axes[batch_label].items():
        shp = (data_shapes or {}).get(name)
        if shp and ax < len(shp):
            batch_extent = shp[ax]
            break
    if batch_extent is None:
        return plan._reject("cannot size the valid-length input: no "
                            "shaped input under the %r label"
                            % batch_label)
    shapes2 = dict(data_shapes or {})
    shapes2[valid_name] = (batch_extent,)
    pad_axes2 = {lb: dict(m) for lb, m in pad_axes.items()}
    # the lengths vector is itself padded along the request axis (pad
    # rows carry length 0): declare it so the batch-label verdict stays
    # honest about graphs that consume it
    pad_axes2[batch_label][valid_name] = 0
    vl2 = dict(valid_lengths or {})
    vl2[label] = valid_name
    report1, ctx1 = analyze(new_sym, data_shapes=shapes2,
                            pad_axes=pad_axes2, policy=policy,
                            training=training, valid_lengths=vl2,
                            passes=_ANALYSIS_PASSES)
    plan.report_after = report1
    plan.verdict_after = ctx1.pad_verdicts.get(label)
    if report1.errors:
        return plan._reject("rewritten graph fails verification:\n%s"
                            % report1.format())
    if plan.verdict_after != "row-local":
        return plan._reject(
            "rewritten graph still %s along %r — masking could not "
            "neutralize every frontier:\n%s"
            % (plan.verdict_after, label,
               "\n".join("  " + str(d) for d in report1.warnings)))
    for other, before in ctx0.pad_verdicts.items():
        if other == label:
            continue
        after = ctx1.pad_verdicts.get(other)
        if before == "row-local" and after != "row-local":
            return plan._reject(
                "repair would make the %r axis verdict worse "
                "(%s -> %s)" % (other, before, after))
    plan.accepted = True
    plan.reason = None
    plan.symbol = new_sym
    return plan


def serving_pad_spec(data_shapes, policy):
    """``check_serving_graph``'s coordinate plumbing, shared with the
    repair path: per-EXAMPLE shapes -> (full graph-coordinate shapes,
    padded-axis spec).  A policy without a sequence axis (the port's
    ``BucketPolicy``) gives only the ``"batch"`` label."""
    seq_axis = getattr(policy, "seq_axis", None)
    seq_buckets = getattr(policy, "seq_buckets", None)
    full = {}
    for name, ex in data_shapes.items():
        try:
            ex = policy.example_shape(tuple(ex))
        except Exception:
            ex = tuple(ex)      # no seq grid, or off-grid: analyze as-is
        full[name] = (policy.max_batch,) + ex
    pad_axes = {"batch": {name: 0 for name in data_shapes}}
    if seq_axis is not None and seq_buckets:
        pad_axes["seq"] = {name: seq_axis + 1 for name in data_shapes}
    return full, pad_axes


def repair_serving_graph(symbol, data_shapes, policy, training=False,
                         label="seq", precomputed=None):
    """:func:`serving_pad_spec` plumbing + :func:`plan_repair`.

    ``data_shapes`` are per-EXAMPLE shapes (no batch dim) exactly as
    ``ServingEngine`` receives them; the padded axes are batch=0 and
    ``policy.seq_axis + 1``.  ``precomputed`` forwards the engine's
    already-run ``check_serving_graph(..., with_ctx=True)`` result so
    construction does not re-analyze the original graph.  Returns a
    :class:`RepairPlan`.
    """
    if label == "seq" and (getattr(policy, "seq_axis", None) is None
                           or not getattr(policy, "seq_buckets", None)):
        return RepairPlan(label)._reject(
            "policy has no seq buckets: nothing to repair")
    full, pad_axes = serving_pad_spec(data_shapes, policy)
    plan = plan_repair(symbol, full, pad_axes, label=label, policy=policy,
                       training=training, precomputed=precomputed)
    if plan.accepted:
        # engine-coordinate length sources: per-example axis
        plan.length_sources = {n: ax - 1
                               for n, ax in plan.length_sources.items()}
    return plan
