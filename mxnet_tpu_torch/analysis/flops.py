"""Analytic per-op FLOP counting over the abstract interpreter's shapes.

Counterpart of ``mxnet_tpu/analysis/flops.py``, with the same rules: the
count is plain arithmetic on the per-node concrete shapes the
shape/dtype abstract interpreter (shapes.py) produces, so both packages
give the same number for the same graph, whatever implements it.  It is
known before anything runs, and it splits by op family.

Counting conventions (the JAX package's, which follow XLA's cost model):

- multiply-add = 2 FLOPs (matmul/conv flops are ``2 * outputs *
  reduction length``);
- backward cost of a contraction (conv / FC / dot / batch_dot) =
  2x forward (dgrad + wgrad are each one forward-sized contraction);
  elementwise backward = 1x forward;
- elementwise and unmodeled ops count one FLOP per output element —
  the ``modeled_fraction`` in the result says how much of the total
  came from ops with a real formula, so a count dominated by the
  default rule is visibly less trustworthy.  No rule names a fused op
  (``_contrib_FusedBottleneckUnit`` counts one FLOP per output
  element), so the step's FLOP count is that of the PLAIN graph of the
  same model.

Cross-check: the tests hold the count within 10% of
``torch.utils.flop_counter.FlopCounterMode`` over the port's own eager
run of a contraction-dominated graph (the JAX package holds it against
XLA's ``cost_analysis`` at the same bar).
"""
from __future__ import annotations

from .core import AnalysisPass, register_pass, analyze
from .diagnostics import Diagnostic, Severity

__all__ = ["FlopsPass", "count_flops"]


def _prod(shape):
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _tuple_attr(attrs, key, default=()):
    v = attrs.get(key, default)
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return default


def _conv_flops(attrs, ins, out):
    """2 * outputs * (Cin/groups) * prod(kernel) — each output element
    is one dot over a Cin/groups x kernel window."""
    kernel = _tuple_attr(attrs, "kernel")
    groups = int(attrs.get("num_group", 1) or 1)
    data = ins[0]
    layout = str(attrs.get("layout", "NCHW") or "NCHW")
    cin = data[layout.find("C")] if data and "C" in layout else data[1]
    return 2.0 * _prod(out) * (cin // max(groups, 1)) * max(_prod(kernel), 1)


def _deconv_flops(attrs, ins, out):
    """Transposed conv: each INPUT element scatters through the kernel
    (2 * inputs * (Cout/groups) * prod(kernel)) — reusing the conv
    formula on the (stride x larger) OUTPUT would overcount ~stride^2."""
    kernel = _tuple_attr(attrs, "kernel")
    groups = int(attrs.get("num_group", 1) or 1)
    layout = str(attrs.get("layout", "NCHW") or "NCHW")
    cout = out[layout.find("C")] if out and "C" in layout else out[1]
    data = ins[0]
    if not data:
        return float(_prod(out))
    return 2.0 * _prod(data) * (cout // max(groups, 1)) \
        * max(_prod(kernel), 1)


def _fc_flops(attrs, ins, out):
    # weight is (num_hidden, input_dim); 2*B*I*O plus the bias add
    weight = ins[1] if len(ins) > 1 and ins[1] else None
    in_dim = weight[1] if weight and len(weight) == 2 else \
        (ins[0][-1] if ins[0] else 1)
    return 2.0 * _prod(out) * in_dim + _prod(out)


def _dot_flops(attrs, ins, out):
    lhs = ins[0]
    if not lhs:
        return float(_prod(out))
    t_a = str(attrs.get("transpose_a", False)).lower() in ("true", "1")
    red = lhs[0] if t_a else lhs[-1]
    return 2.0 * _prod(out) * red


def _batch_dot_flops(attrs, ins, out):
    lhs = ins[0]
    if not lhs or len(lhs) < 3:
        return float(_prod(out))
    t_a = str(attrs.get("transpose_a", False)).lower() in ("true", "1")
    red = lhs[-2] if t_a else lhs[-1]
    return 2.0 * _prod(out) * red


def _pool_flops(attrs, ins, out):
    if str(attrs.get("global_pool", False)).lower() in ("true", "1"):
        return float(_prod(ins[0])) if ins[0] else float(_prod(out))
    return float(_prod(out)) * max(_prod(_tuple_attr(attrs, "kernel")), 1)


def _act_flops(attrs, ins, out):
    act = str(attrs.get("act_type", "relu"))
    return float(_prod(out)) * (1.0 if act == "relu" else 4.0)


# op name -> (fwd formula, backward multiplier).  The multiplier is
# applied to the forward count when training FLOPs are requested.
_RULES = {
    "Convolution":    (_conv_flops, 2.0),
    "Deconvolution":  (_deconv_flops, 2.0),
    "FullyConnected": (_fc_flops, 2.0),
    "dot":            (_dot_flops, 2.0),
    "batch_dot":      (_batch_dot_flops, 2.0),
    "BatchNorm":      (lambda a, i, o: 8.0 * _prod(o), 2.0),
    "LayerNorm":      (lambda a, i, o: 8.0 * _prod(o), 2.0),
    "InstanceNorm":   (lambda a, i, o: 8.0 * _prod(o), 2.0),
    "Pooling":        (_pool_flops, 1.0),
    "Activation":     (_act_flops, 1.0),
    "softmax":        (lambda a, i, o: 5.0 * _prod(o), 1.0),
    "log_softmax":    (lambda a, i, o: 5.0 * _prod(o), 1.0),
    "SoftmaxActivation": (lambda a, i, o: 5.0 * _prod(o), 1.0),
    "SoftmaxOutput":  (lambda a, i, o: 5.0 * _prod(o), 1.0),
    # scatter-at-index KV write (ops/cache.py): O(d) data movement per
    # slot row, no arithmetic — priced as the row elements written so
    # the optimizer's blend->scatter selection registers as the FLOP
    # reduction it is (the one-hot blend it replaces costs
    # O(slots * max_len * d) in muls and adds)
    "_cache_write_row": (
        lambda a, i, o: float(_prod(i[1])) if len(i) > 1 and i[1]
        else 0.0, 1.0),
    # speculative multi-token commit: up to K rows of data movement
    # per slot — priced as the rows operand's elements so swapping the
    # K-deep masked-blend chain (K * O(slots * max_len * d) muls/adds)
    # for the widened scatter registers as the FLOP reduction it is
    "_cache_write_rows": (
        lambda a, i, o: float(_prod(i[1])) if len(i) > 1 and i[1]
        else 0.0, 1.0),
}

_DEFAULT_BWD = 1.0

#: pure data-movement / materialization ops: no arithmetic happens —
#: copies, layout changes and constant materialization count 0 flops,
#: and the optimizer's constant folding (analysis/optimize.py) must
#: register as a FLOP *reduction* in the plan, which it only can if a
#: baked ``_constant`` costs nothing at run time (the work moved to
#: analysis time).
_ZERO_FLOP_OPS = frozenset([
    "_zeros", "_ones", "_full", "_arange", "_eye", "_constant",
    "zeros_like", "ones_like",
    "Reshape", "Flatten", "transpose", "expand_dims", "squeeze",
    "SwapAxis", "_copy", "BlockGrad",
])


@register_pass
class FlopsPass(AnalysisPass):
    """Per-node FLOP count from the shape environment.

    Products on the context (consumed by ``count_flops`` and the
    StepTimer): ``ctx.flops`` = {"fwd", "bwd", "by_op",
    "modeled_fraction"}; nodes whose shapes stayed unresolved are
    skipped (the shapes pass already diagnosed them) and excluded
    from the modeled fraction's denominator.
    """

    name = "flops"

    def run(self, ctx, report):
        view = ctx.ensure_view()
        shapes = ctx.shapes
        by_op = {}
        fwd_total = bwd_total = modeled = 0.0
        skipped = 0
        for n in view.op_nodes():
            out = shapes.get((id(n), 0))
            if out is None:
                skipped += 1
                continue
            ins = [shapes.get((id(i), ix)) for (i, ix) in n.inputs]
            try:
                attrs = n.op.normalize(n.attrs)
            except Exception:
                attrs = dict(n.attrs)
            rule = _RULES.get(n.op.name)
            try:
                if n.op.name in _ZERO_FLOP_OPS:
                    # modeled as exactly zero arithmetic (copies/layout/
                    # constants); contributes to neither total nor the
                    # modeled fraction's numerator-vs-denominator gap
                    fwd, bwd_mult = 0.0, 0.0
                elif rule is not None:
                    fwd = float(rule[0](attrs, ins, out))
                    bwd_mult = rule[1]
                    modeled += fwd
                else:
                    fwd = float(_prod(out))
                    bwd_mult = _DEFAULT_BWD
            except Exception:
                fwd, bwd_mult = float(_prod(out)), _DEFAULT_BWD
            if bwd_mult > 1.0 and n.inputs:
                first = n.inputs[0][0]
                if first.op is None and first.name in ctx.data_shapes:
                    # contraction fed straight by a graph input (conv0 /
                    # fc1 on raw data): autodiff never computes dgrad
                    # through a non-differentiated leaf, only wgrad
                    bwd_mult -= 1.0
            fwd_total += fwd
            bwd_total += fwd * bwd_mult
            agg = by_op.setdefault(n.op.name, [0, 0.0])
            agg[0] += 1
            agg[1] += fwd
        ctx.flops = {
            "fwd": fwd_total,
            "bwd": bwd_total,
            "by_op": {k: {"nodes": v[0], "fwd_flops": v[1]}
                      for k, v in by_op.items()},
            "modeled_fraction": (modeled / fwd_total) if fwd_total else 0.0,
            "skipped_nodes": skipped,
        }
        report.add(Diagnostic(
            Severity.INFO, self.name,
            "analytic FLOPs: fwd=%.3g bwd=%.3g over %d op node(s), "
            "%.0f%% from modeled ops%s"
            % (fwd_total, bwd_total, len(view.op_nodes()),
               ctx.flops["modeled_fraction"] * 100,
               (", %d node(s) skipped (unresolved shapes)" % skipped)
               if skipped else "")))


def count_flops(symbol, data_shapes, dtypes=None, training=False):
    """Analytic FLOPs for one execution of ``symbol`` under
    ``data_shapes``.  Returns ``{"fwd", "bwd", "total", "by_op",
    "modeled_fraction"}`` where ``total`` is fwd (+ bwd when
    ``training``) — the per-step numerator the MFU gauge uses."""
    report, ctx = analyze(symbol, data_shapes=data_shapes, dtypes=dtypes,
                          training=training,
                          passes=("verify", "shapes", "flops"))
    f = getattr(ctx, "flops", None)
    if not f:
        from ..base import MXNetError
        raise MXNetError("flops pass produced no count (structural "
                         "failure?): %s" % report.summary()
                         if hasattr(report, "summary") else "flops pass "
                         "produced no count")
    total = f["fwd"] + (f["bwd"] if training else 0.0)
    return {"fwd": f["fwd"], "bwd": f["bwd"], "total": total,
            "by_op": f["by_op"],
            "modeled_fraction": f["modeled_fraction"],
            "skipped_nodes": f["skipped_nodes"]}
