"""Padding-soundness pass: may zero-pad slots bleed into live outputs?

Counterpart of ``mxnet_tpu/analysis/padding.py``, ported whole: the
verdicts are the JAX package's on every graph.  The serving engine
quantizes traffic onto shape buckets by zero-padding the batch axis (the
JAX package also pads one sequence axis) and slicing outputs back, and
the decode engine runs a fixed slot pool whose dead slots hold stale
state.  That is sound exactly when
the graph is **row-local** along the padded axis: every live output
position depends only on live input positions.  A single cross-position
op — softmax over the padded axis, a mean, an un-lengthed bidirectional
RNN — silently contaminates live rows with pad slots.

This pass decides the question statically with an abstract
interpretation over the certified DAG.  The abstract value per tensor
tracks, for one padded source axis at a time:

- ``values`` — which axes of this tensor carry whole pad *positions*,
  and per axis the constant every pad slot is known to hold (``0.0``
  through f(0)=0 chains — a bias add or sigmoid degrades it to unknown;
  ``-inf``/``+inf``/``1.0`` after a repair mask pinned them there);
- ``diffuse``— pad slots survived but were merged into another axis
  (reshape/flatten), so position-level reasoning is lost.

Transfer rules are keyed by registry op name; families:

- pointwise ops propagate axes and the zero bit (never mix);
- axis movers (transpose/reshape/slice/concat/split) remap the carried
  axes, degrading to ``diffuse`` when an axis is merged;
- contractions and normalizations over a carried axis are the
  interesting cases: a *sum-like* reduction over still-zero pad slots is
  absorbing (exact — reported as info, not a violation), anything else
  over a carried axis is a **cross-position** finding;
- position reorders along the carried axis (reverse/sort/topk, static
  slices) break the "live rows lead" layout unpad slicing assumes;
- unknown ops touching a carried tensor are conservatively
  cross-position (soundness over precision).

The verdict per padded axis ("row-local" / "cross-position") lands in
``ctx.pad_verdicts``; the serving engine consults it at construction and
refuses or de-fangs the unsound bucketing (see serving/engine.py), and
the decode engine refuses or warns on a cross-position step graph (see
serving/decode.py).
"""
from __future__ import annotations

import collections
from functools import reduce as _reduce

from .core import AnalysisPass, register_pass
from .diagnostics import Diagnostic, Severity

__all__ = ["PaddingSoundnessPass", "classify_padding", "PadViolation",
           "MaskAction", "MeanAction", "NEG_INF", "POS_INF"]

#: repair hints a handler attaches to a cross-position finding:
#: mask input ``slot`` with the neutral ``value`` along ``axes``, or
#: rewrite a mean node into the sum/count form over ``axes``
MaskAction = collections.namedtuple("MaskAction", ["value", "axes", "slot"])
MeanAction = collections.namedtuple("MeanAction", ["axes", "slot"])

NEG_INF = float("-inf")
POS_INF = float("inf")

_UNSET = object()


def _prod(xs):
    return _reduce(lambda a, b: a * b, xs, 1)


class _Pad(object):
    """Abstract padding state of one tensor (see module docstring).

    ``values`` maps each carried axis to the constant every pad slot
    along it is known to hold (``None`` = unknown).  Tracking the value
    — not just a zero bit — is what lets the repair engine's spliced
    masks flip verdicts: softmax over pad slots pinned to ``-inf`` is
    exact, max over ``-inf`` pads is exact, prod over ``1.0`` pads is
    exact.  A slot padded along several axes holds the value of the
    axis masked LAST (a mask writes every past-length slot, including
    intersections), which is exactly what chained repair masks produce.
    ``dvalue`` plays the same role for diffuse (axis-merged) pad slots.

    ``blocks`` maps a carried axis to its pad granularity when that is
    more than one position: a reshape that merges the padded axis, as
    the LEADING factor, with the axes after it (``(N, H, W, C) ->
    (N*H*W, C)``, the fused ResNet units' row layout) keeps the pad
    slots a trailing run of whole ``H*W`` blocks, and a reshape that
    splits such an axis back keeps the padded axis exactly when the
    block is a multiple of the inner factor.  Only reshape, Flatten and
    the fused units carry it; any other op drops it, which is the
    conservative reading (granularity unknown, so a later split goes
    diffuse).  The JAX package has no block tracking and calls such a
    graph cross-position.
    """
    __slots__ = ("values", "dvalue", "diffuse", "blocks")

    def __init__(self, axes=(), zero=True, diffuse=False, values=None,
                 dvalue=_UNSET, blocks=None):
        if values is not None:
            self.values = dict(values)
        else:
            v = 0.0 if zero else None
            self.values = {a: v for a in axes}
        self.diffuse = bool(diffuse)
        self.blocks = {a: b for a, b in (blocks or {}).items()
                       if a in self.values and b > 1}
        if dvalue is not _UNSET:
            self.dvalue = dvalue
        else:
            self.dvalue = (0.0 if zero else None) if diffuse else None

    @property
    def axes(self):
        return frozenset(self.values)

    @property
    def zero(self):
        """Every pad slot this state tracks is known exactly zero."""
        return all(v == 0.0 for v in self.values.values()) and \
            (self.dvalue == 0.0 if self.diffuse else True)

    @property
    def carries(self):
        return bool(self.values) or self.diffuse

    def __repr__(self):
        return "<pad values=%s diffuse=%s>" % (
            {a: self.values[a] for a in sorted(self.values)}, self.diffuse)


_EMPTY = _Pad()


class PadViolation(object):
    """One structured cross-position finding (the rewrite engine's
    input): the node that mixes pad into live positions, plus — when
    the mixing op has a masking repair — machine-readable repair
    actions.  ``actions`` is a tuple of :data:`MaskAction` /
    :data:`MeanAction` entries, or ``()`` when the op has no known
    masking rewrite (conv windows, reorders, norm layers...).
    """
    __slots__ = ("label", "node", "op", "actions", "provenance", "message")

    def __init__(self, label, node, op, actions, provenance, message):
        self.label = label
        self.node = node
        self.op = op
        self.actions = tuple(actions or ())
        self.provenance = tuple(provenance)
        self.message = message

    @property
    def repairable(self):
        return bool(self.actions)

    def __repr__(self):
        return "<PadViolation %s@%s(%s) actions=%s>" % (
            self.label, self.node, self.op, list(self.actions))


class _H(object):
    """Per-node handler context."""
    __slots__ = ("node", "attrs", "ins", "in_shapes", "out_shapes",
                 "emit", "training", "view", "valid_len_name",
                 "batch_states")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def rank(self, i=0):
        s = self.in_shapes[i]
        return len(s) if s is not None else None

    def norm_axis(self, ax, i=0):
        r = self.rank(i)
        return ax % r if (r and ax is not None) else ax


# ---------------------------------------------------------------------------
# rule groups
# ---------------------------------------------------------------------------

def _zero_preserving_unaries():
    from ..ops.elemwise import _UNARY, _SPARSITY_PRESERVING
    pointwise = set(_UNARY) | {"gamma", "smooth_l1", "_copy", "BlockGrad",
                               "make_loss", "Dropout", "LeakyReLU", "Cast",
                               "zeros_like", "ones_like"}
    zero = set(_SPARSITY_PRESERVING) | {"_copy", "BlockGrad", "make_loss",
                                        "Dropout", "LeakyReLU", "Cast",
                                        "zeros_like"}
    return pointwise, zero


_POINTWISE_UNARY, _ZERO_UNARY = _zero_preserving_unaries()

# scalar-op zero preservation given the scalar constant c
_SCALAR_ZERO = {
    "_mul_scalar": lambda c: True, "_div_scalar": lambda c: True,
    "_mod_scalar": lambda c: True,
    "_plus_scalar": lambda c: c == 0, "_minus_scalar": lambda c: c == 0,
    "_rminus_scalar": lambda c: c == 0,
    "_power_scalar": lambda c: c > 0,
    "_maximum_scalar": lambda c: c <= 0, "_minimum_scalar": lambda c: c >= 0,
    "_hypot_scalar": lambda c: c == 0,
    "_equal_scalar": lambda c: c != 0, "_not_equal_scalar": lambda c: c == 0,
    "_greater_scalar": lambda c: c >= 0,        # 0 > c is 0 when c >= 0
    "_lesser_scalar": lambda c: c <= 0,
}

_BINARY_PW = {"_add", "_sub", "_mul", "_div", "_mod", "_power", "_maximum",
              "_minimum", "_hypot", "equal", "not_equal", "greater",
              "greater_equal", "lesser", "lesser_equal", "logical_and",
              "logical_or", "logical_xor", "_scatter_elemwise_div",
              "_identity_with_attr_like_rhs", "where"}

# value a pad slot must hold for the reduction to absorb it exactly
# (mean has none — its divisor counts pad slots regardless, which is
# why its repair is a sum/count rewrite, not a mask; see rewrite.py)
_REDUCE_IDENTITY = {"sum": 0.0, "nansum": 0.0, "norm": 0.0,
                    "prod": 1.0, "nanprod": 1.0,
                    "max": NEG_INF, "min": POS_INF,
                    # arg-reductions: a pad slot at the absorbing
                    # identity can never win, and ties break toward the
                    # leading (live) positions
                    "argmax": NEG_INF, "argmin": POS_INF}
_REDUCE_OPS = {"sum", "nansum", "mean", "prod", "nanprod", "max", "min",
               "norm", "argmax", "argmin"}
_REORDER_OPS = {"reverse", "sort", "argsort", "topk", "_shuffle"}


def _contract_absorbed(lhs, l_con, rhs, r_con):
    """Do pad slots vanish from a dot/batch_dot contraction?

    Per pad position k of the contracted axis, the product vanishes
    iff one side holds exactly 0.0 there AND the other side's factor
    is finite — ``0 * inf`` is NaN, and a ``-inf`` masked operand
    (exactly what a softmax repair mask upstream produces) against a
    zero-padded one would poison every live sum.  A side that does
    not carry the contracted axis holds live data there (treated
    finite, as the pre-value-domain rule did).  Diffuse states never
    reach here today (the _transfer gate flags non-pointwise ops on
    diffuse carriers first), but like the softmax/reduce exactness
    rules this one refuses them anyway: position-unknown pad slots
    admit no per-axis claim."""
    def _zero(st, con):
        return (not st.diffuse and con in st.axes
                and st.values.get(con) == 0.0)

    def _finite(st, con):
        if st.diffuse:
            return False
        if con not in st.axes:
            return True                         # live data at pad k
        v = st.values.get(con)
        return v is not None and NEG_INF < v < POS_INF and v == v

    return (_zero(lhs, l_con) and _finite(rhs, r_con)) or \
        (_zero(rhs, r_con) and _finite(lhs, l_con))


def _contract_repair(lhs, l_con, rhs, r_con):
    """Mask actions restoring absorption for a contaminating
    contraction: zero out whichever side's contracted pad slots are
    not already exactly zero (shared by dot and batch_dot)."""
    return tuple(
        MaskAction(0.0, (con,), slot)
        for slot, (st, con) in enumerate([(lhs, l_con), (rhs, r_con)])
        if con in st.axes and st.values.get(con) != 0.0)


def _map_axis_through_reshape(in_shape, out_shape, ax):
    """Output axis the padded input axis survives to, or None if it was
    merged/split (prefix-product matching: row-major reshape keeps an
    axis intact iff the element counts before and at it agree)."""
    before, extent = _prod(in_shape[:ax]), in_shape[ax]
    p = 1
    for j, d in enumerate(out_shape):
        if p == before and d == extent:
            return j
        p *= d
    return None


def _map_blocked_axis(in_shape, out_shape, ax, block):
    """``(output axis, block)`` for a padded axis that a reshape merges
    as the leading factor with the axes after it (the block grows by
    their product), or splits into a leading axis and inner axes whose
    product divides the pad block (the block shrinks by it); None when
    neither holds.  ``block`` is the input axis's pad granularity."""
    before = _prod(in_shape[:ax])
    p = 1
    for j, d in enumerate(out_shape):
        if p == before:
            break
        if p > before:
            return None
        p *= d
    else:
        return None
    extent = in_shape[ax]
    inner, k = 1, ax + 1
    while extent * inner < out_shape[j] and k < len(in_shape):
        inner *= in_shape[k]
        k += 1
    if extent * inner == out_shape[j] and inner > 1:
        return j, block * inner                 # merge
    inner, k = 1, j + 1
    while out_shape[j] * inner < extent and k < len(out_shape):
        inner *= out_shape[k]
        k += 1
    if out_shape[j] * inner == extent and inner > 1 \
            and block % inner == 0:
        return j, block // inner                # split
    return None


def _reduce_axes(attrs, rank):
    ax = attrs.get("axis")
    if ax is None or ax == ():
        axes = tuple(range(rank))
    elif isinstance(ax, int):
        axes = (ax % rank,)
    else:
        axes = tuple(a % rank for a in ax)
    if attrs.get("exclude"):
        axes = tuple(i for i in range(rank) if i not in axes)
    return axes


def _reduce_remap(axes, reduced, keepdims):
    """{surviving input axis: its output position} after a reduction."""
    out = {}
    for a in axes:
        if a in reduced:
            continue
        out[a] = a if keepdims else a - sum(1 for r in reduced if r < a)
    return out


def _remap_after_reduce(axes, reduced, keepdims):
    return set(_reduce_remap(axes, reduced, keepdims).values())


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

@register_pass
class PaddingSoundnessPass(AnalysisPass):
    name = "padding"

    def run(self, ctx, report):
        view = ctx.ensure_view()
        specs = ctx.pad_axes
        if specs is None:
            if not ctx.data_shapes:
                return          # nothing declared padded; nothing to do
            specs = {"batch": {n: 0 for n in ctx.data_shapes}}
        for label, var_axes in specs.items():
            verdict = self._classify(ctx, view, label, var_axes, report)
            ctx.pad_verdicts[label] = verdict
            report.add(Diagnostic(
                Severity.INFO, self.name,
                "axis %r verdict: %s" % (label, verdict)))

    # ------------------------------------------------------------------
    def _classify(self, ctx, view, label, var_axes, report):
        states = {}
        mixing = [False]
        violations = ctx.pad_violations.setdefault(label, [])
        valid_name = self._valid_len_name(ctx, view, label)
        # the batch label's abstract states (classified first: spec
        # order puts "batch" ahead) let the SequenceMask value-pinning
        # rule verify the masked tensor is actually request-indexed at
        # axis 0 — the layout the lengths vector assumes
        batch_states = (ctx.pad_states.get("batch")
                        if label != "batch" else None)

        for n in view.variables():
            if n.name in var_axes:
                # pad_dirty inputs (decode slot-state: stale garbage in
                # dead slots, never serving's zeros) must not earn the
                # zero-absorption credit sum-like reductions rely on
                states[(id(n), 0)] = _Pad(
                    {var_axes[n.name]}, zero=n.name not in ctx.pad_dirty)
            else:
                states[(id(n), 0)] = _EMPTY

        for node in view.op_nodes():
            nout = self._nout(node)
            ins = [states.get((id(i), ix), _EMPTY) for (i, ix) in node.inputs]
            in_shapes = [ctx.shapes.get((id(i), ix))
                         for (i, ix) in node.inputs]
            out_shapes = [ctx.shapes.get((id(node), i)) for i in range(nout)]

            def emit(msg, severity=Severity.WARNING, mixes=True,
                     repair=None, _node=node):
                if mixes and severity == Severity.WARNING:
                    mixing[0] = True
                    violations.append(PadViolation(
                        label, _node.name, _node.op.name, repair,
                        view.provenance(_node), msg))
                report.add(Diagnostic(
                    severity, self.name,
                    "[%s-axis] %s" % (label, msg), node=_node.name,
                    op=_node.op.name, provenance=view.provenance(_node)))

            if not any(s.carries for s in ins):
                outs = [_EMPTY] * nout
            else:
                try:
                    attrs = node.op.normalize(node.attrs)
                except Exception:
                    attrs = dict(node.attrs)
                h = _H(node=node, attrs=attrs, ins=ins, in_shapes=in_shapes,
                       out_shapes=out_shapes, emit=emit,
                       training=ctx.training, view=view,
                       valid_len_name=valid_name,
                       batch_states=batch_states)
                outs = self._transfer(h)
                if len(outs) < nout:
                    outs = list(outs) + [_EMPTY] * (nout - len(outs))
            for i, st in enumerate(outs):
                states[(id(node), i)] = st
        ctx.pad_states[label] = states
        return "cross-position" if mixing[0] else "row-local"

    @staticmethod
    def _valid_len_name(ctx, view, label):
        """The graph input whose values are each request's live length
        along this padded axis: declared by the caller, or discovered
        from the ``__pad_valid_len__`` marker rewrite.py stamps on the
        inputs it creates (so a repaired symbol re-analyzes
        standalone)."""
        name = ctx.valid_lengths.get(label)
        if name is None:
            for n in view.variables():
                if str(n.attrs.get("__pad_valid_len__", "")) == label:
                    name = n.name
                    ctx.valid_lengths[label] = name
                    break
        return name

    @staticmethod
    def _nout(node):
        try:
            return node.num_outputs()
        except Exception:
            return 1

    # ------------------------------------------------------------------
    def _transfer(self, h):
        name = h.node.op.name
        carrier = next(s for s in h.ins if s.carries)

        # a diffuse carrier only survives pointwise ops
        if any(s.diffuse for s in h.ins) and not (
                name in _POINTWISE_UNARY or name in _SCALAR_ZERO
                or name in _BINARY_PW or name == "add_n"):
            h.emit("pad slots were merged into another axis upstream "
                   "(reshape/flatten) and now reach non-pointwise op "
                   "%r — position tracking lost, conservatively "
                   "cross-position" % name)
            return [_Pad(diffuse=True, zero=False)]

        if name in _POINTWISE_UNARY:
            return [_Pad(carrier.axes, carrier.zero and name in _ZERO_UNARY,
                         carrier.diffuse)]
        if name in _SCALAR_ZERO or name in ("_rdiv_scalar", "_rpow_scalar",
                                            "_rmod_scalar",
                                            "_greater_equal_scalar",
                                            "_lesser_equal_scalar",
                                            "_logical_and_scalar",
                                            "_logical_or_scalar",
                                            "_logical_xor_scalar",
                                            "_scatter_plus_scalar",
                                            "_scatter_minus_scalar"):
            rule = _SCALAR_ZERO.get(name)
            c = h.attrs.get("scalar", 0.0)
            zero = bool(carrier.zero and rule is not None and rule(c))
            return [_Pad(carrier.axes, zero, carrier.diffuse)]
        if name in _BINARY_PW or name == "add_n":
            return [self._binary(h, name)]

        handler = getattr(self, "_op_" + _HANDLERS.get(name, ""), None)
        if handler is not None:
            return handler(h)

        h.emit("no padding-soundness rule for op %r with a padded "
               "input — conservatively cross-position (add a transfer "
               "rule in analysis/padding.py if it is row-local)" % name)
        return [_Pad(carrier.axes, False, carrier.diffuse)]

    # ------------------------------------------------------------------
    def _binary(self, h, name):
        """Pointwise n-ary: union carried axes (aligned from the right,
        numpy broadcasting); flag a non-carrying operand whose extent is
        tied to the padded axis (its shape cannot follow the bucket)."""
        out_shape = h.out_shapes[0]
        out_rank = len(out_shape) if out_shape else max(
            (len(s) for s in h.in_shapes if s), default=0)
        axes, diffuse = set(), False
        for s, shp in zip(h.ins, h.in_shapes):
            diffuse |= s.diffuse
            if not s.axes:
                continue
            off = out_rank - (len(shp) if shp else out_rank)
            axes.update(a + off for a in s.axes)
        for s, shp in zip(h.ins, h.in_shapes):
            if s.carries or shp is None:
                continue
            off = out_rank - len(shp)
            for a in axes:
                k = a - off
                if 0 <= k < len(shp) and shp[k] != 1:
                    h.emit("operand %s spans the padded axis without "
                           "deriving from padded data: its extent is "
                           "pinned to ONE bucket size, so other buckets "
                           "cannot bind" % (shp,))
        carriers = [s for s in h.ins if s.carries]
        if name in ("_add", "_sub", "add_n"):
            zero = all(s.carries and s.zero for s in h.ins)
        elif name in ("_mul", "logical_and"):
            zero = any(s.zero for s in carriers)
        elif name == "_div":
            zero = h.ins[0].carries and h.ins[0].zero \
                and not h.ins[1].carries
        elif name in ("_maximum", "_minimum"):
            zero = all(s.carries and s.zero for s in h.ins)
        elif name == "where":
            zero = all(s.carries and s.zero for s in h.ins[1:])
        else:
            zero = False
        return _Pad(axes, zero, diffuse)

    # -- contraction-style layers ---------------------------------------
    def _op_fullyconnected(self, h):
        data = h.ins[0]
        if data.axes <= {0}:
            zero = data.zero and bool(h.attrs.get("no_bias"))
            return [_Pad(data.axes, zero)]
        h.emit("FullyConnected contracts the padded axis: the weight "
               "shape is pinned to the padded extent, so parameters "
               "cannot be shared across buckets"
               + ("" if data.zero else
                  " — and pad slots are no longer zero, so live outputs "
                  "absorb them"))
        return [_Pad()]

    def _op_conv(self, h):
        data = h.ins[0]
        layout = str(h.attrs.get("layout") or "NCHW")
        ch = layout.index("C")
        spatial = {i for i, c in enumerate(layout) if c in "DHW"}
        if data.axes <= {0}:
            zero = data.zero and bool(h.attrs.get("no_bias"))
            return [_Pad(data.axes, zero)]
        if data.axes & spatial:
            kernel = tuple(h.attrs.get("kernel") or ())
            pad = tuple(h.attrs.get("pad") or ())
            if all(k == 1 for k in kernel) and all(p == 0 for p in pad):
                return [_Pad(data.axes, False)]
            h.emit("%s window (kernel=%s) spans neighbouring positions "
                   "along the padded spatial axis: live border outputs "
                   "read pad slots" % (h.node.op.name, kernel or "?"))
            return [_Pad(data.axes, False)]
        if ch in data.axes:
            h.emit("%s contracts the padded channel axis: parameter "
                   "shapes are pinned to the padded extent"
                   % h.node.op.name)
        return [_Pad()]

    def _op_pooling(self, h):
        data = h.ins[0]
        if data.axes <= {0}:
            return [_Pad(data.axes, data.zero)]
        h.emit("Pooling window reads across the padded axis (avg/max "
               "over pad slots shifts live border outputs)")
        return [_Pad(data.axes, False)]

    def _op_batchnorm(self, h):
        data = h.ins[0]
        ch = h.norm_axis(int(h.attrs.get("axis", 1)))
        if h.training and (data.axes - {ch}):
            h.emit("BatchNorm in training mode folds pad slots into the "
                   "batch statistics: every live output shifts")
            return [_Pad(data.axes, False)] * self._nout(h.node)
        if ch in data.axes:
            h.emit("BatchNorm parameters span the padded channel axis: "
                   "shapes pinned to one bucket extent")
        return [_Pad(data.axes, False)] * self._nout(h.node)

    def _op_norm_layer(self, h):
        # InstanceNorm/LayerNorm/L2Normalization/LRN normalize within a
        # row (never across axis 0), so only non-batch pad axes mix
        data = h.ins[0]
        if data.axes <= {0}:
            return [_Pad(data.axes, False)] * self._nout(h.node)
        h.emit("%s normalizes across the padded axis inside each "
               "example: live positions absorb pad slots"
               % h.node.op.name)
        return [_Pad(data.axes, False)] * self._nout(h.node)

    def _op_softmax(self, h):
        data = h.ins[0]
        name = h.node.op.name
        raw_ax = int(h.attrs.get("axis", -1))
        if raw_ax < 0 and h.rank(0) is None:
            h.emit("cannot resolve softmax axis %d without shapes; "
                   "conservatively cross-position" % raw_ax)
            return [_Pad(data.axes, False)]
        ax = h.norm_axis(raw_ax)
        if ax in data.axes:
            if data.values.get(ax) == NEG_INF and not data.diffuse:
                h.emit("softmax over the padded axis is exact: pad "
                       "slots hold -inf and contribute exp(-inf)=0 to "
                       "the partition function",
                       severity=Severity.INFO, mixes=False)
                out_vals = {a: None for a in data.axes}
                if data.axes == {ax}:
                    # live rows renormalize over live slots only; the
                    # pad slots themselves come out exactly 0 (-inf in
                    # log space)
                    out_vals[ax] = (NEG_INF if name == "log_softmax"
                                    else 0.0)
                return [_Pad(values=out_vals)]
            repair = None
            if name in ("softmax", "log_softmax"):
                repair = (MaskAction(NEG_INF, (ax,), 0),)
            h.emit("softmax normalizes over the padded axis: each zero "
                   "pad slot contributes exp(0)=1 to the partition "
                   "function, scaling every live probability down",
                   repair=repair)
            return [_Pad(data.axes, False)]
        return [_Pad(data.axes, False)]

    def _op_softmax_output(self, h):
        data = h.ins[0]
        if h.rank(0) is None:
            h.emit("cannot resolve SoftmaxOutput's normalized axes "
                   "without shapes; conservatively cross-position")
            return [_Pad(data.axes, False)]
        rank = h.rank(0)
        if h.attrs.get("multi_output"):
            norm_axes = {1}
        elif rank <= 2:
            norm_axes = {rank - 1}
        else:
            norm_axes = set(range(1, rank))     # impl flattens non-batch
        if data.axes & norm_axes:
            h.emit("SoftmaxOutput normalizes over the padded axis "
                   "(axes %s): pad slots join the partition function"
                   % sorted(norm_axes))
        return [_Pad(data.axes, False)]

    def _op_reduce(self, h):
        name = h.node.op.name
        data = h.ins[0]
        rank = h.rank(0)
        if rank is None:
            h.emit("cannot resolve reduce axes without shapes; "
                   "conservatively cross-position")
            return [_Pad()]
        reduced = _reduce_axes(h.attrs, rank)
        keepdims = bool(h.attrs.get("keepdims"))
        hit = data.axes & set(reduced)
        out_axes = _remap_after_reduce(data.axes, set(reduced), keepdims)
        if hit:
            ident = _REDUCE_IDENTITY.get(name)
            if ident is not None and not data.diffuse and \
                    all(data.values.get(a) == ident for a in hit):
                h.emit("%s over the padded axis is exact: pad slots "
                       "hold the reduction's absorbing identity (%s)"
                       % (name, ident),
                       severity=Severity.INFO, mixes=False)
                return [_Pad(out_axes, False)]
            if name == "mean":
                repair = (MeanAction(tuple(sorted(hit)), 0),)
            elif ident is not None:
                repair = (MaskAction(ident, tuple(sorted(hit)), 0),)
            else:
                repair = None
            h.emit("%s folds the padded axis into live outputs (%s)"
                   % (name,
                      "pad slots are no longer zero" if not data.zero
                      else "zero is not the identity of this reduction"),
                   repair=repair)
            return [_Pad(out_axes, False)]
        out_vals = {}
        remap = _reduce_remap(data.axes, set(reduced), keepdims)
        for a, j in remap.items():
            out_vals[j] = (0.0 if name in ("sum", "nansum")
                           and data.values.get(a) == 0.0 else None)
        return [_Pad(values=out_vals, diffuse=data.diffuse,
                     dvalue=data.dvalue)]

    def _op_dot(self, h):
        lhs, rhs = h.ins[0], h.ins[1]
        ls, rs = h.in_shapes[0], h.in_shapes[1]
        if ls is None or rs is None:
            h.emit("cannot resolve dot contraction axes without shapes")
            return [_Pad()]
        ta = bool(h.attrs.get("transpose_a"))
        tb = bool(h.attrs.get("transpose_b"))
        l_con = 0 if ta else len(ls) - 1
        r_con = len(rs) - 1 if tb else 0
        contracted_pad = (l_con in lhs.axes) or (r_con in rhs.axes)
        if contracted_pad:
            if _contract_absorbed(lhs, l_con, rhs, r_con):
                h.emit("dot contracts a still-zero padded axis: exact "
                       "(zero terms absorb), but parameter operands "
                       "would pin their shape to the bucket extent",
                       severity=Severity.INFO, mixes=False)
            else:
                repair = _contract_repair(lhs, l_con, rhs, r_con)
                h.emit("dot contracts the padded axis with nonzero pad "
                       "slots: live outputs absorb them", repair=repair)
        out_axes = set()
        l_keep = [i for i in range(len(ls)) if i != l_con]
        for pos, i in enumerate(l_keep):
            if i in lhs.axes:
                out_axes.add(pos)
        r_keep = [i for i in range(len(rs)) if i != r_con]
        for pos, i in enumerate(r_keep):
            if i in rhs.axes:
                out_axes.add(len(l_keep) + pos)
        return [_Pad(out_axes, False)]

    def _op_batch_dot(self, h):
        """matmul over the last two axes; every leading axis is a shared
        batch axis (row-local — pad batch slots multiply among
        themselves and stay in pad positions)."""
        lhs, rhs = h.ins[0], h.ins[1]
        ls, rs = h.in_shapes[0], h.in_shapes[1]
        if ls is None or rs is None:
            if any(s.carries for s in h.ins):
                h.emit("cannot resolve batch_dot contraction axes "
                       "without shapes; conservatively cross-position")
            return [_Pad()]
        l_con = len(ls) - (2 if h.attrs.get("transpose_a") else 1)
        r_con = len(rs) - (1 if h.attrs.get("transpose_b") else 2)
        if (l_con in lhs.axes) or (r_con in rhs.axes):
            if _contract_absorbed(lhs, l_con, rhs, r_con):
                h.emit("batch_dot contracts a still-zero padded axis: "
                       "exact (zero terms absorb)",
                       severity=Severity.INFO, mixes=False)
            else:
                repair = _contract_repair(lhs, l_con, rhs, r_con)
                h.emit("batch_dot contracts the padded axis with "
                       "nonzero pad slots: live outputs absorb them",
                       repair=repair)
        out_axes = set()
        for a in lhs.axes | rhs.axes:
            if a < len(ls) - 2:
                out_axes.add(a)         # shared batch axis, position-kept
        l_row = len(ls) - (1 if h.attrs.get("transpose_a") else 2)
        r_col = len(rs) - (2 if h.attrs.get("transpose_b") else 1)
        if l_row in lhs.axes:
            out_axes.add(len(ls) - 2)
        if r_col in rhs.axes:
            out_axes.add(len(ls) - 1)
        return [_Pad(out_axes, False)]

    # -- axis movers -----------------------------------------------------
    def _op_reshape(self, h):
        data = h.ins[0]
        ins, outs = h.in_shapes[0], h.out_shapes[0]
        if ins is None or outs is None:
            return [_Pad(diffuse=True, zero=data.zero)]
        return [self._reshaped(data, ins, tuple(outs))]

    @staticmethod
    def _reshaped(data, ins, outs):
        axes, blocks, diffuse = set(), {}, data.diffuse
        for a in data.axes:
            j = _map_axis_through_reshape(ins, outs, a)
            if j is not None:
                axes.add(j)
                blocks[j] = data.blocks.get(a, 1)
                continue
            m = _map_blocked_axis(ins, outs, a, data.blocks.get(a, 1))
            if m is None:
                diffuse = True
            else:
                axes.add(m[0])
                blocks[m[0]] = m[1]
        return _Pad(axes, data.zero, diffuse, blocks=blocks)

    def _op_transpose(self, h):
        data = h.ins[0]
        rank = h.rank(0)
        perm = tuple(h.attrs.get("axes") or ()) or tuple(
            reversed(range(rank or 0)))
        inv = {src: dst for dst, src in enumerate(perm)}
        return [_Pad({inv.get(a, a) for a in data.axes}, data.zero,
                     data.diffuse)]

    def _op_swapaxis(self, h):
        data = h.ins[0]
        d1 = h.norm_axis(int(h.attrs.get("dim1", 0)))
        d2 = h.norm_axis(int(h.attrs.get("dim2", 0)))
        swap = {d1: d2, d2: d1}
        return [_Pad({swap.get(a, a) for a in data.axes}, data.zero,
                     data.diffuse)]

    def _op_expand_dims(self, h):
        data = h.ins[0]
        ax = int(h.attrs["axis"])
        if ax < 0:
            ax += (h.rank(0) or 0) + 1
        return [_Pad({a + 1 if a >= ax else a for a in data.axes},
                     data.zero, data.diffuse)]

    def _op_squeeze(self, h):
        data = h.ins[0]
        ins, outs = h.in_shapes[0], h.out_shapes[0]
        if ins is None or outs is None:
            return [_Pad(diffuse=True, zero=data.zero)]
        ax = h.attrs.get("axis")
        drop = set(a % len(ins) for a in ax) if ax else \
            {i for i, d in enumerate(ins) if d == 1}
        axes = set()
        for a in data.axes:
            if a in drop:
                continue
            axes.add(a - sum(1 for d in drop if d < a))
        return [_Pad(axes, data.zero, data.diffuse)]

    def _op_slice(self, h):
        data = h.ins[0]
        name = h.node.op.name
        sliced = set()
        rank = h.rank(0) or 0
        if name == "slice_axis":
            sliced = {h.norm_axis(int(h.attrs["axis"]))}
        else:
            begin = tuple(h.attrs.get("begin") or ())
            end = tuple(h.attrs.get("end") or ())
            for i in range(min(len(begin), rank)):
                ins = h.in_shapes[0]
                if (begin[i] or 0) != 0 or (
                        i < len(end) and end[i] is not None
                        and ins and end[i] != ins[i]):
                    sliced.add(i)
        if sliced & data.axes:
            h.emit("static slice selects fixed positions along the "
                   "padded axis: which slots are pad vs live varies per "
                   "request, so the selection can capture pad slots")
            return [_Pad(data.axes & set(range(rank)), False)]
        return [_Pad(data.axes, data.zero, data.diffuse)]

    def _op_concat(self, h):
        dim = h.norm_axis(int(h.attrs.get("dim", 1)))
        axes, zero, diffuse = set(), True, False
        for s in h.ins:
            axes |= s.axes
            diffuse |= s.diffuse
            zero &= (s.zero or not s.carries)
        if dim in axes:
            h.emit("concat along the padded axis makes pad slots "
                   "interior: unpad slicing (which trims the tail) can "
                   "no longer separate them", mixes=True)
            return [_Pad(axes, False, True)]
        return [_Pad(axes, zero, diffuse)]

    def _op_stack(self, h):
        ax = int(h.attrs.get("axis", 0))
        rank = h.rank(0) or 0
        if ax < 0:
            ax += rank + 1
        axes, zero = set(), True
        for s in h.ins:
            axes |= {a + 1 if a >= ax else a for a in s.axes}
            zero &= (s.zero or not s.carries)
        return [_Pad(axes, zero, any(s.diffuse for s in h.ins))]

    def _op_split(self, h):
        data = h.ins[0]
        ax = h.norm_axis(int(h.attrs.get("axis", 1)))
        n = self._nout(h.node)
        if ax in data.axes:
            h.emit("split along the padded axis redistributes pad "
                   "slots across outputs; per-output liveness is no "
                   "longer the request's length", severity=Severity.INFO,
                   mixes=False)
            return [_Pad(data.axes, data.zero)] * n
        axes = data.axes
        if h.attrs.get("squeeze_axis"):
            axes = {a - 1 if a > ax else a for a in axes if a != ax}
        return [_Pad(axes, data.zero, data.diffuse)] * n

    def _op_reorder(self, h):
        data = h.ins[0]
        ax = h.attrs.get("axis")
        rank = h.rank(0) or 0
        if isinstance(ax, int):
            axes = {ax % rank} if rank else {ax}
        elif ax:
            axes = {a % rank for a in ax} if rank else set(ax)
        else:
            axes = set(range(rank))     # sort default axis=-1 handled above
        name = h.node.op.name
        if name in ("sort", "argsort", "topk") and h.attrs.get("axis") is None:
            axes = {rank - 1} if rank else axes
        if axes & data.axes:
            h.emit("%s reorders positions along the padded axis: live "
                   "rows no longer lead, so unpad slicing returns pad "
                   "slots (and order itself depends on pad values)"
                   % name)
            return [_Pad(data.axes, False)] * self._nout(h.node)
        return [_Pad(data.axes, data.zero, data.diffuse)] * \
            self._nout(h.node)

    def _op_tile_repeat(self, h):
        data = h.ins[0]
        if data.axes:
            h.emit("%s duplicates pad slots into interior positions"
                   % h.node.op.name, severity=Severity.INFO, mixes=False)
        return [_Pad(set(), data.zero, True)]

    def _op_embedding(self, h):
        idx = h.ins[0]
        # pad indices are 0 -> they gather a LIVE weight row; values are
        # garbage but stay in pad positions (row-local)
        return [_Pad(idx.axes, False, idx.diffuse)]

    def _op_gather(self, h):
        data, indices = h.ins[0], h.ins[1] if len(h.ins) > 1 else _EMPTY
        if data.carries:
            h.emit("gather reads from a padded tensor: whether an index "
                   "lands on a pad slot depends on runtime values — "
                   "conservatively cross-position")
            return [_Pad()]
        return [_Pad(indices.axes, False, indices.diffuse)]

    def _op_one_hot(self, h):
        idx = h.ins[0]
        return [_Pad(idx.axes, False, idx.diffuse)]

    def _op_cache_write(self, h):
        """``_cache_write_row(cache, row, pos)``: output row i is
        cache row i with element ``pos[i]`` overwritten by ``row[i]``
        — each output row reads ONLY its own row of every operand, so
        the op is row-local along the slot axis (axis 0) by
        construction, with no zero-pad credit (the written position
        makes pad rows nonzero, and a stale cache row passes through
        untouched)."""
        cache = h.ins[0]
        row = h.ins[1] if len(h.ins) > 1 else _EMPTY
        pos = h.ins[2] if len(h.ins) > 2 else _EMPTY
        if (row.axes - {0}) or (pos.axes - {0}):
            # padding carried on a non-slot axis of the row/pos operand
            # lands at shifted output coordinates — nothing downstream
            # tracks that mapping, so stand down conservatively
            h.emit("_cache_write_row: row/pos operand carries padding "
                   "on a non-slot axis — position tracking lost")
            return [_Pad(diffuse=True, zero=False)]
        axes = set(cache.axes)
        if 0 in row.axes or 0 in pos.axes:
            axes.add(0)
        return [_Pad(axes, False,
                     cache.diffuse or row.diffuse or pos.diffuse)]

    def _op_cache_write_rows(self, h):
        """``_cache_write_rows(cache, rows, pos, count)``: output row i
        is cache row i with up to ``count[i]`` elements starting at
        ``pos[i]`` overwritten by ``rows[i]`` — the speculative
        multi-token widening of ``_cache_write_row``.  Each output row
        reads ONLY its own row of every operand, so the op is
        row-local along the slot axis (axis 0) by construction, with
        no zero-pad credit (committed positions make pad rows nonzero
        and stale cache rows pass through untouched)."""
        cache = h.ins[0]
        rest = [h.ins[i] if len(h.ins) > i else _EMPTY
                for i in (1, 2, 3)]
        if any(r.axes - {0} for r in rest):
            # padding carried on a non-slot axis of rows/pos/count
            # lands at shifted output coordinates — stand down
            h.emit("_cache_write_rows: rows/pos/count operand carries "
                   "padding on a non-slot axis — position tracking "
                   "lost")
            return [_Pad(diffuse=True, zero=False)]
        axes = set(cache.axes)
        if any(0 in r.axes for r in rest):
            axes.add(0)
        return [_Pad(axes, False,
                     cache.diffuse or any(r.diffuse for r in rest))]

    def _op_sequence_mask(self, h):
        data = h.ins[0]
        if not h.attrs.get("use_sequence_length"):
            return [_Pad(values=data.values, diffuse=data.diffuse,
                         dvalue=data.dvalue)]               # identity
        # masks positions past sequence_length along the time axis with
        # `value`.  When the lengths input is the designated per-request
        # valid-length variable (the repair engine's masks' input, or a
        # variable stamped __pad_valid_len__=<label>), every pad slot
        # along the masked axis afterwards holds exactly `value` — the
        # neutral-element fact downstream softmax/sum/max rules key on.
        # Any other lengths source only gets the historical benefit of
        # the doubt for value=0 (restoring the zero invariant).
        ax = int(h.attrs.get("axis", 0))
        val = float(h.attrs.get("value", 0.0) or 0.0)
        values = dict(data.values)
        sl_node = h.node.inputs[1][0] if len(h.node.inputs) > 1 else None
        sl_state = h.ins[1] if len(h.ins) > 1 else _EMPTY
        # the lengths vector is indexed by the batch axis (axis 1 in
        # the reference (T, B, ...) layout when masking axis 0, axis 0
        # otherwise): pad positions carried BY the lengths input land
        # on that axis of the output, row-locally (row i's mask reads
        # lengths[i] only)
        batch_ax = 1 if ax == 0 else 0
        if sl_state.carries:
            # rows whose length entry is itself a pad slot read a
            # garbage length: the row stays in place (row-local) but
            # its value is only known when data and mask value agree
            values[batch_ax] = val if values.get(batch_ax) == val else None
        if ax in values:
            # the masked tensor must really be request-indexed at axis
            # 0 — a shape coincidence (leading dim == batch extent on
            # a transposed layout) is not enough, so the batch label's
            # abstract state at the data input is consulted too
            data_key = (id(h.node.inputs[0][0]), h.node.inputs[0][1])
            bst = (h.batch_states or {}).get(data_key)
            authoritative = (
                h.valid_len_name is not None and sl_node is not None
                and sl_node.op is None
                and sl_node.name == h.valid_len_name
                and ax != 0
                and h.in_shapes[0] is not None
                and h.in_shapes[1] is not None
                and tuple(h.in_shapes[1]) == (h.in_shapes[0][0],)
                and bst is not None and not bst.diffuse
                and bst.axes == frozenset({0}))
            if authoritative:
                values[ax] = val
                h.emit("SequenceMask driven by the designated valid-"
                       "length input %r pins pad slots along axis %d "
                       "to %s" % (h.valid_len_name, ax, val),
                       severity=Severity.INFO, mixes=False)
            else:
                values[ax] = 0.0 if val == 0.0 else None
        return [_Pad(values=values, diffuse=data.diffuse,
                     dvalue=data.dvalue)]

    def _op_rnn(self, h):
        data = h.ins[0]
        nout = self._nout(h.node)
        if data.axes <= {1}:        # (T, B, F): batch axis padding
            return [_Pad(data.axes, False)] * nout
        if bool(h.attrs.get("bidirectional")):
            h.emit("bidirectional RNN over the padded time axis: the "
                   "backward sweep carries pad steps into every live "
                   "step")
            return [_Pad(data.axes, False)] * nout
        # causal recurrence: tail padding cannot reach earlier live
        # steps in output 0, but final-state outputs DO absorb pad steps
        used_states = False
        for consumer in h.view.topo:
            for (inp, ix) in consumer.inputs:
                if inp is h.node and ix >= 1:
                    used_states = True
        for (head, ix) in h.view.heads:
            if head is h.node and ix >= 1:
                used_states = True
        if used_states:
            h.emit("RNN final-state outputs absorb padded time steps "
                   "(the recurrence runs past the live length)")
        else:
            h.emit("causal RNN over tail-padded time axis: per-step "
                   "outputs are row-local (state outputs unused)",
                   severity=Severity.INFO, mixes=False)
        outs = [_Pad(data.axes, False)]
        outs += [_Pad()] * (nout - 1)
        return outs

    def _op_broadcast(self, h):
        data = h.ins[0]
        return [_Pad(data.axes, data.zero, data.diffuse)]

    def _op_flatten(self, h):
        data = h.ins[0]
        ins, outs = h.in_shapes[0], h.out_shapes[0]
        if ins is None:
            return [_Pad(diffuse=True, zero=data.zero)]
        outs = outs or (ins[0], _prod(ins[1:]))
        return [self._reshaped(data, ins, tuple(outs))]

    def _op_activation(self, h):
        data = h.ins[0]
        act = str(h.attrs.get("act_type", "relu"))
        zero = data.zero and act in ("relu", "tanh", "softsign")
        return [_Pad(data.axes, zero, data.diffuse)]

    def _op_clip(self, h):
        data = h.ins[0]
        lo = float(h.attrs.get("a_min", 0.0))
        hi = float(h.attrs.get("a_max", 0.0))
        return [_Pad(data.axes, data.zero and lo <= 0.0 <= hi,
                     data.diffuse)]

    def _op_fused_unit(self, h):
        data = h.ins[0]
        if data.axes <= {0}:
            # the unit reads rows of one image together only, so whole
            # pad blocks along axis 0 stay whole
            return [_Pad(data.axes, False, blocks=data.blocks)] \
                * self._nout(h.node)
        h.emit("fused conv/BN unit mixes across the padded non-batch "
               "axis (conv windows + batch statistics)")
        return [_Pad(data.axes, False)] * self._nout(h.node)


# op name -> handler suffix (method _op_<suffix> on the pass)
_HANDLERS = {
    "FullyConnected": "fullyconnected",
    "Convolution": "conv", "Deconvolution": "conv",
    "Pooling": "pooling",
    "BatchNorm": "batchnorm",
    "InstanceNorm": "norm_layer", "LayerNorm": "norm_layer",
    "L2Normalization": "norm_layer", "LRN": "norm_layer",
    "softmax": "softmax", "log_softmax": "softmax",
    "SoftmaxActivation": "softmax",
    "SoftmaxOutput": "softmax_output", "SVMOutput": "softmax_output",
    "sum": "reduce", "nansum": "reduce", "mean": "reduce",
    "prod": "reduce", "nanprod": "reduce", "max": "reduce",
    "min": "reduce", "norm": "reduce", "argmax": "reduce",
    "argmin": "reduce",
    "dot": "dot", "batch_dot": "batch_dot",
    "Reshape": "reshape", "reshape_like": "reshape",
    "Flatten": "flatten",
    "transpose": "transpose", "SwapAxis": "swapaxis",
    "expand_dims": "expand_dims", "squeeze": "squeeze",
    "slice": "slice", "slice_axis": "slice", "slice_like": "slice",
    "Concat": "concat", "stack": "stack", "SliceChannel": "split",
    "reverse": "reorder", "sort": "reorder", "argsort": "reorder",
    "topk": "reorder", "_shuffle": "reorder",
    "tile": "tile_repeat", "repeat": "tile_repeat",
    "Embedding": "embedding",
    "take": "gather", "batch_take": "gather", "gather_nd": "gather",
    "pick": "gather",
    "one_hot": "one_hot",
    "_cache_write_row": "cache_write",
    "_cache_write_rows": "cache_write_rows",
    "SequenceMask": "sequence_mask",
    "RNN": "rnn",
    "broadcast_to": "broadcast", "broadcast_axis": "broadcast",
    "_contrib_FusedBottleneckUnit": "fused_unit",
    "_contrib_BNStemConv": "fused_unit",
    "Activation": "activation",
    "clip": "clip",
}


# ---------------------------------------------------------------------------
# public helper (used by serving.engine)
# ---------------------------------------------------------------------------

def classify_padding(symbol, data_shapes, pad_axes, training=False,
                     policy=None, valid_lengths=None):
    """Run verify+shapes+padding; returns (verdicts, report).

    ``pad_axes``: {label: {input name: graph axis}}.  Verdict per label
    is "row-local" or "cross-position"; a structurally broken graph
    yields no verdicts (the report carries the errors).
    ``valid_lengths``: optional {label: input name} designating the
    per-request live-length input masking rewrites key on (repaired
    graphs also self-declare it via ``__pad_valid_len__`` markers).
    """
    from .core import analyze
    report, ctx = analyze(symbol, data_shapes=data_shapes,
                          pad_axes=pad_axes, training=training,
                          policy=policy, valid_lengths=valid_lengths,
                          passes=("verify", "shapes", "padding"))
    return dict(ctx.pad_verdicts), report
