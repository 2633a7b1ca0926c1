"""Static memory planner: liveness, peak-memory watermark, donation gate.

Counterpart of ``mxnet_tpu/analysis/memory.py``.  The reference
framework's memory-planning layer (note_memory: liveness-driven in-place
and co-share allocation) decides *allocation*; this pass does the
analysis half as a first-class IR pass (the TVM idiom), so bytes become
a verdict BEFORE anything runs:

- **liveness**: last-use per entry ``(node, out_idx)`` over the shape
  interpreter's concrete shapes+dtypes, yielding per-node live-set
  bytes and a linear-scan peak watermark (params resident +
  activation high-water) per program;
- **donation soundness**: given a donate spec (the decode engine's
  in-place slot pool: state input i aliases output 1+i), statically
  prove every donated input is dead once the aliasing output
  materializes, and REJECT with a node-pinned reason otherwise —
  aliasing is a gated verdict, not a convention;
- **sharding-aware bytes**: under a sharding plan spec, buffer bytes
  divide along plan-partitioned axes (an axis that doesn't divide falls
  back to replicated).  Plan specs come from ``parallel/mesh.py``, which
  the port does not have yet, so :func:`plan_memory` refuses one;
- **in-place / co-share opportunities** (note_memory idiom): emitted as
  INFO diagnostics and a structured report.

The planner only diagnoses — it never mutates the graph.  Its peak is
the predicted partner of ``torch.cuda.max_memory_allocated`` over the
same run; the port's executor keeps intermediates longer than the
planner's liveness does, so the two differ by design.
"""
from __future__ import annotations

import re

import numpy as np

from ..base import MXNetError
from .core import (AnalysisPass, register_pass, analyze, as_dtype,
                   same_dtype, itemsize)
from .diagnostics import Diagnostic, Severity

__all__ = ["MemoryPass", "DonationCheck", "plan_memory",
           "predict_peak_bytes", "check_donation", "shard_divisor",
           "device_memory_budget", "plan_digest", "format_bytes"]

_F32 = np.dtype(np.float32)

#: view-of-input ops: the output is (or can be) a reinterpretation of
#: the input buffer — zero new bytes, and the SOURCE buffer stays live
#: as long as the view does.  transpose/SwapAxis are excluded: XLA on
#: real layouts usually materializes them.
_ALIAS_OPS = frozenset([
    "Reshape", "Flatten", "expand_dims", "squeeze", "_copy", "BlockGrad",
])

#: ops whose output may overwrite a same-shape/dtype input in place
#: once that input is dead (FInplaceOption in the reference's
#: note_memory) — the co-share candidate set the report surfaces.
_INPLACE_OPS = frozenset([
    "Activation", "LeakyReLU", "relu", "sigmoid", "tanh", "exp", "log",
    "sqrt", "square", "negative", "abs", "clip", "Dropout",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "_plus", "_minus", "_mul", "_div",
    "_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
    "_rminus_scalar", "_rdiv_scalar", "_maximum", "_minimum",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "softmax", "log_softmax", "SoftmaxActivation",
    "BatchNorm", "LayerNorm", "InstanceNorm",
])


def _prod(shape):
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _itemsize(dt):
    try:
        return itemsize(dt)
    except Exception:
        return _F32.itemsize


def _axspec_divisor(shape, axspec, axes):
    """Product of mesh-axis sizes an axis-spec partitions ``shape`` by,
    with the plan's divisibility-drop: a named axis whose size does not
    divide the dim falls back to replicated on that dim."""
    div = 1
    for dim, ax in zip(shape, tuple(axspec)[:len(shape)]):
        if ax is not None and ax in axes and axes[ax] > 0 \
                and int(dim) % int(axes[ax]) == 0:
            div *= int(axes[ax])
    return div


def shard_divisor(spec, name, shape, kind="act"):
    """How many ways one buffer divides under a normalized plan spec.

    ``kind``: "param" matches ``param_rules`` (first hit wins,
    unmatched replicated), "state" matches ``state_rules``; "input" and
    "act" use the data placement (dim 0 over ``batch_axis``, dim 1 over
    ``seq_axis``) — activations follow data under jit, so the batch
    shard is the honest static estimate for intermediate buffers too.
    """
    if not spec or not shape:
        return 1
    axes = spec.get("axes") or {}
    if kind in ("param", "state"):
        rules = spec.get("param_rules" if kind == "param"
                         else "state_rules") or []
        for pat, axspec in rules:
            try:
                hit = re.search(pat, name or "")
            except re.error:
                hit = None
            if hit:
                return _axspec_divisor(shape, axspec, axes)
        return 1
    div = 1
    ba, sa = spec.get("batch_axis"), spec.get("seq_axis")
    if ba and len(shape) >= 1 and int(shape[0]) % int(axes[ba]) == 0:
        div *= int(axes[ba])
    if sa and len(shape) >= 2 and int(shape[1]) % int(axes[sa]) == 0:
        div *= int(axes[sa])
    return div


class DonationCheck(object):
    """Reasoned verdict over one donate spec ({input name: output
    index}), mirroring ShardingCheck: ``accepted`` iff every donated
    input is statically provably dead once its aliasing output
    materializes; ``reasons`` pin the violating node otherwise."""

    def __init__(self, accepted, per_input=None, reasons=()):
        self.accepted = bool(accepted)
        self.per_input = dict(per_input or {})
        self.reasons = list(reasons)

    def to_dict(self):
        return {"accepted": self.accepted,
                "per_input": self.per_input,
                "reasons": list(self.reasons)}

    def __repr__(self):
        return "<DonationCheck accepted=%s inputs=%d>" % (
            self.accepted, len(self.per_input))


def _dt_name(dt):
    d = as_dtype(dt)
    return d if isinstance(d, str) else d.name


def _ancestors(node):
    """ids of every node reachable backwards from ``node`` (exclusive)."""
    seen = set()
    stack = [i for (i, _ix) in node.inputs]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        stack.extend(i for (i, _ix) in n.inputs)
    return seen


def _run_donation(view, shapes, dtypes, donate):
    """The soundness proof.  A donated input d aliasing output o is
    sound iff (a) d is a graph input with the output's exact
    shape+dtype, and (b) every consumer of d is the output's producing
    node or one of its ancestors — then every read of the donated
    buffer is ordered before the write that overwrites it in ANY valid
    schedule.  A consumer outside that ancestor set means some schedule
    clobbers the buffer before its last read: REJECT, naming the node.
    """
    vars_by_name = {v.name: v for v in view.variables()}
    per_input, reasons = {}, []
    for name in sorted(donate):
        out_idx = int(donate[name])
        entry_ok, reason, pin = True, None, None
        var = vars_by_name.get(name)
        if var is None:
            entry_ok = False
            reason = ("donated input %r is not a graph input variable"
                      % name)
        elif not (0 <= out_idx < len(view.heads)):
            entry_ok = False
            reason = ("donated input %r aliases output #%d but the "
                      "graph has %d output(s)"
                      % (name, out_idx, len(view.heads)))
        else:
            head, hix = view.heads[out_idx]
            in_shape = shapes.get((id(var), 0))
            out_shape = shapes.get((id(head), hix))
            in_dt = dtypes.get((id(var), 0), _F32)
            out_dt = dtypes.get((id(head), hix), _F32)
            if in_shape is None or out_shape is None:
                entry_ok = False
                reason = ("donated input %r: shapes unresolved, alias "
                          "soundness cannot be proven" % name)
            elif tuple(in_shape) != tuple(out_shape) \
                    or not same_dtype(in_dt, out_dt):
                entry_ok = False
                pin = head
                reason = ("donated input %r %s%s cannot alias output "
                          "#%d @ %s %s%s (shape/dtype mismatch)"
                          % (name, tuple(in_shape), _dt_name(in_dt),
                             out_idx, head.name, tuple(out_shape),
                             _dt_name(out_dt)))
            elif head is not var:
                anc = _ancestors(head)
                for n in view.topo:
                    if n.op is None:
                        continue
                    if not any(i is var for (i, _ix) in n.inputs):
                        continue
                    if n is head or id(n) in anc:
                        continue
                    entry_ok = False
                    pin = n
                    reason = ("donated input %r is read by %s (%s) "
                              "which is NOT ordered before aliasing "
                              "output #%d @ %s — the in-place write "
                              "may clobber the buffer before its last "
                              "read"
                              % (name, n.name, n.op.name, out_idx,
                                 head.name))
                    break
        per_input[name] = {"sound": entry_ok, "output": out_idx,
                           "reason": reason,
                           "node": pin.name if pin is not None else None}
        if not entry_ok:
            reasons.append(reason)
    return DonationCheck(not reasons, per_input, reasons), \
        [(per_input[k]["node"], per_input[k]["reason"])
         for k in per_input if not per_input[k]["sound"]]


@register_pass
class MemoryPass(AnalysisPass):
    """Liveness + peak-memory watermark from the shape environment.

    Products on the context (consumed by :func:`plan_memory`):
    ``ctx.memory`` =
    {"param_bytes", "input_bytes", "output_bytes",
    "transient_peak_bytes", "peak_bytes", "per_node_top", "inplace",
    "inplace_savings_bytes", "donation", "skipped_nodes", "sharded"}.
    Nodes with unresolved shapes are skipped (the shapes pass already
    diagnosed them); the watermark is then a lower bound and the
    summary says so.
    """

    name = "memory"

    def run(self, ctx, report):
        view = ctx.ensure_view()
        shapes, dtypes = ctx.shapes, ctx.node_dtypes
        spec = getattr(ctx, "shard_spec", None)
        donate = getattr(ctx, "donate", None)
        state_names = frozenset(ctx.pad_dirty or ())
        topo = view.topo
        index = view.node_index

        def entry_bytes(node, ix, kind):
            shp = shapes.get((id(node), ix))
            if shp is None:
                return None
            raw = _prod(shp) * _itemsize(dtypes.get((id(node), ix), _F32))
            return raw // max(
                shard_divisor(spec, node.name, shp, kind=kind), 1)

        # -- classify inputs vs resident params --------------------------
        param_bytes = input_bytes = 0
        skipped = 0
        for v in view.variables():
            if v.name in ctx.data_shapes:
                kind = "state" if v.name in state_names else "input"
            else:
                kind = "param"
            b = entry_bytes(v, 0, kind)
            if b is None:
                skipped += 1
                continue
            if kind == "param":
                param_bytes += b
            else:
                input_bytes += b

        # -- last use per produced entry ---------------------------------
        # heads live to the end; alias ops (views) keep their source
        # alive as long as the view is (propagated in reverse topo so
        # alias chains fold onto the real buffer).
        INF = len(topo) + 1
        last_use = {}
        for n in topo:
            if n.op is None:
                continue
            i = index[id(n)]
            for (src, ix) in n.inputs:
                key = (id(src), ix)
                if last_use.get(key, -1) < i:
                    last_use[key] = i
        head_entries = set()
        for (h, hix) in view.heads:
            head_entries.add((id(h), hix))
            last_use[(id(h), hix)] = INF
        for n in reversed(topo):
            if n.op is None or n.op.name not in _ALIAS_OPS:
                continue
            if not n.inputs:
                continue
            src, ix = n.inputs[0]
            mine = last_use.get((id(n), 0), -1)
            if last_use.get((id(src), ix), -1) < mine:
                last_use[(id(src), ix)] = mine

        # -- donation gate ------------------------------------------------
        donation = None
        alias_credit = set()        # head entries priced at 0 bytes
        if donate:
            donation, failures = _run_donation(view, shapes, dtypes,
                                               donate)
            ctx.memory_donation = donation
            for name, info in donation.per_input.items():
                if info["sound"]:
                    alias_credit.add(
                        (id(view.heads[info["output"]][0]),
                         view.heads[info["output"]][1]))
            for node, reason in failures:
                report.add(Diagnostic(
                    Severity.WARNING, self.name,
                    "unsound donation: %s" % reason, node=node))
            if donation.accepted:
                report.add(Diagnostic(
                    Severity.INFO, self.name,
                    "donation spec sound: %d input(s) provably dead "
                    "before their aliasing outputs materialize"
                    % len(donation.per_input)))

        # -- linear-scan watermark ---------------------------------------
        free_at = {}
        for key, lu in last_use.items():
            free_at.setdefault(lu, []).append(key)
        ebytes = {}             # produced-entry -> priced bytes
        live = input_bytes      # argument buffers live for the program
        peak = live
        output_bytes = 0
        per_node = []
        for n in topo:
            if n.op is None:
                continue
            i = index[id(n)]
            alias = n.op.name in _ALIAS_OPS
            out_total = 0
            try:
                nout = n.num_outputs()
            except Exception:
                nout = 1
            for ix in range(nout):
                key = (id(n), ix)
                if alias or key in alias_credit:
                    b = 0
                else:
                    b = entry_bytes(n, ix, "act")
                    if b is None:
                        skipped += 1
                        b = 0
                ebytes[key] = b
                out_total += b
                if key in head_entries:
                    output_bytes += b
            live += out_total
            if live > peak:
                peak = live
            if out_total:
                per_node.append((out_total, n.name, n.op.name,
                                 param_bytes + live))
            for key in free_at.get(i, ()):
                live -= ebytes.get(key, 0)

        per_node.sort(key=lambda t: (-t[0], t[1]))
        top = [{"node": name, "op": op, "out_bytes": b, "live_bytes": lv}
               for (b, name, op, lv) in per_node[:8]]

        # -- in-place / co-share opportunities ---------------------------
        inplace, savings = [], 0
        for n in topo:
            if n.op is None or n.op.name not in _INPLACE_OPS:
                continue
            try:
                if n.num_outputs() != 1:
                    continue
            except Exception:
                pass
            i = index[id(n)]
            ob = ebytes.get((id(n), 0), 0)
            odt = dtypes.get((id(n), 0), _F32)
            if not ob:
                continue
            for (src, ix) in n.inputs:
                if src.op is None:        # caller-owned argument buffer
                    continue
                key = (id(src), ix)
                if key in head_entries or last_use.get(key) != i:
                    continue
                if ebytes.get(key, -1) != ob \
                        or not same_dtype(dtypes.get(key, _F32), odt):
                    continue
                inplace.append({"node": n.name, "op": n.op.name,
                                "reuses": src.name, "bytes": ob})
                savings += ob
                break

        ctx.memory = {
            "param_bytes": int(param_bytes),
            "input_bytes": int(input_bytes),
            "output_bytes": int(output_bytes),
            "transient_peak_bytes": int(peak),
            "peak_bytes": int(param_bytes + peak),
            "per_node_top": top,
            "inplace": inplace,
            "inplace_savings_bytes": int(savings),
            "donation": donation.to_dict() if donation else None,
            "skipped_nodes": skipped,
            "sharded": bool(spec),
        }
        report.add(Diagnostic(
            Severity.INFO, self.name,
            "predicted peak HBM %s: params %s + transient %s "
            "(inputs %s, outputs %s) over %d op node(s)%s%s"
            % (_fmt(param_bytes + peak), _fmt(param_bytes), _fmt(peak),
               _fmt(input_bytes), _fmt(output_bytes),
               len(view.op_nodes()),
               ", sharded" if spec else "",
               (", %d entr(ies) skipped (unresolved shapes) — "
                "watermark is a lower bound" % skipped) if skipped
               else "")))
        if inplace:
            report.add(Diagnostic(
                Severity.INFO, self.name,
                "in-place opportunities: %d op(s) could reuse a dead "
                "input buffer, %s reclaimable (future paging/planner "
                "work)" % (len(inplace), _fmt(savings))))


def _fmt(b):
    b = float(b)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024.0 or unit == "GiB":
            return ("%.1f%s" if unit != "B" else "%.0f%s") % (b, unit)
        b /= 1024.0


#: human-readable bytes for engine warnings / lint output
format_bytes = _fmt


def plan_digest(plan):
    """Short content digest of one memory plan: a stable key that
    changes whenever any number of the plan does."""
    import hashlib
    import json
    return hashlib.sha256(
        json.dumps(plan, sort_keys=True, default=str,
                   separators=(",", ":")).encode()).hexdigest()[:12]


def plan_memory(symbol, data_shapes, dtypes=None, training=False,
                sharding=None, donate=None, state_names=(), policy=None):
    """One program's memory plan: runs verify+shapes+memory and returns
    ``(plan dict, Report)`` — ``plan`` is the ``ctx.memory`` product
    (None when the graph is structurally broken).  ``donate`` maps
    input name -> aliased output index; ``state_names`` mark inputs
    priced as slot state.  ``sharding`` (a plan spec of the JAX
    package's ``parallel/mesh.py``) raises: sharding plans are not
    ported yet (ROADMAP Queue A, item 7)."""
    spec = None
    if sharding is not None:
        raise MXNetError(
            "plan_memory: sharding plan specs need parallel/mesh.py, "
            "which the port does not have yet (ROADMAP Queue A, item 7)")
    report, ctx = analyze(symbol, data_shapes=data_shapes, dtypes=dtypes,
                          training=training, policy=policy,
                          pad_dirty=state_names,
                          passes=("verify", "shapes", "memory"),
                          shard_spec=spec, donate=donate)
    return getattr(ctx, "memory", None), report


def predict_peak_bytes(symbol, data_shapes, **kw):
    """Predicted peak device bytes (params resident + transient
    high-water)
    for one execution of ``symbol`` under ``data_shapes``.  Raises
    :class:`MXNetError` when the graph defeats the planner."""
    plan, report = plan_memory(symbol, data_shapes, **kw)
    if not plan:
        raise MXNetError("memory pass produced no plan (structural "
                         "failure?):\n%s" % report.format())
    return int(plan["peak_bytes"])


def check_donation(symbol, data_shapes, donate, dtypes=None,
                   training=False):
    """Stand-alone donation/aliasing soundness gate: returns a
    :class:`DonationCheck` whose ``reasons`` pin the violating node
    when a donated input cannot be statically proven dead before its
    aliasing output materializes."""
    _plan, report = plan_memory(symbol, data_shapes, dtypes=dtypes,
                                training=training, donate=donate)
    check = None
    if _plan and _plan.get("donation") is not None:
        d = _plan["donation"]
        check = DonationCheck(d["accepted"], d["per_input"], d["reasons"])
    if check is None:
        check = DonationCheck(False, {}, [
            "memory pass produced no donation verdict (structural "
            "failure?):\n%s" % report.format()])
    return check


def device_memory_budget(device=None):
    """Per-device memory budget in bytes for an OOM preflight:
    ``MXNET_MEMORY_BUDGET_BYTES`` when set (>0), else the CUDA card's
    total memory (``torch.cuda.mem_get_info``).  ``device`` is a
    Context, a torch device or a card index; None is the current card.
    Returns None on the CPU or without a card and no override —
    prediction still runs, capacity refusal does not."""
    import torch
    from .. import config
    b = int(config.get("MXNET_MEMORY_BUDGET_BYTES"))
    if b > 0:
        return b
    dev = getattr(device, "device", device)
    if dev is None:
        if not torch.cuda.is_available():
            return None
        dev = torch.cuda.current_device()
    dev = torch.device("cuda", dev) if isinstance(dev, int) \
        else torch.device(dev)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(dev)[1]) or None
