"""Shape/dtype abstract interpretation with per-node provenance.

Counterpart of ``mxnet_tpu/analysis/shapes.py``: ``symbol.
infer_graph_env`` re-run as a *diagnosing* pass.  The same forward fixed
point runs each op's impl on ``device="meta"`` tensors (shapes and
dtypes, no data, no kernel launch), but instead of raising one bare
``MXNetError`` at the first failure it keeps walking, and every failure
becomes a Diagnostic that names the node, shows the concrete input
shapes that reached it, and traces where they flowed from — "node `fc1`
(FullyConnected): ...; inputs: data=(8, 3, 224, 224)  [data -> conv0 ->
fc1]" instead of a stack trace out of the executor.

Dtypes stay in the analysis's numpy vocabulary (``core.as_dtype``: numpy
dtypes, bfloat16 by name); they become torch dtypes only where a meta
tensor is made.

Dynamic dims (0/None entries in ``data_shapes``) are abstracted to a
representative concrete size for interpretation — the smallest
configured seq bucket when a policy has one, else 2 — and noted, so
shape errors found here hold for the whole family of shapes serving
will actually dispatch.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..ops.registry import torch_dtype
from .core import AnalysisPass, register_pass, as_dtype
from .diagnostics import Diagnostic, Severity

__all__ = ["ShapeDtypePass"]

_REPR_DYN = 2   # stand-in extent for a dynamic dim with no bucket grid


def _fmt_shape(s):
    return "?" if s is None else str(tuple(s))


@register_pass
class ShapeDtypePass(AnalysisPass):
    name = "shapes"

    def run(self, ctx, report):
        view = ctx.ensure_view()
        f32 = _np.dtype(_np.float32)
        shapes, dtypes = ctx.shapes, ctx.node_dtypes

        # -- seed variables ------------------------------------------------
        dyn_subst = {}
        for n in view.variables():
            shape = None
            if n.name in ctx.data_shapes and ctx.data_shapes[n.name]:
                shape = ctx.data_shapes[n.name]
            elif "__shape__" in n.attrs:
                shape = tuple(n.attrs["__shape__"])
            if shape is not None:
                conc, subst = self._concretize(ctx, shape)
                if subst:
                    dyn_subst[n.name] = (shape, conc)
                shapes[(id(n), 0)] = conc
            if n.name in ctx.dtypes:
                want = as_dtype(ctx.dtypes[n.name])
                dtypes[(id(n), 0)] = want
                declared = n.attrs.get("__dtype__")
                if declared is not None and as_dtype(declared) != want:
                    report.add(Diagnostic(
                        Severity.WARNING, self.name,
                        "dtype %s requested for %r, but the variable "
                        "declares __dtype__=%s" % (want, n.name, declared),
                        node=n.name))
            elif "__dtype__" in n.attrs:
                dtypes[(id(n), 0)] = as_dtype(n.attrs["__dtype__"])
        for name, (orig, conc) in dyn_subst.items():
            report.add(Diagnostic(
                Severity.INFO, self.name,
                "dynamic dims in %r abstracted %s -> %s for "
                "interpretation" % (name, _fmt_shape(orig),
                                    _fmt_shape(conc)), node=name))

        # -- forward fixed point ------------------------------------------
        failed = set()      # nodes already diagnosed: report each once
        max_passes = max(3, len(view.topo))
        for _ in range(max_passes):
            progressed = False
            for n in view.topo:
                if n.op is None or id(n) in failed:
                    continue
                if all((id(n), i) in shapes
                       for i in range(self._nout(n))):
                    continue
                try:
                    attrs = n.op.normalize(n.attrs)
                except Exception:
                    failed.add(id(n))   # verifier already reported this
                    continue
                in_keys = [(id(i), ix) for (i, ix) in n.inputs]
                in_shapes = [shapes.get(k) for k in in_keys]
                in_dtypes = [dtypes.get(k, f32) for k in in_keys]
                if n.op.fill_shapes is not None:
                    try:
                        filled = list(n.op.fill_shapes(attrs,
                                                       list(in_shapes)))
                    except Exception as e:
                        self._fail(ctx, report, failed, n, in_shapes, e,
                                   stage="parameter shape completion")
                        continue
                    for k, s_old, s_new in zip(in_keys, in_shapes, filled):
                        if s_old is None and s_new is not None:
                            shapes[k] = tuple(s_new)
                            progressed = True
                    in_shapes = [shapes.get(k) for k in in_keys]
                if any(s is None for s in in_shapes):
                    continue        # blocked; maybe a later sweep fills it
                try:
                    metas = [torch.empty(tuple(s), dtype=torch_dtype(d),
                                         device="meta")
                             for s, d in zip(in_shapes, in_dtypes)]
                    out = n.op.bound(attrs, ctx.training)(*metas)
                except Exception as e:
                    self._fail(ctx, report, failed, n, in_shapes, e)
                    continue
                for i, o in enumerate(out):
                    shapes[(id(n), i)] = tuple(o.shape)
                    dtypes[(id(n), i)] = as_dtype(o.dtype)
                progressed = True
            if not progressed:
                break

        # -- anything still unresolved? -----------------------------------
        self._report_blocked(ctx, report, view, shapes, failed)

    # ------------------------------------------------------------------
    @staticmethod
    def _nout(n):
        try:
            return n.num_outputs()
        except Exception:
            return 1

    def _concretize(self, ctx, shape):
        """Replace dynamic (0/None) dims with a representative size."""
        conc, subst = [], False
        seq_buckets = getattr(ctx.policy, "seq_buckets", None)
        for ax, d in enumerate(shape):
            if d in (0, None):
                subst = True
                conc.append(seq_buckets[0] if seq_buckets else _REPR_DYN)
            else:
                conc.append(int(d))
        return tuple(conc), subst

    def _fail(self, ctx, report, failed, n, in_shapes, err,
              stage="shape inference"):
        failed.add(id(n))
        view = ctx.view
        try:
            names = n.op.input_names(dict(n.attrs),
                                     num_inputs=len(n.inputs))
        except Exception:
            names = []
        if len(names) != len(n.inputs):
            names = [inp.name for (inp, _) in n.inputs]
        ins = ", ".join("%s=%s" % (nm, _fmt_shape(s))
                        for nm, s in zip(names, in_shapes))
        msg = str(err).strip().split("\n")[0]
        report.add(Diagnostic(
            Severity.ERROR, self.name,
            "%s failed: %s; inputs: %s" % (stage, msg, ins),
            node=n.name, op=n.op.name, provenance=view.provenance(n)))

    def _report_blocked(self, ctx, report, view, shapes, failed):
        """Name the FIRST node (topo order) whose output shapes stayed
        unknown without an error of its own — it is blocked on unknown
        inputs, and saying *which* is the actionable part."""
        for n in view.topo:
            if n.op is None or id(n) in failed:
                continue
            if all((id(n), i) in shapes for i in range(self._nout(n))):
                continue
            unknown = [inp.name for (inp, ix) in n.inputs
                       if (id(inp), ix) not in shapes]
            report.add(Diagnostic(
                Severity.WARNING, self.name,
                "shapes unresolved: blocked waiting on input(s) %s — "
                "provide shapes for the unshaped graph inputs"
                % unknown, node=n.name, op=n.op.name,
                provenance=view.provenance(n)))
            return
