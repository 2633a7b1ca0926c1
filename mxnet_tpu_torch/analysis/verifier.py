"""Graph verifier: IR well-formedness before anything runs.

Counterpart of ``mxnet_tpu/analysis/verifier.py``.  Reference gap this
closes: the reference validates a graph only when it binds
(GraphExecutor::Init) or dispatches (InvokeOperator), so a malformed
symbol fails deep inside executor.py with no provenance. Relay's type
checker (PAPERS.md) demonstrates the alternative: certify the IR once,
up front.  Checks, in dependency order:

1. **acyclicity** — tricolor DFS (``graph.find_cycle``); a cycle gates
   every later pass, since topological traversals silently mis-order
   cyclic graphs instead of failing;
2. **dangling output references** — an input edge ``(producer, k)`` with
   ``k >= producer.num_outputs()`` reads a tensor that does not exist;
3. **name discipline** — two distinct *variable* nodes sharing a name is
   an error (infer_shape kwargs, executor arg binding, and JSON
   round-trips all key on the name); duplicate *op* names only warn
   (attr_dict/output-name collisions);
4. **registry consistency** — the node's op must resolve in the central
   registry (else the graph cannot round-trip through tojson/load_json);
5. **arity** — input count vs the registry's declared signature
   (``key_var_num_args`` for variadic ops);
6. **attr schema** — every attr re-validated against the op's typed
   Param schema (the dmlc::Parameter contract), catching attrs that were
   mutated after construction or deserialized from a corrupt JSON.
"""
from __future__ import annotations

from ..base import ParamError, MXNetError
from ..ops.registry import get_op
from .core import AnalysisPass, register_pass
from .diagnostics import Diagnostic, Severity
from .graph import find_cycle

__all__ = ["VerifierPass"]


@register_pass
class VerifierPass(AnalysisPass):
    name = "verify"

    def run(self, ctx, report):
        cycle = find_cycle(ctx.symbol._outputs)
        if cycle is not None:
            ctx.structural_ok = False
            report.add(Diagnostic(
                Severity.ERROR, self.name,
                "graph contains a cycle: %s" % " -> ".join(cycle),
                node=cycle[0]))
            return
        ctx.structural_ok = True
        view = ctx.ensure_view()

        self._check_names(view, report)
        for node in view.topo:
            if node.op is None:
                continue
            prov = view.provenance(node)
            self._check_edges(node, prov, report)
            self._check_registry(node, prov, report)
            self._check_arity_and_attrs(node, prov, report)
        self._check_heads(view, report)

    # ------------------------------------------------------------------
    def _check_names(self, view, report):
        seen = {}
        for node in view.topo:
            kind = "variable" if node.op is None else "op"
            if not node.name:
                report.add(Diagnostic(
                    Severity.ERROR, self.name,
                    "unnamed %s node (naming is the graph's span "
                    "information; NameManager assigns one at creation)"
                    % kind, node=repr(node)))
                continue
            prev = seen.get(node.name)
            if prev is None:
                seen[node.name] = kind
                continue
            if kind == "variable" and prev == "variable":
                report.add(Diagnostic(
                    Severity.ERROR, self.name,
                    "duplicate argument name %r: two distinct variable "
                    "nodes share it, so infer_shape kwargs and executor "
                    "arg binding resolve ambiguously" % node.name,
                    node=node.name))
            else:
                report.add(Diagnostic(
                    Severity.WARNING, self.name,
                    "duplicate node name %r (%s vs %s): attr_dict and "
                    "output naming collide" % (node.name, prev, kind),
                    node=node.name))

    def _check_edges(self, node, prov, report):
        for pos, (inp, out_idx) in enumerate(node.inputs):
            try:
                nout = inp.num_outputs()
            except Exception:
                nout = 1        # producer's own attrs are broken; its
                #                 schema check reports that separately
            if out_idx < 0 or out_idx >= nout:
                report.add(Diagnostic(
                    Severity.ERROR, self.name,
                    "input %d references output %d of %r, which has "
                    "only %d output(s) — dangling edge"
                    % (pos, out_idx, inp.name, nout),
                    node=node.name, op=node.op.name, provenance=prov))

    def _check_registry(self, node, prov, report):
        try:
            registered = get_op(node.op.name)
        except MXNetError:
            report.add(Diagnostic(
                Severity.ERROR, self.name,
                "op %r is not in the registry: the graph cannot "
                "round-trip through tojson/load_json" % node.op.name,
                node=node.name, op=node.op.name, provenance=prov))
            return
        if registered is not node.op:
            report.add(Diagnostic(
                Severity.WARNING, self.name,
                "op %r resolves to a different OpDef than this node "
                "holds (shadowed registration?)" % node.op.name,
                node=node.name, op=node.op.name, provenance=prov))

    def _check_arity_and_attrs(self, node, prov, report):
        op = node.op
        core = {k: v for k, v in node.attrs.items()
                if not k.startswith("_")}
        try:
            norm = op.normalize(dict(node.attrs))
        except ParamError as e:
            report.add(Diagnostic(
                Severity.ERROR, self.name,
                "attr schema violation: %s" % e,
                node=node.name, op=op.name, provenance=prov))
            norm = core     # arity check proceeds on raw attrs
        n_in = len(node.inputs)
        if op.variable_inputs:
            declared = norm.get(op.key_var_num_args or "num_args")
            if declared is not None and int(declared or 0) not in (0, n_in):
                report.add(Diagnostic(
                    Severity.ERROR, self.name,
                    "arity mismatch: attr %s=%s but node has %d inputs"
                    % (op.key_var_num_args, declared, n_in),
                    node=node.name, op=op.name, provenance=prov))
            return
        try:
            expected = op.input_names(norm, num_inputs=n_in)
        except Exception:
            return          # signature needs attrs the schema rejected
        if n_in != len(expected):
            report.add(Diagnostic(
                Severity.ERROR, self.name,
                "arity mismatch: registry declares %d input(s) %s, "
                "node has %d" % (len(expected), expected, n_in),
                node=node.name, op=op.name, provenance=prov))

    def _check_heads(self, view, report):
        for i, (node, out_idx) in enumerate(view.heads):
            try:
                nout = node.num_outputs()
            except Exception:
                continue
            if out_idx < 0 or out_idx >= nout:
                report.add(Diagnostic(
                    Severity.ERROR, self.name,
                    "head %d references output %d of %r, which has only "
                    "%d output(s)" % (i, out_idx, node.name, nout),
                    node=node.name,
                    op=node.op.name if node.op else None))
