"""Retrace-hazard linter + host-sync detector.

Counterpart of ``mxnet_tpu/analysis/retrace.py``.  The serving
contract is "build once, dispatch forever": the ``ProgramCache`` keeps
one prepared program per input-shape signature and quantizes traffic
onto a bucket grid so the program count stays flat after warmup.
Everything that silently violates that contract is a *retrace hazard*.
Statically detectable hazards:

- **unbucketed dynamic dims**: a data dim declared dynamic (0/None)
  that no BucketPolicy quantizes builds one program per distinct
  size — an unbounded program population under real traffic;
- **shape-literal attrs downstream of a dynamic dim**: a Reshape /
  broadcast_to / tile with a fully-literal target freezes one concrete
  size into the graph — off that size the op fails;
- **cache-busting attrs**: an attr holding a host ndarray cannot be
  hashed into a program key nor written to the symbol JSON;
- **scalar-capture fingerprints**: many sibling nodes of the same
  ``*_scalar`` op differing only in their constant is the footprint of
  a Python scalar captured per trace (Gluon hybridize closure capture)
  — each new value busts the graph signature;
- **mode-dependent ops**: train/predict each build their own program
  (expected, but worth surfacing in a program-count estimate).

The **host-sync detector** flags ops whose impl reads device values
back on the host (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``torch.cuda.synchronize``): inside a serving hot path every dispatch
then waits for the card to drain before the host can go on.  The
registry's ``host_sync`` flag is authoritative; the source scan catches
impls that forgot to declare it.  The JAX package scans for its own
host bridges (``pure_callback``/``io_callback``) instead, so the two
packages' findings differ exactly where one backend's op syncs and the
other's does not.
"""
from __future__ import annotations

import inspect
import re

import numpy as _np

from .core import AnalysisPass, register_pass
from .diagnostics import Diagnostic, Severity

__all__ = ["RetraceHazardPass"]

_HOST_SYNC_RE = re.compile(
    r"\.(item|tolist|cpu|numpy)\(\)|\btorch\.cuda\.synchronize\b")
_host_sync_cache = {}


def _op_host_syncs(op):
    """Does this op's impl read device values back on the host per
    dispatch?  The registry's ``host_sync`` declaration is
    authoritative; impls that forgot to declare are caught by scanning
    their source for torch's host round trips."""
    if getattr(op, "host_sync", False):
        return True
    hit = _host_sync_cache.get(op.name)
    if hit is None:
        try:
            src = inspect.getsource(op.impl)
        except (OSError, TypeError):
            src = ""
        hit = bool(_HOST_SYNC_RE.search(src))
        _host_sync_cache[op.name] = hit
    return hit


def _is_pow2(n):
    return n >= 1 and (n & (n - 1)) == 0


@register_pass
class RetraceHazardPass(AnalysisPass):
    name = "retrace"

    def run(self, ctx, report):
        view = ctx.ensure_view()
        dyn_vars = self._dynamic_inputs(ctx, report)
        reachable = self._reachable_from(view, dyn_vars)
        program_estimate = 1

        seq_buckets = getattr(ctx.policy, "seq_buckets", None)
        if ctx.policy is not None:
            program_estimate *= len(ctx.policy.batch_buckets())
            if seq_buckets:
                program_estimate *= len(seq_buckets)

        scalar_groups = {}
        mode_dependent = False
        for node in view.op_nodes():
            prov = view.provenance(node)
            if _op_host_syncs(node.op):
                report.add(Diagnostic(
                    Severity.WARNING, self.name,
                    "host sync: impl reads device values back on the "
                    "host (.item()/.tolist()/.cpu()/.numpy()/"
                    "synchronize) — every dispatch waits for the card "
                    "to drain before the host goes on; keep this op "
                    "out of serving hot paths",
                    node=node.name, op=node.op.name, provenance=prov))
            mode_dependent |= bool(node.op.mode_dependent)
            self._check_attr_values(node, prov, report)
            if id(node) in reachable:
                self._check_shape_literals(node, prov, report)
            sc = node.attrs.get("scalar")
            if isinstance(sc, (int, float)):
                key = (node.op.name,
                       tuple(inp.op.name if inp.op else "var"
                             for (inp, _) in node.inputs))
                scalar_groups.setdefault(key, set()).add(float(sc))

        for (op_name, _), values in scalar_groups.items():
            if len(values) >= 3:
                report.add(Diagnostic(
                    Severity.INFO, self.name,
                    "%d sibling %s nodes differ only in their scalar "
                    "constant — the fingerprint of a Python scalar "
                    "captured at trace time; passing it as a graph "
                    "input would share one program across values"
                    % (len(values), op_name)))

        if ctx.policy is not None:
            if mode_dependent:
                program_estimate *= 2   # train + predict each compile
            report.add(Diagnostic(
                Severity.INFO, self.name,
                "bucket grid bounds the warm program population at "
                "~%d program(s) (batch buckets x seq buckets%s)"
                % (program_estimate,
                   " x train/predict modes" if mode_dependent else "")))

    # ------------------------------------------------------------------
    def _dynamic_inputs(self, ctx, report):
        """Vars with dynamic dims; flags the unbucketed ones."""
        view = ctx.view
        byname = {n.name: n for n in view.variables()}
        dyn = {}
        for name, shape in ctx.data_shapes.items():
            if shape is None or name not in byname:
                continue
            axes = [ax for ax, d in enumerate(shape) if d in (0, None)]
            if not axes:
                continue
            dyn[name] = axes
            # axes the policy quantizes, in GRAPH coordinates: batch
            # buckets absorb axis 0, and seq buckets absorb the seq
            # axis — taken from ctx.pad_axes when the caller mapped it
            # explicitly, else policy.seq_axis + 1 (policy axes are
            # per-example; the batch dim sits in front in graph coords)
            seq_covered = set()
            seq_buckets = getattr(ctx.policy, "seq_buckets", None)
            seq_axis = getattr(ctx.policy, "seq_axis", None)
            if seq_buckets:
                if ctx.pad_axes and "seq" in ctx.pad_axes:
                    seq_covered = set(ctx.pad_axes["seq"].values())
                elif seq_axis is not None:
                    seq_covered = {seq_axis + 1}
            for ax in axes:
                if ctx.policy is not None and ax == 0:
                    report.add(Diagnostic(
                        Severity.INFO, self.name,
                        "dynamic batch axis of %r rides the pow2 batch "
                        "buckets (<= %d programs)"
                        % (name, len(ctx.policy.batch_buckets())),
                        node=name))
                    continue
                if ax in seq_covered:
                    bad = [b for b in seq_buckets if not _is_pow2(b)]
                    if bad:
                        report.add(Diagnostic(
                            Severity.INFO, self.name,
                            "dynamic dim %d of %r rides non-pow2 seq "
                            "buckets %s — legal, but off-grid sizes "
                            "between buckets still pad up"
                            % (ax, name, bad), node=name))
                    continue
                report.add(Diagnostic(
                    Severity.WARNING, self.name,
                    "dynamic dim %d of %r is not quantized by any "
                    "bucket policy: every distinct size builds a new "
                    "program (ProgramCache.compile_count grows with "
                    "traffic, unbounded)" % (ax, name), node=name))
        return dyn

    @staticmethod
    def _reachable_from(view, dyn_vars):
        if not dyn_vars:
            return set()
        reach = {id(n) for n in view.variables() if n.name in dyn_vars}
        for node in view.topo:
            if node.op is None:
                continue
            if any(id(inp) in reach for (inp, _) in node.inputs):
                reach.add(id(node))
        return reach

    def _check_shape_literals(self, node, prov, report):
        """A fully-literal shape attr downstream of a dynamic dim pins
        one concrete size into the graph."""
        attr_name = {"Reshape": "shape", "broadcast_to": "shape",
                     "tile": "reps"}.get(node.op.name)
        if attr_name is None:
            return
        target = node.attrs.get(attr_name) or ()
        if not target:
            return
        if node.op.name == "Reshape" and any(d in (0, -1, -2, -3, -4)
                                             for d in target):
            return      # wildcard entries keep it shape-polymorphic
        report.add(Diagnostic(
            Severity.WARNING, self.name,
            "shape-literal attr %s=%s sits downstream of a dynamic "
            "dim: it freezes one concrete size, so other request "
            "sizes retrace or fail — use wildcard dims (0/-1) or "
            "shape-polymorphic ops" % (attr_name, tuple(target)),
            node=node.name, op=node.op.name, provenance=prov))

    def _check_attr_values(self, node, prov, report):
        for k, v in node.attrs.items():
            if isinstance(v, _np.ndarray):
                report.add(Diagnostic(
                    Severity.WARNING, self.name,
                    "attr %r holds a host ndarray: it cannot be "
                    "hashed into a program key nor written to the "
                    "symbol JSON, so every call rebuilds it" % k,
                    node=node.name, op=node.op.name, provenance=prov))
