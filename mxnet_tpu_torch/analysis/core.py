"""Pass framework: context, registry, and the `analyze` entry point.

Counterpart of ``mxnet_tpu/analysis/core.py``.  Modeled on TVM's pass
infrastructure (PAPERS.md: Relay's compile-time checking over a typed
graph IR): each pass is a named unit that reads a shared
:class:`AnalysisContext` and appends :class:`Diagnostic`s.  ``analyze``
owns ordering and the structural gate — if the verifier finds the graph
is not a DAG, later passes (which all assume topological order) are
skipped rather than fed garbage.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..ops.registry import dtype_name
from .diagnostics import Diagnostic, Report, Severity
from .graph import GraphView

__all__ = ["AnalysisContext", "AnalysisPass", "register_pass", "get_pass",
           "list_passes", "analyze", "DEFAULT_PASSES", "as_dtype",
           "same_dtype", "itemsize"]


def as_dtype(dt):
    """The analysis's dtype vocabulary, as the JAX package's: a numpy
    dtype, except bfloat16, which numpy lacks without ``ml_dtypes`` and
    is carried as the name ``"bfloat16"``.  Takes a torch or numpy dtype
    or a dtype name; the registry's torch dtypes convert here only."""
    name = dtype_name(dt)
    return name if name == "bfloat16" else np.dtype(name)


def same_dtype(a, b):
    return dtype_name(a) == dtype_name(b)


def itemsize(dt):
    """Bytes per element of any dtype :func:`as_dtype` takes."""
    d = as_dtype(dt)
    return 2 if isinstance(d, str) else int(d.itemsize)

_PASSES = {}

#: pipeline order: structural soundness first, then the abstract
#: interpreter (whose shape environment the linters reuse), then lints.
DEFAULT_PASSES = ("verify", "shapes", "retrace", "padding")


class AnalysisContext(object):
    """Everything a pass may read, plus cross-pass products.

    ``data_shapes`` maps input-variable name -> shape tuple; entries may
    contain 0/None for a dynamic (per-request varying) dim — the retrace
    linter keys on those.  ``policy`` is an optional
    :class:`~mxnet_tpu_torch.serving.BucketPolicy` describing how serving
    quantizes those dynamic dims.  ``pad_axes`` maps input name -> set of
    graph-coordinate axes that serving zero-pads (batch axis and the
    bucketed seq axis).  ``training`` selects which mode the abstract
    interpretation models (BatchNorm batch-stats vs moving-stats, ...).
    """

    def __init__(self, symbol, data_shapes=None, dtypes=None, policy=None,
                 pad_axes=None, training=False, valid_lengths=None,
                 pad_dirty=None, shard_spec=None, donate=None):
        self.symbol = symbol
        self.data_shapes = {k: (tuple(v) if v is not None else None)
                            for k, v in (data_shapes or {}).items()}
        self.dtypes = dict(dtypes or {})
        self.policy = policy
        self.pad_axes = pad_axes
        self.training = training
        # axis label -> name of the graph input carrying each request's
        # live length along that padded axis (what the repair engine's
        # masks read).  Also auto-discovered from variables that declare
        # ``__pad_valid_len__ = <label>`` (rewrite.py marks the inputs
        # it creates, so a repaired graph re-analyzes standalone).
        self.valid_lengths = dict(valid_lengths or {})
        # input names whose PAD slots hold arbitrary stale values, not
        # serving's zeros — the decode engine's slot-resident state: a
        # freed slot's KV cache / hidden state is never rewritten, so
        # the padding pass must not credit zero-absorption (sum over
        # "zero" pads) to those inputs.  Seeds _Pad(zero=False).
        self.pad_dirty = frozenset(pad_dirty or ())
        # memory-planner inputs: a normalized sharding plan spec (buffer
        # bytes divide along plan-partitioned axes) and a donate
        # spec {input name -> aliased output index} for the aliasing
        # soundness gate (memory.py)
        self.shard_spec = shard_spec
        self.donate = dict(donate or {})
        self.view = None          # GraphView, set once certified acyclic
        self.structural_ok = None # verifier verdict; gates later passes
        # products of the shape/dtype abstract interpreter, keyed
        # (id(node), out_idx) exactly like symbol._infer_graph
        self.shapes = {}
        self.node_dtypes = {}
        # padding pass verdicts: axis label -> "row-local"|"cross-position"
        self.pad_verdicts = {}
        # padding pass by-products consumed by rewrite.py:
        # label -> {(id(node), out_idx): _Pad abstract state}, and
        # label -> [PadViolation] (structured cross-position findings
        # with repair hints)
        self.pad_states = {}
        self.pad_violations = {}

    def ensure_view(self):
        if self.view is None:
            self.view = GraphView(self.symbol)
        return self.view


class AnalysisPass(object):
    """Base class: subclasses set ``name`` and implement ``run``."""

    name = None

    def run(self, ctx, report):
        raise NotImplementedError


def register_pass(cls):
    """Class decorator registering an AnalysisPass by its ``name``."""
    if not cls.name:
        raise MXNetError("analysis pass %r has no name" % cls)
    _PASSES[cls.name] = cls
    return cls


def get_pass(name):
    if name not in _PASSES:
        raise MXNetError("unknown analysis pass %r (known: %s)"
                         % (name, sorted(_PASSES)))
    return _PASSES[name]


def list_passes():
    return sorted(_PASSES)


def analyze(symbol, data_shapes=None, dtypes=None, policy=None,
            pad_axes=None, training=False, passes=None,
            valid_lengths=None, pad_dirty=None, shard_spec=None,
            donate=None):
    """Run a pass pipeline over ``symbol``; returns (Report, ctx).

    ``passes`` is an ordered iterable of pass names (default: the full
    suite).  The verifier always runs first even when not requested —
    every other pass assumes a certified DAG.
    """
    names = list(passes if passes is not None else DEFAULT_PASSES)
    if "padding" in names and "shapes" not in names:
        # the padding rules resolve axes/ranks from the shape
        # environment; without it they degrade to blanket conservatism
        names.insert(names.index("padding"), "shapes")
    if "flops" in names and "shapes" not in names:
        # the FLOP formulas read per-node concrete shapes
        names.insert(names.index("flops"), "shapes")
    if "memory" in names and "shapes" not in names:
        # liveness prices buffers off the same shape environment
        names.insert(names.index("memory"), "shapes")
    if "verify" not in names:
        names.insert(0, "verify")
    elif names[0] != "verify":
        names.remove("verify")
        names.insert(0, "verify")
    ctx = AnalysisContext(symbol, data_shapes=data_shapes, dtypes=dtypes,
                          policy=policy, pad_axes=pad_axes,
                          training=training, valid_lengths=valid_lengths,
                          pad_dirty=pad_dirty, shard_spec=shard_spec,
                          donate=donate)
    report = Report()
    for name in names:
        if name != "verify" and ctx.structural_ok is False:
            break       # graph is not a DAG; nothing downstream is safe
        p = get_pass(name)()        # unknown pass names DO raise
        try:
            p.run(ctx, report)
        except Exception as e:      # a linter crash must never take down
            #                         the construction path it guards —
            #                         WARNING, not ERROR, so strict-mode
            #                         construction still builds valid
            #                         graphs (CI --strict still fails)
            report.add(Diagnostic(
                Severity.WARNING, name,
                "analysis pass crashed: %r — please report; remaining "
                "checks of this pass were skipped" % (e,)))
    return report, ctx
