"""Executor: a bound symbol that runs forward, and backward in training.

Counterpart of ``mxnet_tpu/executor.py``.  ``build_graph_fn`` interprets
the symbol's registry impls in topological order; torch runs each op
eagerly on the bound tensors' device, so there is no trace or compile
step.  Aux-state mutation is threaded functionally as in the reference:
an op's aux write-back output replaces that aux entry for downstream
readers and is returned to the caller.

``forward(is_train=True)`` runs the graph in training mode under
autograd, with a fresh leaf for each argument whose gradient is
requested, and writes the aux states back right there, once per step.
(The reference defers a training forward to ``backward``, and applies
the moving averages a second time when the outputs are read before
``backward``; the port does not.)  ``backward`` differentiates the
recorded outputs: loss heads ignore the head gradient, so
``backward()`` needs none, and an argument the outputs do not depend on
gets a zero gradient.  ``set_monitor_callback`` reports each output by
name after every forward (under ``monitor_all`` each argument and aux
state first), as ``Monitor`` reads them.

Telemetry, under the reference's names: ``mxnet_xla_traces_total``
counts the graph programs built across the process (an Executor builds
one per mode, eval and training, at its first forward in that mode; a
CachedOp one per input signature; the serving caches one per bucket;
``xla_traces_ever`` counts them whatever the telemetry switch), and
``mxnet_executor_dispatch_total{kind}`` the dispatches: ``forward`` for
an eval forward, ``forward_backward`` for a ``backward`` (whose
training forward ran in ``forward(is_train=True)``).  The batch upload
is the training step's ``h2d`` phase; ``executor.forward`` and
``executor.forward_backward`` spans land in the active trace, and the
profiler's ``forward``/``forward_backward`` spans in its ring.
"""
from __future__ import annotations

import collections

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray, _host_tensor
from .symbol.symbol import _topo

__all__ = ["Executor", "build_graph_fn"]


_TM_CACHE = {}          # memoized instrument children (see telemetry.bound)

_XLA_TRACES_EVER = 0


def xla_traces_ever():
    """Graph programs built across the process, counted whatever the
    telemetry switch says (the reference's name: its programs are XLA
    traces)."""
    return _XLA_TRACES_EVER


def _count_xla_trace():
    """One graph program built (an Executor mode, a CachedOp signature,
    a serving bucket, a decode step): moves ``mxnet_xla_traces_total``;
    warm dispatches never do."""
    global _XLA_TRACES_EVER
    _XLA_TRACES_EVER += 1
    from . import telemetry
    if telemetry.enabled():
        telemetry.bound(
            _TM_CACHE, "xla_traces",
            lambda: telemetry.counter(
                "mxnet_xla_traces_total",
                "graph programs built across the process's graph "
                "functions (CachedOp signatures, Executor modes, serving "
                "buckets, decode steps); warm dispatches never move "
                "this")).inc()


def _count_dispatch(kind):
    """One executor graph dispatch (forward / forward_backward);
    memoized child, no registry lock on the warm path."""
    from . import telemetry
    if telemetry.enabled():
        telemetry.bound(
            _TM_CACHE, ("dispatch", kind),
            lambda: telemetry.counter(
                "mxnet_executor_dispatch_total",
                "Executor graph dispatches by kind",
                labelnames=("kind",)).labels(kind=kind)).inc()


def build_graph_fn(symbol, arg_names, aux_names):
    """Compile a Symbol DAG into
    ``fn(arg_vals, aux_vals, training, donated) -> (outputs, new_aux)``
    over tensors, with each node's attrs normalized once here.

    Any number of outputs and state inputs pass through.  An op that
    writes an input in place (``OpDef.inplace``, the KV-cache writes)
    gets that buffer itself only when the graph owns it outright: the
    entry has no other consumer and is no graph output, and it is either
    an argument the caller named in ``donated`` (as JAX's donated
    buffers: the caller reads the returned value, never the old one) or
    a fresh intermediate (not a view, not a creation op's constant).
    Otherwise the op gets a copy, so an undonated input never changes.
    In training the in-place ops take their functional path and nothing
    is copied.  Input-less creation ops (``_arange``) are constants: each
    is computed once per device and kept."""
    topo = _topo(symbol._outputs)
    aux_set = set(aux_names)
    plan = []
    for n in topo:
        if n.op is None:
            plan.append((n, None))
        else:
            attrs = n.op.normalize({k: v for k, v in n.attrs.items()
                                    if not k.startswith("__")})
            plan.append((n, attrs))
    heads = symbol._outputs
    uses = collections.Counter((id(i), ix) for n in topo
                               for (i, ix) in n.inputs)
    uses.update((id(n), ix) for (n, ix) in heads)
    consts = {}

    def graph_fn(arg_vals, aux_vals, training=False, donated=()):
        env = {}
        aux_env = dict(zip(aux_names, aux_vals))
        argd = dict(zip(arg_names, arg_vals))
        kept = {id(t) for name, t in argd.items() if name not in donated}
        kept.update(id(t) for t in aux_vals)
        device = next((t.device for t in list(arg_vals) + list(aux_vals)
                       if isinstance(t, torch.Tensor)), None)
        for n, attrs in plan:
            if attrs is None:
                env[(id(n), 0)] = aux_env[n.name] if n.name in aux_set \
                    else argd[n.name]
                continue
            ins = [env[(id(i), ix)] for (i, ix) in n.inputs]
            if not n.inputs:
                outs = consts.get((id(n), device))
                if outs is None:
                    outs = tuple(o.to(device) for o in
                                 n.op.bound(attrs, training)())
                    consts[(id(n), device)] = outs
            else:
                if n.op.inplace and not training:
                    for k in n.op.inplace:
                        src, ix = n.inputs[k]
                        owned = uses[(id(src), ix)] == 1 and (
                            src.name in donated if src.op is None
                            else bool(src.inputs) and ins[k]._base is None
                            and id(ins[k]) not in kept)
                        if not owned:
                            ins[k] = ins[k].clone()
                outs = n.op.bound(attrs, training)(*ins)
            for i, o in enumerate(outs):
                env[(id(n), i)] = o
            for in_idx, out_idx in n.op.mutate_aux.items():
                src, _ = n.inputs[in_idx]
                if src.op is None and src.name in aux_set:
                    aux_env[src.name] = outs[out_idx]
        return (tuple(env[(id(n), ix)] for (n, ix) in heads),
                tuple(aux_env[a] for a in aux_names))

    return graph_fn


_GRAD_REQS = ("null", "write", "add")


class Executor:
    """Symbol bound to argument, gradient and aux NDArrays on one
    context.  ``grad_req`` is one of null/write/add, or a list or dict of
    them by argument; a gradient array is allocated for every argument
    whose request is not null and that ``args_grad`` does not give."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._as_dict(args, self.arg_names, "args")
        self.aux_dict = self._as_dict(aux_states or {}, self.aux_names, "aux")
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(self.arg_names, grad_req))
        else:
            reqs = {n: grad_req.get(n, "null") for n in self.arg_names}
        bad = sorted(set(reqs.values()) - set(_GRAD_REQS))
        if bad:
            raise MXNetError("grad_req must be one of %s, got %s"
                             % (_GRAD_REQS, bad))
        self._grad_req = reqs
        self.grad_dict = self._as_dict(args_grad or {}, self.arg_names,
                                       "args_grad", allow_missing=True)
        for n in self.arg_names:
            if reqs[n] != "null" and n not in self.grad_dict:
                self.grad_dict[n] = NDArray(torch.zeros_like(
                    self.arg_dict[n]._data))
        self._graph_fn = build_graph_fn(symbol, self.arg_names,
                                        self.aux_names)
        self.outputs = []
        self._recorded = None
        self._monitor = None
        self._monitor_all = False
        self._built_modes = set()    # is_train values run so far

    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` for each output after every forward;
        with ``monitor_all`` also for each argument and aux state, before
        the outputs."""
        self._monitor = callback
        self._monitor_all = monitor_all

    def _report(self):
        if self._monitor is None:
            return
        if self._monitor_all:
            for name in self.arg_names:
                self._monitor(name, self.arg_dict[name])
            for name in self.aux_names:
                self._monitor(name, self.aux_dict[name])
        for name, out in zip(self.output_names, self.outputs):
            self._monitor(name, out)

    @staticmethod
    def _as_dict(values, names, what, allow_missing=False):
        if isinstance(values, dict):
            missing = [n for n in names if n not in values]
            if missing and not allow_missing:
                raise MXNetError("%s: missing %s" % (what, missing))
            return {n: values[n] for n in names if n in values}
        values = list(values)
        if len(values) != len(names) and not allow_missing:
            raise MXNetError("%s: expected %d entries, got %d"
                             % (what, len(names), len(values)))
        return {n: v for n, v in zip(names, values) if v is not None}

    @property
    def grad_arrays(self):
        """Gradient arrays in argument order, None where not requested."""
        return [self.grad_dict.get(n) for n in self.arg_names]

    def forward(self, is_train=False, **kwargs):
        from . import profiler
        from . import telemetry
        from .telemetry import step as _step
        with _step.active_phase("h2d"):
            # batch upload: the training step's h2d phase when a
            # StepTimer is ambient (no-op otherwise)
            for k, v in kwargs.items():
                if k not in self.arg_dict:
                    raise MXNetError("forward: unknown argument %r" % k)
                src = v._data if isinstance(v, NDArray) \
                    else _host_tensor(v)
                self.arg_dict[k]._data.copy_(src)
        aux = [self.aux_dict[n]._data for n in self.aux_names]
        self._recorded = None
        is_train = bool(is_train)
        if is_train not in self._built_modes:
            self._built_modes.add(is_train)
            _count_xla_trace()
        if not is_train:
            _count_dispatch("forward")
            with telemetry.maybe_span("executor.forward", "executor"), \
                    profiler.record_span("forward", "forward"), \
                    torch.inference_mode():
                outs, _ = self._graph_fn(
                    [self.arg_dict[n]._data for n in self.arg_names], aux)
            self.outputs = [NDArray(o) for o in outs]
            self._report()
            return self.outputs
        leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                  for n in self.arg_names if self._grad_req[n] != "null"}
        with telemetry.maybe_span("executor.forward", "executor"), \
                profiler.record_span("forward", "forward"), \
                torch.enable_grad():
            outs, new_aux = self._graph_fn(
                [leaves.get(n, self.arg_dict[n]._data)
                 for n in self.arg_names], aux, training=True)
        for n, a in zip(self.aux_names, new_aux):
            self.aux_dict[n]._data = a.detach()
        self._recorded = (outs, leaves)
        self.outputs = [NDArray(o.detach()) for o in outs]
        self._report()
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the outputs of the last ``forward(is_train=True)``
        into ``grad_dict``: written, or added under grad_req='add'."""
        if self._recorded is None:
            raise MXNetError("backward called without forward(is_train=True)")
        from . import profiler
        from . import telemetry
        _count_dispatch("forward_backward")
        with telemetry.maybe_span("executor.forward_backward", "executor"), \
                profiler.record_span("forward_backward", "backward"):
            self._backward(out_grads)

    def _backward(self, out_grads):
        outs, leaves = self._recorded
        self._recorded = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [g._data for g in out_grads]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        [leaves[n] for n in names],
                                        [h for _, h in pairs],
                                        allow_unused=True)
        with torch.no_grad():
            for n, g in zip(names, grads):
                dst = self.grad_dict[n]._data
                if self._grad_req[n] == "add":
                    if g is not None:
                        dst.add_(g)
                elif g is None:
                    dst.zero_()
                else:
                    dst.copy_(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for src, dst, what in ((arg_params or {}, self.arg_dict, "arg"),
                               (aux_params or {}, self.aux_dict, "aux")):
            for k, v in src.items():
                if k in dst:
                    dst[k][:] = v
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %r" % (what, k))
