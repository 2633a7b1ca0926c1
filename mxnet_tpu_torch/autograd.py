"""Autograd for the imperative frontend, over torch's autograd.

Counterpart of ``mxnet_tpu/autograd.py``.  The reference
records each op's ``jax.vjp`` closure on a tape of its own; here torch
records the graph itself: ``ndarray.invoke`` runs ops with torch's
gradient recording on while ``record()`` is active, so every result
carries its ``grad_fn``.  A variable is an NDArray whose tensor is a
leaf that requires grad (``attach_grad`` / ``mark_variables``), with a
gradient buffer and a grad_req (write, add or null).  ``backward`` finds
the variables its heads depend on by walking the recorded graph from the
heads, takes their gradients with ``torch.autograd.grad`` and writes or
adds them into the buffers; ``grad`` returns them instead.

``grad(create_graph=True)`` records the gradient computation itself
(torch's ``create_graph``), so its results can be differentiated again.
``Function`` is a user-defined operation: its ``forward`` and
``backward`` run on NDArrays with recording paused, joined to the
recorded graph by a ``torch.autograd.Function``.  ``get_symbol`` raises,
as the reference's does: the recorded graph is torch's, not a Symbol.

Recording and training are flags of the calling thread, as in the
reference.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]


class _Scope(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_scope = _Scope()


def is_recording():
    return _scope.recording


def is_training():
    return _scope.training


def set_recording(flag):
    """Set whether ops are recorded; returns the previous value."""
    prev = _scope.recording
    _scope.recording = bool(flag)
    return prev


def set_training(flag):
    """Set training (vs predict) mode; returns the previous value."""
    prev = _scope.training
    _scope.training = bool(flag)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._record = is_record
        self._train = train_mode_
        self._prev = None

    def __enter__(self):
        self._prev = (_scope.recording, _scope.training)
        if self._record is not None:
            _scope.recording = self._record
        if self._train is not None:
            _scope.training = self._train
        return self

    def __exit__(self, *exc):
        _scope.recording, _scope.training = self._prev


def record(train_mode=True):
    """Scope in which executed ops are recorded for ``backward``."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope in which ops are not recorded."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of ``variables`` a leaf of later recordings with
    its gradient buffer from ``gradients`` and its grad_req (write, add or
    null; null records no gradient)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        t = v._data.detach()
        if req != "null":
            if not t.is_floating_point():
                raise MXNetError("only floating-point arrays can have a "
                                 "gradient, got %s" % t.dtype)
            t.requires_grad_(True)
            # the walk in backward maps this leaf back to its NDArray
            t._mx_variable = weakref.ref(v)
        v._data = t
        v._grad = g if req != "null" else None
        v._grad_req = req


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _heads(heads, head_grads):
    heads = _as_list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    head_grads = _as_list(head_grads)
    if len(head_grads) != len(heads):
        raise MXNetError("%d heads but %d head gradients"
                         % (len(heads), len(head_grads)))
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue        # nothing recorded reaches it: no contribution
        outs.append(t)
        grads.append(torch.ones_like(t) if hg is None
                     else getattr(hg, "_data", hg).to(t.device, t.dtype))
    if not outs:
        raise MXNetError("backward: no recorded computation reaches the "
                         "heads; run them inside autograd.record() on "
                         "arrays with attach_grad()")
    return outs, grads


def _variables(outs):
    """The attached NDArrays whose leaves the recorded graph of ``outs``
    reaches, in the order first met."""
    found, seen = [], set()
    stack = [t.grad_fn for t in outs if t.grad_fn is not None]
    stack += [t for t in outs if t.grad_fn is None]    # heads that are leaves
    # id -> node: holding each visited node keeps its Python wrapper
    # alive, so a later wrapper cannot take a freed one's id and be
    # skipped as visited
    visited = {}
    while stack:
        node = stack.pop()
        if node is None or id(node) in visited:
            continue
        visited[id(node)] = node
        leaf = node if isinstance(node, torch.Tensor) \
            else getattr(node, "variable", None)
        if leaf is not None:
            ref = getattr(leaf, "_mx_variable", None)
            v = ref() if ref is not None else None
            if v is not None and v._data is leaf and id(v) not in seen:
                seen.add(id(v))
                found.append(v)
            continue
        stack.extend(fn for fn, _ in node.next_functions)
    return found


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (weighted by ``head_grads``, ones by default)
    into the buffers of every variable they depend on: written, or added
    under grad_req 'add'.  Without ``retain_graph`` the heads' recording
    is released, and a second ``backward`` through them raises."""
    outs, grads = _heads(heads, head_grads)
    variables = _variables(outs)
    if not variables:
        raise MXNetError("backward: the heads depend on no variable; call "
                         "attach_grad() on the inputs before record()")
    with _RecordingStateScope(False, train_mode):
        got = torch.autograd.grad(outs, [v._data for v in variables], grads,
                                  retain_graph=retain_graph,
                                  allow_unused=True)
    with torch.no_grad():
        for v, g in zip(variables, got):
            dst = v._grad._data
            if v._grad_req == "add":
                if g is not None:
                    dst.add_(g)
            elif g is None:
                dst.zero_()
            else:
                dst.copy_(g)
    if not retain_graph:
        for h in _as_list(heads):
            if h._data.grad_fn is not None:
                h._data = h._data.detach()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (NDArrays with
    attach_grad), returned as new NDArrays; zeros for a variable the heads
    do not depend on.  With ``create_graph`` the gradients are themselves
    recorded (differentiable again); ``retain_graph`` defaults to
    ``create_graph``."""
    from .ndarray.ndarray import NDArray
    if retain_graph is None:
        retain_graph = create_graph
    outs, grads = _heads(heads, head_grads)
    variables = _as_list(variables)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("grad: a variable has no gradient; call "
                             "attach_grad() before record()")
    with _RecordingStateScope(create_graph, train_mode):
        got = torch.autograd.grad(outs, [v._data for v in variables], grads,
                                  retain_graph=bool(retain_graph),
                                  create_graph=create_graph,
                                  allow_unused=True)
    return [NDArray(torch.zeros_like(v._data.detach()) if g is None
                    else g if create_graph else g.detach())
            for v, g in zip(variables, got)]


def get_symbol(x):
    """The reference cannot rebuild a Symbol from its tape, and neither can
    the port from torch's graph: use a HybridBlock's or CachedOp's
    symbol."""
    raise NotImplementedError(
        "get_symbol on the recorded graph is not supported; use HybridBlock/"
        "CachedOp tracing for a graph view")


class _FunctionNode(torch.autograd.Function):
    """Joins a ``Function``'s outputs to the recorded graph: forward runs
    the user's ``forward`` and backward the user's ``backward``, both on
    NDArrays with recording paused."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        func._single = not isinstance(outs, (list, tuple))
        return tuple(o._data for o in _as_list(outs))

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        with pause():
            in_grads = ctx.func.backward(*[NDArray(g) for g in out_grads])
        return (None,) + tuple(getattr(g, "_data", g)
                               for g in _as_list(in_grads))


class Function:
    """A user-defined differentiable operation (the reference's
    ``autograd.Function``): subclass it and override ``forward`` (NDArrays
    in, NDArray or list out) and ``backward`` (one gradient per output in,
    one per input out).  Both run with recording paused; under
    ``record()`` the call is one node of the recorded graph."""

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        outs = _FunctionNode.apply(self, *[i._data for i in inputs])
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if self._single else wrapped

    def save_for_backward(self, *args):
        self._saved_tensors = args

    @property
    def saved_tensors(self):
        return self._saved_tensors

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
