"""CachedOp: a symbol run as one imperative operation (Gluon's hybridize).

Counterpart of ``mxnet_tpu/cached_op.py``.  The reference jits the
symbol's graph function once per input signature and records the whole
call as one tape node.  Here the graph function of ``executor.
build_graph_fn`` runs the registry's ops eagerly, as the Executor does,
with ``training = autograd.is_training()`` and torch's gradient recording
on while ``autograd.record()`` is active, so the outputs carry their
graph back to the caller's variables.  The op's new aux states
(BatchNorm's moving statistics) are written into the callers' arrays in
place, recording nothing (``ndarray.write_aux``), once per call.
``trace_count`` counts the distinct (shapes, dtypes, training)
signatures met, the reference's compile counter; each new one also moves
the process-wide program-build counter (``mxnet_xla_traces_total``).  A
call inside an active trace records a ``CachedOp(<name>)`` span.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import autograd
from .base import MXNetError
from .executor import _count_xla_trace, build_graph_fn
from .ndarray.ndarray import NDArray, write_aux

__all__ = ["CachedOp"]


class CachedOp:
    """``op(*inputs)`` runs ``sym`` on NDArrays given in
    ``sym.list_inputs()`` order (arguments and aux states as the graph
    meets them); returns the output NDArray, or a list of them."""

    def __init__(self, sym, flags=None):
        self._sym = sym
        self._flags = dict(flags or {})
        self.arg_names = sym.list_arguments()
        self.aux_names = sym.list_auxiliary_states()
        self.input_names = sym.list_inputs()
        self._graph_fn = build_graph_fn(sym, self.arg_names, self.aux_names)
        self._signatures = set()
        self._lock = threading.Lock()

    @property
    def trace_count(self):
        """Distinct (shapes, dtypes, training) signatures called so far."""
        return len(self._signatures)

    def __call__(self, *inputs):
        if len(inputs) != len(self.input_names):
            raise MXNetError("CachedOp expects %d inputs (%s), got %d"
                             % (len(self.input_names), self.input_names,
                                len(inputs)))
        by_name = dict(zip(self.input_names, inputs))
        args = [by_name[n]._data for n in self.arg_names]
        aux_nds = [by_name[n] for n in self.aux_names]
        training = autograd.is_training()
        sig = (tuple((tuple(t.shape), t.dtype) for t in args)
               + tuple((a.shape, a.dtype) for a in aux_nds), training)
        with self._lock:
            new = sig not in self._signatures
            self._signatures.add(sig)
        if new:
            _count_xla_trace()
        from . import telemetry
        # one contextvar probe on the common no-trace path: the span
        # exists only under an active trace
        tc = telemetry.current_trace()
        span = (tc.span("CachedOp(%s)" % (self._sym.name or "graph"),
                        "op")
                if tc is not None and not tc.finished
                else contextlib.nullcontext())
        with span, torch.set_grad_enabled(autograd.is_recording()):
            outs, new_aux = self._graph_fn(
                args, [a._data for a in aux_nds], training)
        for arr, t in zip(aux_nds, new_aux):
            write_aux(arr, t)
        out_nds = [NDArray(o) for o in outs]
        return out_nds[0] if len(out_nds) == 1 else out_nds
