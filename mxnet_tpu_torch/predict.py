"""Predictor: forward-only inference over a frozen graph.

Counterpart of ``mxnet_tpu/predict.py`` (the c_predict_api runtime):
built from the checkpoint format Module writes, bound once on one
device.  Construction verifies the graph first (``analysis.verify``): a
malformed graph warns with node provenance, or raises under
``MXNET_ANALYSIS_STRICT=1``.  Loss-head label inputs are bound with
placeholder zeros and never read at inference.  With no ``ctx`` it runs
on the first CUDA card and raises when there is none; pass ``ctx=cpu()``
for the CPU.
"""
from __future__ import annotations

import warnings

import numpy as np

from .base import MXNetError
from .context import default_context
from . import config
from . import ndarray as nd
from . import symbol as sym

__all__ = ["Predictor", "load_checkpoint_predictor"]


def _verify_graph(symbol, what):
    """Construction-time IR verification (mxnet_tpu_torch.analysis):
    catch a malformed graph here, with node provenance, instead of deep
    inside bind/dispatch.  Warn by default; MXNET_ANALYSIS_STRICT=1
    raises."""
    if not config.get("MXNET_ANALYSIS_ON"):
        return
    from .analysis import verify
    report = verify(symbol)
    if not report.ok:
        if config.get("MXNET_ANALYSIS_STRICT"):
            report.raise_if_errors()    # message names the failing pass
        warnings.warn("%s: graph verification failed:\n%s"
                      % (what, report.format()))


def _label_like(names):
    """Loss-head label inputs (the placeholder-label convention): bound with
    zeros, never read at inference."""
    return [n for n in names if n.endswith("_label") or n == "label"]


def _infer_label_shapes(symbol, data_shapes, labels):
    if not labels:
        return {}
    arg_shapes, _, _ = symbol.infer_shape(**data_shapes)
    return {n: tuple(s) for n, s in
            zip(symbol.list_arguments(), arg_shapes) if n in labels}


def _assemble_args(symbol, data_shapes, ctx, params):
    """Args for an inference bind: zero buffers for the data inputs and
    the placeholder labels, everything else from ``params`` as given."""
    arg_names = symbol.list_arguments()
    labels = _label_like(n for n in arg_names
                         if n not in params and n not in data_shapes)
    label_shapes = _infer_label_shapes(symbol, data_shapes, labels)
    args = {}
    for n in arg_names:
        if n in data_shapes:
            args[n] = nd.zeros(data_shapes[n], ctx=ctx)
        elif n in label_shapes:
            args[n] = nd.zeros(label_shapes[n], ctx=ctx)
        else:
            args[n] = params[n]
    return args


class Predictor(object):
    """Forward-only executor over a frozen graph."""

    def __init__(self, symbol, arg_params, aux_params, data_shapes,
                 ctx=None):
        if isinstance(symbol, (str, bytes)):
            symbol = sym.load_json(symbol)
        ctx = default_context(ctx)
        data_shapes = dict(data_shapes)
        _verify_graph(symbol, "Predictor")
        arg_names = symbol.list_arguments()
        missing = [n for n in arg_names
                   if n not in arg_params and n not in data_shapes]
        missing = [n for n in missing if n not in _label_like(missing)]
        if missing:
            raise MXNetError("Predictor: params missing for %s" % missing)
        params = {n: arg_params[n].as_in_context(ctx) for n in arg_names
                  if n in arg_params and n not in data_shapes}
        aux = {n: aux_params[n].as_in_context(ctx)
               for n in symbol.list_auxiliary_states()}
        self._bind(symbol, ctx, data_shapes,
                   _assemble_args(symbol, data_shapes, ctx, params), aux)

    def _bind(self, symbol, ctx, data_shapes, args, aux):
        """Where every Predictor, constructed or ``reshape``d, gets its
        attributes and bound executor."""
        self._sym = symbol
        self._ctx = ctx
        self._data_names = list(data_shapes)
        self._exec = symbol.bind(ctx, args=args, grad_req="null",
                                 aux_states=aux)
        self._outputs = None

    def set_input(self, name=None, value=None, **named):
        feeds = dict(named)
        if name is not None:
            feeds[name] = value
        for k, v in feeds.items():
            if k not in self._data_names:
                raise MXNetError("unknown input %r (inputs: %s)"
                                 % (k, self._data_names))
            arr = v if isinstance(v, nd.NDArray) else nd.array(
                np.asarray(v), ctx=self._ctx)
            arr.copyto(self._exec.arg_dict[k])
        return self

    def forward(self, **feeds):
        if feeds:
            self.set_input(**feeds)
        self._outputs = self._exec.forward(is_train=False)
        return self

    def get_output(self, index=0):
        if self._outputs is None:
            raise MXNetError("forward() has not run")
        return self._outputs[index].asnumpy()

    def get_outputs(self, as_numpy=True):
        """All outputs in one call; ``as_numpy=False`` returns the
        device-resident NDArrays without a copy to the host."""
        if self._outputs is None:
            raise MXNetError("forward() has not run")
        if as_numpy:
            return [o.asnumpy() for o in self._outputs]
        return list(self._outputs)

    @property
    def output_shapes(self):
        """The outputs' shapes at the bound input shapes."""
        shapes = {n: self._exec.arg_dict[n].shape for n in self._data_names}
        _, out_shapes, _ = self._sym.infer_shape(**shapes)
        return [tuple(s) for s in out_shapes]

    def reshape(self, data_shapes):
        """A Predictor for new input shapes (MXPredReshape) that shares
        this one's device-resident parameters and auxiliary states: no
        copy, no upload.  Only the data (and placeholder label) buffers
        are new."""
        data_shapes = dict(data_shapes)
        if set(data_shapes) != set(self._data_names):
            raise MXNetError("reshape: data_shapes %s must cover exactly "
                             "the bound inputs %s"
                             % (sorted(data_shapes), self._data_names))
        arg_names = self._sym.list_arguments()
        labels = set(_label_like(arg_names))
        params = {n: self._exec.arg_dict[n] for n in arg_names
                  if n not in data_shapes and n not in labels}
        new = object.__new__(Predictor)
        new._bind(self._sym, self._ctx, data_shapes,
                  _assemble_args(self._sym, data_shapes, self._ctx, params),
                  dict(self._exec.aux_dict))
        return new


def load_checkpoint_predictor(prefix, epoch, data_shapes, ctx=None):
    """A Predictor from ``prefix-symbol.json`` + ``prefix-%04d.params``."""
    from .model import load_checkpoint
    ctx = default_context(ctx)
    symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
    return Predictor(symbol, arg_params, aux_params, data_shapes, ctx=ctx)
