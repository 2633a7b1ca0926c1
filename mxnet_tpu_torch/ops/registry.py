"""Central operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``.  One registration per op
holds a typed parameter schema and one implementation
``impl(attrs, *tensors) -> output(s)`` that is the eager kernel, the
executor's lowering and — run on ``device="meta"`` tensors — the shape
and dtype inference.  A kernel wrapper called on meta tensors takes its
plain version, so inference never launches anything.

Output-tuple convention: the impl returns its ``nout`` graph outputs
first, then one entry per ``mutate_aux`` target; ``mutate_aux`` maps an
input index to the output index holding that aux input's new value.

A ``variable_inputs`` op (Concat, add_n, stack) takes any number of
inputs, counted in its ``key_var_num_args`` attr.

``stochastic`` (Dropout, RNN) and ``host_sync`` mark what the analysis
passes must not fold, merge or hide in a hot path; they change nothing at
run time.

``inplace`` maps an input index to the output index that IS that input,
written in place (the KV-cache writes).  Outside training the executor
hands such an op a copy of the input unless the graph owns the buffer
outright (see ``executor.build_graph_fn``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import Param, normalize_attrs, MXNetError

__all__ = ["OpDef", "register", "register_opdef", "get_op", "list_ops",
           "P", "invoke", "torch_dtype", "dtype_name"]

_REGISTRY = {}
_ALIASES = {}

P = Param


def torch_dtype(dt):
    """torch dtype, numpy dtype or dtype name -> torch dtype; bfloat16 by
    name, or as the numpy dtype of ``ml_dtypes``."""
    if isinstance(dt, torch.dtype):
        return dt
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    return getattr(torch, name if name == "bfloat16" else np.dtype(name).name)


def dtype_name(dt):
    """The name of a torch or numpy dtype or dtype name (``"float32"``,
    ``"bfloat16"``), as op attrs and symbol JSON carry it."""
    return str(torch_dtype(dt)).replace("torch.", "")


class OpDef:
    def __init__(self, name, impl, params=None, nin=1, nout=1,
                 input_names=None, mode_dependent=False, mutate_aux=None,
                 fill_shapes=None, num_visible_outputs=None, aux_inputs=(),
                 inplace=None, variable_inputs=False, key_var_num_args=None,
                 stochastic=False, host_sync=False, doc=""):
        self.name = name
        self.impl = impl
        self.params = params or {}
        self.nin = nin
        self.nout = nout
        self.input_names_spec = input_names or (["data"] if nin == 1 else None)
        self.mode_dependent = mode_dependent
        self.mutate_aux = mutate_aux or {}
        self.fill_shapes = fill_shapes
        self.num_visible_outputs = (num_visible_outputs if num_visible_outputs
                                    is not None else nout)
        self.aux_inputs = tuple(aux_inputs)
        self.inplace = inplace or {}
        self.variable_inputs = variable_inputs
        self.key_var_num_args = key_var_num_args
        # flags the analysis reads (analysis/shapes.py, retrace.py and the
        # optimizer's fold and CSE guards): a stochastic op draws random
        # numbers, so two of them never merge or fold; a host_sync op
        # reads device values back on the host at every dispatch
        self.stochastic = stochastic
        self.host_sync = host_sync
        self.doc = doc or (impl.__doc__ or "")

    def normalize(self, attrs):
        return normalize_attrs(self.params, attrs, self.name)

    def input_names(self, attrs=None, num_inputs=None):
        if self.variable_inputs:
            n = num_inputs
            if n is None and attrs:
                n = attrs.get(self.key_var_num_args or "num_args")
            return ["arg%d" % i for i in range(int(n or 0))]
        if self.input_names_spec is not None:
            names = list(self.input_names_spec)
            n = self.nin(attrs) if callable(self.nin) else self.nin
            if isinstance(n, int) and 0 < n <= len(names):
                names = names[:n]
            return names
        return ["arg%d" % i for i in range(self.nin)]

    def num_outputs(self, attrs=None):
        return self.nout(attrs) if callable(self.nout) else self.nout

    def bound(self, attrs, training=False):
        """impl closed over attrs: f(*tensors) -> tuple of outputs
        (visible outputs first, then mutate_aux updates)."""
        opdef = self

        def f(*inputs):
            a = dict(attrs)
            if opdef.mode_dependent:
                a["_training"] = training
            out = opdef.impl(a, *inputs)
            if not isinstance(out, tuple):
                out = (out,)
            return out
        return f

    def infer(self, attrs, in_shapes, in_dtypes):
        """Shape/dtype inference: fill parameter shapes, then run the
        impl on meta tensors.  Returns (in_shapes, out_shapes, out_dtypes)
        with torch dtypes."""
        in_shapes = list(in_shapes)
        if self.fill_shapes is not None:
            in_shapes = list(self.fill_shapes(attrs, in_shapes))
        if any(s is None for s in in_shapes):
            unknown = [i for i, s in enumerate(in_shapes) if s is None]
            raise MXNetError("%s: cannot infer shapes; inputs %s unknown"
                             % (self.name, unknown))
        metas = [torch.empty(tuple(s), dtype=torch_dtype(d or torch.float32),
                             device="meta")
                 for s, d in zip(in_shapes, in_dtypes)]
        out = self.bound(attrs, training=False)(*metas)
        return (in_shapes, [tuple(o.shape) for o in out],
                [o.dtype for o in out])


def register(name, aliases=(), **kwargs):
    """Decorator: register an impl as an operator."""
    def deco(impl):
        register_opdef(OpDef(name, impl, **kwargs), aliases)
        return impl
    return deco


def register_opdef(opdef, aliases=()):
    """Register a built OpDef under its name and ``aliases`` (run-time
    registration, ``rtc.register_kernel_op``).  As in the reference, a
    name or alias registered again points at the newest OpDef."""
    _REGISTRY[opdef.name] = opdef
    _ALIASES[opdef.name] = opdef.name
    for a in aliases:
        _ALIASES[a] = opdef.name
    return opdef


def get_op(name):
    real = _ALIASES.get(name)
    if real is None:
        raise MXNetError("operator %r is not registered (%d ops known)"
                         % (name, len(_REGISTRY)))
    return _REGISTRY[real]


def list_ops():
    return sorted(_ALIASES)


def invoke(op_name, attrs, *inputs, training=False):
    """Run an op on raw tensors (the counterpart of ``invoke_jax``)."""
    op = get_op(op_name)
    return op.bound(op.normalize(attrs), training)(*inputs)
