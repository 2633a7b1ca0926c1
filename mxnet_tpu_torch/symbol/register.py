"""Symbol op functions generated from the registry, and the Symbol methods
that forward to an op (counterpart of ``mxnet_tpu/symbol/register.py``)."""
from __future__ import annotations

from ..ops import list_ops, get_op
from .symbol import Symbol, _create

__all__ = ["make_sym_func", "build_namespace", "attach_methods"]


def make_sym_func(opdef, public_name):
    input_names = opdef.input_names_spec or []

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        inputs = [a for a in args if isinstance(a, Symbol)]
        attrs = {}
        kw_inputs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                kw_inputs[k] = v       # keyword inputs: placed by name
            elif v is not None:
                attrs[k] = v
        if kw_inputs:
            merged = []
            pos = iter(inputs)
            for nm in input_names:
                if nm in kw_inputs:
                    merged.append(kw_inputs[nm])
                else:
                    nxt = next(pos, None)
                    if nxt is None:
                        break
                    merged.append(nxt)
            merged.extend(pos)
            inputs = merged
        return _create(opdef, inputs, attrs, name=name)

    fn.__name__ = public_name
    fn.__doc__ = opdef.doc
    return fn


def build_namespace():
    return {name: make_sym_func(get_op(name), name) for name in list_ops()}


# the reference's Symbol methods that forward to the op of the same name
# (mxnet_tpu/symbol/register.py _SYMBOL_METHODS)
_SYMBOL_METHODS = [
    "sum", "mean", "prod", "max", "min", "norm", "argmax", "argmin", "abs",
    "sign", "round", "ceil", "floor", "square", "sqrt", "exp", "log",
    "sigmoid", "relu", "softmax", "log_softmax", "tanh", "flatten",
    "expand_dims", "squeeze", "tile", "repeat", "pad", "swapaxes", "split",
    "slice", "slice_axis", "take", "one_hot", "pick", "sort", "argsort",
    "topk", "clip", "transpose", "flip", "reciprocal", "reshape",
    "reshape_like", "broadcast_to", "broadcast_axes", "astype",
]
_METHOD_OPS = {"reshape": "Reshape", "flatten": "Flatten", "astype": "Cast"}


def attach_methods():
    """``sym.<op>(...)`` for each op of _SYMBOL_METHODS: positional
    non-symbol arguments fill the op's params in schema order."""
    def make_method(opname):
        op = get_op(opname)
        param_order = [k for k in op.params if not k.startswith("_")]

        def method(self, *args, **kwargs):
            name = kwargs.pop("name", None)
            inputs, attrs = [self], {}
            pos_params = iter(param_order)
            for a in args:
                if isinstance(a, Symbol):
                    inputs.append(a)
                else:
                    attrs[next(pos_params)] = a
            for k, v in kwargs.items():
                if isinstance(v, Symbol):
                    inputs.append(v)
                elif v is not None:
                    attrs[k] = v
            return _create(op, inputs, attrs, name=name)
        method.__name__ = opname
        return method

    for nm in _SYMBOL_METHODS:
        if not hasattr(Symbol, nm):
            setattr(Symbol, nm, make_method(_METHOD_OPS.get(nm, nm)))

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _create("dot", [self, other], {"transpose_a": transpose_a,
                                              "transpose_b": transpose_b})
    Symbol.dot = dot
