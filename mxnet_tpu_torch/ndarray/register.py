"""``mt.nd.<op>`` functions generated from the registry.

Counterpart of ``mxnet_tpu/ndarray/register.py``: each OpDef yields a
function taking NDArray inputs by position or by input name, the op's
params as keywords, ``out=`` and ``ctx=`` (the context of an op without
array inputs), which calls ``invoke``.  ``attach_methods`` gives NDArray
the reference's generated methods for the ops the port registers.
"""
from __future__ import annotations

from ..ops import list_ops, get_op
from .ndarray import NDArray, invoke

__all__ = ["make_op_func", "build_namespace", "attach_methods"]


def make_op_func(opdef, public_name):
    input_names = opdef.input_names_spec or []

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        inputs = list(args)
        # inputs passed by keyword (data=..., weight=...)
        by_name = {k: kwargs.pop(k) for k in list(kwargs)
                   if k in input_names and isinstance(kwargs[k], NDArray)}
        if by_name:
            merged = []
            pos = iter(inputs)
            for nm in input_names:
                if nm in by_name:
                    merged.append(by_name[nm])
                else:
                    nxt = next(pos, None)
                    if nxt is None:
                        break
                    merged.append(nxt)
            merged.extend(pos)
            inputs = merged
        # trailing Nones: optional inputs left out (bias with no_bias)
        while inputs and inputs[-1] is None:
            inputs.pop()
        attrs = {k: v for k, v in kwargs.items() if v is not None}
        return invoke(opdef, inputs, attrs, out=out)

    fn.__name__ = public_name
    fn.__doc__ = opdef.doc
    return fn


def build_namespace():
    """{name: function} for every registered op name and alias."""
    return {name: make_op_func(get_op(name), name) for name in list_ops()}


# the reference's generated NDArray methods that forward to the op of the
# same name (mxnet_tpu/ndarray/register.py _NDARRAY_METHODS)
_NDARRAY_METHODS = [
    "sum", "mean", "prod", "nansum", "nanprod", "max", "min", "norm",
    "argmax", "argmin", "abs", "sign", "round", "ceil", "floor", "trunc",
    "rint", "fix", "square", "sqrt", "rsqrt", "cbrt", "rcbrt", "exp", "log",
    "log10", "log2", "log1p", "expm1", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
    "arctanh", "degrees", "radians", "sigmoid", "relu", "softmax",
    "log_softmax", "flatten", "expand_dims", "squeeze", "tile", "repeat",
    "pad", "swapaxes", "split", "slice", "slice_axis", "take", "one_hot",
    "pick", "sort", "argsort", "topk", "clip", "transpose", "flip",
    "reciprocal",
]


def attach_methods():
    """Attach ``x.<op>(...)`` for each op of _NDARRAY_METHODS that is
    registered and that NDArray does not define itself."""
    known = set(list_ops())

    def make_method(opname):
        op = get_op(opname)
        param_order = [k for k in op.params if not k.startswith("_")]
        in_names = op.input_names_spec or []

        def method(self, *args, **kwargs):
            out = kwargs.pop("out", None)
            inputs = [self]
            attrs = {}
            pos_params = iter(param_order)
            for a in args:
                if isinstance(a, NDArray):
                    inputs.append(a)
                else:
                    # positional non-array args fill the params in schema
                    # order (x.argmax(1) -> axis=1), as in the reference
                    try:
                        attrs[next(pos_params)] = a
                    except StopIteration:
                        raise TypeError("%s: too many positional args"
                                        % opname) from None
            for k, v in kwargs.items():
                if v is None:
                    continue
                if isinstance(v, NDArray) or k in in_names:
                    inputs.append(v)
                else:
                    attrs[k] = v
            return invoke(op, inputs, attrs, out=out)
        method.__name__ = opname
        return method

    for name in _NDARRAY_METHODS:
        if name in known and not hasattr(NDArray, name):
            setattr(NDArray, name, make_method(name))

    # the methods whose positional arguments the reference reads its own
    # way
    def clip(self, a_min=None, a_max=None, out=None):
        return invoke("clip", [self], {"a_min": float(a_min),
                                       "a_max": float(a_max)}, out=out)

    def transpose(self, axes=None):
        return invoke("transpose", [self],
                      {"axes": tuple(axes) if axes else ()})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", [self, other], {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})
    NDArray.clip = clip
    NDArray.transpose = transpose
    NDArray.dot = dot
    NDArray.__matmul__ = lambda self, other: invoke("dot", [self, other])
