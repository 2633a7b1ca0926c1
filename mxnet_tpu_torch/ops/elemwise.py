"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
binary arithmetic and comparison ops and the scalar forms that the
ResNet residual add, the attention decoder's step, draft and commit
graphs and the NDArray operators (+ - * /) use, under the reference's
primary names and aliases.  Binary ops
broadcast; a comparison returns 1/0 in its left operand's dtype."""
from .registry import register, P


@register("_add", aliases=["broadcast_add", "add", "elemwise_add", "_plus"],
          nin=2, input_names=["lhs", "rhs"])
def add(attrs, a, b):
    return a + b


@register("_sub", aliases=["broadcast_sub", "sub", "elemwise_sub",
                           "_minus"],
          nin=2, input_names=["lhs", "rhs"])
def sub(attrs, a, b):
    return a - b


@register("_mul", aliases=["broadcast_mul", "mul", "elemwise_mul"],
          nin=2, input_names=["lhs", "rhs"])
def mul(attrs, a, b):
    return a * b


@register("_div", aliases=["broadcast_div", "div", "elemwise_div"],
          nin=2, input_names=["lhs", "rhs"])
def div(attrs, a, b):
    return a / b


@register("greater", aliases=["broadcast_greater", "_greater"],
          nin=2, input_names=["lhs", "rhs"])
def greater(attrs, a, b):
    return (a > b).to(a.dtype)


@register("lesser_equal", aliases=["broadcast_lesser_equal",
                                   "_lesser_equal"],
          nin=2, input_names=["lhs", "rhs"])
def lesser_equal(attrs, a, b):
    return (a <= b).to(a.dtype)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
}

for _name, _fn in _SCALAR.items():
    register(_name, params={"scalar": P(float, 0.0)})(
        lambda attrs, x, _fn=_fn: _fn(x, attrs["scalar"]))
