"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
reference's tables ported whole.  Unary math, the binary arithmetic and
logic ops (each under its ``_<op>``, ``broadcast_<op>``, ``elemwise_<op>``
and old names, all broadcasting), their scalar forms, ``add_n``, Cast,
clip, BlockGrad, smooth_l1 and LeakyReLU.  A logic op returns 1/0 in its
left operand's dtype.  Gradients come from torch's autograd.  Sparse
storage stays out (``ROADMAP.md`` Queue A item 9).
"""
import math

import torch
import torch.nn.functional as F

from .registry import register, P, torch_dtype


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# ---------------------------------------------------------------------------
# Unary math
# ---------------------------------------------------------------------------

_UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "reciprocal": lambda x: 1.0 / x,
    "abs": torch.abs,
    "sign": torch.sign,
    "round": torch.round,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "negative": torch.neg,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _fn in _UNARY.items():
    register(_name)(lambda attrs, x, _fn=_fn: _fn(x))


@register("gamma")
def gamma_fn(attrs, x):
    """exp(gammaln(x)) with the sign of sin(pi x) for x < 0, as the
    reference computes it."""
    mag = torch.exp(torch.lgamma(x))
    sign = torch.where(x > 0, torch.ones_like(x),
                       torch.sign(torch.sin(math.pi * x)))
    return sign * mag


@register("_copy", aliases=["identity", "_CrossDeviceCopy"])
def _copy(attrs, x):
    """A copy (``NDArray.copy`` runs it; recorded under autograd)."""
    return x.clone()


@register("BlockGrad", aliases=["stop_gradient", "block_grad"])
def block_grad(attrs, x):
    return x.detach()


@register("make_loss", params={"grad_scale": P(float, 1.0)})
def make_loss_op(attrs, x):
    return x


@register("smooth_l1", params={"scalar": P(float, 1.0)})
def smooth_l1(attrs, x):
    s2 = attrs["scalar"] ** 2
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       absx - 0.5 / s2)


@register("Cast", aliases=["cast"], params={"dtype": P(str)})
def cast(attrs, x):
    return x.to(torch_dtype(attrs["dtype"]))


@register("clip", params={"a_min": P(float), "a_max": P(float)})
def clip(attrs, x):
    return torch.clamp(x, attrs["a_min"], attrs["a_max"])


# f(0) = 0 unary ops (the reference's sparsity-preserving set): the
# padding analysis (analysis/padding.py) reads it beside ``_UNARY`` to
# know which unaries keep zero pad slots zero.
_SPARSITY_PRESERVING = frozenset([
    "relu", "abs", "sign", "round", "rint", "ceil", "floor", "trunc",
    "fix", "square", "sqrt", "cbrt", "negative", "degrees", "radians",
    "expm1", "log1p", "erf", "erfinv", "sin", "tan", "arcsin", "arctan",
    "sinh", "tanh", "arcsinh", "arctanh",
])

# ---------------------------------------------------------------------------
# Binary: elemwise_*, broadcast_* and the bare names, all broadcasting
# ---------------------------------------------------------------------------

def _safe_mod(a, b):
    """a - floor(a / b) * b, and 0 where b is 0 (the reference's
    gradient-safe floor mod)."""
    safe = torch.where(b == 0, torch.ones_like(b), b)
    return torch.where(b == 0, torch.zeros_like(a),
                       a - torch.floor(a / safe) * b)


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": _safe_mod,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
}

_BINARY_LOGIC = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
    "logical_and": lambda a, b: torch.logical_and(a != 0, b != 0),
    "logical_or": lambda a, b: torch.logical_or(a != 0, b != 0),
    "logical_xor": lambda a, b: torch.logical_xor(a != 0, b != 0),
}

_ELEMWISE_NAME = {"add": "elemwise_add", "sub": "elemwise_sub",
                  "mul": "elemwise_mul", "div": "elemwise_div"}
_OLD_NAME = {"add": "_plus", "sub": "_minus", "mul": "_mul", "div": "_div",
             "mod": "_mod", "power": "_power", "maximum": "_maximum",
             "minimum": "_minimum", "hypot": "_hypot", "equal": "_equal",
             "not_equal": "_not_equal", "greater": "_greater",
             "greater_equal": "_greater_equal", "lesser": "_lesser",
             "lesser_equal": "_lesser_equal"}

for _name, _fn in {**_BINARY, **_BINARY_LOGIC}.items():
    if _name in _BINARY_LOGIC:
        def _impl(attrs, a, b, _fn=_fn):
            return _fn(a, b).to(a.dtype)
    else:
        def _impl(attrs, a, b, _fn=_fn):
            return _fn(a, b)
    _primary = "_" + _name if _name in _BINARY else _name
    _aliases = ["broadcast_" + _name]
    if _primary != _name:
        _aliases.append(_name)
    if _name in _ELEMWISE_NAME:
        _aliases.append(_ELEMWISE_NAME[_name])
    if _name in _OLD_NAME and _OLD_NAME[_name] != _primary:
        _aliases.append(_OLD_NAME[_name])
    register(_primary, aliases=_aliases, nin=2,
             input_names=["lhs", "rhs"])(_impl)


# ---------------------------------------------------------------------------
# Scalar forms (and their reversed twins)
# ---------------------------------------------------------------------------

def _full(x, s):
    return torch.full_like(x, s)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: _safe_mod(x, _full(x, s)),
    "_rmod_scalar": lambda x, s: _safe_mod(_full(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpow_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _full(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _full(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _full(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: ((x != 0) & (s != 0)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: ((x != 0) | (s != 0)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: ((x != 0) ^ (s != 0)).to(x.dtype),
}

for _name, _fn in _SCALAR.items():
    register(_name, params={"scalar": P(float, 0.0)})(
        lambda attrs, x, _fn=_fn: _fn(x, attrs["scalar"]))


@register("_scatter_plus_scalar", params={"scalar": P(float, 0.0)})
def _scatter_plus_scalar(attrs, x):
    return x + attrs["scalar"]


@register("_scatter_minus_scalar", params={"scalar": P(float, 0.0)})
def _scatter_minus_scalar(attrs, x):
    return x - attrs["scalar"]


@register("_scatter_elemwise_div", nin=2, input_names=["lhs", "rhs"])
def _scatter_elemwise_div(attrs, a, b):
    return a / b


# ---------------------------------------------------------------------------
# N-ary
# ---------------------------------------------------------------------------

@register("add_n", aliases=["ElementWiseSum", "element_wise_sum"],
          variable_inputs=True, key_var_num_args="num_args",
          params={"num_args": P(int, 0)})
def add_n(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register("_identity_with_attr_like_rhs", nin=2, input_names=["lhs", "rhs"])
def _identity_with_attr_like_rhs(attrs, lhs, rhs):
    return lhs


@register("LeakyReLU", aliases=["leaky_relu"],
          params={"act_type": P(str, "leaky", choices=["elu", "leaky", "prelu",
                                                       "rrelu", "selu"]),
                  "slope": P(float, 0.25),
                  "lower_bound": P(float, 0.125),
                  "upper_bound": P(float, 0.334)})
def leaky_relu(attrs, x, gamma=None):
    """leaky, elu, selu, prelu (per-channel ``gamma``) and rrelu with the
    mean of its bounds as the slope, as the reference computes them."""
    t = attrs["act_type"]
    if t == "leaky":
        return torch.where(x > 0, x, attrs["slope"] * x)
    if t == "elu":
        return torch.where(x > 0, x, attrs["slope"] * torch.expm1(x))
    if t == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if t == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.ndim - 2)) \
            if gamma.ndim == 1 else gamma
        return torch.where(x > 0, x, g * x)
    slope = (attrs["lower_bound"] + attrs["upper_bound"]) / 2.0
    return torch.where(x > 0, x, slope * x)
