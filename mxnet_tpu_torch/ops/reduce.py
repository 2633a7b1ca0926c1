"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``): sum, mean,
prod, nansum, nanprod, max, min and norm with MXNet's ``axis`` (an int, a
tuple or None for all), ``keepdims`` and ``exclude``; argmax, argmin and
argmax_channel; pick; broadcast_to and broadcast_axis."""
import torch

from .registry import register, P

_AXES = {"axis": P("shape_or_none", None), "keepdims": P(bool, False),
         "exclude": P(bool, False)}


def _norm_axes(attrs, ndim):
    ax = attrs.get("axis")
    if ax is None or ax == ():
        axes = tuple(range(ndim))
    elif isinstance(ax, int):
        axes = (ax % ndim,)
    else:
        axes = tuple(a % ndim for a in ax)
    if attrs.get("exclude"):
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCE = {
    "sum": torch.sum,
    "mean": torch.mean,
    "prod": _prod,
    "nansum": torch.nansum,
    "nanprod": lambda x, dim, keepdim: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim),
    "max": torch.amax,
    "min": torch.amin,
}
_REDUCE_ALIASES = {"sum": ["sum_axis"], "max": ["max_axis"],
                   "min": ["min_axis"]}


def _reduce(fn):
    def impl(attrs, x):
        axes = _norm_axes(attrs, x.ndim)
        if not axes:
            # no axis to reduce (exclude over every axis): x itself, as
            # numpy's reduction over an empty axis tuple
            return x
        return fn(x, dim=axes, keepdim=attrs["keepdims"])
    return impl


for _name, _fn in _REDUCE.items():
    register(_name, aliases=_REDUCE_ALIASES.get(_name, []),
             params=dict(_AXES))(_reduce(_fn))


@register("norm", params={"ord": P(int, 2), "axis": P("shape_or_none", None),
                          "keepdims": P(bool, False)})
def norm(attrs, x):
    ax = attrs["axis"]
    dims = tuple(range(x.ndim)) if ax is None else (
        (ax,) if isinstance(ax, int) else tuple(ax))
    if attrs["ord"] == 1:
        return torch.sum(torch.abs(x), dim=dims, keepdim=attrs["keepdims"])
    return torch.sqrt(torch.sum(torch.square(x), dim=dims,
                                keepdim=attrs["keepdims"]))


def _arg_reduce(fn):
    def impl(attrs, x):
        """Index of the first extreme value, in ``x``'s dtype."""
        ax = attrs["axis"]
        if ax is None:
            return fn(x.reshape(-1), dim=0).to(x.dtype)
        return fn(x, dim=ax, keepdim=attrs["keepdims"]).to(x.dtype)
    return impl


for _name, _fn in {"argmax": torch.argmax, "argmin": torch.argmin}.items():
    register(_name, params={"axis": P("int_or_none", None),
                            "keepdims": P(bool, False)})(_arg_reduce(_fn))


@register("argmax_channel")
def argmax_channel(attrs, x):
    return torch.argmax(x, dim=1).to(x.dtype)


@register("pick", nin=2, input_names=["data", "index"],
          params={"axis": P("int_or_none", 1), "keepdims": P(bool, False)})
def pick(attrs, data, index):
    """``data``'s entries at ``index`` along ``axis``, the index truncated
    to int32 and clipped into range."""
    ax = attrs["axis"]
    idx = index.to(torch.int32).long()
    if ax is None:
        return data.reshape(-1)[idx.reshape(-1)].reshape(index.shape)
    ax = ax % data.ndim
    idx = torch.clamp(idx, 0, data.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if attrs["keepdims"] else out.squeeze(ax)


@register("broadcast_to", params={"shape": P("shape", ())})
def broadcast_to(attrs, x):
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, attrs["shape"]))
    return x.expand(tgt)


@register("broadcast_axis", aliases=["broadcast_axes"],
          params={"axis": P("shape", ()), "size": P("shape", ())})
def broadcast_axis(attrs, x):
    tgt = list(x.shape)
    ax, sz = attrs["axis"], attrs["size"]
    if isinstance(ax, int):
        ax, sz = (ax,), (sz,)
    for a, s in zip(ax, sz):
        tgt[a] = s
    return x.expand(tuple(tgt))
