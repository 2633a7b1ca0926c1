"""Shape ops (counterpart of ``mxnet_tpu/ops/shape_ops.py``): Reshape with
MXNet's special codes, Flatten, transpose, expand_dims, squeeze,
SwapAxis, reshape_like, the slices and slice assignments, repeat, tile,
reverse, stack, Concat, split (SliceChannel), Pad (constant mode), take,
batch_take, one_hot, gather_nd, scatter_nd, where, topk, sort, argsort and
the creation ops (_zeros, _ones, _full, _arange, _eye, _constant,
zeros_like, ones_like).  A creation op makes its tensor on the device its
``ctx`` attr names (the imperative call's context), else on the host, and
the executor moves it to the graph's device once."""
import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register, P, torch_dtype
from ..base import MXNetError


def infer_reshape(target, src_shape):
    """Resolve an MXNet reshape spec (codes 0, -1, -2, -3, -4) to a shape."""
    out = []
    src = list(src_shape)
    i = 0   # index into src
    j = 0   # index into target
    target = list(target)
    while j < len(target):
        t = target[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[j + 1], target[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(t)
            if i < len(src):
                i += 1
        j += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape: more than one -1")
    if -1 in out:
        known = math.prod(d for d in out if d != -1) or 1
        out[out.index(-1)] = math.prod(src_shape) // known
    return tuple(out)


@register("Reshape", aliases=["reshape"],
          params={"shape": P("shape", ()), "reverse": P(bool, False),
                  "target_shape": P("shape", ()),
                  "keep_highest": P(bool, False)})
def reshape(attrs, x):
    tgt = attrs["shape"] or attrs["target_shape"]
    if attrs["reverse"]:
        new = infer_reshape(tuple(reversed(tgt)), tuple(reversed(x.shape)))
        return x.reshape(tuple(reversed(new)))
    return x.reshape(infer_reshape(tgt, tuple(x.shape)))


@register("Flatten", aliases=["flatten"])
def flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


@register("transpose", params={"axes": P("shape", ())})
def transpose(attrs, x):
    """The axes permuted as ``axes`` gives them, reversed when empty."""
    return x.permute(tuple(attrs["axes"]) or tuple(range(x.ndim))[::-1])


@register("expand_dims", params={"axis": P(int)})
def expand_dims(attrs, x):
    return x.unsqueeze(attrs["axis"])


@register("slice_axis",
          params={"axis": P(int), "begin": P(int, 0),
                  "end": P("int_or_none", None)})
def slice_axis(attrs, x):
    sl = [slice(None)] * x.dim()
    sl[attrs["axis"] % x.dim()] = slice(attrs["begin"], attrs["end"])
    return x[tuple(sl)]


@register("Pad", aliases=["pad"],
          params={"mode": P(str, "constant",
                            choices=["constant", "edge", "reflect"]),
                  "pad_width": P("shape", ()),
                  "constant_value": P(float, 0.0)})
def pad(attrs, x):
    """``pad_width`` holds (before, after) for every axis in order; the
    constant mode fills with ``constant_value``."""
    if attrs["mode"] != "constant":
        raise MXNetError("Pad: mode=%s is not yet ported (constant only)"
                         % attrs["mode"])
    pw = attrs["pad_width"]
    if len(pw) != 2 * x.ndim:
        raise MXNetError("Pad: pad_width needs 2 entries per axis of a %d-D "
                         "input, got %d" % (x.ndim, len(pw)))
    # F.pad takes the pairs last axis first
    flat = [p for i in reversed(range(x.ndim)) for p in pw[2 * i:2 * i + 2]]
    return F.pad(x, flat, mode="constant", value=attrs["constant_value"])


@register("squeeze", params={"axis": P("shape_or_none", None)})
def squeeze(attrs, x):
    ax = attrs["axis"]
    if ax is None:
        return x.squeeze()
    ax = (ax,) if isinstance(ax, int) else tuple(ax)
    return x.squeeze(tuple(a % x.ndim for a in ax))


@register("SwapAxis", aliases=["swapaxes", "swap_axis"],
          params={"dim1": P(int, 0), "dim2": P(int, 0)})
def swapaxes(attrs, x):
    return x.transpose(attrs["dim1"], attrs["dim2"])


@register("reshape_like", nin=2, input_names=["lhs", "rhs"])
def reshape_like(attrs, lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("shape_array")
def shape_array(attrs, x):
    return torch.tensor(x.shape, dtype=torch.int64, device=x.device)


@register("size_array")
def size_array(attrs, x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


# ---------------------------------------------------------------------------
# Slicing
# ---------------------------------------------------------------------------

def _norm_slice(begin, end, step, shape):
    """The reference's (begin, end, step) tuples as a tuple of slices;
    negative steps are taken as numpy takes them."""
    slices = []
    for i in range(len(shape)):
        if i < len(begin):
            e = end[i] if i < len(end) else None
            s = step[i] if step and i < len(step) else None
            slices.append(slice(begin[i], e, s))
        else:
            slices.append(slice(None))
    return tuple(slices)


def _take_slices(x, slices):
    """``x[slices]``; torch indexes with positive steps only, so an axis
    with a negative step is flipped and read forward."""
    out = x
    for ax, sl in enumerate(slices):
        if sl.step is not None and sl.step < 0:
            idx = torch.arange(x.shape[ax], device=x.device)[sl]
            out = out.index_select(ax, idx)
        else:
            out = out[(slice(None),) * ax + (sl,)]
    return out


@register("slice", aliases=["crop"],
          params={"begin": P("shape", ()), "end": P("shape", ()),
                  "step": P("shape", ())})
def slice_op(attrs, x):
    return _take_slices(x, _norm_slice(attrs["begin"], attrs["end"],
                                       attrs["step"], x.shape))


def _slice_index(attrs, shape, device):
    """Flat indices of the elements ``_norm_slice`` selects (what a slice
    assignment writes), shaped as the selection."""
    flat = torch.arange(math.prod(shape), device=device).reshape(shape)
    return _take_slices(flat, _norm_slice(attrs["begin"], attrs["end"],
                                          attrs["step"], shape))


@register("_slice_assign", aliases=["_crop_assign"], nin=2,
          input_names=["lhs", "rhs"],
          params={"begin": P("shape", ()), "end": P("shape", ()),
                  "step": P("shape", ())})
def _slice_assign(attrs, lhs, rhs):
    """lhs with the slice replaced by rhs (a new tensor)."""
    idx = _slice_index(attrs, lhs.shape, lhs.device).reshape(-1)
    out = lhs.reshape(-1).clone()
    return out.index_copy(0, idx, rhs.expand(
        _slice_index(attrs, lhs.shape, "meta").shape).reshape(-1)
        .to(lhs.dtype)).reshape(lhs.shape)


@register("_slice_assign_scalar", aliases=["_crop_assign_scalar"],
          params={"scalar": P(float, 0.0), "begin": P("shape", ()),
                  "end": P("shape", ()), "step": P("shape", ())})
def _slice_assign_scalar(attrs, lhs):
    idx = _slice_index(attrs, lhs.shape, lhs.device).reshape(-1)
    out = lhs.reshape(-1).clone()
    return out.index_fill(0, idx, attrs["scalar"]).reshape(lhs.shape)


@register("slice_like", nin=2, input_names=["data", "shape_like"],
          params={"axes": P("shape", ())})
def slice_like(attrs, data, like):
    axes = attrs["axes"] or tuple(range(min(data.ndim, like.ndim)))
    sl = [slice(None)] * data.ndim
    for a in axes:
        sl[a % data.ndim] = slice(0, like.shape[a % like.ndim])
    return data[tuple(sl)]


# ---------------------------------------------------------------------------
# Repeat / tile / reverse / stack / concat / split
# ---------------------------------------------------------------------------

@register("repeat", params={"repeats": P(int), "axis": P("int_or_none", None)})
def repeat(attrs, x):
    if attrs["axis"] is None:
        return x.reshape(-1).repeat_interleave(attrs["repeats"])
    return x.repeat_interleave(attrs["repeats"], dim=attrs["axis"])


@register("tile", params={"reps": P("shape", ())})
def tile(attrs, x):
    return torch.tile(x, tuple(attrs["reps"]))


@register("reverse", aliases=["flip"], params={"axis": P("shape", ())})
def reverse(attrs, x):
    ax = attrs["axis"]
    return torch.flip(x, (ax,) if isinstance(ax, int) else tuple(ax))


@register("stack", variable_inputs=True, key_var_num_args="num_args",
          params={"axis": P(int, 0), "num_args": P(int, 0)})
def stack(attrs, *xs):
    return torch.stack(xs, dim=attrs["axis"])


@register("Concat", aliases=["concat"], variable_inputs=True,
          key_var_num_args="num_args",
          params={"dim": P(int, 1), "num_args": P(int, 0)})
def concat(attrs, *xs):
    return torch.cat(xs, dim=attrs["dim"])


def _split_nout(attrs):
    if attrs is None:
        return 1
    n = int(attrs.get("num_outputs", 1))
    return 1 if attrs.get("squeeze_axis") and n == 0 else n


@register("SliceChannel", aliases=["split"], nout=_split_nout,
          params={"num_outputs": P(int), "axis": P(int, 1),
                  "squeeze_axis": P(bool, False)})
def split(attrs, x):
    ax, n = attrs["axis"], attrs["num_outputs"]
    if x.shape[ax] % n:
        raise MXNetError("split: axis %d of size %d does not split into %d "
                         "equal parts" % (ax, x.shape[ax], n))
    parts = x.split(x.shape[ax] // n, dim=ax)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


# ---------------------------------------------------------------------------
# Indexing
# ---------------------------------------------------------------------------

def _index(t):
    """Indices truncated to int32, as the reference's ``astype(int32)``,
    in the long dtype torch indexes with."""
    return t.to(torch.int32).long()


@register("take", nin=2, input_names=["a", "indices"],
          params={"axis": P(int, 0),
                  "mode": P(str, "clip", choices=["raise", "wrap", "clip"])})
def take(attrs, a, indices):
    ax = attrs["axis"] % a.ndim
    n = a.shape[ax]
    idx = _index(indices)
    idx = idx % n if attrs["mode"] == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + tuple(indices.shape)
                       + a.shape[ax + 1:])


@register("batch_take", nin=2, input_names=["a", "indices"])
def batch_take(attrs, a, indices):
    idx = _index(indices).clamp(0, a.shape[1] - 1)
    return torch.gather(a, 1, idx.reshape(-1, 1)).reshape(indices.shape)


@register("one_hot", input_names=["indices"],
          params={"depth": P(int), "on_value": P(float, 1.0),
                  "off_value": P(float, 0.0), "dtype": P(str, "float32")})
def one_hot(attrs, indices):
    """Indices are truncated to int32 as ``astype(int32)`` does; an index
    outside ``[0, depth)`` gives an all-off row."""
    depth = attrs["depth"]
    idx = indices.to(torch.int32).unsqueeze(-1)
    oh = (idx == torch.arange(depth, dtype=torch.int32,
                              device=indices.device)).to(torch.float32)
    out = oh * (attrs["on_value"] - attrs["off_value"]) + attrs["off_value"]
    return out.to(torch_dtype(attrs["dtype"]))


@register("gather_nd", nin=2, input_names=["data", "indices"])
def gather_nd(attrs, data, indices):
    idx = _index(indices)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", nin=2, input_names=["data", "indices"],
          params={"shape": P("shape", ())})
def scatter_nd(attrs, data, indices):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (repeats
    sum)."""
    idx = _index(indices)
    out = data.new_zeros(tuple(attrs["shape"]))
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


@register("_scatter_set_nd", nin=2, input_names=["data", "indices"],
          params={"shape": P("shape", ())})
def _scatter_set_nd(attrs, data, indices):
    idx = _index(indices)
    out = data.new_zeros(tuple(attrs["shape"]))
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@register("where", nin=3, input_names=["condition", "x", "y"])
def where(attrs, cond, x, y):
    if cond.ndim == 1 and x.ndim > 1:
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(cond != 0, x, y)


# ---------------------------------------------------------------------------
# Ordering
# ---------------------------------------------------------------------------

def _order_axis(attrs, x):
    ax = attrs["axis"]
    return (x.reshape(-1), 0) if ax is None else (x, ax)


@register("topk", nout=lambda attrs: 2 if (attrs or {}).get("ret_typ")
          == "both" else 1,
          params={"axis": P("int_or_none", -1), "k": P(int, 1),
                  "ret_typ": P(str, "indices",
                               choices=["value", "indices", "mask", "both"]),
                  "is_ascend": P(bool, False), "dtype": P(str, "float32")})
def topk(attrs, x):
    """The k largest (smallest with ``is_ascend``) along ``axis``, ties in
    index order, as the reference's stable argsort gives them."""
    x, ax = _order_axis(attrs, x)
    order = torch.argsort(x, dim=ax, descending=not attrs["is_ascend"],
                          stable=True)
    idx = order.narrow(ax, 0, attrs["k"])
    rt = attrs["ret_typ"]
    dt = torch_dtype(attrs["dtype"])
    if rt == "value":
        return torch.gather(x, ax, idx)
    if rt == "indices":
        return idx.to(dt)
    if rt == "both":
        return torch.gather(x, ax, idx), idx.to(dt)
    return torch.zeros_like(x).scatter(ax, idx, 1.0)


@register("sort", params={"axis": P("int_or_none", -1),
                          "is_ascend": P(bool, True)})
def sort(attrs, x):
    x, ax = _order_axis(attrs, x)
    s = torch.sort(x, dim=ax, stable=True).values
    return s if attrs["is_ascend"] else torch.flip(s, (ax,))


@register("argsort", params={"axis": P("int_or_none", -1),
                             "is_ascend": P(bool, True),
                             "dtype": P(str, "float32")})
def argsort(attrs, x):
    x, ax = _order_axis(attrs, x)
    return torch.argsort(x, dim=ax, descending=not attrs["is_ascend"],
                         stable=True).to(torch_dtype(attrs["dtype"]))


# ---------------------------------------------------------------------------
# Creation ops: no array inputs
# ---------------------------------------------------------------------------

_CREATE = {"dtype": P(str, "float32"), "ctx": P("str_or_none", None)}


def _device(attrs):
    """The device of the ``ctx`` attr (``"gpu(0)"``), else the host."""
    ctx = attrs.get("ctx")
    if not ctx:
        return torch.device("cpu")
    dev_type, dev_id = ctx.rstrip(")").split("(")
    return torch.device("cpu") if dev_type == "cpu" \
        else torch.device("cuda", int(dev_id))


def _created(attrs, fn):
    return fn(tuple(attrs["shape"]), dtype=torch_dtype(attrs["dtype"]),
              device=_device(attrs))


@register("_zeros", nin=0, params={"shape": P("shape", ()), **_CREATE})
def _zeros(attrs):
    return _created(attrs, torch.zeros)


@register("_ones", nin=0, params={"shape": P("shape", ()), **_CREATE})
def _ones(attrs):
    return _created(attrs, torch.ones)


@register("_full", nin=0, params={"shape": P("shape", ()),
                                  "value": P(float, 0.0), **_CREATE})
def _full(attrs):
    return torch.full(tuple(attrs["shape"]), attrs["value"],
                      dtype=torch_dtype(attrs["dtype"]),
                      device=_device(attrs))


@register("_arange", nin=0,
          params={"start": P(float, 0.0), "stop": P("float_or_none", None),
                  "step": P(float, 1.0), "repeat": P(int, 1),
                  "infer_range": P(bool, False), **_CREATE})
def _arange(attrs):
    """numpy's arange, as the reference computes it, moved to the device
    of ``ctx``."""
    start, stop = attrs["start"], attrs["stop"]
    if stop is None:
        start, stop = 0.0, start
    out = np.arange(start, stop, attrs["step"], dtype=np.dtype(attrs["dtype"]))
    if attrs["repeat"] > 1:
        out = np.repeat(out, attrs["repeat"])
    return torch.from_numpy(out).to(_device(attrs))


@register("_eye", nin=0, params={"N": P(int), "M": P(int, 0), "k": P(int, 0),
                                 **_CREATE})
def _eye(attrs):
    n, m, k = attrs["N"], attrs["M"] or attrs["N"], attrs["k"]
    rows = torch.arange(n).unsqueeze(1)
    cols = torch.arange(m).unsqueeze(0)
    return (cols - rows == k).to(torch_dtype(attrs["dtype"])) \
        .to(_device(attrs))


@register("_constant", nin=0,
          params={"value": P("float_tuple", ()), "shape": P("shape", ()),
                  **_CREATE})
def _constant(attrs):
    """A baked literal: ``value`` is the row-major flat element tuple."""
    arr = np.array(attrs["value"], dtype=np.float64).reshape(attrs["shape"])
    return torch.from_numpy(np.asarray(arr, dtype=np.dtype(attrs["dtype"]))) \
        .to(_device(attrs))


@register("zeros_like")
def zeros_like(attrs, x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(attrs, x):
    return torch.ones_like(x)


@register("softmax_cross_entropy", nin=2, input_names=["data", "label"])
def softmax_cross_entropy(attrs, data, label):
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, _index(label).reshape(-1, 1))
    return -picked.sum()
