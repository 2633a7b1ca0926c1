"""Shape ops (counterpart of ``mxnet_tpu/ops/shape_ops.py``): Reshape with
MXNet's special codes, Flatten, transpose, expand_dims, slice_axis and
Pad (constant mode), and the creation ops one_hot and _arange that the
attention decoder's graphs use."""
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


@register("_arange", nin=0,
          params={"start": P(float, 0.0), "stop": P("float_or_none", None),
                  "step": P(float, 1.0), "repeat": P(int, 1),
                  "infer_range": P(bool, False),
                  "dtype": P(str, "float32"),
                  "ctx": P("str_or_none", None)})
def _arange(attrs):
    """A host constant (numpy's arange, as the reference computes it); the
    executor moves it to the graph's device once and keeps it there."""
    start, stop = attrs["start"], attrs["stop"]
    if stop is None:
        start, stop = 0.0, start
    out = np.arange(start, stop, attrs["step"], dtype=np.dtype(attrs["dtype"]))
    if attrs["repeat"] > 1:
        out = np.repeat(out, attrs["repeat"])
    return torch.from_numpy(out)
