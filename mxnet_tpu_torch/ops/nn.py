"""Neural-network layer ops.

Counterpart of the ResNet ops in ``mxnet_tpu/ops/nn.py``: Convolution,
Pooling, BatchNorm, the fused input BatchNorm and stem convolution
``_contrib_BNStemConv``, Activation, FullyConnected and SoftmaxOutput, and
the attention decoder's Embedding and softmax, and Gluon's
Deconvolution, log_softmax, InstanceNorm and Dropout, the recurrent
cells' SequenceMask, SequenceLast and SequenceReverse, and SSD's
MakeLoss, with the same parameter schemas (so symbol JSON interchanges)
and the same layouts at the op boundary (NHWC data with OHWI weights when
``layout`` ends in C, else NCHW/OIHW).  None of these was a Pallas kernel
in the reference, so they run on torch's own operators (cuDNN/cuBLAS on
the card) and take their gradients from autograd, except where the
reference wrote the backward by hand: BatchNorm's and the stem's training
backward and the loss gradients of SoftmaxOutput and MakeLoss are
``torch.autograd.Function``s with the reference's arithmetic, and with
MXNET_CONV1X1_FUSED_BWD a stride-1 1x1 convolution's backward is the
hand-written CUDA kernel K8 (``conv1x1_bwd``, csrc/nn_conv1x1_bwd.cu).
"""
import math

import torch
import torch.nn.functional as F

from .registry import register, P
from ._cuda import (check, check_dims, launch, mma_plan, mma_wgrad_plan,
                    on_host, stream)
from .. import config
from .. import random as _random
from ..base import MXNetError
from ..context import Context


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

def _fc_fill(attrs, in_shapes):
    data = in_shapes[0]
    out = list(in_shapes)
    if data is not None:
        nh = attrs["num_hidden"]
        in_dim = 1
        for d in (data[1:] if attrs.get("flatten", True) else data[-1:]):
            in_dim *= d
        if len(out) > 1 and out[1] is None:
            out[1] = (nh, in_dim)
        if len(out) > 2 and out[2] is None:
            out[2] = (nh,)
    return out


_FC_ROWS = 8


def _fixed_height_matmul(x2d, weight):
    """``x2d @ weight.T`` over blocks of ``_FC_ROWS`` rows, the last one
    zero-padded.  BLAS picks its kernel, and with it the order of the sum,
    by the matrix height; at one fixed height a row's result depends on
    nothing else in the batch, so a served example's answer is bitwise the
    same whatever batch it was coalesced into."""
    m = x2d.shape[0]
    pad = -m % _FC_ROWS
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros(pad, x2d.shape[1])])
    return torch.cat([blk @ weight.t() for blk in x2d.split(_FC_ROWS)])[:m]


@register("FullyConnected", aliases=["fully_connected"],
          nin=lambda attrs: 2 if (attrs or {}).get("no_bias") else 3,
          input_names=["data", "weight", "bias"],
          fill_shapes=_fc_fill,
          params={"num_hidden": P(int), "no_bias": P(bool, False),
                  "flatten": P(bool, True)})
def fully_connected(attrs, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    out = _fixed_height_matmul(x.reshape(-1, x.shape[-1]), weight)
    out = out.reshape(x.shape[:-1] + (weight.shape[0],))
    if bias is not None and not attrs["no_bias"]:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

def _channels_last(attrs):
    return (attrs.get("layout") or "").endswith("C")


def _conv_fill(attrs, in_shapes):
    out = list(in_shapes)
    data = out[0]
    if data is not None:
        k = tuple(attrs["kernel"])
        nf = attrs["num_filter"]
        ng = attrs.get("num_group", 1)
        if _channels_last(attrs):
            wshape = (nf,) + k + (data[-1] // ng,)
        else:
            wshape = (nf, data[1] // ng) + k
        if len(out) > 1 and out[1] is None:
            out[1] = wshape
        if len(out) > 2 and out[2] is None:
            out[2] = (nf,)
    return out


_CONV_PARAMS = {
    "kernel": P("shape"), "stride": P("shape", ()), "dilate": P("shape", ()),
    "pad": P("shape", ()), "num_filter": P(int), "num_group": P(int, 1),
    "workspace": P(int, 1024), "no_bias": P(bool, False),
    "cudnn_tune": P("str_or_none", None), "cudnn_off": P(bool, False),
    "layout": P("str_or_none", None),
}

_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _to_channels_first(x):
    """N...C view -> NC... view (no copy: a channels-last strided tensor)."""
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _to_channels_last(x):
    return x.permute(0, *range(2, x.ndim), 1)


def _conv1x1_cl(x, w, stride):
    """Channels-last 1x1 convolution as one matrix product over the
    (strided) rows — the counterpart of ``_conv1x1_cl``."""
    if any(s > 1 for s in stride):
        x = x[(slice(None),) + tuple(slice(None, None, s) for s in stride)]
    co, ci = w.shape[0], w.shape[-1]
    y = torch.matmul(x.reshape(-1, ci), w.reshape(co, ci).t())
    return y.reshape(x.shape[:-1] + (co,))


def conv1x1_bwd_plain(x2d, dy2d, w):
    """Plain version of K8: (dx = dy @ w in x's dtype, dW = dy^T x
    computed in f32 and cast to w's dtype, in w's shape)."""
    w2 = w.reshape(w.shape[0], -1).float()
    dx = torch.matmul(dy2d.float(), w2).to(x2d.dtype)
    dw = torch.matmul(dy2d.float().t(), x2d.float())
    return dx, dw.reshape(w.shape).to(w.dtype)


def conv1x1_bwd_buffers(rows, ci, co, device, f32=True):
    """K8's launch plans for x (rows, ci) and dy (rows, co) in f32 or bf16,
    the dgrad's ``mma_plan(rows, ci, co)`` and the wgrad's
    ``mma_wgrad_plan(co, ci, rows)``, and the f32 buffers they imply:
    (dgrad plan, wgrad plan, dgrad split partials (splits, rows, ci) or
    None, dW (co, ci), wgrad split partials (splits, co, ci) or None)."""
    dplan = mma_plan(rows, ci, co, f32)
    wplan = mma_wgrad_plan(co, ci, rows)
    fp = dict(dtype=torch.float32, device=device)
    dws = torch.empty((dplan[2], rows, ci), **fp) if dplan[2] > 1 else None
    wpart = torch.empty((wplan[2], co, ci), **fp) if wplan[2] > 1 else None
    return dplan, wplan, dws, torch.empty((co, ci), **fp), wpart


def conv1x1_bwd(x2d, dy2d, w):
    """K8: the backward of a 1x1 convolution y = x @ w^T with x (R, Ci), w
    (Co, Ci) or (Co, 1, 1, Ci), from dy (R, Co): (dx = dy @ w (R, Ci) in
    x's dtype, dW = dy^T x summed in f32 and cast to w's dtype, in w's
    shape).

    Replaces mxnet_tpu/ops/nn.py ``_fused1x1_bwd_pallas``.  Bound on the
    H100: arithmetic (4*R*Ci*Co operations) at the transition units'
    widths, which the tensor cores serve (bf16 MMA, float32 through
    3xTF32); it is K5's two products without finalize, prologue, mask or
    sums, on K5's loop (csrc/nn_conv1x1_bwd.cu, csrc/fu_mma.cuh): the
    weight and dy^T read in place from MN-major tiles, plans and scratch
    from ``conv1x1_bwd_buffers`` (shapes only), every split's partials
    added in a fixed order."""
    if on_host(x2d):
        return conv1x1_bwd_plain(x2d, dy2d, w)
    rows, ci = x2d.shape
    w2 = w.reshape(w.shape[0], -1)
    co = w2.shape[0]
    if dy2d.shape != (rows, co) or w2.shape[1] != ci:
        raise MXNetError("conv1x1_bwd: shapes x %s dy %s w %s disagree"
                         % (tuple(x2d.shape), tuple(dy2d.shape),
                            tuple(w.shape)))
    check("conv1x1_bwd", x2d.dtype, x2d.device, x=x2d, dy=dy2d, w=w2)
    check_dims("conv1x1_bwd", ci, co)
    dev = x2d.device
    dx = torch.empty((rows, ci), dtype=x2d.dtype, device=dev)
    dplan, wplan, dws, dw, wpart = conv1x1_bwd_buffers(
        rows, ci, co, dev, x2d.dtype == torch.float32)
    with torch.cuda.device(dev):
        launch("nn_conv1x1_bwd", x2d, dy2d, w2, dx, dw, wpart, dws, rows,
               ci, co, int(x2d.dtype == torch.bfloat16), *dplan, *wplan,
               stream(dev))
    conv1x1_bwd.launches += 1
    return dx, dw.reshape(w.shape).to(w.dtype)


conv1x1_bwd.launches = 0


class _Conv1x1FusedBwd(torch.autograd.Function):
    """A channels-last stride-1 1x1 convolution whose forward is torch's
    and whose backward is K8 (the reference's ``_conv1x1_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _to_channels_last(F.conv2d(_to_channels_first(x),
                                          _to_channels_first(w)))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ci, co = x.shape[-1], w.shape[0]
        dx, dw = conv1x1_bwd(x.contiguous().reshape(-1, ci),
                             dy.contiguous().reshape(-1, co), w)
        return dx.reshape(x.shape), dw


def _conv1x1_fused_eligible(attrs, k, stride, pad, data):
    """The reference's gate (``_conv1x1_fused_eligible``) without its
    row-divisibility condition, a TPU tile constraint: both paths give
    the same gradient."""
    return (config.get("MXNET_CONV1X1_FUSED_BWD") and _channels_last(attrs)
            and data.ndim == 4 and all(ki == 1 for ki in k)
            and all(s == 1 for s in stride) and attrs["num_group"] == 1
            and not any(pad) and data.shape[1] * data.shape[2] <= 256)


@register("Convolution", aliases=["convolution", "Convolution_v1",
                                  "convolution_v1"],
          nin=lambda attrs: 2 if (attrs or {}).get("no_bias") else 3,
          input_names=["data", "weight", "bias"], fill_shapes=_conv_fill,
          params=_CONV_PARAMS)
def convolution(attrs, data, weight, bias=None):
    nd = data.ndim - 2
    k = tuple(attrs["kernel"])
    stride = tuple(attrs["stride"]) or (1,) * nd
    dilate = tuple(attrs["dilate"]) or (1,) * nd
    pad = tuple(attrs["pad"]) or (0,) * nd
    cl = _channels_last(attrs)
    if _conv1x1_fused_eligible(attrs, k, stride, pad, data):
        out = _Conv1x1FusedBwd.apply(data, weight)
    elif (cl and all(ki == 1 for ki in k) and attrs["num_group"] == 1
            and not any(pad)):
        out = _conv1x1_cl(data, weight, stride)
    elif cl:
        out = _to_channels_last(_CONV_FN[nd](
            _to_channels_first(data), _to_channels_first(weight),
            stride=stride, padding=pad, dilation=dilate,
            groups=attrs["num_group"]))
    else:
        out = _CONV_FN[nd](data, weight, stride=stride, padding=pad,
                           dilation=dilate, groups=attrs["num_group"])
    if bias is not None and not attrs["no_bias"]:
        bshape = (1,) * (data.ndim - 1) + (-1,) if cl else (1, -1) + (1,) * nd
        out = out + bias.reshape(bshape)
    return out


def _deconv_fill(attrs, in_shapes):
    out = list(in_shapes)
    data = out[0]
    if data is not None:
        k = tuple(attrs["kernel"])
        nf = attrs["num_filter"]
        ng = attrs.get("num_group", 1)
        if _channels_last(attrs):
            wshape = (data[-1],) + k + (nf // ng,)
        else:
            wshape = (data[1], nf // ng) + k
        if len(out) > 1 and out[1] is None:
            out[1] = wshape
        if len(out) > 2 and out[2] is None:
            out[2] = (nf,)
    return out


_CONVT_FN = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
             3: F.conv_transpose3d}


@register("Deconvolution", aliases=["deconvolution"],
          nin=lambda attrs: 2 if (attrs or {}).get("no_bias", True) else 3,
          input_names=["data", "weight", "bias"], fill_shapes=_deconv_fill,
          params={**_CONV_PARAMS, "adj": P("shape", ()),
                  "target_shape": P("shape", ()), "no_bias": P(bool, True)})
def deconvolution(attrs, data, weight, bias=None):
    """Transposed convolution as the reference computes it: the input
    dilated by ``stride``, padded by ``(k - 1) * dilate - pad`` (plus
    ``adj`` at the high end) and correlated with the weight as it is
    stored, (C_in, num_filter / num_group, *kernel) (channels-last: C_in,
    *kernel, num_filter / num_group).  torch's transposed convolution
    correlates with the kernel flipped, so the weight goes in flipped."""
    nd = data.ndim - 2
    stride = tuple(attrs["stride"]) or (1,) * nd
    dilate = tuple(attrs["dilate"]) or (1,) * nd
    pad = tuple(attrs["pad"]) or (0,) * nd
    adj = tuple(attrs["adj"]) or (0,) * nd
    cl = _channels_last(attrs)
    x = _to_channels_first(data) if cl else data
    w = weight.permute(0, weight.ndim - 1, *range(1, weight.ndim - 1)) \
        if cl else weight
    w = torch.flip(w, tuple(range(2, w.ndim)))
    out = _CONVT_FN[nd](x, w, stride=stride, padding=pad,
                        output_padding=adj, groups=attrs["num_group"],
                        dilation=dilate)
    if bias is not None and not attrs["no_bias"]:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return _to_channels_last(out) if cl else out


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_POOL_FN = {"max": {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d},
            "avg": {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}}


@register("Pooling", aliases=["pooling", "Pooling_v1", "pooling_v1"],
          params={"kernel": P("shape", ()), "stride": P("shape", ()),
                  "pad": P("shape", ()),
                  "pool_type": P(str, "max", choices=["max", "avg", "sum"]),
                  "global_pool": P(bool, False),
                  "pooling_convention": P(str, "valid",
                                          choices=["valid", "full"]),
                  "layout": P("str_or_none", None),
                  "cudnn_off": P(bool, False)})
def pooling(attrs, data):
    nd = data.ndim - 2
    cl = _channels_last(attrs)
    spatial = tuple(range(1, data.ndim - 1)) if cl \
        else tuple(range(2, data.ndim))
    pt = attrs["pool_type"]
    if attrs["global_pool"]:
        if pt == "max":
            return data.amax(dim=spatial, keepdim=True)
        if pt == "sum":
            return data.sum(dim=spatial, keepdim=True)
        return data.mean(dim=spatial, keepdim=True)
    k = tuple(attrs["kernel"])
    stride = tuple(attrs["stride"]) or (1,) * nd
    pad = tuple(attrs["pad"]) or (0,) * nd
    x = _to_channels_first(data) if cl else data
    if pt == "sum" or attrs["pooling_convention"] == "full":
        y = _pool_padded(x, pt, k, stride, pad,
                         attrs["pooling_convention"] == "full")
    elif pt == "max":
        # torch pads max pooling with -inf, as the reference does
        y = _POOL_FN["max"][nd](x, k, stride, pad)
    else:
        # the reference divides by the full window, padding included
        y = _POOL_FN["avg"][nd](x, k, stride, pad, count_include_pad=True)
    return _to_channels_last(y) if cl else y


def _pool_padded(x, pt, k, stride, pad, full):
    """Pooling over the input padded explicitly, as the reference pools:
    under the ``full`` convention each axis gets the extra high padding
    that makes its last partial window count; max pads with -inf, avg and
    sum with 0, and avg divides by the whole window."""
    nd = x.ndim - 2
    pads = []
    for i in reversed(range(nd)):
        lo = hi = pad[i]
        rem = (x.shape[2 + i] + 2 * pad[i] - k[i]) % stride[i]
        if full and rem:
            hi += stride[i] - rem
        pads += [lo, hi]
    fill = float("-inf") if pt == "max" else 0.0
    xp = F.pad(x, pads, value=fill)
    if pt == "max":
        return _POOL_FN["max"][nd](xp, k, stride)
    y = _POOL_FN["avg"][nd](xp, k, stride)
    return y * float(math.prod(k)) if pt == "sum" else y


# ---------------------------------------------------------------------------
# BatchNorm: batch statistics in training, moving statistics in eval
# ---------------------------------------------------------------------------

_BN_PARAMS = {"eps": P(float, 1e-3), "momentum": P(float, 0.9),
              "fix_gamma": P(bool, True), "use_global_stats": P(bool, False),
              "output_mean_var": P(bool, False), "axis": P(int, 1),
              "cudnn_off": P(bool, False)}


def _bn_fill(attrs, in_shapes):
    out = list(in_shapes)
    data = out[0]
    if data is not None:
        c = data[attrs.get("axis", 1) % len(data)]
        for i in range(1, 5):
            if len(out) > i and out[i] is None:
                out[i] = (c,)
    return out


def _batch_stats(xf, red):
    """Batch mean and variance of the f32 tensor ``xf`` over the axes
    ``red``: E[x] and E[x^2], the variance clamped at 0 so that f32
    cancellation cannot make it negative."""
    mean = xf.mean(red)
    return mean, torch.clamp((xf * xf).mean(red) - mean * mean, min=0.0)


class _BatchNormTrain(torch.autograd.Function):
    """Training BatchNorm: (out, batch mean, batch var) with the
    reference's hand-written backward (``_bn_train_bwd``): one pass for
    the two sums, one for dx.  The statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, red, bshape):
        xf = x.float()
        mean, var = _batch_stats(xf, red)
        inv = torch.rsqrt(var + eps)
        scale = gamma * inv
        shift = beta - mean * scale
        out = (xf * scale.reshape(bshape) + shift.reshape(bshape)) \
            .to(x.dtype)
        ctx.red, ctx.bshape = red, bshape
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        red, bshape = ctx.red, ctx.bshape
        dyf, xf = dy.float(), x.float()
        n = xf.numel() // mean.numel()
        sdy = dyf.sum(red)
        sdyx = (dyf * xf).sum(red)
        dgamma = (sdyx - mean * sdy) * inv
        xhat = (xf - mean.reshape(bshape)) * inv.reshape(bshape)
        dx = ((gamma * inv).reshape(bshape)
              * (dyf - (sdy / n).reshape(bshape)
                 - xhat * (dgamma / n).reshape(bshape))).to(x.dtype)
        return dx, dgamma, sdy, None, None, None


def _batch_norm_impl(attrs, data, gamma, beta, mov_mean, mov_var):
    """Outputs (out, mean, var, moving_mean, moving_var): three graph
    outputs, then the two aux write-backs (unchanged in eval).  With
    fix_gamma the scale is ones, so gamma's gradient is zero."""
    ax = attrs["axis"] % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.ndim))
    f32 = torch.float32
    gamma32 = torch.ones_like(gamma, dtype=f32) if attrs["fix_gamma"] \
        else gamma.to(f32)
    if attrs.get("_training", False) and not attrs["use_global_stats"]:
        out, mean, var = _BatchNormTrain.apply(
            data, gamma32, beta.to(f32), attrs["eps"], red, bshape)
        m = attrs["momentum"]
        return (out, mean, var, m * mov_mean + (1 - m) * mean,
                m * mov_var + (1 - m) * var)
    mean = mov_mean.to(f32)
    var = mov_var.to(f32)
    scale = gamma32 * torch.rsqrt(var + attrs["eps"])
    shift = beta.to(f32) - mean * scale
    out = (data.to(f32) * scale.reshape(bshape)
           + shift.reshape(bshape)).to(data.dtype)
    return out, mean, var, mov_mean, mov_var


register("BatchNorm", aliases=["batch_norm", "BatchNorm_v1", "batch_norm_v1",
                               "CuDNNBatchNorm"],
         nin=5, input_names=["data", "gamma", "beta", "moving_mean",
                             "moving_var"],
         aux_inputs=(3, 4), nout=3,
         num_visible_outputs=lambda attrs: 3 if (attrs or {}).get(
             "output_mean_var") else 1,
         mutate_aux={3: 3, 4: 4}, mode_dependent=True,
         fill_shapes=_bn_fill, params=_BN_PARAMS)(_batch_norm_impl)


# ---------------------------------------------------------------------------
# _contrib_BNStemConv: the input BatchNorm fused with the stem convolution
# ---------------------------------------------------------------------------
#
# BatchNorm(fix_gamma=True) on the raw input, then the stem convolution.
# Under autodiff the only live cotangent into that BatchNorm is dbeta =
# sum(d conv input), which the backward takes without the stem's dgrad
# convolution:
#
#     sum_m dx[m] = sum_{kh,kw} W[kh,kw] * (sum of g over the output
#                   positions whose window covers tap (kh,kw))
#
# from per-tap rectangle sums of sum_n(g), as separable masked
# contractions along H and along W.  ``data`` is a graph input: the op
# returns zero for d(data) and for gamma.

def _bn_stem_fill(attrs, in_shapes):
    out = list(in_shapes)
    data = out[0]
    if data is not None:
        cl = _channels_last(attrs)
        cin = data[-1] if cl else data[1]
        k = tuple(attrs["kernel"])
        for i in (1, 2, 4, 5):
            if len(out) > i and out[i] is None:
                out[i] = (cin,)
        if len(out) > 3 and out[3] is None:
            out[3] = ((attrs["num_filter"],) + k + (cin,) if cl
                      else (attrs["num_filter"], cin) + k)
    return out


def _stem_valid_mask(k_dim, pad, stride, in_size, out_size, device):
    """(K, OUT) f32 0/1 mask: mask[k, o] = 1 where output o's window covers
    tap k, that is where o*stride + k - pad lies in [0, in_size)."""
    o = torch.arange(out_size, device=device)
    k = torch.arange(k_dim, device=device)[:, None]
    pos = o * stride + k - pad
    return ((pos >= 0) & (pos < in_size)).float()


def _bn_stem_norm(xf, beta, mean, inv, cl, dtype):
    """(x - mean) * inv + beta from the f32 data ``xf`` (gamma fixed at
    1), rounded to ``dtype``, the data's."""
    ax = xf.ndim - 1 if cl else 1
    bshape = tuple(xf.shape[ax] if i == ax else 1 for i in range(xf.ndim))
    return ((xf - mean.reshape(bshape)) * inv.reshape(bshape)
            + beta.float().reshape(bshape)).to(dtype)


def _bn_stem_conv(bn, weight, stride, pad, cl):
    if cl:
        return _to_channels_last(F.conv2d(
            _to_channels_first(bn), _to_channels_first(weight),
            stride=stride, padding=pad))
    return F.conv2d(bn, weight, stride=stride, padding=pad)


class _BNStemConv(torch.autograd.Function):
    """Training forward from the batch statistics, and the reference's
    backward (``_bn_stem_bwd``): dW through the convolution with the
    normalized input recomputed from the saved statistics, dbeta from the
    per-tap rectangle sums, zero for the data.  Outputs (out, mean, var);
    the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, data, beta, weight, eps, stride, pad, cl):
        red = tuple(i for i in range(data.ndim)
                    if i != (data.ndim - 1 if cl else 1))
        xf = data.float()
        mean, var = _batch_stats(xf, red)
        inv = torch.rsqrt(var + eps)
        out = _bn_stem_conv(_bn_stem_norm(xf, beta, mean, inv, cl,
                                          data.dtype), weight, stride, pad,
                            cl)
        ctx.cfg = (stride, pad, cl)
        ctx.save_for_backward(data, beta, weight, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        stride, pad, cl = ctx.cfg
        data, beta, weight, mean, inv = ctx.saved_tensors
        bn = _bn_stem_norm(data.float(), beta, mean, inv, cl, data.dtype)
        if cl:
            dw = _to_channels_last(torch.nn.grad.conv2d_weight(
                _to_channels_first(bn), _to_channels_first(weight).shape,
                _to_channels_first(g), stride=stride, padding=pad))
            gsum = g.float().sum(0)                          # (OH, OW, O)
            kh, kw = weight.shape[1], weight.shape[2]
            in_h, in_w = data.shape[1], data.shape[2]
        else:
            dw = torch.nn.grad.conv2d_weight(bn, weight.shape, g,
                                             stride=stride, padding=pad)
            gsum = g.float().sum(0).movedim(0, -1)           # (OH, OW, O)
            kh, kw = weight.shape[2], weight.shape[3]
            in_h, in_w = data.shape[2], data.shape[3]
        vh = _stem_valid_mask(kh, pad[0], stride[0], in_h, gsum.shape[0],
                              g.device)
        vw = _stem_valid_mask(kw, pad[1], stride[1], in_w, gsum.shape[1],
                              g.device)
        t = torch.einsum("bw,awo->abo", vw,
                         torch.einsum("ah,hwo->awo", vh, gsum))
        dbeta = torch.einsum("hwo,ohwc->c" if cl else "hwo,ochw->c", t,
                             weight.float())
        return (torch.zeros_like(data), dbeta.to(beta.dtype),
                dw.to(weight.dtype), None, None, None, None)


@register("_contrib_BNStemConv",
          nin=6,
          input_names=["data", "gamma", "beta", "weight",
                       "moving_mean", "moving_var"],
          aux_inputs=(4, 5), nout=1, mutate_aux={4: 1, 5: 2},
          mode_dependent=True, fill_shapes=_bn_stem_fill,
          params={"eps": P(float, 2e-5), "momentum": P(float, 0.9),
                  "fix_gamma": P(bool, True),
                  "num_filter": P(int), "kernel": P("shape"),
                  "stride": P("shape", ()), "pad": P("shape", ()),
                  "layout": P("str_or_none", None)})
def bn_stem_conv(attrs, data, gamma, beta, weight, mov_mean, mov_var):
    """BatchNorm(fix_gamma=True) of the input, then a 2-D convolution,
    with no bias.  Training normalizes by the batch statistics and returns
    the two moving averages updated; eval uses and returns them."""
    if not attrs["fix_gamma"]:
        raise MXNetError("_contrib_BNStemConv requires fix_gamma=true (the "
                         "reference bn_data contract); use separate "
                         "BatchNorm + Convolution otherwise")
    if data.ndim != 4:
        raise MXNetError("_contrib_BNStemConv supports 2D convs only")
    stride = tuple(attrs["stride"]) or (1, 1)
    pad = tuple(attrs["pad"]) or (0, 0)
    cl = _channels_last(attrs)
    if attrs.get("_training", False):
        out, mean, var = _BNStemConv.apply(data, beta.float(), weight,
                                           attrs["eps"], stride, pad, cl)
        m = attrs["momentum"]
        return (out, m * mov_mean + (1 - m) * mean,
                m * mov_var + (1 - m) * var)
    mean = mov_mean.float()
    inv = torch.rsqrt(mov_var.float() + attrs["eps"])
    bn = _bn_stem_norm(data.float(), beta, mean, inv, cl, data.dtype)
    return _bn_stem_conv(bn, weight, stride, pad, cl), mov_mean, mov_var


# ---------------------------------------------------------------------------
# Activation / SoftmaxOutput
# ---------------------------------------------------------------------------

_ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": F.softsign}


@register("Activation", aliases=["activation"],
          params={"act_type": P(str, choices=["relu", "sigmoid", "tanh",
                                              "softrelu", "softsign"])})
def activation(attrs, x):
    return _ACT[attrs["act_type"]](x)


@register("SoftmaxOutput", aliases=["softmax_output", "Softmax"],
          nin=2, input_names=["data", "label"],
          fill_shapes=lambda attrs, s: [s[0], (s[0][0],) if s[0] and len(s) > 1
                                        and s[1] is None else s[1]],
          params={"grad_scale": P(float, 1.0), "ignore_label": P(float, -1.0),
                  "multi_output": P(bool, False), "use_ignore": P(bool, False),
                  "preserve_shape": P(bool, False),
                  "normalization": P(str, "null",
                                     choices=["null", "batch", "valid"]),
                  "out_grad": P(bool, False), "smooth_alpha": P(float, 0.0)})
def softmax_output(attrs, data, label):
    """Softmax over the class axis; its gradient is the loss's, whatever
    the head gradient (``_SoftmaxOutput``)."""
    return _SoftmaxOutput.apply(data, label, attrs)


def _softmax_fwd(data, multi_output):
    if multi_output:
        return torch.softmax(data, dim=1)
    if data.ndim > 2:
        return torch.softmax(data.reshape(data.shape[0], -1),
                             dim=-1).reshape(data.shape)
    return torch.softmax(data, dim=-1)


class _SoftmaxOutput(torch.autograd.Function):
    """Loss head (softmax_output-inl.h): d(data) = p - onehot(label),
    with label smoothing, ignored labels, normalization and grad_scale as
    the reference applies them; the incoming head gradient is not read,
    so ``backward()`` needs none."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        out = _softmax_fwd(data, attrs["multi_output"])
        ctx.attrs = attrs
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        a = ctx.attrs
        axis = 1 if a["multi_output"] else -1
        k = out.shape[axis]
        lab = label.long()
        # labels outside [0, k) one-hot to zeros, as jax.nn.one_hot does
        onehot = (lab.unsqueeze(-1) == torch.arange(k, device=lab.device)) \
            .to(out.dtype).movedim(-1, axis)
        alpha = a["smooth_alpha"]
        if alpha:
            onehot = onehot * (1 - alpha) + alpha / (k - 1) * (1 - onehot)
        grad = out - onehot
        valid = None
        if a["use_ignore"]:
            mask = (lab != int(a["ignore_label"])).to(out.dtype)
            grad = grad * mask.unsqueeze(axis)
            valid = torch.clamp(mask.sum(), min=1.0)
        if a["normalization"] == "batch":
            grad = grad / out.shape[0]
        elif a["normalization"] == "valid":
            grad = grad / (valid if valid is not None else label.numel())
        return grad * a["grad_scale"], torch.zeros_like(label), None


@register("MakeLoss",
          params={"grad_scale": P(float, 1.0),
                  "valid_thresh": P(float, 0.0),
                  "normalization": P(str, "null",
                                     choices=["null", "batch", "valid"])})
def make_loss_layer(attrs, data):
    """The identity forward; its gradient is ``grad_scale`` everywhere,
    whatever the head gradient (``_MakeLoss``)."""
    return _MakeLoss.apply(data, attrs["grad_scale"], attrs["normalization"])


class _MakeLoss(torch.autograd.Function):
    """Legacy loss layer (make_loss-inl.h): d(data) = grad_scale, divided
    by shape[0] under "batch" and, as the JAX package does, by the element
    count under "valid" (the reference counts the elements above
    ``valid_thresh``)."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization):
        scale = grad_scale
        if normalization == "batch":
            scale = scale / data.shape[0]
        elif normalization == "valid":
            scale = scale / float(math.prod(data.shape))
        ctx.scale = scale
        ctx.meta = (data.shape, data.dtype, data.device)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, _head):
        shape, dtype, device = ctx.meta
        return torch.full(shape, ctx.scale, dtype=dtype, device=device), \
            None, None


# ---------------------------------------------------------------------------
# Embedding and softmax (the attention decoder's)
# ---------------------------------------------------------------------------

@register("Embedding", aliases=["embedding", "_contrib_SparseEmbedding"],
          nin=2, input_names=["data", "weight"],
          fill_shapes=lambda attrs, s: [
              s[0], (attrs["input_dim"], attrs["output_dim"])
              if len(s) > 1 and s[1] is None else s[1]],
          params={"input_dim": P(int), "output_dim": P(int),
                  "dtype": P(str, "float32"), "sparse_grad": P(bool, False)})
def embedding(attrs, data, weight):
    """Rows of ``weight`` at the ids in ``data``, truncated to int32 and
    clamped into ``[0, input_dim)`` as the reference does."""
    idx = data.to(torch.int32).clamp(0, attrs["input_dim"] - 1)
    return weight[idx.long()]


@register("softmax", params={"axis": P(int, -1),
                             "temperature": P("float_or_none", None)})
def softmax_op(attrs, x):
    t = attrs["temperature"]
    if t:
        x = x / t
    return torch.softmax(x, dim=attrs["axis"])


@register("log_softmax", params={"axis": P(int, -1),
                                 "temperature": P("float_or_none", None)})
def log_softmax_op(attrs, x):
    t = attrs["temperature"]
    if t:
        x = x / t
    return torch.log_softmax(x, dim=attrs["axis"])


# ---------------------------------------------------------------------------
# InstanceNorm, Dropout
# ---------------------------------------------------------------------------

def _in_fill(attrs, s):
    out = list(s)
    if s[0] is not None:
        for i in (1, 2):
            if len(out) > i and out[i] is None:
                out[i] = (s[0][1],)
    return out


@register("InstanceNorm", aliases=["instance_norm"],
          nin=3, input_names=["data", "gamma", "beta"], fill_shapes=_in_fill,
          params={"eps": P(float, 1e-3)})
def instance_norm(attrs, data, gamma, beta):
    """Each sample's channels normalized over their spatial axes (the
    biased variance), then scaled by gamma and shifted by beta."""
    red = tuple(range(2, data.ndim))
    mean = data.mean(red, keepdim=True)
    var = data.var(red, unbiased=False, keepdim=True)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (data - mean) * torch.rsqrt(var + attrs["eps"])
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("Dropout", aliases=["dropout"], stochastic=True,
          mode_dependent=True,
          params={"p": P(float, 0.5),
                  "mode": P(str, "training", choices=["training", "always"]),
                  "axes": P("shape", ())})
def dropout(attrs, x):
    """In training (or with mode ``always``) each element is kept with
    probability 1 - p and scaled by 1 / (1 - p); the mask is drawn from
    the explicit generator of ``x``'s device (``random.generator``), one
    draw per element, shared along ``axes``.  Otherwise ``x`` itself."""
    p = attrs["p"]
    active = attrs.get("_training", False) or attrs["mode"] == "always"
    if not active or p <= 0 or x.device.type == "meta":
        return x
    shape = tuple(1 if i in attrs["axes"] else d
                  for i, d in enumerate(x.shape))
    gen = _random.generator(Context.of(x.device))
    u = torch.rand(shape, generator=gen, device=x.device)
    keep = (u < 1.0 - p).to(x.dtype)
    return x * keep / (1.0 - p)


# ---------------------------------------------------------------------------
# Sequence ops: data (T, batch, ...) unless ``axis`` says otherwise
# ---------------------------------------------------------------------------

def _seq_nin(attrs):
    return 2 if (attrs or {}).get("use_sequence_length") else 1


@register("SequenceMask", aliases=["sequence_mask"], nin=_seq_nin,
          input_names=["data", "sequence_length"],
          params={"use_sequence_length": P(bool, False),
                  "value": P(float, 0.0), "axis": P(int, 0)})
def sequence_mask(attrs, data, seq_len=None):
    """Steps at or past each sequence's length set to ``value``.  Time on
    axis 0 is the reference's (T, batch, ...) layout; any other time axis
    takes the batch on axis 0."""
    if not attrs["use_sequence_length"]:
        return data
    ax = attrs["axis"]
    T = data.shape[ax]
    steps = torch.arange(T, device=data.device)
    sl = seq_len.long()
    if ax == 0:
        mask = steps[:, None] < sl[None, :]
        mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    else:
        mask = (steps.reshape((1,) * ax + (T,) + (1,) * (data.ndim - ax - 1))
                < sl.reshape((sl.shape[0],) + (1,) * (data.ndim - 1)))
    return torch.where(mask, data, torch.full((), attrs["value"],
                                              dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast", aliases=["sequence_last"], nin=_seq_nin,
          input_names=["data", "sequence_length"],
          params={"use_sequence_length": P(bool, False), "axis": P(int, 0)})
def sequence_last(attrs, data, seq_len=None):
    """Each sequence's last valid step: time on ``axis`` 0 indexes
    (T, batch, ...), any other axis (batch, T, ...)."""
    ax = attrs["axis"]
    if not attrs["use_sequence_length"]:
        return data.select(ax, data.shape[ax] - 1)
    idx = seq_len.long() - 1
    rows = torch.arange(idx.shape[0], device=data.device)
    return data[idx, rows] if ax == 0 else data[rows, idx]


@register("SequenceReverse", aliases=["sequence_reverse"], nin=_seq_nin,
          input_names=["data", "sequence_length"],
          params={"use_sequence_length": P(bool, False), "axis": P(int, 0)})
def sequence_reverse(attrs, data, seq_len=None):
    """Each sequence's valid steps reversed along axis 0, the padding left
    in place (the whole axis 0 without ``use_sequence_length``)."""
    if not attrs["use_sequence_length"]:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    sl = seq_len.long()[None, :]
    t = torch.arange(T, device=data.device)[:, None]
    src = torch.where(t < sl, sl - 1 - t, t)                  # (T, batch)
    src = src.reshape(src.shape + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, src)
