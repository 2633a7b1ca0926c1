"""Gluon convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv1D/2D/3D (Conv2D in NCHW or
NHWC), the transposed convolutions over ``Deconvolution``, and the max,
average and global poolings over ``Pooling`` (``ceil_mode`` is its
``full`` convention)."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _to_tuple(x, n):
    if isinstance(x, int):
        return (x,) * n
    if len(x) != n:
        raise ValueError("expected %d values, got %r" % (n, x))
    return tuple(x)


class _Conv(HybridBlock):
    """Base convolution: the weight's shape comes from the op's own shape
    fill, with the input channels unknown (0) until the first forward
    unless ``in_channels`` gives them."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            if isinstance(kernel_size, int):
                kernel_size = (kernel_size,)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj

            dshape = [0] * (len(kernel_size) + 2)
            dshape[layout.find("N")] = 1
            dshape[layout.find("C")] = in_channels
            wshapes = self._infer_weight_shape(op_name, tuple(dshape))
            self.weight = self.params.get("weight", shape=wshapes[1],
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=wshapes[2],
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None

            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_weight_shape(self, op_name, data_shape):
        from ... import symbol
        op = getattr(symbol, op_name)
        sym = op(symbol.var("data", shape=data_shape), **self._kwargs)
        return sym.infer_shape_partial()[0]

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = getattr(F, self._op_name)(x, weight, name="fwd",
                                            **self._kwargs)
        else:
            act = getattr(F, self._op_name)(x, weight, bias, name="fwd",
                                            **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride})"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]),
                        **self._kwargs)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 1)
        strides = _to_tuple(strides, 1)
        padding = _to_tuple(padding, 1)
        dilation = _to_tuple(dilation, 1)
        if layout != "NCW":
            raise ValueError("Only supports 'NCW' layout for now")
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 2)
        strides = _to_tuple(strides, 2)
        padding = _to_tuple(padding, 2)
        dilation = _to_tuple(dilation, 2)
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("Only supports 'NCHW' and 'NHWC' layout for "
                             "now")
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 3)
        strides = _to_tuple(strides, 3)
        padding = _to_tuple(padding, 3)
        dilation = _to_tuple(dilation, 3)
        if layout not in ("NCDHW", "NDHWC"):
            raise ValueError("Only supports 'NCDHW' and 'NDHWC' layout for "
                             "now")
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 1)
        strides = _to_tuple(strides, 1)
        padding = _to_tuple(padding, 1)
        dilation = _to_tuple(dilation, 1)
        output_padding = _to_tuple(output_padding, 1)
        if layout != "NCW":
            raise ValueError("Only supports 'NCW' layout for now")
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)
        self.outpad = output_padding


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 2)
        strides = _to_tuple(strides, 2)
        padding = _to_tuple(padding, 2)
        dilation = _to_tuple(dilation, 2)
        output_padding = _to_tuple(output_padding, 2)
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("Only supports 'NCHW' and 'NHWC' layout for "
                             "now")
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)
        self.outpad = output_padding


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 3)
        strides = _to_tuple(strides, 3)
        padding = _to_tuple(padding, 3)
        dilation = _to_tuple(dilation, 3)
        output_padding = _to_tuple(output_padding, 3)
        if layout not in ("NCDHW", "NDHWC"):
            raise ValueError("Only supports 'NCDHW' and 'NDHWC' layout for "
                             "now")
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)
        self.outpad = output_padding


class _Pooling(HybridBlock):
    """Base pooling."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        s = "{name}(size={kernel}, stride={stride}, padding={pad}, " \
            "ceil_mode={ceil_mode})"
        return s.format(name=self.__class__.__name__,
                        ceil_mode=self._kwargs["pooling_convention"] == "full",
                        **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        if layout != "NCW":
            raise ValueError("Only supports 'NCW' layout for now")
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        if len(pool_size) != 1:
            raise ValueError("pool_size %r has the wrong length"
                             % (pool_size,))
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("Only supports 'NCHW' and 'NHWC' layout for "
                             "now")
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        if len(pool_size) != 2:
            raise ValueError("pool_size %r has the wrong length"
                             % (pool_size,))
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        if layout != "NCDHW":
            raise ValueError("Only supports 'NCDHW' layout for now")
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        if len(pool_size) != 3:
            raise ValueError("pool_size %r has the wrong length"
                             % (pool_size,))
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        if layout != "NCW":
            raise ValueError("Only supports 'NCW' layout for now")
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        if len(pool_size) != 1:
            raise ValueError("pool_size %r has the wrong length"
                             % (pool_size,))
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("Only supports 'NCHW' and 'NHWC' layout for "
                             "now")
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        if len(pool_size) != 2:
            raise ValueError("pool_size %r has the wrong length"
                             % (pool_size,))
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        if layout != "NCDHW":
            raise ValueError("Only supports 'NCDHW' layout for now")
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        if len(pool_size) != 3:
            raise ValueError("pool_size %r has the wrong length"
                             % (pool_size,))
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        if layout != "NCW":
            raise ValueError("Only supports 'NCW' layout for now")
        super().__init__((1,), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("Only supports 'NCHW' and 'NHWC' layout for "
                             "now")
        super().__init__((1, 1), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        if layout != "NCDHW":
            raise ValueError("Only supports 'NCDHW' layout for now")
        super().__init__((1, 1, 1), None, 0, True, True, "max", **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        if layout != "NCW":
            raise ValueError("Only supports 'NCW' layout for now")
        super().__init__((1,), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("Only supports 'NCHW' and 'NHWC' layout for "
                             "now")
        super().__init__((1, 1), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        if layout != "NCDHW":
            raise ValueError("Only supports 'NCDHW' layout for now")
        super().__init__((1, 1, 1), None, 0, True, True, "avg", **kwargs)
