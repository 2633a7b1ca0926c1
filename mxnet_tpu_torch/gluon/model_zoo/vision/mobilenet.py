"""MobileNet v1, table-driven (Howard et al. 1704.04861; counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``).

The whole body is one generated row table: a full-conv stem, then 13
depthwise-separable pairs described by (width, stride) entries, scaled by
the channel multiplier.  The assembler in _builder.py consumes it.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._builder import assemble, named_factory

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25"]

# (pointwise output width, depthwise stride) for each separable pair;
# the depthwise stage always runs at the PREVIOUS pair's width
_SEPARABLE = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
              (512, 2)] + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]


def _body_rows(multiplier):
    def m(width):
        return int(width * multiplier)
    rows = [("conv", m(32), 3, 2, 1, {"bias": False}), ("bn",), ("relu",)]
    prev = 32
    for width, stride in _SEPARABLE:
        rows += [("conv", m(prev), 3, stride, 1,
                  {"groups": m(prev), "bias": False}), ("bn",), ("relu",),
                 ("conv", m(width), 1, 1, 0, {"bias": False}), ("bn",),
                 ("relu",)]
        prev = width
    return rows + [("gap",), ("flatten",)]


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                assemble(self.features, _body_rows(multiplier))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        from ..model_store import get_model_file
        tag = "%.2f" % multiplier
        tag = tag[:-1] if tag.endswith("0") else tag   # 1.00 -> 1.0
        net.load_params(get_model_file("mobilenet%s" % tag, root=root),
                        ctx=ctx)
    return net


mobilenet1_0 = named_factory("mobilenet1_0", get_mobilenet, 1.0)
mobilenet0_75 = named_factory("mobilenet0_75", get_mobilenet, 0.75)
mobilenet0_5 = named_factory("mobilenet0_5", get_mobilenet, 0.5)
mobilenet0_25 = named_factory("mobilenet0_25", get_mobilenet, 0.25)
