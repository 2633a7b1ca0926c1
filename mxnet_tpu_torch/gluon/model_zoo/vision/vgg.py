"""VGG 11/13/16/19, with and without BatchNorm, table-driven
(Simonyan & Zisserman 1409.1556; counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``).

One spec table (convs-per-stage x stage widths) expands into a row list
for the shared assembler; the classifier tail is three Dense rows.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....initializer import Xavier
from ._builder import assemble, named_factory

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]

vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}

_CONV_INIT = {"init": Xavier(rnd_type="gaussian", factor_type="out",
                             magnitude=2)}


def _feature_rows(layers, filters, batch_norm):
    rows = []
    for count, width in zip(layers, filters):
        for _ in range(count):
            rows.append(("conv", width, 3, 1, 1, _CONV_INIT))
            if batch_norm:
                rows.append(("bn",))
            rows.append(("relu",))
        rows.append(("pool", 2, 2, 0))
    for _ in range(2):
        rows += [("dense", 4096, {"act": "relu", "init": "normal"}),
                 ("dropout", 0.5)]
    return rows


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("need one width per stage")
        with self.name_scope():
            self.features = assemble(
                nn.HybridSequential(prefix=""),
                _feature_rows(layers, filters, batch_norm))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import get_model_file
        tag = "_bn" if kwargs.get("batch_norm") else ""
        net.load_params(get_model_file("vgg%d%s" % (num_layers, tag),
                                       root=root), ctx=ctx)
    return net


vgg11 = named_factory("vgg11", get_vgg, 11)
vgg13 = named_factory("vgg13", get_vgg, 13)
vgg16 = named_factory("vgg16", get_vgg, 16)
vgg19 = named_factory("vgg19", get_vgg, 19)
vgg11_bn = named_factory("vgg11_bn", get_vgg, 11, batch_norm=True)
vgg13_bn = named_factory("vgg13_bn", get_vgg, 13, batch_norm=True)
vgg16_bn = named_factory("vgg16_bn", get_vgg, 16, batch_norm=True)
vgg19_bn = named_factory("vgg19_bn", get_vgg, 19, batch_norm=True)
