"""ResNet v1/v2 for Gluon, table-driven.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (He et
al. 1512.03385 v1 in the torch-style stride-on-first-conv variant;
1603.05027 v2 pre-activation).  Here each unit variant is ONE row table
consumed by a generic ResidualUnit, and both network versions share one
generic assembler — the architecture is data, not transcribed class
bodies.  Parameterized-layer order matches the reference exactly (incl.
its quirks: v1 bottleneck 1x1 convs keep their bias, v2 downsample is a
bare conv), so parameter names and checkpoints are unchanged.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._builder import assemble, make_layer, named_factory

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]

_NOBIAS = {"bias": False}


def _unit_rows(version, kind, c, s):
    """Forward-order row table of one residual unit."""
    q = c // 4
    if version == 1:
        if kind == "basic":
            return [("conv", c, 3, s, 1, _NOBIAS), ("bn",), ("relu",),
                    ("conv", c, 3, 1, 1, _NOBIAS), ("bn",)]
        return [("conv", q, 1, s, 0), ("bn",), ("relu",),       # bias kept:
                ("conv", q, 3, 1, 1, _NOBIAS), ("bn",), ("relu",),  # ref quirk
                ("conv", c, 1, 1, 0), ("bn",)]
    if kind == "basic":
        return [("bn",), ("relu",), ("conv", c, 3, s, 1, _NOBIAS),
                ("bn",), ("relu",), ("conv", c, 3, 1, 1, _NOBIAS)]
    return [("bn",), ("relu",), ("conv", q, 1, 1, 0, _NOBIAS),
            ("bn",), ("relu",), ("conv", q, 3, s, 1, _NOBIAS),
            ("bn",), ("relu",), ("conv", c, 1, 1, 0, _NOBIAS)]


class ResidualUnit(HybridBlock):
    """One residual unit assembled from a row table.

    v1 (post-activation): rows live in ``self.body``; the skip path is an
    optional conv+bn pair; output = relu(body(x) + skip(x)).
    v2 (pre-activation): rows apply in sequence; the skip branches off the
    FIRST activated tensor (after the leading bn+relu) through an optional
    bare conv; output = chain(x) + skip.
    """

    def __init__(self, version, kind, channels, stride, downsample=False,
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        rows = _unit_rows(version, kind, channels, stride)
        self._preact = version == 2
        if not self._preact:
            self.body = assemble(nn.HybridSequential(prefix=""), rows)
            if downsample:
                self.downsample = assemble(
                    nn.HybridSequential(prefix=""),
                    [("conv", channels, 1, stride, 0, _NOBIAS), ("bn",)])
            else:
                self.downsample = None
        else:
            self._chain = []
            for row in rows:
                layer = make_layer(row)
                self.register_child(layer)
                self._chain.append(layer)
            self._tap = rows.index(("relu",)) \
                if ("relu",) in rows else 0
            if downsample:
                self.downsample = nn.Conv2D(channels, 1, stride,
                                            use_bias=False,
                                            in_channels=in_channels)
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        if not self._preact:
            skip = x if self.downsample is None else self.downsample(x)
            return F.Activation(self.body(x) + skip, act_type="relu")
        skip = x
        for i, layer in enumerate(self._chain):
            x = layer(x)
            if i == self._tap and self.downsample is not None:
                skip = self.downsample(x)
        return x + skip


def _unit_factory(version, kind):
    class _Unit(ResidualUnit):
        def __init__(self, channels, stride, downsample=False,
                     in_channels=0, **kwargs):
            super().__init__(version, kind, channels, stride,
                             downsample=downsample,
                             in_channels=in_channels, **kwargs)
    return _Unit


BasicBlockV1 = _unit_factory(1, "basic")
BottleneckV1 = _unit_factory(1, "bottleneck")
BasicBlockV2 = _unit_factory(2, "basic")
BottleneckV2 = _unit_factory(2, "bottleneck")
for _cls, _nm in ((BasicBlockV1, "BasicBlockV1"),
                  (BottleneckV1, "BottleneckV1"),
                  (BasicBlockV2, "BasicBlockV2"),
                  (BottleneckV2, "BottleneckV2")):
    _cls.__name__ = _cls.__qualname__ = _nm


class _ResNet(HybridBlock):
    """Generic ResNet assembler: stem rows + staged units + head rows."""

    _version = None

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one more width than stages")
        v = self._version
        stem = [("conv", channels[0], 3, 1, 1, _NOBIAS)] if thumbnail else [
            ("conv", channels[0], 7, 2, 3, _NOBIAS), ("bn",), ("relu",),
            ("pool", 3, 2, 1)]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if v == 2:
                # raw-input normalization, the v2 graph's bn_data
                self.features.add(nn.BatchNorm(scale=False, center=False))
            assemble(self.features, stem)
            width = channels[0]
            for i, n_units in enumerate(layers):
                stage = nn.HybridSequential(prefix="stage%d_" % (i + 1))
                with stage.name_scope():
                    out = channels[i + 1]
                    stage.add(block(out, 1 if i == 0 else 2, out != width,
                                    in_channels=width, prefix=""))
                    for _ in range(n_units - 1):
                        stage.add(block(out, 1, False, in_channels=out,
                                        prefix=""))
                self.features.add(stage)
                width = out
            head = [("gap",)] if v == 1 else [("bn",), ("relu",), ("gap",),
                                              ("flatten",)]
            assemble(self.features, head)
            self.output = nn.Dense(classes, in_units=width)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    _version = 1


class ResNetV2(_ResNet):
    _version = 2


# depth -> (unit kind, units per stage, stage widths) — resnet_spec parity
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    if num_layers not in resnet_spec:
        raise ValueError("no resnet of depth %d; known depths: %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise ValueError("resnet version must be 1 or 2, got %r" % version)
    kind, layers, channels = resnet_spec[num_layers]
    net = resnet_net_versions[version - 1](
        resnet_block_versions[version - 1][kind], layers, channels, **kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file("resnet%d_v%d" % (num_layers, version),
                                       root=root), ctx=ctx)
    return net


resnet18_v1 = named_factory("resnet18_v1", get_resnet, 1, 18)
resnet34_v1 = named_factory("resnet34_v1", get_resnet, 1, 34)
resnet50_v1 = named_factory("resnet50_v1", get_resnet, 1, 50)
resnet101_v1 = named_factory("resnet101_v1", get_resnet, 1, 101)
resnet152_v1 = named_factory("resnet152_v1", get_resnet, 1, 152)
resnet18_v2 = named_factory("resnet18_v2", get_resnet, 2, 18)
resnet34_v2 = named_factory("resnet34_v2", get_resnet, 2, 34)
resnet50_v2 = named_factory("resnet50_v2", get_resnet, 2, 50)
resnet101_v2 = named_factory("resnet101_v2", get_resnet, 2, 101)
resnet152_v2 = named_factory("resnet152_v2", get_resnet, 2, 152)
