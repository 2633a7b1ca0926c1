"""AlexNet, table-driven (Krizhevsky et al.; counterpart of
``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._builder import assemble

__all__ = ["AlexNet", "alexnet_fn", "alexnet"]

_FEATURES = [
    ("conv", 64, 11, 4, 2, {"act": "relu"}), ("pool", 3, 2, 0),
    ("conv", 192, 5, 1, 2, {"act": "relu"}), ("pool", 3, 2, 0),
    ("conv", 384, 3, 1, 1, {"act": "relu"}),
    ("conv", 256, 3, 1, 1, {"act": "relu"}),
    ("conv", 256, 3, 1, 1, {"act": "relu"}), ("pool", 3, 2, 0),
    ("flatten",),
]


def _classifier_rows(classes):
    return [("dense", 4096, {"act": "relu"}), ("dropout", 0.5),
            ("dense", 4096, {"act": "relu"}), ("dropout", 0.5),
            ("dense", classes)]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                assemble(self.features, _FEATURES)
            self.classifier = nn.HybridSequential(prefix="")
            with self.classifier.name_scope():
                assemble(self.classifier, _classifier_rows(classes))

    def hybrid_forward(self, F, x):
        return self.classifier(self.features(x))


def alexnet_fn(pretrained=False, ctx=None, root=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file("alexnet", root=root), ctx=ctx)
    return net


alexnet = alexnet_fn
