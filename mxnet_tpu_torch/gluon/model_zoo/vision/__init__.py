"""Vision model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
ResNet v1 and v2 (18-152), VGG 11-19 with and without BatchNorm, AlexNet
and MobileNet (0.25-1.0).  ``pretrained=True`` reads a ``.params`` file
already under ``root``; nothing is downloaded.  DenseNet, SqueezeNet and
Inception v3 are not ported yet (``ROADMAP.md`` Queue A item 2).
"""
from .resnet import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)
from .alexnet import alexnet_fn
from .mobilenet import (mobilenet1_0, mobilenet0_75, mobilenet0_5,
                        mobilenet0_25)
from .vgg import (vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn,
                  vgg19_bn)

_NOT_PORTED = ("densenet121", "densenet161", "densenet169", "densenet201",
               "squeezenet1.0", "squeezenet1.1", "inceptionv3")


def get_model(name, **kwargs):
    """A model of the zoo by name (``resnet50_v2``, ``vgg16_bn``, ...)."""
    models = {
        "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
        "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
        "resnet152_v1": resnet152_v1,
        "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
        "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
        "resnet152_v2": resnet152_v2,
        "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
        "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
        "vgg19_bn": vgg19_bn,
        "alexnet": alexnet_fn,
        "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
        "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    }
    name = name.lower()
    if name in _NOT_PORTED:
        raise ValueError("model %r is not ported yet (DenseNet, SqueezeNet "
                         "and Inception v3 are not); this zoo has:\n\t%s"
                         % (name, "\n\t".join(sorted(models))))
    if name not in models:
        raise ValueError("unknown model %r; this zoo has:\n\t%s"
                         % (name, "\n\t".join(sorted(models))))
    return models[name](**kwargs)
