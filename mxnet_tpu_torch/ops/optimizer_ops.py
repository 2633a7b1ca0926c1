"""SGD update ops, in place on tensors.

Counterpart of ``sgd_update`` / ``sgd_mom_update`` in
``mxnet_tpu/ops/optimizer_ops.py`` (src/operator/optimizer_op.cc:39,66):
the same arithmetic, in the same order, written into the weight (and the
momentum) in place instead of returned as new arrays.
"""
import torch

__all__ = ["sgd_update", "sgd_mom_update"]


def _prep_grad(grad, rescale_grad, clip_gradient):
    """clip(rescale_grad * grad); weight decay is applied separately
    (optimizer_op-inl.h:74-78)."""
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight -= lr * (clip(rescale_grad * grad) + wd * weight)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (g + wd * weight))
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * (clip(rescale_grad * grad) + wd *
    weight); weight += mom."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight))
    weight.add_(mom)
    return weight, mom
