"""SGD update ops.

Counterpart of ``sgd_update``, ``sgd_mom_update``, ``mp_sgd_update`` and
``mp_sgd_mom_update`` in ``mxnet_tpu/ops/optimizer_ops.py``
(src/operator/optimizer_op.cc:39-128): the same arithmetic, in the same
order, in two forms.  Registered ops (``sym.<op>``, and ``nd.<op>`` for the
multi-precision pair) return the new weight and states, with the states
as ``mutate_aux`` write-backs, as the reference's do.  The in-place
functions of the same names write into the weight (and the states)
instead; ``Optimizer`` and the ``nd`` helpers use those.  The
multi-precision forms keep a float32 master copy of the weight: the
update runs on it in f32 and the weight gets its value rounded to the
weight's dtype.
"""
import torch

from .registry import register, P

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update"]

_COMMON = {"lr": P(float), "wd": P(float, 0.0), "rescale_grad": P(float, 1.0),
           "clip_gradient": P(float, -1.0), "lazy_update": P(bool, True)}


def _prep_grad(grad, rescale_grad, clip_gradient):
    """clip(rescale_grad * grad); weight decay is applied separately
    (optimizer_op-inl.h:74-78)."""
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _step(attrs, weight, grad):
    """lr * (clip(rescale_grad * grad) + wd * weight)."""
    g = _prep_grad(grad, attrs["rescale_grad"], attrs["clip_gradient"])
    return attrs["lr"] * (g + attrs["wd"] * weight)


@register("sgd_update", nin=2, input_names=["weight", "grad"], nout=1,
          mutate_aux={0: 0}, num_visible_outputs=1, params=dict(_COMMON))
def _sgd_update_op(attrs, weight, grad):
    return weight - _step(attrs, weight, grad)


@register("sgd_mom_update", nin=3, input_names=["weight", "grad", "mom"],
          nout=2, mutate_aux={0: 0, 2: 1}, num_visible_outputs=1,
          params={**_COMMON, "momentum": P(float, 0.0)})
def _sgd_mom_update_op(attrs, weight, grad, mom):
    new_mom = attrs["momentum"] * mom - _step(attrs, weight, grad)
    return weight + new_mom, new_mom


@register("mp_sgd_update", nin=3, input_names=["weight", "grad", "weight32"],
          nout=2, mutate_aux={0: 0, 2: 1}, num_visible_outputs=1,
          params=dict(_COMMON))
def _mp_sgd_update_op(attrs, weight, grad, weight32):
    new_w32 = weight32 - _step(attrs, weight32, grad.float())
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", nin=4,
          input_names=["weight", "grad", "mom", "weight32"],
          nout=3, mutate_aux={0: 0, 2: 1, 3: 2}, num_visible_outputs=1,
          params={**_COMMON, "momentum": P(float, 0.0)})
def _mp_sgd_mom_update_op(attrs, weight, grad, mom, weight32):
    new_mom = attrs["momentum"] * mom - _step(attrs, weight32, grad.float())
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def _attrs(lr, wd, rescale_grad, clip_gradient, **more):
    return dict(lr=lr, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient, **more)


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight -= lr * (clip(rescale_grad * grad) + wd * weight), in
    place."""
    weight.sub_(_step(_attrs(lr, wd, rescale_grad, clip_gradient), weight,
                      grad))
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * (clip(rescale_grad * grad) + wd *
    weight); weight += mom, in place."""
    mom.copy_(momentum * mom - _step(
        _attrs(lr, wd, rescale_grad, clip_gradient), weight, grad))
    weight.add_(mom)
    return weight, mom


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """``sgd_update`` of the f32 master copy ``weight32`` by the gradient
    in f32, in place; the weight takes its value in its own dtype."""
    weight32.sub_(_step(_attrs(lr, wd, rescale_grad, clip_gradient),
                        weight32, grad.float()))
    weight.copy_(weight32)
    return weight, weight32


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """``sgd_mom_update`` of the f32 master copy ``weight32`` with the f32
    momentum ``mom``, in place; the weight takes its value in its own
    dtype."""
    mom.copy_(momentum * mom - _step(
        _attrs(lr, wd, rescale_grad, clip_gradient), weight32,
        grad.float()))
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight, mom, weight32
