"""Optimizer update ops.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py``
(src/operator/optimizer_op.cc): ``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update``, ``mp_sgd_mom_update``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftrl_update``,
``signsgd_update`` and ``signum_update``, the same arithmetic in the same
order, in two forms.  Registered ops (``sym.<op>``, and ``nd.<op>``)
return the new weight and states, with the states as ``mutate_aux``
write-backs, as the reference's do.  The in-place functions of the same
names write into the weight (and the states) instead; ``Optimizer`` and
the ``nd`` helpers use those.  The multi-precision forms keep a float32
master copy of the weight: the update runs on it in f32 and the weight
gets its value rounded to the weight's dtype.  The SGD family and
``ftrl_update`` clip the rescaled gradient and apply the weight decay
apart; Adam and RMSProp fold ``wd * weight`` into the gradient first,
then clip (optimizer_op-inl.h).
"""
import torch

from .registry import get_op, register, P

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "signsgd_update",
           "signum_update"]

_COMMON = {"lr": P(float), "wd": P(float, 0.0), "rescale_grad": P(float, 1.0),
           "clip_gradient": P(float, -1.0)}
# the SGD family and Adam also take the reference's lazy_update (which
# only row-sparse gradients read)
_LAZY = {**_COMMON, "lazy_update": P(bool, True)}


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
          mutate_aux={0: 0}, num_visible_outputs=1, params=dict(_LAZY))
def _sgd_update_op(attrs, weight, grad):
    return weight - _step(attrs, weight, grad)


@register("sgd_mom_update", nin=3, input_names=["weight", "grad", "mom"],
          nout=2, mutate_aux={0: 0, 2: 1}, num_visible_outputs=1,
          params={**_LAZY, "momentum": P(float, 0.0)})
def _sgd_mom_update_op(attrs, weight, grad, mom):
    new_mom = attrs["momentum"] * mom - _step(attrs, weight, grad)
    return weight + new_mom, new_mom


@register("mp_sgd_update", nin=3, input_names=["weight", "grad", "weight32"],
          nout=2, mutate_aux={0: 0, 2: 1}, num_visible_outputs=1,
          params=dict(_LAZY))
def _mp_sgd_update_op(attrs, weight, grad, weight32):
    new_w32 = weight32 - _step(attrs, weight32, grad.float())
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", nin=4,
          input_names=["weight", "grad", "mom", "weight32"],
          nout=3, mutate_aux={0: 0, 2: 1, 3: 2}, num_visible_outputs=1,
          params={**_LAZY, "momentum": P(float, 0.0)})
def _mp_sgd_mom_update_op(attrs, weight, grad, mom, weight32):
    new_mom = attrs["momentum"] * mom - _step(attrs, weight32, grad.float())
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def _prep_grad_wd(attrs, grad, weight):
    """clip(rescale_grad * grad + wd * weight): the Adam and RMSProp
    family folds the weight decay in first (AdamUpdate)."""
    g = grad * attrs["rescale_grad"] + attrs["wd"] * weight
    if attrs["clip_gradient"] > 0:
        c = attrs["clip_gradient"]
        g = torch.clamp(g, -c, c)
    return g


def _clip_weights(attrs, w):
    if attrs["clip_weights"] > 0:
        c = attrs["clip_weights"]
        w = torch.clamp(w, -c, c)
    return w


@register("adam_update", nin=4, input_names=["weight", "grad", "mean", "var"],
          nout=3, mutate_aux={0: 0, 2: 1, 3: 2}, num_visible_outputs=1,
          params={**_LAZY, "beta1": P(float, 0.9), "beta2": P(float, 0.999),
                  "epsilon": P(float, 1e-8)})
def _adam_update_op(attrs, weight, grad, mean, var):
    g = _prep_grad_wd(attrs, grad, weight)
    new_mean = attrs["beta1"] * mean + (1 - attrs["beta1"]) * g
    new_var = attrs["beta2"] * var + (1 - attrs["beta2"]) * torch.square(g)
    new_w = weight - attrs["lr"] * new_mean / (torch.sqrt(new_var)
                                               + attrs["epsilon"])
    return new_w, new_mean, new_var


_RMSPROP = {**_COMMON, "gamma1": P(float, 0.95), "epsilon": P(float, 1e-8),
            "clip_weights": P(float, -1.0)}


@register("rmsprop_update", nin=3, input_names=["weight", "grad", "n"],
          nout=2, mutate_aux={0: 0, 2: 1}, num_visible_outputs=1,
          params=_RMSPROP)
def _rmsprop_update_op(attrs, weight, grad, n):
    g = _prep_grad_wd(attrs, grad, weight)
    new_n = (1 - attrs["gamma1"]) * torch.square(g) + attrs["gamma1"] * n
    new_w = weight - attrs["lr"] * g / torch.sqrt(new_n + attrs["epsilon"])
    return _clip_weights(attrs, new_w), new_n


@register("rmspropalex_update", nin=5,
          input_names=["weight", "grad", "n", "g", "delta"],
          nout=4, mutate_aux={0: 0, 2: 1, 3: 2, 4: 3}, num_visible_outputs=1,
          params={**_RMSPROP, "gamma2": P(float, 0.9)})
def _rmspropalex_update_op(attrs, weight, grad, n, gbar, delta):
    g = _prep_grad_wd(attrs, grad, weight)
    new_n = (1 - attrs["gamma1"]) * torch.square(g) + attrs["gamma1"] * n
    new_g = (1 - attrs["gamma1"]) * g + attrs["gamma1"] * gbar
    new_delta = attrs["gamma2"] * delta - attrs["lr"] * g / torch.sqrt(
        new_n - torch.square(new_g) + attrs["epsilon"])
    return (_clip_weights(attrs, weight + new_delta), new_n, new_g,
            new_delta)


@register("ftrl_update", nin=4, input_names=["weight", "grad", "z", "n"],
          nout=3, mutate_aux={0: 0, 2: 1, 3: 2}, num_visible_outputs=1,
          params={**_COMMON, "lamda1": P(float, 0.01), "beta": P(float, 1.0)})
def _ftrl_update_op(attrs, weight, grad, z, n):
    g = _prep_grad(grad, attrs["rescale_grad"], attrs["clip_gradient"])
    lr, l1, beta, wd = attrs["lr"], attrs["lamda1"], attrs["beta"], attrs["wd"]
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= l1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * l1) / ((beta + torch.sqrt(new_n)) / lr
                                             + wd))
    return new_w, new_z, new_n


@register("signsgd_update", nin=2, input_names=["weight", "grad"],
          nout=1, mutate_aux={0: 0}, num_visible_outputs=1,
          params=dict(_COMMON))
def _signsgd_update_op(attrs, weight, grad):
    g = _prep_grad(grad, attrs["rescale_grad"], attrs["clip_gradient"])
    return weight - attrs["lr"] * (torch.sign(g) + attrs["wd"] * weight)


@register("signum_update", nin=3, input_names=["weight", "grad", "mom"],
          nout=2, mutate_aux={0: 0, 2: 1}, num_visible_outputs=1,
          params={**_COMMON, "momentum": P(float, 0.0),
                  "wd_lh": P(float, 0.0)})
def _signum_update_op(attrs, weight, grad, mom):
    g = _prep_grad(grad, attrs["rescale_grad"], attrs["clip_gradient"])
    new_mom = attrs["momentum"] * mom - (1 - attrs["momentum"]) * g
    new_w = (1 - attrs["lr"] * attrs["wd_lh"]) * weight \
        + attrs["lr"] * torch.sign(new_mom)
    return new_w, new_mom


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


def _in_place(name, op):
    """The in-place form of update op ``name`` (impl ``op``): ``fn(weight,
    grad, *states, lr=..., **attrs)``, the attrs defaulted and checked by
    the op's schema, writes the new weight and states into the tensors it
    was given and returns them."""
    @torch.no_grad()
    def fn(weight, grad, *states, **attrs):
        outs = op(get_op(name).normalize(attrs), weight, grad, *states)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for dst, src in zip((weight,) + states, outs):
            dst.copy_(src)
        return (weight,) + states if states else weight
    fn.__name__ = name
    return fn


adam_update = _in_place("adam_update", _adam_update_op)
rmsprop_update = _in_place("rmsprop_update", _rmsprop_update_op)
rmspropalex_update = _in_place("rmspropalex_update", _rmspropalex_update_op)
ftrl_update = _in_place("ftrl_update", _ftrl_update_op)
signsgd_update = _in_place("signsgd_update", _signsgd_update_op)
signum_update = _in_place("signum_update", _signum_update_op)
