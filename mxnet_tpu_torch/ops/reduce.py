"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``): argmax, the
decode engine's greedy head."""
import torch

from .registry import register, P


@register("argmax", params={"axis": P("int_or_none", None),
                            "keepdims": P(bool, False)})
def argmax(attrs, x):
    """Index of the largest value, the first one on ties (as
    ``jnp.argmax``), returned in ``x``'s dtype."""
    ax = attrs["axis"]
    if ax is None:
        return torch.argmax(x.reshape(-1), dim=0).to(x.dtype)
    return torch.argmax(x, dim=ax, keepdim=attrs["keepdims"]).to(x.dtype)
