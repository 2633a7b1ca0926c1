"""Linear-algebra ops (counterpart of ``mxnet_tpu/ops/linalg.py``): the
batched product the attention decoder reads its cache with."""
import torch

from .registry import register, P


@register("batch_dot", nin=2, input_names=["lhs", "rhs"],
          params={"transpose_a": P(bool, False), "transpose_b": P(bool, False),
                  "forward_stype": P("str_or_none", None)})
def batch_dot(attrs, a, b):
    """``a @ b`` over the leading batch axis, in ``a``'s dtype.  Each batch
    entry's product reads only that entry, so a decode slot's answer does
    not depend on what the other slots hold."""
    if attrs["transpose_a"]:
        a = a.transpose(-1, -2)
    if attrs["transpose_b"]:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)
