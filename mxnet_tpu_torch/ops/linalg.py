"""Linear-algebra ops (counterpart of ``mxnet_tpu/ops/linalg.py``): ``dot``
(the last axis of ``lhs`` against the first of ``rhs``) and the batched
product the attention decoder reads its cache with."""
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


@register("dot", nin=2, input_names=["lhs", "rhs"],
          params={"transpose_a": P(bool, False), "transpose_b": P(bool, False),
                  "forward_stype": P("str_or_none", None)})
def dot(attrs, a, b):
    """MXNet's dot: the inner product of two vectors, else the last axis
    of ``a`` contracted with the first of ``b``; ``transpose_a`` moves
    ``a``'s first axis last, ``transpose_b`` ``b``'s last axis first."""
    if attrs["transpose_a"]:
        a = a.movedim(0, -1) if a.ndim > 2 else a.t()
    if attrs["transpose_b"]:
        b = b.movedim(-1, 0) if b.ndim > 2 else b.t()
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0])).to(a.dtype)
