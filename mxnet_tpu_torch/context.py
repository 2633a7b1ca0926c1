"""Device contexts: ``cpu()`` and ``gpu(i)`` name a ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``.  ``gpu(i)`` is CUDA card ``i``;
there is no ``tpu()``.  ``with ctx:`` makes ``ctx`` the current context
of the thread, as in the reference.  ``current_context()`` is the
innermost such scope, else the first card, and an error when there is
none; ``default_context(ctx)`` is what the entry points use: the caller's
``ctx``, else ``current_context()``.  A caller that wants the CPU says so
with ``ctx=cpu()`` or ``with cpu():``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "default_context"]


class Context:
    """A device context; hashable and comparable, and usable with ``with``
    to set the current context of this thread."""

    _scope = threading.local()

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise MXNetError("unknown device type %r (cpu or gpu)"
                             % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device(self):
        """The ``torch.device`` this context names."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        stack = getattr(Context._scope, "stack", None)
        if stack is None:
            stack = Context._scope.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._scope.stack.pop()

    @staticmethod
    def of(device):
        """The context of a ``torch.device``."""
        if device.type == "cuda":
            return gpu(device.index or 0)
        return cpu()


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def current_context():
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``;
    raises when that is wanted and no card is present."""
    stack = getattr(Context._scope, "stack", None)
    if stack:
        return stack[-1]
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device is available; pass ctx=cpu() or "
                         "open a `with mxnet_tpu_torch.cpu():` scope to run "
                         "on the CPU")
    return gpu(0)


def default_context(ctx=None):
    """``ctx`` itself, else ``current_context()``."""
    return ctx if ctx is not None else current_context()
