"""Seeded random streams: one explicit ``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/random.py``.  ``seed(n)`` resets every stream;
``generator(ctx)`` is the stream of one device, created from the seed on
first use.  Code on the port's paths draws only from these generators and
never from torch's global random state.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_state = {"seed": 0, "generators": {}}


def seed(seed_state):
    """Seed all random streams (``mx.random.seed``)."""
    with _lock:
        _state["seed"] = int(seed_state)
        _state["generators"].clear()


def generator(ctx=None):
    """The generator of ``ctx``'s device (the CPU's when None)."""
    device = ctx.device if ctx is not None else torch.device("cpu")
    with _lock:
        gen = _state["generators"].get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_state["seed"])
            _state["generators"][device] = gen
    return gen
