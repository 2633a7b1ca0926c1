"""Named locks.

Counterpart of ``mxnet_tpu/locks.py``'s factories: :func:`named_lock`,
:func:`named_rlock` and :func:`named_condition` construct the runtime's
locks under stable names (``"telemetry.recorder"``, ...) and return the
plain ``threading`` primitives.

The reference's runtime lock sanitizer (``MXNET_LOCK_SANITIZER``, its
``_DUMP`` file, its lock-order and hold-time series and its ``/healthz``
section) is not ported yet: it comes with the static half that reads its
observations (``analysis/concurrency.py``, ``tools/thread_lint.py``).
Until then the names only label the call sites for it.
"""
from __future__ import annotations

import threading

__all__ = ["named_lock", "named_rlock", "named_condition"]


def named_lock(name):
    """A ``threading.Lock`` under a stable name."""
    return threading.Lock()


def named_rlock(name):
    """A ``threading.RLock`` under a stable name."""
    return threading.RLock()


def named_condition(name, lock=None):
    """A ``threading.Condition`` over ``lock``, or over a new lock named
    ``name``."""
    if lock is None:
        lock = named_lock(name)
    return threading.Condition(lock)
