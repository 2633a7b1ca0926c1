"""NDArray save/load in the reference's ``.params`` format.

Counterpart of ``mxnet_tpu/ndarray/utils.py``: an ``.npz`` archive keyed
by name (list saves use ``arr_i``), with a ``__mxtpu_list__`` flag saying
which of the two was saved.  Files written by either package load in the
other.
"""
from __future__ import annotations

import numpy as np

from ..context import current_context
from .ndarray import NDArray, array

__all__ = ["save", "load"]


def save(fname, data):
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        arrs = {k: v.asnumpy() for k, v in data.items()}
        listlike = False
    elif isinstance(data, (list, tuple)):
        arrs = {"arr_%d" % i: v.asnumpy() for i, v in enumerate(data)}
        listlike = True
    else:
        raise ValueError("data needs to either be a NDArray, dict of str to "
                         "NDArray or a list of NDArray")
    with open(fname, "wb") as f:       # exact filename, no .npz appended
        np.savez(f, __mxtpu_list__=listlike, **arrs)


def load(fname, ctx=None):
    """Arrays saved by ``save`` (or by the JAX package), on ``ctx``, else on
    ``current_context()``."""
    ctx = ctx or current_context()
    with np.load(fname, allow_pickle=False) as z:
        listlike = bool(z["__mxtpu_list__"]) if "__mxtpu_list__" in z \
            else False
        items = {k: z[k] for k in z.files if k != "__mxtpu_list__"}
    if listlike:
        return [array(items["arr_%d" % i], ctx=ctx)
                for i in range(len(items))]
    return {k: array(v, ctx=ctx) for k, v in items.items()}
