"""Pretrained weight files (counterpart of ``mxnet_tpu/gluon/model_zoo/
model_store.py``).  Nothing is downloaded: a model's ``.params`` file must
already be under ``root``; ``get_model_file`` only finds it there."""
from __future__ import annotations

import os

__all__ = ["get_model_file", "purge"]


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """Return the local path of a pretrained model parameter file."""
    root = os.path.expanduser(root or os.path.join("~", ".mxnet", "models"))
    for cand in os.listdir(root) if os.path.isdir(root) else []:
        if cand.startswith(name) and cand.endswith(".params"):
            return os.path.join(root, cand)
    raise IOError(
        "Pretrained model file for %s not found under %s. Nothing is "
        "downloaded; place the .params file there." % (
            name, root))


def purge(root=os.path.join("~", ".mxnet", "models")):
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
