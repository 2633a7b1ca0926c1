"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
split_data, split_and_load, clip_global_norm, check_sha1 and download,
which reads only a file already present (the machine has no network)."""
from __future__ import annotations

import hashlib
import math
import os

import numpy as np

from .. import ndarray as nd

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split along batch_axis into num_slice slices."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (str(data.shape), num_slice,
                                                 batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    if batch_axis == 0:
        slices = [data[i * step:(i + 1) * step] if i < num_slice - 1
                  else data[i * step:size]
                  for i in range(num_slice)]
    else:
        slices = [nd.invoke("slice_axis", [data],
                            {"axis": batch_axis, "begin": i * step,
                             "end": (i + 1) * step if i < num_slice - 1
                             else size})
                  for i in range(num_slice)]
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` and put one slice on each
    context of ``ctx_list``."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so that their joint 2-norm is at most
    ``max_norm``; returns the norm before scaling."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    total_norm = 0
    for arr in arrays:
        arr = arr.reshape((-1,))
        total_norm += float(nd.invoke("dot", [arr, arr], {}).asscalar())
    total_norm = math.sqrt(total_norm)
    if not np.isfinite(total_norm):
        import warnings
        warnings.warn(UserWarning("nan or inf is detected. Clipping results "
                                  "will be undefined."), stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the sha1 hash of the file is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """The local file ``url`` would be downloaded to.  Nothing is fetched:
    the file must already be there (and match ``sha1_hash`` when given),
    else this raises."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if overwrite or not os.path.exists(fname) or (
            sha1_hash and not check_sha1(fname, sha1_hash)):
        raise RuntimeError("download of %s is not supported: place the file "
                           "at %s" % (url, fname))
    return fname
