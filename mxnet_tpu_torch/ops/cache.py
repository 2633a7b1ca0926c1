"""Scatter-at-index KV-cache writes: the decode step's O(d) row writes.

Counterpart of ``mxnet_tpu/ops/cache.py``.  The decode engine keeps
per-slot caches in the fixed ``(slots, max_len) + tail`` layout and the
step graph writes one row per slot per step.  Written long-hand as a
one-hot blend (``cache*(1-oh) + row*oh``) that write reads and writes the
whole cache; the optimizer's ``select`` pass (analysis/optimize.py) swaps
it for these ops, which touch only the rows written:

- K9 ``_cache_write_row``:   out[i, pos[i]] = row[i], pos clamped into
  ``[0, max_len)`` (the reference's ``dynamic_update_slice`` semantics;
  ``clip`` is kept for the schema and changes nothing, since both of the
  reference's implementations clamp too);
- K10 ``_cache_write_rows``: out[i, pos[i]+j] = rows[i, j] for
  ``j < count[i]``; a row outside ``[0, max_len)`` is dropped.

Both write the cache IN PLACE and return it (``OpDef.inplace``): the
executor hands them a copy unless the graph owns the buffer outright, so
a caller that did not donate its cache never sees it change.  Positions
and counts arrive as float32 device vectors (the graphs compare ``pos``
against ``_arange``) and are truncated to int32 on the device: neither
wrapper reads them on the host, so a decode step never waits for the
card here.

Each kernel has beside it its plain PyTorch version (the reference's
XLA fallback, bitwise), a launch counter (``<wrapper>.launches``) and a
note on what it replaces.  A wrapper runs the plain version only for a
tensor on the CPU or the meta device; for a CUDA tensor it launches the
kernel or raises.  In training mode both ops take the plain version on a
copy, which autograd can follow (the reference's fallback in training).
The CUDA sources are ``mxnet_tpu_torch/csrc/cache_write_row.cu`` and
``cache_write_rows.cu``.
"""
import torch

from .registry import register, P
from ._cuda import launch, on_host, stream
from ..base import MXNetError

DTYPES = (torch.float32, torch.float16, torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions (any device; the reference's _scatter_xla and
# _scatter_rows_xla, bitwise)
# ---------------------------------------------------------------------------

def cache_write_row_plain(cache, row, pos):
    """Plain version of K9, in place on ``cache``, which it returns."""
    n, T = cache.shape[0], cache.shape[1]
    idx = pos.to(torch.int32).clamp(0, T - 1).long()
    cache[torch.arange(n, device=cache.device), idx] = row.to(cache.dtype)
    return cache


def cache_write_rows_plain(cache, rows, pos, count):
    """Plain version of K10, in place on ``cache``, which it returns: K
    masked row writes in ascending j, each a select between the new row
    and the row already at the (clamped) target."""
    n, T, K = cache.shape[0], cache.shape[1], rows.shape[1]
    p = pos.to(torch.int32)
    c = count.to(torch.int32).clamp(0, K)
    rows = rows.to(cache.dtype)
    ar = torch.arange(n, device=cache.device)
    bcast = (-1,) + (1,) * (cache.dim() - 2)
    for j in range(K):
        pj = p + j
        ok = (c > j) & (pj >= 0) & (pj < T)
        at = pj.clamp(0, T - 1).long()
        cache[ar, at] = torch.where(ok.reshape(bcast), rows[:, j],
                                    cache[ar, at])
    return cache


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _index_vector(name, v, n, device):
    """(vector, is_int32) as the kernel reads it: float32 stays, any other
    dtype is converted to int32 on the device (truncating, as
    ``astype(int32)`` does)."""
    if v.shape != (n,):
        raise MXNetError("%s: index vector has shape %s, expected (%d,)"
                         % (name, tuple(v.shape), n))
    if v.device != device:
        raise MXNetError("%s: index vector is on %s, cache on %s"
                         % (name, v.device, device))
    if v.dtype == torch.float32:
        return v.contiguous(), 0
    return v.to(torch.int32).contiguous(), 1


def _check_cache(name, cache, src, lead):
    """Shape, dtype, device and layout checks of a cache and the rows to
    write, which are ``lead + cache.shape[2:]``; returns (the rows cast to
    the cache's dtype, bytes per row)."""
    if cache.dim() < 2:
        raise MXNetError("%s: cache must be (slots, max_len, ...), got %s"
                         % (name, tuple(cache.shape)))
    if cache.dtype not in DTYPES:
        raise MXNetError("%s: dtype %s not supported (float32, float16, "
                         "bfloat16)" % (name, cache.dtype))
    want = tuple(lead) + tuple(cache.shape[2:])
    if tuple(src.shape) != want:
        raise MXNetError("%s: rows have shape %s, expected %s"
                         % (name, tuple(src.shape), want))
    if src.device != cache.device:
        raise MXNetError("%s: rows are on %s, cache on %s"
                         % (name, src.device, cache.device))
    if not cache.is_contiguous():
        raise MXNetError("%s: the cache must be contiguous (it is written "
                         "in place)" % name)
    src = src.to(cache.dtype).contiguous()
    row_bytes = cache.element_size()
    for d in cache.shape[2:]:
        row_bytes *= d
    return src, row_bytes


def cache_write_row(cache, row, pos):
    """K9: cache[i, clamp(pos[i])] = row[i] in place; returns ``cache``.

    Replaces mxnet_tpu/ops/cache.py ``_scatter_pallas``.  Bound on the
    H100: bytes, 2*slots*d elements, far below a launch's latency; the
    design touches no cache row but the written one, so its time does not
    grow with max_len (csrc/cache_write_row.cu)."""
    if on_host(cache):
        return cache_write_row_plain(cache, row, pos)
    name = "cache_write_row"
    row, row_bytes = _check_cache(name, cache, row, cache.shape[:1])
    n, T = cache.shape[0], cache.shape[1]
    pos, pos_int = _index_vector(name, pos, n, cache.device)
    if n == 0 or T == 0 or row_bytes == 0:
        return cache
    with torch.cuda.device(cache.device):
        launch(name, cache, row, pos, n, T, row_bytes, cache.element_size(),
               pos_int, stream(cache.device))
    cache_write_row.launches += 1
    return cache


cache_write_row.launches = 0


def cache_write_rows(cache, rows, pos, count):
    """K10: cache[i, pos[i]+j] = rows[i, j] for j < count[i], rows outside
    the cache dropped, in place; returns ``cache``.

    Replaces mxnet_tpu/ops/cache.py ``_scatter_rows_pallas``.  Bound on
    the H100: bytes, at most 2*slots*K*d elements, below a launch's
    latency; a rejected row moves no byte (csrc/cache_write_rows.cu)."""
    if on_host(cache):
        return cache_write_rows_plain(cache, rows, pos, count)
    name = "cache_write_rows"
    if rows.dim() < 2:
        raise MXNetError("%s: rows must be (slots, K, ...), got %s"
                         % (name, tuple(rows.shape)))
    K = rows.shape[1]
    rows, row_bytes = _check_cache(name, cache, rows, (cache.shape[0], K))
    n, T = cache.shape[0], cache.shape[1]
    pos, pos_int = _index_vector(name, pos, n, cache.device)
    count, count_int = _index_vector(name, count, n, cache.device)
    if n == 0 or T == 0 or K == 0 or row_bytes == 0:
        return cache
    with torch.cuda.device(cache.device):
        launch(name, cache, rows, pos, count, n, T, K, row_bytes,
               cache.element_size(), pos_int, count_int,
               stream(cache.device))
    cache_write_rows.launches += 1
    return cache


cache_write_rows.launches = 0

KERNEL_WRAPPERS = (cache_write_row, cache_write_rows)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

@register("_cache_write_rows", nin=4,
          input_names=["cache", "rows", "pos", "count"],
          mode_dependent=True, inplace={0: 0})
def _cache_write_rows(attrs, cache, rows, pos, count):
    """out[i, pos[i]+j] = rows[i, j] for j < count[i]: the speculative
    commit of the accepted rows (K10)."""
    if attrs.get("_training"):
        return cache_write_rows_plain(cache.clone(), rows, pos, count)
    return cache_write_rows(cache, rows, pos, count)


@register("_cache_write_row", nin=3, input_names=["cache", "row", "pos"],
          mode_dependent=True, params={"clip": P(bool, True)},
          inplace={0: 0})
def _cache_write_row(attrs, cache, row, pos):
    """out[i, pos[i]] = row[i], pos clamped into range (K9)."""
    if attrs.get("_training"):
        return cache_write_row_plain(cache.clone(), row, pos)
    return cache_write_row(cache, row, pos)
