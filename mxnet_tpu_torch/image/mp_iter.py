"""Worker processes for ImageRecordIter: batches in shared memory.

Counterpart of ``mxnet_tpu/image/mp_iter.py`` (``ProcessPool``), used by
``ImageRecordIterImpl(use_processes=True)``:

- N worker processes (``spawn`` unless MXNET_MP_START_METHOD says
  otherwise), each with its own record reader.  Workers import this
  package, which neither imports JAX nor touches CUDA: a batch is numpy
  work only.
- Preallocated ``multiprocessing.shared_memory`` slots, one batch each
  (the f32 labels, then the data).  The parent picks a free slot when it
  submits a batch and names it in the task; the result (slot, pad, keys)
  comes back through the executor's future.
- A delivered batch's buffers stay valid until the next ``next()``: its
  slot is recycled one delivery later (``_retired``).
- The augmentation stream is seeded (seed, epoch, batch) as in the
  threaded pool, so both give the same batches bit for bit.
"""
import collections
import threading
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context, shared_memory

import numpy as np

from ..base import MXNetError
from ..io import DataBatch
from ..ndarray import from_numpy
from .. import config
from .. import recordio

# ---------------------------------------------------------------------------
# worker side: module-level state initialized once per process
# ---------------------------------------------------------------------------

_W = {}  # worker-global: cfg, reader, attached slots


def _worker_init(cfg):
    _W["cfg"] = cfg
    _W["reader"] = None
    _W["slots"] = {}


def _worker_ping(_i):
    """No-op task that starts a worker."""
    return True


def _worker_reader():
    rd = _W.get("reader")
    if rd is None:
        cfg = _W["cfg"]
        rd = recordio.MXIndexedRecordIO(None, cfg["path_imgrec"], "r",
                                        _index=cfg["index_table"])
        _W["reader"] = rd
    return rd


def _worker_slot(name):
    shm = _W["slots"].get(name)
    if shm is None:
        shm = shared_memory.SharedMemory(name=name)
        _W["slots"][name] = shm
    return shm


def _produce_shared(slot_name, epoch, batch_idx, keys, pad):
    """Decode+augment one batch straight into the shared-memory slot."""
    from . import image as img_mod
    cfg = _W["cfg"]
    c, h, w = cfg["data_shape"]
    nhwc = cfg["layout"] == "NHWC"
    bs, lw = cfg["batch_size"], cfg["label_width"]
    shm = _worker_slot(slot_name)
    label = np.ndarray((bs, lw), np.float32, buffer=shm.buf)
    off = label.nbytes
    shape = (bs, h, w, c) if nhwc else (bs, c, h, w)
    data = np.ndarray(shape, np.dtype(cfg["dtype"]), buffer=shm.buf,
                      offset=off)
    rng = np.random.default_rng((cfg["seed"], epoch, batch_idx))
    rd = _worker_reader()
    for i, key in enumerate(keys):
        header, buf = recordio.unpack(rd.read_idx(key))
        if cfg["raw_shape"] is not None:
            img = np.frombuffer(buf, dtype=np.uint8) \
                .reshape(cfg["raw_shape"])
        else:
            img = img_mod.imdecode(buf, flag=1 if c == 3 else 0)
        for aug in cfg["augs"]:
            img = aug(img, rng)
        if img.shape[:2] != (h, w):
            raise MXNetError(
                "augmented image %s != data_shape %s for record %d"
                % (img.shape[:2], (h, w), key))
        if cfg["mean"] is not None or cfg["std"] is not None:
            img = img_mod.color_normalize(img, cfg["mean"], cfg["std"])
        if cfg["scale"] != 1.0:
            img = img.astype(np.float32) * cfg["scale"]
        data[i] = img if nhwc else np.transpose(img, (2, 0, 1))
        if lw == 1:
            label[i, 0] = np.float32(header.label) \
                if np.isscalar(header.label) else header.label[0]
        else:
            label[i] = header.label[:lw]
    return slot_name, pad, list(keys)


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class ProcessPool(object):
    """Owns the executor + shared-memory slots for one iterator."""

    def __init__(self, it, workers, depth, start_method=None):
        start_method = start_method or config.get("MXNET_MP_START_METHOD")
        c, h, w = it.data_shape
        bs, lw = it.batch_size, it.label_width
        nbytes = (bs * lw * 4
                  + bs * h * w * c * np.dtype(it.dtype).itemsize)
        # in-flight (depth) + possibly-still-running after a reset (workers)
        # + delivered-to-caller + headroom
        self._nslots = depth + workers + 2
        self._slots = [shared_memory.SharedMemory(create=True, size=nbytes)
                       for _ in range(self._nslots)]
        self._lock = threading.Lock()
        self._free = collections.deque(s.name for s in self._slots)
        self._avail = threading.Condition(self._lock)
        self._by_name = {s.name: s for s in self._slots}
        cfg = dict(
            path_imgrec=it._path_imgrec, path_imgidx=it._path_imgidx,
            # parent already scanned the offsets; ship them so idx-less
            # record files are not re-scanned once per worker
            index_table=it._index_table,
            data_shape=it.data_shape, layout=it.layout, dtype=it.dtype,
            batch_size=bs, label_width=lw, seed=it._seed,
            augs=it._augs, mean=it._mean, std=it._std, scale=it._scale,
            raw_shape=it._raw_shape)
        self._exe = ProcessPoolExecutor(
            max_workers=workers, mp_context=get_context(start_method),
            initializer=_worker_init, initargs=(cfg,))
        # start every worker now, so the first batch does not pay for the
        # workers' imports
        list(self._exe.map(_worker_ping, range(workers)))
        # the slot of the batch the caller holds (the DataIter contract)
        self._retired = None
        self._it = it

    def _release(self, slot):
        with self._avail:
            self._free.append(slot)
            self._avail.notify()

    def submit(self, epoch, batch_idx, keys, pad):
        with self._avail:
            while not self._free:
                # only reachable transiently right after reset() while a
                # cancelled-but-running task drains; bounded wait
                if not self._avail.wait(timeout=60):
                    raise MXNetError("process-pool slot starvation")
            slot = self._free.popleft()
        fut = self._exe.submit(_produce_shared, slot, epoch, batch_idx,
                               keys, pad)
        fut._mx_slot = slot
        # failed or cancelled work is never delivered through to_batch, so
        # its slot must come back here (a worker raising on every batch of
        # a corrupt file would otherwise starve the pool)
        fut.add_done_callback(
            lambda f, s=slot: self._release(s)
            if (f.cancelled() or f.exception() is not None) else None)
        return fut

    def to_batch(self, result):
        slot_name, pad, keys = result
        if self._retired is not None:
            self._release(self._retired)
        self._retired = slot_name
        it = self._it
        shm = self._by_name[slot_name]
        c, h, w = it.data_shape
        bs, lw = it.batch_size, it.label_width
        label = np.ndarray((bs, lw), np.float32, buffer=shm.buf)
        shape = (bs, h, w, c) if it.layout == "NHWC" else (bs, c, h, w)
        data = np.ndarray(shape, np.dtype(it.dtype), buffer=shm.buf,
                          offset=label.nbytes)
        lab = label[:, 0] if lw == 1 else label
        return DataBatch(data=[from_numpy(data)], label=[from_numpy(lab)],
                         pad=pad, index=np.array(keys))

    def discard(self, futures):
        """reset(): reclaim the slots of pending work.  Cancelled/failed
        tasks release via the submit-time callback; tasks that complete
        successfully but will never be delivered release here."""
        for f in futures:
            slot = getattr(f, "_mx_slot", None)
            if slot is None:
                continue
            if not f.cancel():
                # runs now if already done, else at completion; mutually
                # exclusive with the submit-time failure/cancel callback
                f.add_done_callback(
                    lambda fut, s=slot: self._release(s)
                    if (not fut.cancelled()
                        and fut.exception() is None) else None)

    def close(self):
        self._exe.shutdown(wait=False, cancel_futures=True)
        for s in self._slots:
            # unlink first: a delivered batch that is still referenced keeps
            # its mapping open, and close() then raises BufferError
            try:
                s.unlink()
            except FileNotFoundError:
                pass
            try:
                s.close()
            except BufferError:
                pass
        self._slots = []
