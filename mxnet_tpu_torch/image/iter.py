"""ImageRecordIter: the threaded record-file training pipeline.

Counterpart of ``mxnet_tpu/image/iter.py`` (``ImageRecordIterImpl``,
``ImageRecordUInt8Iter``), with its parameter names and its batches bit
for bit.  Each *batch* is one unit of work: a worker thread with its own
record reader (independent seeks, no lock) decodes and augments the
batch's records into fresh buffers, drawing from a generator seeded by
(seed, epoch, batch), and an ordered, bounded deque of futures gives
pipelining and backpressure.  ``use_processes=True`` runs the same work in
worker processes over shared-memory slots (``mp_iter.py``).

Batches are CPU NDArrays over those produce-once buffers
(``ndarray.from_numpy``); the executor copies them to its device.  The
layout is NCHW by default; ``layout='NHWC'`` keeps the decoded HWC images
as they are, with no host transpose.
"""
import collections
import concurrent.futures
import os
import threading

import numpy as np

from ..base import MXNetError
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import from_numpy
from .. import config
from .. import recordio
from . import image as img_mod


class ImageRecordIterImpl(DataIter):
    """Threaded record-file image iterator (see module docstring).

    Accepts the reference's parameter names (image_iter_common.h:129-268,
    image_aug_default.cc:85-137).  Unknown kwargs raise.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1,
                 shuffle=False, seed=0,
                 num_parts=1, part_index=0,
                 preprocess_threads=None, prefetch_buffer=4,
                 round_batch=True,
                 # augmentation (image_aug_default.cc)
                 resize=-1, rand_crop=False, rand_resize=False,
                 rand_mirror=False, mirror=False,
                 max_random_scale=1.0, min_random_scale=1.0,
                 max_aspect_ratio=0.0, max_rotate_angle=0, rotate=-1,
                 random_h=0, random_s=0, random_l=0,
                 brightness=0.0, contrast=0.0, saturation=0.0,
                 pca_noise=0.0, rand_gray=0.0, fill_value=255,
                 inter_method=img_mod.INTER_LINEAR,
                 # normalization (iter_normalize.h)
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, mean_a=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, std_a=1.0, scale=1.0,
                 mean_img=None,
                 dtype="float32", layout="NCHW",
                 data_name="data", label_name="softmax_label",
                 verbose=False, aug_list=None,
                 raw_shape=None, _raw_uint8=False,
                 use_processes=False):
        super().__init__(batch_size)
        if not path_imgrec or not os.path.exists(path_imgrec):
            raise MXNetError("path_imgrec %r does not exist" % path_imgrec)
        assert len(data_shape) == 3, "data_shape must be (C, H, W)"
        assert layout in ("NCHW", "NHWC")
        assert 0 <= part_index < num_parts
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.layout = layout
        self.dtype = dtype
        self.round_batch = round_batch
        self._data_name, self._label_name = data_name, label_name
        self._path_imgrec = path_imgrec
        self._path_imgidx = path_imgidx or \
            os.path.splitext(path_imgrec)[0] + ".idx"
        if not os.path.exists(self._path_imgidx):
            self._path_imgidx = None  # recordio scans offsets on open
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._raw_uint8 = _raw_uint8
        # records packed as raw uint8 HWC pixels (im2rec --encoding raw):
        # decode becomes a zero-copy reshape, the input path for hosts
        # with few cores to decode on
        self._raw_shape = tuple(raw_shape) if raw_shape else None

        # --- record sharding: contiguous slice of keys per (rank, size),
        # matching the reference's byte-range partition semantics
        probe = recordio.MXIndexedRecordIO(self._path_imgidx, path_imgrec, "r")
        keys = list(probe.keys)
        index_table = dict(probe.idx)
        probe.close()
        if not keys:
            raise MXNetError("record file %s is empty" % path_imgrec)
        per = len(keys) // num_parts
        if per == 0:
            raise MXNetError("fewer records (%d) than num_parts (%d)"
                             % (len(keys), num_parts))
        lo = part_index * per
        hi = lo + per if part_index < num_parts - 1 else len(keys)
        self._keys = keys[lo:hi]
        self._index_table = index_table

        # --- augmenter pipeline
        if aug_list is not None:
            self._augs = list(aug_list)
        elif _raw_uint8:
            c, h, w = self.data_shape
            self._augs = [img_mod.CenterCropAug((w, h), inter_method)] \
                if not rand_crop else \
                [img_mod.RandomCropAug((w, h), inter_method)]
            if resize > 0:
                self._augs.insert(0, img_mod.ResizeAug(resize, inter_method))
            if rand_mirror:
                self._augs.append(img_mod.HorizontalFlipAug(0.5))
        else:
            self._augs = self._build_augs(
                resize=resize, rand_crop=rand_crop, rand_resize=rand_resize,
                rand_mirror=rand_mirror, mirror=mirror,
                max_random_scale=max_random_scale,
                min_random_scale=min_random_scale,
                max_aspect_ratio=max_aspect_ratio,
                random_h=random_h, random_s=random_s, random_l=random_l,
                brightness=brightness, contrast=contrast,
                saturation=saturation, pca_noise=pca_noise,
                rand_gray=rand_gray, inter_method=inter_method)
        if _raw_uint8:
            self._mean = self._std = None
            self._scale = 1.0
        else:
            self._mean = None
            self._std = None
            if mean_img:
                raise MXNetError("mean_img files are not supported; pass "
                                 "mean_r/g/b instead")
            if mean_r or mean_g or mean_b or mean_a:
                self._mean = np.array([mean_r, mean_g, mean_b, mean_a]
                                      [:data_shape[0]], dtype=np.float32)
            if (std_r, std_g, std_b, std_a) != (1.0, 1.0, 1.0, 1.0):
                self._std = np.array([std_r, std_g, std_b, std_a]
                                     [:data_shape[0]], dtype=np.float32)
            self._scale = scale

        # --- worker pool: each thread owns a record reader (independent
        # seeks), created lazily in thread-local storage
        if preprocess_threads is None:
            preprocess_threads = config.get("MXNET_CPU_WORKER_NTHREADS")
        self._tls = threading.local()
        self._depth = max(2, prefetch_buffer)
        self._ppool = None
        if use_processes:
            # multiprocess decode pool (mp_iter.py): the reference's
            # scale-with-cores C++ pool analog, shared-memory batch slots
            if type(self)._produce is not ImageRecordIterImpl._produce:
                # subclasses with a custom _produce (e.g. the detection
                # iterator's box-label batches) never reach the worker-side
                # producer — refuse rather than deliver wrong labels
                raise MXNetError(
                    "use_processes=True is not supported by %s (it overrides "
                    "_produce); use the threaded pool"
                    % type(self).__name__)
            from .mp_iter import ProcessPool
            self._pool = None
            self._ppool = ProcessPool(self, max(1, preprocess_threads),
                                      self._depth)
        else:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, preprocess_threads),
                thread_name_prefix="imgrec")
        self._futures = collections.deque()
        self._order = []          # key order for the current epoch
        self._next_batch = 0      # next batch index to submit
        self._nbatch = 0
        self.reset()

    # -- reference augmenter order: resize → random scale/aspect crop or
    # center crop → mirror → HSL jitter (image_aug_default.cc)
    def _build_augs(self, resize, rand_crop, rand_resize, rand_mirror, mirror,
                    max_random_scale, min_random_scale, max_aspect_ratio,
                    random_h, random_s, random_l, brightness, contrast,
                    saturation, pca_noise, rand_gray, inter_method):
        c, h, w = self.data_shape
        augs = []
        if resize > 0:
            augs.append(img_mod.ResizeAug(resize, inter_method))
        random_scale = (max_random_scale != 1.0 or min_random_scale != 1.0)
        if rand_resize or (rand_crop and (random_scale or max_aspect_ratio)):
            area = (min_random_scale ** 2 if random_scale else 0.08,
                    max_random_scale ** 2 if random_scale else 1.0)
            ar = max_aspect_ratio or 0.25
            augs.append(img_mod.RandomSizedCropAug(
                (w, h), area, (1 - ar, 1 + ar) if max_aspect_ratio
                else (3 / 4.0, 4 / 3.0), inter_method))
        elif rand_crop:
            augs.append(img_mod.RandomCropAug((w, h), inter_method))
        else:
            augs.append(img_mod.CenterCropAug((w, h), inter_method))
        if mirror:
            augs.append(img_mod.HorizontalFlipAug(1.0))
        elif rand_mirror:
            augs.append(img_mod.HorizontalFlipAug(0.5))
        if brightness or contrast or saturation:
            augs.append(img_mod.ColorJitterAug(brightness, contrast,
                                               saturation))
        if random_h or random_s or random_l:
            # the C++ augmenter jitters HSL channels additively; approximate
            # with the python-API jitter magnitudes normalized to [0,1]
            augs.append(img_mod.ColorJitterAug(random_l / 255.0,
                                               0, random_s / 255.0))
            if random_h:
                augs.append(img_mod.HueJitterAug(random_h / 180.0))
        if pca_noise > 0:
            augs.append(img_mod.LightingAug(
                pca_noise,
                eigval=np.array([55.46, 4.794, 1.148]),
                eigvec=np.array([[-0.5675, 0.7192, 0.4009],
                                 [-0.5808, -0.0045, -0.8140],
                                 [-0.5836, -0.6948, 0.4203]])))
        if rand_gray > 0:
            augs.append(img_mod.RandomGrayAug(rand_gray))
        return augs

    # ------------------------------------------------------------------
    @property
    def provide_data(self):
        c, h, w = self.data_shape
        shape = (self.batch_size, h, w, c) if self.layout == "NHWC" \
            else (self.batch_size, c, h, w)
        return [DataDesc(self._data_name, shape, self.dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape, "float32")]

    @property
    def num_samples(self):
        return len(self._keys)

    def _reader(self):
        rd = getattr(self._tls, "reader", None)
        if rd is None:
            rd = recordio.MXIndexedRecordIO(None, self._path_imgrec, "r",
                                            _index=self._index_table)
            self._tls.reader = rd
        return rd

    def _produce(self, batch_idx, keys, pad):
        """Worker: decode+augment one batch into fresh buffers."""
        c, h, w = self.data_shape
        nhwc = self.layout == "NHWC"
        shape = (self.batch_size, h, w, c) if nhwc \
            else (self.batch_size, c, h, w)
        data = np.zeros(shape, dtype=self.dtype)
        label = np.zeros((self.batch_size, self.label_width),
                         dtype=np.float32)
        # deterministic per-(epoch, batch) augmentation stream
        rng = np.random.default_rng(
            (self._seed, self._epoch, batch_idx))
        rd = self._reader()
        for i, key in enumerate(keys):
            header, buf = recordio.unpack(rd.read_idx(key))
            if self._raw_shape is not None:
                img = np.frombuffer(buf, dtype=np.uint8) \
                    .reshape(self._raw_shape)
            else:
                img = img_mod.imdecode(buf, flag=1 if c == 3 else 0)
            for aug in self._augs:
                img = aug(img, rng)
            if img.shape[:2] != (h, w):
                raise MXNetError(
                    "augmented image %s != data_shape %s for record %d"
                    % (img.shape[:2], (h, w), key))
            if self._mean is not None or self._std is not None:
                img = img_mod.color_normalize(img, self._mean, self._std)
            if self._scale != 1.0:
                img = img.astype(np.float32) * self._scale
            data[i] = img if nhwc else np.transpose(img, (2, 0, 1))
            if self.label_width == 1:
                label[i, 0] = np.float32(header.label) \
                    if np.isscalar(header.label) else header.label[0]
            else:
                label[i] = header.label[:self.label_width]
        lab = label[:, 0] if self.label_width == 1 else label
        # from_numpy: the buffers are produce-once (never mutated after
        # this return), so the aliasing wrap is safe and skips a 38MB copy
        return DataBatch(data=[from_numpy(data)], label=[from_numpy(lab)],
                         pad=pad, index=np.array(keys))

    def _submit(self):
        while (len(self._futures) < self._depth
               and self._next_batch < self._nbatch):
            b = self._next_batch
            self._next_batch += 1
            s = b * self.batch_size
            keys = self._order[s:s + self.batch_size]
            pad = self.batch_size - len(keys)
            if pad:  # last partial batch: wrap from the epoch head
                keys = keys + self._order[:pad]
            if self._ppool is not None:
                self._futures.append(
                    self._ppool.submit(self._epoch, b, keys, pad))
            else:
                self._futures.append(
                    self._pool.submit(self._produce, b, keys, pad))

    def reset(self):
        if self._ppool is not None:
            self._ppool.discard(self._futures)
        else:
            for f in self._futures:
                f.cancel()
        self._futures.clear()
        self._epoch += 1
        order = list(self._keys)
        if self._shuffle:
            np.random.default_rng((self._seed, self._epoch)).shuffle(order)
        self._order = order
        n = len(order)
        if self.round_batch:
            self._nbatch = (n + self.batch_size - 1) // self.batch_size
        else:
            self._nbatch = n // self.batch_size
        self._next_batch = 0
        self._submit()

    def next(self):
        if not self._futures:
            raise StopIteration
        fut = self._futures.popleft()
        self._submit()
        if self._ppool is not None:
            return self._ppool.to_batch(fut.result())
        return fut.result()

    def close(self):
        if self._ppool is not None:
            self._ppool.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def ImageRecordUInt8Iter(**kwargs):
    """uint8 variant: decode + crop/mirror only, no float conversion
    (iter_image_recordio_2.cc:759)."""
    kwargs.setdefault("dtype", "uint8")
    return ImageRecordIterImpl(_raw_uint8=True, **kwargs)
