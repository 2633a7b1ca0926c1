"""Detection data pipeline: ImageDetRecordIter and ImageDetIter.

Counterpart of ``mxnet_tpu/image/detection.py`` (the reference's
src/io/iter_image_det_recordio.cc, image_det_aug_default.cc and
python/mxnet/image/detection.py:943), with its batches, crops and
mirrors bit for bit: each batch draws from
``np.random.default_rng((seed, epoch, batch))``.

The record header holds a flat float vector ``[header_width, obj_width,
(extra header...), obj0..., obj1...]``, each object ``[class_id, xmin,
ymin, xmax, ymax, ...]`` in [0, 1].  Batches pad the object axis with -1
rows to ``label_pad_count``, which MultiBoxTarget reads as absent boxes.
Crop and mirror move the boxes too, so the detection iterator augments
its images itself and runs on the threaded pool only (the process pool
refuses a subclass that overrides ``_produce``).
"""
import numpy as np

from ..io import DataBatch, DataDesc
from ..ndarray import from_numpy
from .. import recordio
from . import image as img_mod
from .iter import ImageRecordIterImpl


def parse_det_label(raw, obj_pad, max_objs=None):
    """Flat label vector -> (obj_pad, 5) array padded with -1 rows."""
    raw = np.asarray(raw, np.float32).reshape(-1)
    if raw.size < 2:
        return np.full((obj_pad, 5), -1.0, np.float32)
    hw = int(raw[0])
    ow = int(raw[1])
    body = raw[hw:]
    n = body.size // ow if ow > 0 else 0
    objs = body[:n * ow].reshape(n, ow)[:, :5]
    if max_objs is not None:
        objs = objs[:max_objs]
    out = np.full((obj_pad, 5), -1.0, np.float32)
    out[:min(len(objs), obj_pad)] = objs[:obj_pad]
    return out


def pack_det_label(objs, header_width=2, obj_width=5):
    """(N, 5) objects -> flat label vector for recordio packing."""
    objs = np.asarray(objs, np.float32)
    return np.concatenate([
        np.array([header_width, obj_width], np.float32),
        objs.reshape(-1)])


def _flip_boxes(label):
    """Mirror normalized boxes horizontally (valid rows only)."""
    out = label.copy()
    valid = out[:, 0] >= 0
    out[valid, 1] = 1.0 - label[valid, 3]
    out[valid, 3] = 1.0 - label[valid, 1]
    return out


def _crop_boxes(label, x0, y0, w, h, src_w, src_h, min_overlap=0.3):
    """Re-express boxes in crop coordinates; drop boxes mostly outside
    (image_det_aug_default.cc crop semantics)."""
    out = np.full_like(label, -1.0)
    j = 0
    for row in label:
        if row[0] < 0:
            continue
        # to pixel space of the source
        bx1, by1, bx2, by2 = (row[1] * src_w, row[2] * src_h,
                              row[3] * src_w, row[4] * src_h)
        ix1, iy1 = max(bx1, x0), max(by1, y0)
        ix2, iy2 = min(bx2, x0 + w), min(by2, y0 + h)
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        area = max(bx2 - bx1, 0) * max(by2 - by1, 0)
        if area <= 0 or inter / area < min_overlap:
            continue
        out[j, 0] = row[0]
        out[j, 1] = np.clip((ix1 - x0) / w, 0, 1)
        out[j, 2] = np.clip((iy1 - y0) / h, 0, 1)
        out[j, 3] = np.clip((ix2 - x0) / w, 0, 1)
        out[j, 4] = np.clip((iy2 - y0) / h, 0, 1)
        j += 1
    return out


class ImageDetRecordIterImpl(ImageRecordIterImpl):
    """Detection record iterator: image pipeline + box-aware augmentation.

    Extends ImageRecordIterImpl with (a) flat→padded label parsing,
    (b) geometric augs applied to boxes, (c) (B, obj_pad, 5) label batches.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_pad_width=None, label_pad_count=16,
                 rand_crop_prob=0.0, min_crop_overlaps=0.3,
                 min_crop_scales=0.3, max_crop_scales=1.0,
                 rand_mirror=False, resize=-1, **kwargs):
        self._obj_pad = (label_pad_width // 5 if label_pad_width
                         else label_pad_count)
        self._det_rand_crop = rand_crop_prob
        self._det_min_overlap = min_crop_overlaps
        self._det_scales = (min_crop_scales, max_crop_scales)
        self._det_mirror = rand_mirror
        self._det_resize = resize
        # the base pipeline must not crop/mirror (it would orphan boxes)
        super().__init__(path_imgrec=path_imgrec, data_shape=data_shape,
                         batch_size=batch_size, rand_crop=False,
                         rand_mirror=False, resize=-1,
                         label_width=1, **kwargs)

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size, self._obj_pad, 5))]

    def _produce(self, batch_idx, keys, pad):
        c, h, w = self.data_shape
        nhwc = self.layout == "NHWC"
        shape = (self.batch_size, h, w, c) if nhwc \
            else (self.batch_size, c, h, w)
        data = np.zeros(shape, dtype=self.dtype)
        labels = np.full((self.batch_size, self._obj_pad, 5), -1.0,
                         np.float32)
        rng = np.random.default_rng((self._seed, self._epoch, batch_idx))
        rd = self._reader()
        for i, key in enumerate(keys):
            header, buf = recordio.unpack(rd.read_idx(key))
            img = img_mod.imdecode(buf, flag=1 if c == 3 else 0)
            label = parse_det_label(header.label if not np.isscalar(
                header.label) else [header.label], self._obj_pad)
            if self._det_resize > 0:
                img = img_mod.resize_short(img, self._det_resize)
            src_h, src_w = img.shape[:2]
            if self._det_rand_crop > 0 and rng.random() < self._det_rand_crop:
                scale = rng.uniform(*self._det_scales)
                cw = max(int(src_w * scale), 1)
                ch = max(int(src_h * scale), 1)
                x0 = int(rng.integers(0, src_w - cw + 1))
                y0 = int(rng.integers(0, src_h - ch + 1))
                img = img[y0:y0 + ch, x0:x0 + cw]
                label = _crop_boxes(label, x0, y0, cw, ch, src_w, src_h,
                                    self._det_min_overlap)
            if self._det_mirror and rng.random() < 0.5:
                img = img[:, ::-1]
                label = _flip_boxes(label)
            img = img_mod.imresize(img, w, h)
            img = img.astype(np.float32)
            if self._mean is not None or self._std is not None:
                img = img_mod.color_normalize(img, self._mean, self._std)
            if self._scale != 1.0:
                img = img * self._scale
            data[i] = img if nhwc else np.transpose(img, (2, 0, 1))
            labels[i] = label
        return DataBatch(data=[from_numpy(data)], label=[from_numpy(labels)],
                         pad=pad, index=np.array(keys))


def ImageDetRecordIter(**kwargs):
    """Factory with the reference iterator's name
    (iter_image_det_recordio.cc registration)."""
    return ImageDetRecordIterImpl(**kwargs)


class ImageDetIter(ImageDetRecordIterImpl):
    """Alias-level parity for python/mxnet/image/detection.py:943 — the
    record-backed path covers the same contract here."""
