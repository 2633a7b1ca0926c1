"""Functional image transforms, augmenters and the pure-Python ImageIter.

Counterpart of ``mxnet_tpu/image/image.py``: ``imdecode``, ``imresize``,
``resize_short`` and the crops, ``color_normalize``, every ``Augmenter``,
``CreateAugmenter`` and ``ImageIter``.  Transforms take and return numpy
HWC arrays in RGB order and draw only from the ``numpy.random.Generator``
they are given, so the same input and generator give the same bits in
both packages.  cv2 (or, without it, PIL) is imported at the first decode
or resize; without either those raise ImportError.
"""
import functools
import os

import numpy as np

from ..base import MXNetError
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import from_numpy
from .. import recordio


@functools.lru_cache(maxsize=None)
def _cv2():
    """cv2, or None where it is not installed; imported at first use."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    """PIL's Image module, the fallback where cv2 is missing."""
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("image decode and resize need cv2 or PIL; "
                          "neither is installed")
    return Image

# cv2 inter_method codes (the reference exposes these integers directly)
INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = range(5)

_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float32)  # BT.601 luma


# ---------------------------------------------------------------------------
# Functional transforms
# ---------------------------------------------------------------------------

def imdecode(buf, to_rgb=True, flag=1):
    """Decode a compressed image buffer to an HWC uint8 array.

    ``flag=0`` decodes grayscale (kept 3-channel like the reference's
    iterator when data_shape wants 3).  Output is RGB when ``to_rgb``.
    """
    data = np.frombuffer(buf, dtype=np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        if flag and to_rgb and hasattr(cv2, "IMREAD_COLOR_RGB"):
            # OpenCV >= 4.10 decodes straight to RGB, without the BGR->RGB
            # reversal copy
            img = cv2.imdecode(data, cv2.IMREAD_COLOR_RGB)
            if img is None:
                raise MXNetError("imdecode failed (invalid image data)")
            return img
        img = cv2.imdecode(data, cv2.IMREAD_COLOR if flag else
                           cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise MXNetError("imdecode failed (invalid image data)")
        if img.ndim == 2:
            img = img[:, :, None]
        elif to_rgb:
            img = img[:, :, ::-1]  # cv2 decodes BGR
        return np.ascontiguousarray(img)
    from io import BytesIO
    img = _pil_image().open(BytesIO(bytes(buf)))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if not to_rgb and arr.shape[2] == 3:
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)


def imread(filename, to_rgb=True, flag=1):
    """Read + decode an image file (ref image.py:imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


def imresize(img, w, h, interp=INTER_LINEAR):
    """Resize to exactly (h, w)."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    cv2 = _cv2()
    if cv2 is not None:
        out = cv2.resize(img, (w, h), interpolation=interp)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    Image = _pil_image()
    pil = Image.fromarray(img.squeeze(-1) if img.shape[2] == 1 else img)
    pil_interp = {INTER_NEAREST: Image.NEAREST, INTER_CUBIC: Image.BICUBIC,
                  INTER_AREA: Image.BOX,
                  INTER_LANCZOS4: Image.LANCZOS}.get(interp, Image.BILINEAR)
    out = np.asarray(pil.resize((w, h), pil_interp))
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def resize_short(img, size, interp=INTER_LINEAR):
    """Scale so the shorter edge becomes ``size``."""
    h, w = img.shape[:2]
    if h > w:
        return imresize(img, size, int(round(h * size / w)), interp)
    return imresize(img, int(round(w * size / h)), size, interp)


def fixed_crop(img, x0, y0, w, h, size=None, interp=INTER_LINEAR):
    """Crop the (x0, y0, w, h) window; optionally resize to ``size`` (w, h)."""
    out = img[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(img, size, interp=INTER_LINEAR):
    """Center-crop to ``size`` (w, h); upscales first if the image is
    smaller."""
    h, w = img.shape[:2]
    cw, ch = size
    if w < cw or h < ch:
        img = imresize(img, max(w, cw), max(h, ch), interp)
        h, w = img.shape[:2]
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return fixed_crop(img, x0, y0, cw, ch), (x0, y0, cw, ch)


def random_crop(img, size, rng, interp=INTER_LINEAR):
    """Uniform-position crop to ``size`` (w, h)."""
    h, w = img.shape[:2]
    cw, ch = size
    if w < cw or h < ch:
        img = imresize(img, max(w, cw), max(h, ch), interp)
        h, w = img.shape[:2]
    x0 = int(rng.integers(0, w - cw + 1))
    y0 = int(rng.integers(0, h - ch + 1))
    return fixed_crop(img, x0, y0, cw, ch), (x0, y0, cw, ch)


def random_size_crop(img, size, area, ratio, rng, interp=INTER_LINEAR):
    """Random area + aspect-ratio crop, resized to ``size`` (w, h).

    ``area``: (min, max) fraction of source area (a scalar means (a, 1.0)).
    ``ratio``: (min, max) aspect-ratio range.  Falls back to random_crop
    after 10 failed proposals, like the reference.
    """
    h, w = img.shape[:2]
    src_area = h * w
    if np.isscalar(area):
        area = (area, 1.0)
    for _ in range(10):
        target = src_area * rng.uniform(*area)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return (fixed_crop(img, x0, y0, cw, ch, size, interp),
                    (x0, y0, cw, ch))
    return random_crop(img, size, rng, interp)


def color_normalize(img, mean, std=None):
    """(img - mean) / std in float32."""
    out = img.astype(np.float32) - mean
    if std is not None:
        out = out / std
    return out


# ---------------------------------------------------------------------------
# Augmenters — stateless callables: (img [, rng]) -> img
# ---------------------------------------------------------------------------

class Augmenter(object):
    """One augmentation step.  Subclasses override __call__(img, rng)."""

    def dumps(self):
        """Serialized [name, param-dict] form."""
        import json

        def enc(v):
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, Augmenter):
                return json.loads(v.dumps())
            if isinstance(v, (list, tuple)):
                return [enc(x) for x in v]
            return v
        return json.dumps([self.__class__.__name__,
                           {k: enc(v) for k, v in self.__dict__.items()}])

    def __call__(self, img, rng):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        self.ts = list(ts)

    def __call__(self, img, rng):
        for t in self.ts:
            img = t(img, rng)
        return img


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        self.ts = list(ts)

    def __call__(self, img, rng):
        order = rng.permutation(len(self.ts))
        for i in order:
            img = self.ts[i](img, rng)
        return img


class ResizeAug(Augmenter):
    """Shorter-edge resize."""

    def __init__(self, size, interp=INTER_LINEAR):
        self.size, self.interp = size, interp

    def __call__(self, img, rng):
        return resize_short(img, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Exact (w, h) resize, aspect ratio be damned."""

    def __init__(self, size, interp=INTER_LINEAR):
        self.size, self.interp = size, interp

    def __call__(self, img, rng):
        return imresize(img, self.size[0], self.size[1], self.interp)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=INTER_LINEAR):
        self.size, self.interp = size, interp

    def __call__(self, img, rng):
        return center_crop(img, self.size, self.interp)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=INTER_LINEAR):
        self.size, self.interp = size, interp

    def __call__(self, img, rng):
        return random_crop(img, self.size, rng, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=INTER_LINEAR):
        self.size, self.min_area, self.ratio = size, min_area, ratio
        self.interp = interp

    def __call__(self, img, rng):
        return random_size_crop(img, self.size, self.min_area, self.ratio,
                                rng, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return img[:, ::-1]
        return img


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, img, rng):
        alpha = 1.0 + rng.uniform(-self.brightness, self.brightness)
        return img.astype(np.float32) * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        self.contrast = contrast

    def __call__(self, img, rng):
        alpha = 1.0 + rng.uniform(-self.contrast, self.contrast)
        f = img.astype(np.float32)
        gray_mean = (f * _GRAY).sum() / (img.shape[0] * img.shape[1])
        return f * alpha + gray_mean * (1.0 - alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, img, rng):
        alpha = 1.0 + rng.uniform(-self.saturation, self.saturation)
        f = img.astype(np.float32)
        gray = (f * _GRAY).sum(axis=2, keepdims=True)
        return f * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    """Hue rotation via the YIQ linear approximation (ref image.py:729)."""

    def __init__(self, hue):
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype=np.float32)

    def __call__(self, img, rng):
        alpha = rng.uniform(-self.hue, self.hue)
        u, w_ = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w_], [0.0, w_, u]],
                      dtype=np.float32)
        t = self.ityiq @ bt @ self.tyiq
        return img.astype(np.float32) @ t.T


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def __call__(self, img, rng):
        alpha = rng.normal(0, self.alphastd, size=(3,)).astype(np.float32)
        return img.astype(np.float32) + self.eigvec @ (self.eigval * alpha)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, img, rng):
        return color_normalize(img, self.mean, self.std)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            gray = (img.astype(np.float32) * _GRAY).sum(axis=2, keepdims=True)
            return np.broadcast_to(gray, img.shape).copy()
        return img


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        self.typ = typ

    def __call__(self, img, rng):
        return img.astype(self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=INTER_LINEAR):
    """Build the standard augmenter list (ref image.py:885).

    Returns a list; apply in order via SequentialAug or a pipeline loop.
    ``mean=True`` / ``std=True`` select the ImageNet defaults.
    """
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])  # (w, h)
    if rand_resize:
        assert rand_crop, "rand_resize requires rand_crop"
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3 / 4.0, 4 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(
            pca_noise,
            eigval=np.array([55.46, 4.794, 1.148]),
            eigvec=np.array([[-0.5675, 0.7192, 0.4009],
                             [-0.5808, -0.0045, -0.8140],
                             [-0.5836, -0.6948, 0.4203]])))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], dtype=np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], dtype=np.float32)
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter — pure-python iterator over a .lst/.rec dataset
# ---------------------------------------------------------------------------

class ImageIter(DataIter):
    """Flexible image iterator: .rec file, .lst file, or (label, path) list.

    Reference: python/mxnet/image/image.py:999.  Unlike the threaded
    ImageRecordIter this decodes inline — it is the debuggable/extensible
    path; subclass and override ``augment`` for custom pipelines.

    Outputs float32 NCHW (or NHWC with ``layout='NHWC'``) RGB batches.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NCHW", seed=0,
                 last_batch_handle="pad",
                 **aug_kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3 and data_shape[0] in (1, 3), \
            "data_shape must be (C, H, W)"
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.layout = layout
        self.dtype = dtype
        self._data_name, self._label_name = data_name, label_name
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError("last_batch_handle must be 'pad' or 'discard', "
                             "got %r" % last_batch_handle)
        self._last_batch_handle = last_batch_handle
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._aug_rng = np.random.default_rng(seed + 1)
        self.path_root = path_root

        self._rec = None
        self.imglist = {}
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self._rec = recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                       "r")
                keys = list(self._rec.keys)
            else:
                # build the offset index by scanning once
                self._rec = recordio.MXIndexedRecordIO(None, path_imgrec, "r")
                keys = list(self._rec.keys)
            self.seq = keys
        elif path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = int(parts[0])
                    label = np.array(parts[1:-1], dtype=np.float32)
                    self.imglist[key] = (label if label.size > 1
                                         else float(label[0]), parts[-1])
            self.seq = sorted(self.imglist)
        elif imglist is not None:
            for i, (label, path) in enumerate(imglist):
                self.imglist[i] = (label, path)
            self.seq = list(range(len(imglist)))
        else:
            raise MXNetError("ImageIter needs path_imgrec, path_imglist, "
                             "or imglist")

        # rank sharding: contiguous slice per part, remainder to the last
        # part (same cover contract as ImageRecordIterImpl)
        if num_parts > 1:
            per = len(self.seq) // num_parts
            lo = part_index * per
            hi = lo + per if part_index < num_parts - 1 else len(self.seq)
            self.seq = self.seq[lo:hi]

        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **aug_kwargs)
        self.auglist = aug_list
        self._cursor = 0
        self.reset()

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

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self.seq)
        self._cursor = 0

    def _read_sample(self, key):
        """Returns (label, decoded HWC uint8 RGB image)."""
        if self._rec is not None:
            s = self._rec.read_idx(key)
            header, buf = recordio.unpack(s)
            label = header.label
            if self.imglist:
                label = self.imglist[key][0]
            return label, imdecode(buf, flag=1 if self.data_shape[0] == 3
                                   else 0)
        label, fname = self.imglist[key]
        path = os.path.join(self.path_root, fname) if self.path_root else fname
        return label, imread(path, flag=1 if self.data_shape[0] == 3 else 0)

    def augment(self, img):
        for aug in self.auglist:
            img = aug(img, self._aug_rng)
        return img

    def next(self):
        if self._cursor >= len(self.seq):
            raise StopIteration
        if (self._last_batch_handle == "discard"
                and len(self.seq) - self._cursor < self.batch_size):
            raise StopIteration
        c, h, w = self.data_shape
        nhwc = self.layout == "NHWC"
        shape = (self.batch_size, h, w, c) if nhwc \
            else (self.batch_size, c, h, w)
        data = np.zeros(shape, dtype=self.dtype)
        label = np.zeros((self.batch_size, self.label_width), dtype=np.float32)
        i = 0
        while i < self.batch_size and self._cursor < len(self.seq):
            lab, img = self._read_sample(self.seq[self._cursor])
            self._cursor += 1
            img = self.augment(img)
            if img.shape[:2] != (h, w):
                raise MXNetError(
                    "augmented image shape %s != data_shape %s — add a "
                    "crop/resize augmenter" % (img.shape, (h, w)))
            data[i] = img if nhwc else img.transpose(2, 0, 1)
            label[i] = lab
            i += 1
        pad = self.batch_size - i
        if self.label_width == 1:
            label = label[:, 0]
        # host batches, as every iterator's: the executor copies them to
        # its device
        return DataBatch(data=[from_numpy(data)], label=[from_numpy(label)],
                         pad=pad)
