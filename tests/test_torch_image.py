"""Image transforms, augmenters, CreateAugmenter and ImageIter in the
PyTorch port against the JAX package.

Every transform and augmenter gets the same input and a
``numpy.random.Generator`` from the same seed in both packages: uint8
results must match bit for bit and float results within 1e-6 of their
largest magnitude, and both generators must end in the same state (the
same draws were made).  ``CreateAugmenter`` must build the same list
(``dumps()``), and ``ImageIter`` over one record file the same batches.
cv2 decodes and resizes here; without cv2 and PIL the port raises an
ImportError naming both.
"""
import sys

import numpy as np
import pytest

from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image as timg

FLOAT_TOL = 1e-6
EIG = dict(eigval=np.array([55.46, 4.794, 1.148]),
           eigvec=np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]]))
MEAN = np.array([123.68, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def _images(n=4, h=40, w=52):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (h + 3 * i, w - 2 * i, 3), dtype=np.uint8)
            for i in range(n)]


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= FLOAT_TOL * scale


# augmenter constructors, given the package's image module
AUGMENTERS = {
    "resize": lambda m: m.ResizeAug(24),
    "resize-cubic": lambda m: m.ResizeAug(60, m.image.INTER_CUBIC),
    "force-resize": lambda m: m.ForceResizeAug((30, 20)),
    "center-crop": lambda m: m.CenterCropAug((20, 24)),
    "center-crop-upscale": lambda m: m.CenterCropAug((64, 64)),
    "random-crop": lambda m: m.RandomCropAug((20, 20)),
    "random-crop-upscale": lambda m: m.RandomCropAug((60, 48)),
    "random-sized-crop": lambda m: m.RandomSizedCropAug(
        (20, 20), 0.08, (3 / 4.0, 4 / 3.0)),
    "random-sized-crop-area": lambda m: m.RandomSizedCropAug(
        (16, 24), (0.3, 0.9), (0.5, 2.0), m.image.INTER_AREA),
    "flip-half": lambda m: m.HorizontalFlipAug(0.5),
    "flip-always": lambda m: m.HorizontalFlipAug(1.0),
    "brightness": lambda m: m.BrightnessJitterAug(0.3),
    "contrast": lambda m: m.ContrastJitterAug(0.3),
    "saturation": lambda m: m.SaturationJitterAug(0.3),
    "hue": lambda m: m.HueJitterAug(0.2),
    "color-jitter": lambda m: m.ColorJitterAug(0.3, 0.2, 0.1),
    "lighting": lambda m: m.LightingAug(0.1, **EIG),
    "normalize": lambda m: m.ColorNormalizeAug(MEAN, STD),
    "normalize-mean-only": lambda m: m.ColorNormalizeAug(MEAN, None),
    "random-gray": lambda m: m.RandomGrayAug(0.5),
    "cast": lambda m: m.CastAug(),
    "sequential": lambda m: m.SequentialAug(
        [m.RandomCropAug((24, 24)), m.HorizontalFlipAug(0.5), m.CastAug(),
         m.ColorNormalizeAug(MEAN, STD)]),
    "random-order": lambda m: m.RandomOrderAug(
        [m.BrightnessJitterAug(0.2), m.ContrastJitterAug(0.2),
         m.SaturationJitterAug(0.2)]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_augmenter_matches_the_reference(name):
    jaug, taug = AUGMENTERS[name](jimg), AUGMENTERS[name](timg)
    assert taug.dumps() == jaug.dumps()
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for img in _images():
        _same(taug(img, tr), jaug(img, jr))
    assert tr.bit_generator.state == jr.bit_generator.state


# (name, function of (module, image, rng)) for the functional transforms
FUNCTIONS = {
    "imresize": lambda m, im, r: m.imresize(im, 33, 17),
    "imresize-nearest": lambda m, im, r: m.imresize(im, 70, 50,
                                                    m.image.INTER_NEAREST),
    "resize-short": lambda m, im, r: m.resize_short(im, 30),
    "resize-short-tall": lambda m, im, r: m.resize_short(im[:, :20], 30),
    "fixed-crop": lambda m, im, r: m.fixed_crop(im, 3, 5, 20, 18),
    "fixed-crop-resize": lambda m, im, r: m.fixed_crop(im, 3, 5, 20, 18,
                                                       (24, 24)),
    "center-crop": lambda m, im, r: m.center_crop(im, (21, 19)),
    "random-crop": lambda m, im, r: m.random_crop(im, (21, 19), r),
    "random-size-crop": lambda m, im, r: m.random_size_crop(
        im, (21, 19), 0.2, (0.75, 1.33), r),
    "color-normalize": lambda m, im, r: m.color_normalize(im, MEAN, STD),
}


def _flatten(out):
    """A transform's outputs as a list (crops also return their window)."""
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functional_transform_matches_the_reference(name):
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for img in _images():
        got = _flatten(FUNCTIONS[name](timg, img, tr))
        want = _flatten(FUNCTIONS[name](jimg, img, jr))
        assert len(got) == len(want)
        _same(got[0], want[0])
        assert got[1:] == want[1:]
    assert tr.bit_generator.state == jr.bit_generator.state


@pytest.mark.parametrize("fmt,kw", [(".jpg", dict()),
                                    (".png", dict()),
                                    (".jpg", dict(flag=0)),
                                    (".jpg", dict(to_rgb=False))],
                         ids=["jpg", "png", "gray", "bgr"])
def test_imdecode_matches_the_reference(fmt, kw):
    import cv2
    img = _images(1)[0]
    ok, buf = cv2.imencode(fmt, img)
    assert ok
    _same(timg.imdecode(buf.tobytes(), **kw),
          jimg.imdecode(buf.tobytes(), **kw))


CREATE_KWARGS = [
    dict(),
    dict(resize=30, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1,
         pca_noise=0.05, rand_gray=0.2, mean=MEAN, std=STD),
]


@pytest.mark.parametrize("kwargs", CREATE_KWARGS,
                         ids=["default", "crop-mirror", "sized-crop",
                              "color"])
def test_create_augmenter_lists_match(kwargs):
    want = jimg.CreateAugmenter((3, 24, 24), **kwargs)
    got = timg.CreateAugmenter((3, 24, 24), **kwargs)
    assert [a.dumps() for a in got] == [a.dumps() for a in want]
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for img in _images():
        a, b = img, img
        for ja, ta in zip(want, got):
            a, b = ja(a, jr), ta(b, tr)
        _same(b, a)


@pytest.fixture(scope="module")
def jpeg_rec(tmp_path_factory):
    root = tmp_path_factory.mktemp("imageiter")
    path = str(root / "data.rec")
    w = jrec.MXIndexedRecordIO(str(root / "data.idx"), path, "w")
    for i, img in enumerate(_images(10, 36, 36)):
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 3), i, 0),
                                     img[:36, :36], quality=95))
    w.close()
    return path


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(shuffle=True, rand_crop=True, rand_mirror=True, layout="NHWC",
         mean=True, std=True),
    dict(last_batch_handle="discard", num_parts=2, part_index=1,
         resize=40, rand_crop=True),
], ids=["center", "shuffle-crop-nhwc", "discard-part"])
def test_image_iter_over_a_record_file_matches(jpeg_rec, kwargs):
    its = [m.ImageIter(batch_size=4, data_shape=(3, 28, 28),
                       path_imgrec=jpeg_rec, seed=2, **kwargs)
           for m in (jimg, timg)]
    for epoch in range(2):
        jb, tb = list(its[0]), list(its[1])
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert b.pad == a.pad
            assert b.data[0].context.device_type == "cpu"
            _same(b.data[0].asnumpy(), a.data[0].asnumpy())
            np.testing.assert_array_equal(b.label[0].asnumpy(),
                                          a.label[0].asnumpy())
        for it in its:
            it.reset()


def test_decode_and_resize_name_cv2_and_pil_when_both_are_missing(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    timg.image._cv2.cache_clear()
    try:
        with pytest.raises(ImportError, match="cv2 or PIL"):
            timg.imdecode(b"\xff\xd8\xff")
        with pytest.raises(ImportError, match="cv2 or PIL"):
            timg.imresize(np.zeros((4, 4, 3), np.uint8), 8, 8)
        # crops and flips of raw pixels need neither
        img = _images(1)[0]
        out = timg.RandomCropAug((20, 20))(img, np.random.default_rng(0))
        assert out.shape == (20, 20, 3)
    finally:
        monkeypatch.undo()
        timg.image._cv2.cache_clear()
