"""The detection data path in the port against the JAX package:
``image/detection.py``'s label helpers and ``io.ImageDetRecordIter``,
whose batches (images, padded box labels, record keys) must equal the
JAX package's bit for bit, crops and mirrors included, across two
shuffled epochs; and the port alone training SSD's ``testnet`` on those
batches, its class loss falling.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.image import detection as jdet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.image import detection as tdet

N_RECORDS, PAD, N_CLASSES = 12, 6, 3
ITER_CASES = {
    # examples/train_ssd.py's arguments at a small size
    "the example's": dict(data_shape=(3, 48, 48), batch_size=5,
                          label_pad_count=PAD, rand_mirror=True,
                          rand_crop_prob=0.5, shuffle=True, seed=3,
                          mean_r=123.68, mean_g=116.779, mean_b=103.939),
    "resized, NHWC, scaled": dict(data_shape=(3, 40, 40), batch_size=4,
                                  label_pad_width=PAD * 5, resize=56,
                                  rand_crop_prob=1.0, min_crop_scales=0.5,
                                  layout="NHWC", scale=1 / 255.0, seed=4),
}


def _objects(rng, n):
    xy = rng.uniform(0.0, 0.5, (n, 2))
    wh = rng.uniform(0.1, 0.5, (n, 2))
    cls = rng.integers(0, N_CLASSES, (n, 1))
    return np.concatenate([cls, xy, np.minimum(xy + wh, 1.0)],
                          axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    """Seeded PNG detection records of 50-70 pixels a side, 1-4 boxes:
    the file's path and each record's padded label by key."""
    root = tmp_path_factory.mktemp("detrec")
    rec = str(root / "det.rec")
    w = mt.recordio.MXIndexedRecordIO(str(root / "det.idx"), rec, "w")
    rng = np.random.default_rng(0)
    labels = {}
    for i in range(N_RECORDS):
        h, wd = rng.integers(50, 71, 2)
        img = (rng.random((h, wd, 3)) * 255).astype(np.uint8)
        label = tdet.pack_det_label(_objects(rng, 1 + i % 4))
        labels[i] = tdet.parse_det_label(label, PAD)
        w.write_idx(i, mt.recordio.pack_img(
            mt.recordio.IRHeader(0, label, i, 0), img, img_fmt=".png"))
    w.close()
    return rec, labels


def test_label_helpers_match_jax():
    rng = np.random.default_rng(5)
    objs = _objects(rng, 4)
    flat = tdet.pack_det_label(objs)
    np.testing.assert_array_equal(flat, jdet.pack_det_label(objs))
    # a wider header and objects with an extra column
    wide = np.concatenate([[3, 6, 9.0], np.concatenate(
        [objs, rng.random((4, 1))], axis=1).reshape(-1)]).astype(np.float32)
    for raw, pad, most in ((flat, PAD, None), (flat, 3, None),
                           (wide, PAD, 2), ([7.0], PAD, None)):
        got = tdet.parse_det_label(raw, pad, max_objs=most)
        np.testing.assert_array_equal(
            got, jdet.parse_det_label(raw, pad, max_objs=most))
    label = tdet.parse_det_label(flat, PAD)
    np.testing.assert_array_equal(tdet._flip_boxes(label),
                                  jdet._flip_boxes(label))
    for crop in ((0, 0, 30, 40), (12, 5, 25, 30), (40, 40, 10, 10)):
        np.testing.assert_array_equal(
            tdet._crop_boxes(label, *crop, 64, 60, 0.3),
            jdet._crop_boxes(label, *crop, 64, 60, 0.3))


@pytest.mark.parametrize("case", list(ITER_CASES))
def test_det_record_iter_matches_jax_bit_for_bit(det_rec, case):
    rec, stored = det_rec
    kw = dict(ITER_CASES[case], path_imgrec=rec, preprocess_threads=2,
              label_name="label")
    it = mt.io.ImageDetRecordIter(**kw)
    ref = mx.io.ImageDetRecordIter(**kw)
    assert it.provide_label[0].shape == ref.provide_label[0].shape \
        == (kw["batch_size"], PAD, 5)
    assert it.provide_data[0].shape == ref.provide_data[0].shape
    moved = 0
    for epoch in range(2):
        if epoch:
            it.reset()
            ref.reset()
        got, want = list(it), list(ref)
        assert len(got) == len(want) == -(-N_RECORDS // kw["batch_size"])
        for g, r in zip(got, want):
            assert g.pad == r.pad
            np.testing.assert_array_equal(g.index, r.index)
            np.testing.assert_array_equal(g.data[0].asnumpy(),
                                          r.data[0].asnumpy())
            lab = g.label[0].asnumpy()
            np.testing.assert_array_equal(lab, r.label[0].asnumpy())
            valid = lab[:, :, 0] >= 0
            assert (lab[valid][:, 1:] >= 0).all() \
                and (lab[valid][:, 1:] <= 1).all()
            moved += sum(not np.array_equal(row, stored[key])
                         for row, key in zip(lab, g.index))
    it.close()
    ref.close()
    # crops and mirrors moved the boxes of some images
    assert moved > 0


def test_det_iter_refuses_worker_processes(det_rec):
    with pytest.raises(MXNetError, match="use_processes"):
        mt.io.ImageDetRecordIter(path_imgrec=det_rec[0],
                                 data_shape=(3, 32, 32), batch_size=4,
                                 use_processes=True)


def test_testnet_trains_on_the_det_iter(det_rec):
    """The port alone: four epochs of SGD over the detection batches; the
    masked class cross-entropy of the last step is below the first's."""
    it = mt.io.ImageDetRecordIter(
        path_imgrec=det_rec[0], data_shape=(3, 48, 48), batch_size=4,
        label_pad_count=PAD, rand_mirror=True, preprocess_threads=1,
        scale=1 / 255.0, label_name="label", data_name="data")
    net = mt.models.get_ssd_symbol("testnet", num_classes=N_CLASSES,
                                   mode="train")
    mt.random.seed(0)
    mod = mt.mod.Module(net, context=mt.cpu(), data_names=("data",),
                        label_names=("label",))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mt.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9})
    ces = []
    for _ in range(4):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
            probs, _, labels = (o.asnumpy() for o in mod.get_outputs())
            mask = labels >= 0
            picked = probs.transpose(0, 2, 1)[mask, labels[mask].astype(int)]
            ces.append(-np.log(np.clip(picked, 1e-8, 1)).mean())
    it.close()
    assert np.isfinite(ces).all()
    assert ces[-1] < ces[0], ces
