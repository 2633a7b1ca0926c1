"""ResizeIter, PrefetchingIter, NDArrayIter's roll_over, MNISTIter and
CSVIter in the PyTorch port against the JAX package, on synthetic files
and arrays: the same batches (data, label, pad) over several epochs."""
import gzip
import struct

import numpy as np
import pytest

from mxnet_tpu import io as jio
from mxnet_tpu_torch import io as tio


def _batches(it, epochs=3):
    out = []
    for epoch in range(epochs):
        if epoch:
            it.reset()
        for b in it:
            out.append(([d.asnumpy().copy() for d in b.data],
                        [l.asnumpy().copy() for l in b.label or []], b.pad))
    return out


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for (d, l, p), (d0, l0, p0) in zip(got, want):
        assert p == p0
        for a, b in zip(d + l, d0 + l0):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _arrays(n=10):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            np.arange(n, dtype=np.float32))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("batch", [3, 4])
def test_ndarray_iter_last_batch_handles_match(handle, batch):
    x, y = _arrays()
    want = _batches(jio.NDArrayIter(x, y, batch_size=batch,
                                    last_batch_handle=handle))
    got = _batches(tio.NDArrayIter(x, y, batch_size=batch,
                                   last_batch_handle=handle))
    _assert_same(got, want)


@pytest.mark.parametrize("size", [2, 7])
def test_resize_iter_matches(size):
    x, y = _arrays()
    want = _batches(jio.ResizeIter(jio.NDArrayIter(x, y, batch_size=4), size))
    got = _batches(tio.ResizeIter(tio.NDArrayIter(x, y, batch_size=4), size))
    _assert_same(got, want)
    assert len(got) == 3 * size


def test_prefetching_iter_matches():
    x, y = _arrays()
    x2 = x * 2

    def make(io):
        return io.PrefetchingIter(
            [io.NDArrayIter(x, y, batch_size=4),
             io.NDArrayIter(x2, y, batch_size=4, data_name="data2",
                            label_name="label2")])
    want, got = make(jio), make(tio)
    assert [d.name for d in got.provide_data] == ["data", "data2"]
    assert [tuple(d.shape) for d in got.provide_data] == \
        [tuple(d.shape) for d in want.provide_data]
    _assert_same(_batches(got), _batches(want))


def _write_mnist(root, n=23, gz=False):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img_path = str(root / ("images" + suffix))
    lab_path = str(root / ("labels" + suffix))
    with opener(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(lab_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img_path, lab_path


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(flat=True, shuffle=False, gz=True),
    dict(num_parts=2, part_index=1, seed=5),
    dict(input_shape=(28, 28, 1)),
], ids=["default", "flat-gz", "part", "input-shape"])
def test_mnist_iter_matches(tmp_path, kwargs):
    kwargs = dict(kwargs)
    img, lab = _write_mnist(tmp_path, gz=kwargs.pop("gz", False))
    want = _batches(jio.MNISTIter(image=img, label=lab, batch_size=5,
                                  **kwargs))
    got = _batches(tio.MNISTIter(image=img, label=lab, batch_size=5,
                                 **kwargs))
    _assert_same(got, want)


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("with_label", [True, False])
def test_csv_iter_matches(tmp_path, round_batch, with_label):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((11, 6)).astype(np.float32)
    np.savetxt(tmp_path / "data.csv", data, delimiter=",")
    kwargs = dict(data_csv=str(tmp_path / "data.csv"), data_shape=(2, 3),
                  batch_size=4, round_batch=round_batch)
    if with_label:
        np.savetxt(tmp_path / "label.csv", np.arange(11.0), delimiter=",")
        kwargs["label_csv"] = str(tmp_path / "label.csv")
    _assert_same(_batches(tio.CSVIter(**kwargs)),
                 _batches(jio.CSVIter(**kwargs)))
