"""ImageRecordIterImpl in the PyTorch port against the JAX package.

Both packages read the same raw (``im2rec --encoding raw``) and JPEG
record files with the same arguments; every batch of two epochs (the
second after ``reset``) must be equal bit for bit: data, label, pad and
the record keys in ``index``.  The cases cover shuffling, random crops
and mirrors, resizing, mean/std normalization, both layouts, uint8 and
float32 output, sharding by ``num_parts``/``part_index`` and a partial
last batch, wrapped (``round_batch``) or dropped.  The port's batches
are the same whatever its thread count, and its worker processes
(``use_processes=True``) give the threaded pool's batches.
"""
import numpy as np
import pytest

from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import io as tio

N_REC = 27              # not a multiple of the batch: the last one is partial
RAW = (32, 40, 3)       # stored H, W, C
BATCH = 8


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(raw .rec path, JPEG .rec path): the same seeded images, labels
    i % 5, written by the JAX package (the formats are held equal in
    test_torch_recordio.py)."""
    root = tmp_path_factory.mktemp("recs")
    imgs = np.random.default_rng(0).integers(0, 256, (N_REC,) + RAW,
                                             dtype=np.uint8)
    paths = {}
    for kind in ("raw", "jpeg"):
        paths[kind] = str(root / (kind + ".rec"))
        w = jrec.MXIndexedRecordIO(str(root / (kind + ".idx")), paths[kind],
                                   "w")
        for i, img in enumerate(imgs):
            header = jrec.IRHeader(0, float(i % 5), i, 0)
            w.write_idx(i, jrec.pack(header, img.tobytes()) if kind == "raw"
                        else jrec.pack_img(header, img, quality=90))
        w.close()
    return paths


CASES = {
    "center": dict(),
    "shuffle-crop-mirror": dict(shuffle=True, seed=3, rand_crop=True,
                                rand_mirror=True),
    "resize": dict(resize=28, rand_crop=True),
    "mean-std-nhwc": dict(layout="NHWC", rand_crop=True, rand_mirror=True,
                          mean_r=123.68, mean_g=116.779, mean_b=103.939,
                          std_r=58.393, std_g=57.12, std_b=57.375),
    "uint8-nhwc": dict(layout="NHWC", dtype="uint8", rand_crop=True,
                       shuffle=True),
    "scale": dict(scale=1 / 255.0, rand_mirror=True),
    "part-1-of-3": dict(num_parts=3, part_index=1, shuffle=True),
    "part-2-of-3-no-round": dict(num_parts=3, part_index=2,
                                 round_batch=False),
    "no-round-batch": dict(round_batch=False, rand_crop=True),
}


def _make(pkg, rec, kind, threads=2, processes=False, factory=None,
          **kwargs):
    if kind == "raw":
        kwargs["raw_shape"] = RAW
    factory = factory or pkg.ImageRecordIter
    return factory(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=BATCH,
                   preprocess_threads=threads, use_processes=processes,
                   **kwargs)


def _epochs(it, n=2):
    """Every batch of ``n`` epochs as host copies (the pool may reuse a
    batch's buffers once the next one is asked for)."""
    out = []
    try:
        for epoch in range(n):
            if epoch:
                it.reset()
            for b in it:
                out.append((b.data[0].asnumpy().copy(),
                            b.label[0].asnumpy().copy(), b.pad,
                            np.array(b.index)))
    finally:
        it.close()
    return out


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for (d, l, p, i), (d0, l0, p0, i0) in zip(got, want):
        assert d.dtype == d0.dtype and d.shape == d0.shape
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(l, l0)
        np.testing.assert_array_equal(i, i0)
        assert p == p0


@pytest.mark.parametrize("kind", ["raw", "jpeg"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_the_reference(records, kind, case):
    want = _epochs(_make(jio, records[kind], kind, **CASES[case]))
    got = _epochs(_make(tio, records[kind], kind, **CASES[case]))
    _assert_same(got, want)
    if CASES[case].get("round_batch", True):
        assert any(p for _, _, p, _ in got) or \
            CASES[case].get("num_parts", 1) > 1


@pytest.mark.parametrize("kind", ["raw", "jpeg"])
def test_uint8_iterator_equals_the_reference(records, kind):
    kwargs = dict(rand_crop=True, rand_mirror=True, shuffle=True,
                  layout="NHWC")
    want = _epochs(_make(jio, records[kind], kind,
                         factory=jio.ImageRecordUInt8Iter, **kwargs))
    got = _epochs(_make(tio, records[kind], kind,
                        factory=tio.ImageRecordUInt8Iter, **kwargs))
    _assert_same(got, want)
    assert got[0][0].dtype == np.uint8


def test_thread_count_does_not_change_the_batches(records):
    kwargs = CASES["shuffle-crop-mirror"]
    one = _epochs(_make(tio, records["jpeg"], "jpeg", threads=1, **kwargs))
    four = _epochs(_make(tio, records["jpeg"], "jpeg", threads=4, **kwargs))
    _assert_same(four, one)


def test_worker_processes_equal_the_threaded_pool(records):
    kwargs = dict(CASES["mean-std-nhwc"], shuffle=True, prefetch_buffer=2)
    threaded = _epochs(_make(tio, records["raw"], "raw", **kwargs))
    procs = _epochs(_make(tio, records["raw"], "raw", processes=True,
                          **kwargs))
    _assert_same(procs, threaded)


def test_batches_are_host_arrays_over_the_pipeline_buffers(records):
    it = _make(tio, records["raw"], "raw", layout="NHWC")
    try:
        b = it.next()
        assert b.data[0].context.device_type == "cpu"
        assert b.data[0].shape == (BATCH, 24, 24, 3)
        assert it.provide_data[0].shape == (BATCH, 24, 24, 3)
        assert it.provide_label[0].shape == (BATCH,)
    finally:
        it.close()
