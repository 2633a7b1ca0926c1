"""RecordIO in the PyTorch port against the JAX package.

The same writes give byte-identical ``.rec`` and ``.idx`` files in both
packages, and each package reads the other's files: plain records,
records whose payload holds the magic word (written as several parts),
empty payloads, ``IRHeader`` with scalar labels and with label arrays
(``flag > 0``), and images through ``pack_img``/``unpack_img`` (cv2 is
installed here).  Without cv2 and PIL the image functions raise an
ImportError that names both.
"""
import struct
import sys

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as trec

MAGIC = struct.pack("<I", 0xced7230a)


def _payloads():
    """Payloads that exercise every branch of the writer: lengths that
    are and are not multiples of 4, the magic at aligned and unaligned
    offsets, at the start, twice in a row and in the last partial word."""
    rng = np.random.default_rng(0)
    body = rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
    return [
        b"", b"a", b"abcd", body, body[:36],
        MAGIC, MAGIC + body, body[:8] + MAGIC + body[:5],
        body[:3] + MAGIC + body[:9],              # unaligned: not split
        body[:4] + MAGIC + MAGIC + body[:4],
        body[:8] + MAGIC,                         # magic as the last word
        body[:6] + MAGIC[:2],
        body[:12] + MAGIC + body[:12] + MAGIC + body[:3],
    ]


def _write(pkg, root, name, records):
    w = pkg.MXIndexedRecordIO(str(root / (name + ".idx")),
                              str(root / (name + ".rec")), "w")
    for i, r in enumerate(records):
        w.write_idx(i, r)
    w.close()
    return root / (name + ".rec"), root / (name + ".idx")


def _read_all(pkg, rec, idx=None):
    r = pkg.MXIndexedRecordIO(None if idx is None else str(idx), str(rec),
                              "r")
    out = [r.read_idx(k) for k in r.keys]
    r.close()
    return out


def test_same_writes_give_byte_identical_files(tmp_path):
    records = _payloads()
    j_rec, j_idx = _write(jrec, tmp_path, "jax", records)
    t_rec, t_idx = _write(trec, tmp_path, "port", records)
    assert j_rec.read_bytes() == t_rec.read_bytes()
    assert j_idx.read_bytes() == t_idx.read_bytes()


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("with_idx", [True, False], ids=["idx", "scan"])
def test_each_package_reads_the_others_files(tmp_path, writer, reader,
                                             with_idx):
    records = _payloads()
    rec, idx = _write(writer, tmp_path, "data", records)
    assert _read_all(reader, rec, idx if with_idx else None) == records
    # sequential reads walk the multi-part records the same way
    r = reader.MXRecordIO(str(rec), "r")
    seq = []
    while True:
        s = r.read()
        if s is None:
            break
        seq.append(s)
    r.close()
    assert seq == records


@pytest.mark.parametrize("payload", _payloads()[5:],
                         ids=lambda p: "len%d" % len(p))
def test_magic_in_payload_is_split_as_the_reference_splits_it(tmp_path,
                                                             payload):
    """Each payload that holds the magic word gives the reference's parts
    (cflag 1/2/3) byte for byte, and reads back whole in both packages."""
    for pkg, name in ((jrec, "jax"), (trec, "port")):
        w = pkg.MXRecordIO(str(tmp_path / (name + ".rec")), "w")
        w.write(payload)
        w.close()
    data = (tmp_path / "port.rec").read_bytes()
    assert data == (tmp_path / "jax.rec").read_bytes()
    for pkg in (jrec, trec):
        for name in ("jax", "port"):
            r = pkg.MXRecordIO(str(tmp_path / (name + ".rec")), "r")
            assert r.read() == payload
            assert r.read() is None
            r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(7.0)],
                         ids=["scalar", "list", "array7"])
def test_irheader_pack_unpack_interchange(label):
    header = (0, label, 17, 3)
    payload = b"\x01\x02\x03payload"
    packed = trec.pack(trec.IRHeader(*header), payload)
    assert packed == jrec.pack(jrec.IRHeader(*header), payload)
    for unpack in (jrec.unpack, trec.unpack):
        h, s = unpack(packed)
        assert s == payload
        assert (h.id, h.id2) == (17, 3)
        if np.isscalar(label):
            assert h.flag == 0 and h.label == label
        else:
            assert h.flag == len(label)
            np.testing.assert_array_equal(h.label,
                                          np.asarray(label, np.float32))


@pytest.mark.parametrize("fmt,kw", [(".jpg", {"quality": 90}),
                                    (".png", {"quality": 3})],
                         ids=["jpg", "png"])
def test_pack_img_unpack_img_interchange(fmt, kw):
    img = np.random.default_rng(1).integers(0, 256, (20, 28, 3),
                                            dtype=np.uint8)
    header = trec.IRHeader(0, 5.0, 2, 0)
    packed = trec.pack_img(header, img, img_fmt=fmt, **kw)
    assert packed == jrec.pack_img(jrec.IRHeader(0, 5.0, 2, 0), img,
                                   img_fmt=fmt, **kw)
    (h1, a), (h2, b) = trec.unpack_img(packed), jrec.unpack_img(packed)
    assert h1.label == h2.label == 5.0
    np.testing.assert_array_equal(a, b)
    if fmt == ".png":
        np.testing.assert_array_equal(a, img)       # lossless


def test_image_functions_name_cv2_and_pil_when_both_are_missing(
        monkeypatch):
    """The port imports cv2 and PIL only when an image is encoded or
    decoded; without either, that raises an ImportError naming both."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ImportError, match="cv2 or PIL"):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img)
    packed = jrec.pack(jrec.IRHeader(0, 1.0, 0, 0), b"\xff\xd8")
    with pytest.raises(ImportError, match="cv2 or PIL"):
        trec.unpack_img(packed)
