"""RecordIO: MXNet's packed-record container format, bit for bit.

Counterpart of ``mxnet_tpu/recordio.py``: ``MXRecordIO``,
``MXIndexedRecordIO``, ``IRHeader``, ``pack``, ``unpack``, ``pack_img`` and
``unpack_img``.  Each record is
  [kMagic:u32][cflag|len:u32][payload][pad to 4B]
where cflag (upper 3 bits) marks the parts of a record whose payload holds
the magic word; ``IRHeader`` prepends (flag, label, id, id2) to image
records.  Files written by either package read in the other.  cv2 (or
PIL) is imported only when ``pack_img`` or ``unpack_img`` runs.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a
_LE_U32 = struct.Struct("<I")


class MXRecordIO(object):
    """Sequential RecordIO reader/writer (recordio.py:28)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.handle.close()
        self.is_open = False

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("handle", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        is_open = d["is_open"]
        self.is_open = False
        self.handle = None
        if is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def write(self, buf):
        """Write one record, splitting around embedded magic words.

        dmlc recordio escape: any 4B-aligned occurrence of the magic inside
        the payload ends a part (cflag=1 first part, 2 middle, 3 last); the
        embedded magic itself is dropped and re-inserted by read(). cflag=0
        marks an unsplit record.
        """
        assert self.writable
        data = bytes(buf)
        length = len(data)
        assert length < (1 << 29), "record too large"
        magic_b = _LE_U32.pack(_kMagic)
        out = self.handle
        dptr = 0
        lower_align = (length >> 2) << 2
        # C-speed scan: only 4B-aligned, fully-inside-lower_align hits split
        pos = data.find(magic_b)
        while 0 <= pos:
            if pos % 4 == 0 and pos + 4 <= lower_align:
                part_len = pos - dptr
                out.write(magic_b)
                out.write(_LE_U32.pack(((1 if dptr == 0 else 2) << 29)
                                       | part_len))
                if part_len:
                    out.write(data[dptr:pos])
                # part lengths are multiples of 4 here: no pad needed
                dptr = pos + 4
                pos = data.find(magic_b, pos + 4)
            else:
                pos = data.find(magic_b, pos + 1)
        part_len = length - dptr
        out.write(magic_b)
        out.write(_LE_U32.pack(((3 if dptr else 0) << 29) | part_len))
        if part_len:
            out.write(data[dptr:])
        pad = (4 - part_len % 4) % 4
        if pad:
            out.write(b"\x00" * pad)

    def read(self):
        """Read one record, reassembling multi-part (cflag 1/2/3) records."""
        assert not self.writable
        magic_b = _LE_U32.pack(_kMagic)
        parts = []
        while True:
            hdr = self.handle.read(8)
            if len(hdr) < 8:
                if parts:
                    raise IOError("Truncated multi-part record in %s"
                                  % self.uri)
                return None
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _kMagic:
                raise IOError("Invalid magic number in record file %s"
                              % self.uri)
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            data = self.handle.read(length)
            if len(data) != length:
                raise IOError("Truncated record payload in %s" % self.uri)
            pad = (4 - length % 4) % 4
            if pad and len(self.handle.read(pad)) != pad:
                raise IOError("Truncated record padding in %s" % self.uri)
            parts.append(data)
            if cflag in (0, 3):
                break
            # non-final part: the split point was an embedded magic word
            parts.append(magic_b)
        return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a `.idx` sidecar (recordio.py:87).

    idx file format: "<key>\t<byte offset>\n" per record.
    """

    def __init__(self, idx_path, uri, flag, key_type=int, _index=None):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        # prebuilt {key: offset} table (lets pipeline worker threads share
        # one scan instead of re-reading the sidecar / re-scanning the file)
        self._prebuilt = dict(_index) if _index is not None else None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        else:
            self.fidx = None
            if self._prebuilt is not None:
                self.idx = dict(self._prebuilt)
                self.keys = list(self.idx)
            elif self.idx_path and os.path.exists(self.idx_path):
                with open(self.idx_path) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        if len(parts) < 2:
                            continue
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
            else:
                # no sidecar: build the offset table by scanning the stream
                # once — header reads + seeks only, payloads are skipped
                key = 0
                while True:
                    pos = self.handle.tell()
                    start = True
                    while True:  # walk the parts of one logical record
                        hdr = self.handle.read(8)
                        if len(hdr) < 8:
                            if not start:
                                raise IOError("Truncated multi-part record "
                                              "in %s" % self.uri)
                            hdr = None
                            break
                        magic, lrec = struct.unpack("<II", hdr)
                        if magic != _kMagic:
                            raise IOError("Invalid magic number in record "
                                          "file %s" % self.uri)
                        cflag, length = lrec >> 29, lrec & ((1 << 29) - 1)
                        self.handle.seek(length + (4 - length % 4) % 4, 1)
                        start = False
                        if cflag in (0, 3):
                            break
                    if hdr is None:
                        break
                    self.idx[self.key_type(key)] = pos
                    self.keys.append(self.key_type(key))
                    key += 1
                self.handle.seek(0)

    def close(self):
        if not self.is_open:
            return
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("fidx", None)
        return d

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# header for image records: flag steers label layout (scalar vs vector)
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a (header, payload bytes) into a record string."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, *header) + s
    return s


def unpack(s):
    """Unpack a record string into (header, payload) (recordio.py:240)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        return None


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array; requires cv2 or PIL (recordio.py:261)."""
    cv2 = _cv2()
    if cv2 is not None:
        encode_params = None
        if img_fmt in (".jpg", ".jpeg"):
            encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        elif img_fmt == ".png":
            encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
        ret, buf = cv2.imencode(img_fmt, img, encode_params)
        assert ret, "failed to encode image"
        return pack(header, buf.tobytes())
    try:
        from io import BytesIO
        from PIL import Image
        bio = BytesIO()
        fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
        Image.fromarray(np.asarray(img)[..., ::-1] if fmt == "JPEG" else
                        np.asarray(img)).save(bio, fmt, quality=quality)
        return pack(header, bio.getvalue())
    except ImportError:
        raise ImportError("pack_img requires cv2 or PIL")


def unpack_img(s, iscolor=-1):
    """Unpack a record into (header, decoded BGR image) (recordio.py:295)."""
    header, s = unpack(s)
    img = np.frombuffer(s, dtype=np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(img, iscolor)
    else:
        from io import BytesIO
        try:
            from PIL import Image
        except ImportError:
            raise ImportError("unpack_img requires cv2 or PIL")
        img = np.asarray(Image.open(BytesIO(bytes(s))))
        if img.ndim == 3:
            img = img[..., ::-1]  # RGB -> BGR, matching cv2 convention
    return header, img
