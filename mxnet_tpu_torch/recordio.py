"""RecordIO: MXNet's packed-record container format.

Counterpart of ``mxnet_tpu/recordio.py`` (reference
``python/mxnet/recordio.py`` over dmlc-core's ``recordio.h``), kept as the
port's own copy.  The files it writes are byte-identical to the
reference's, ``.rec`` and ``.idx`` both:

    [kMagic:u32][cflag|length:u32][payload][pad to 4B]   per record

where the upper 3 bits of the second word are the continuation flag of a
record split over 2^29-byte chunks.  The indexed variant keeps a text
``.idx`` (key \\t offset per line).  ``IRHeader`` packs (flag, label, id,
id2) ahead of image payloads.

Records are decoded on the host (``image``); batches reach the card in one
copy each (``io.ImageRecordIter``, ``data.DevicePrefetcher``).
"""
from __future__ import annotations

import numbers
import os
import struct

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_KMAGIC = 0xCED7230A
_LFLAG_BITS = 29
_MAX_CHUNK = (1 << _LFLAG_BITS) - 1


def _encode_lrec(cflag, length):
    return (cflag << _LFLAG_BITS) | length


def _decode_lrec(lrec):
    return lrec >> _LFLAG_BITS, lrec & _MAX_CHUNK


class MXRecordIO:
    """Sequential record reader/writer (reference ``MXRecordIO``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fh = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.fh = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fh = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag!r}")
        self.is_open = True

    def close(self):
        if self.is_open and self.fh is not None:
            self.fh.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __getstate__(self):
        """The state without the file handle; the copy reopens the file.
        A writer is closed first (its data flushed); a reader stays open,
        so a dataset stays usable after it was sent to process workers."""
        is_open = self.is_open
        if self.writable:
            self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("fh", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.fh = None
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            if self.flag == "w":
                self.fh = open(self.uri, "ab")  # continue where it was
                self.is_open = True
            else:
                self.open()

    def write(self, buf):
        if not self.writable:
            raise MXNetError("record file opened read-only")
        if not isinstance(buf, (bytes, bytearray)):
            raise MXNetError("write() takes bytes")
        data = bytes(buf)
        remaining = len(data)
        offset = 0
        first = True
        while remaining > 0 or first:
            chunk = min(remaining, _MAX_CHUNK)
            total_left = remaining - chunk
            if first:
                cflag = 0 if total_left == 0 else 1
            else:
                cflag = 3 if total_left == 0 else 2
            self.fh.write(struct.pack("<II", _KMAGIC,
                                      _encode_lrec(cflag, chunk)))
            self.fh.write(data[offset:offset + chunk])
            pad = (4 - chunk % 4) % 4
            if pad:
                self.fh.write(b"\x00" * pad)
            offset += chunk
            remaining -= chunk
            first = False

    def read(self):
        if self.writable:
            raise MXNetError("record file opened write-only")
        parts = []
        while True:
            header = self.fh.read(8)
            if len(header) < 8:
                return None if not parts else b"".join(parts)
            magic, lrec = struct.unpack("<II", header)
            if magic != _KMAGIC:
                raise MXNetError(
                    f"corrupt record file {self.uri!r}: bad magic")
            cflag, length = _decode_lrec(lrec)
            payload = self.fh.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.fh.read(pad)
            parts.append(payload)
            if cflag in (0, 3):
                return b"".join(parts)

    def tell(self):
        return self.fh.tell()


def read_idx_file(idx_path, key_type=int):
    """The ``(key, offset)`` pairs of a ``.idx`` file, in file order.
    Blank lines are skipped (``im2rec`` and hand-edited indexes have
    them); a malformed line raises ``MXNetError`` naming it."""
    pairs = []
    with open(idx_path) as fin:
        for lineno, line in enumerate(fin, 1):
            stripped = line.strip()
            if not stripped:
                continue
            parts = stripped.split("\t")
            try:
                pairs.append((key_type(parts[0]), int(parts[1])))
            except (IndexError, ValueError) as exc:
                raise MXNetError(
                    f"corrupt index line {lineno} in {idx_path!r}: "
                    f"{stripped!r}") from exc
    return pairs


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file through a ``.idx`` sidecar (reference
    ``MXIndexedRecordIO``)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            for key, offset in read_idx_file(idx_path, key_type):
                self.idx[key] = offset
                self.keys.append(key)

    def close(self):
        if self.writable and self.is_open:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        if self.writable:
            raise MXNetError("cannot seek a writable indexed record file")
        self.fh.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.fh.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


class IRHeader:
    """Image-record header (reference struct: flag, label, id, id2)."""

    __slots__ = ("flag", "label", "id", "id2")
    _FMT = "<IfQQ"

    def __init__(self, flag, label, id, id2):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2

    def __iter__(self):
        return iter((self.flag, self.label, self.id, self.id2))

    def __eq__(self, other):
        return tuple(self) == tuple(other)


def pack(header, s):
    """Pack (IRHeader, payload bytes) (reference ``pack``)."""
    header = IRHeader(*header) if not isinstance(header, IRHeader) else header
    label = header.label
    if isinstance(label, numbers.Number):
        packed = struct.pack(IRHeader._FMT, 0, float(label), header.id,
                             header.id2)
    else:
        label = np.asarray(label, dtype=np.float32)
        packed = struct.pack(IRHeader._FMT, len(label), 0.0, header.id,
                             header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """Unpack bytes into (IRHeader, payload) (reference ``unpack``)."""
    size = struct.calcsize(IRHeader._FMT)
    flag, label, id_, id2 = struct.unpack(IRHeader._FMT, s[:size])
    s = s[size:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC BGR (or gray) uint8 image and pack it (reference
    ``pack_img``; OpenCV's encoder, as ``im2rec`` uses)."""
    from .image import _cv2

    cv2 = _cv2("encoding an image")
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError(f"failed to encode image as {img_fmt}")
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Unpack and decode an image record (reference ``unpack_img``): the
    image comes back as the encoder got it (BGR)."""
    from .image import _decode_bgr

    header, img_bytes = unpack(s)
    return header, _decode_bgr(img_bytes, iscolor)
