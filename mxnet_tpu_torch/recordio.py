"""RecordIO: sequential binary record container and packed image records
(counterpart of ``mxnet_tpu/recordio.py``).

The dmlc-core framing of the reference: magic 0xced7230a, a length word
with the continuation flag, 4-byte alignment; the ``IRHeader`` packing of
``im2rec``.  Numpy and bytes only, so a ``.rec``/``.idx`` pair written by
either package reads byte for byte in the other.  ``pack_img`` and
``unpack_img`` import PIL when they run, and store or read raw CHW bytes
without it, as the reference does.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "stream_records", "count_records"]

_MAGIC = 0xced7230a


def _iter_frames(uri: str, want, chunk_bytes: int):
    """Walk a .rec file's framing via chunked ``os.pread``, yielding
    ``(index, payload_or_None)`` for every record — payload bytes are
    assembled only when ``want(index)`` is true, so skipping a record
    costs header arithmetic, not a copy, and the whole file is never
    resident (at most ~``chunk_bytes`` of it is)."""
    fd = os.open(uri, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        buf = b""
        base = 0          # file offset of buf[0]
        pos = 0           # absolute parse position
        idx = 0
        while pos + 8 <= size:
            if pos + 8 > base + len(buf):
                buf = os.pread(fd, chunk_bytes, pos)
                base = pos
            magic, length = struct.unpack_from("<II", buf, pos - base)
            if magic != _MAGIC:
                raise MXNetError("invalid record magic at offset %d in %s"
                                 % (pos, uri))
            length &= (1 << 29) - 1
            pad = (4 - length % 4) % 4
            if pos + 8 + length > size:
                raise MXNetError("truncated record %d at offset %d in %s"
                                 % (idx, pos, uri))
            if want is None or want(idx):
                end = pos + 8 + length
                if end > base + len(buf):
                    # record spans past the buffered chunk: one pread
                    # sized to the record (large records never force a
                    # whole-file read)
                    buf = os.pread(fd, max(chunk_bytes, 8 + length), pos)
                    base = pos
                off = pos - base
                yield idx, bytes(buf[off + 8:off + 8 + length])
            else:
                yield idx, None
            pos += 8 + length + pad
            idx += 1
    finally:
        os.close(fd)


def stream_records(uri: str, want=None, chunk_bytes: int = 1 << 20):
    """Stream ``(index, payload)`` out of a RecordIO file without ever
    materializing it: records are parsed out of a sliding pread window
    (``chunk_bytes`` at a time).  ``want(index) -> bool`` selects which
    records get their payload copied out — the sharded-reader workers
    pass ``lambda i: i % nshards == shard`` so each process pays copy
    cost only for its own shard while the page cache amortizes the
    sequential walk across processes."""
    for idx, payload in _iter_frames(uri, want, chunk_bytes):
        if payload is not None:
            yield idx, payload


def count_records(uri: str, chunk_bytes: int = 1 << 20) -> int:
    """Number of records in a .rec file via a payload-free framing walk
    (headers only are decoded; nothing is copied)."""
    n = 0
    for idx, _ in _iter_frames(uri, lambda _i: False, chunk_bytes):
        n = idx + 1
    return n


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference recordio.py:10)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        if flag == "w":
            self._f = open(uri, "wb")
        elif flag == "r":
            self._f = open(uri, "rb")
        else:
            raise ValueError("Invalid flag %s" % flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self._f.close()
            self.is_open = False

    def __del__(self):
        self.close()

    def tell(self) -> int:
        return self._f.tell()

    def seek(self, pos: int):
        self._f.seek(pos)

    def write(self, buf: bytes):
        assert self.flag == "w"
        self._f.write(struct.pack("<II", _MAGIC, len(buf)))
        self._f.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self._f.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        assert self.flag == "r"
        header = self._f.read(8)
        if len(header) < 8:
            return None
        magic, length = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic in %s" % self.uri)
        length &= (1 << 29) - 1  # mask continuation flag bits
        buf = self._f.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self._f.read(pad)
        return buf

    def reset(self):
        self._f.seek(0)


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with .idx sidecar (reference recordio.py:65)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys: List = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.flag == "w" and self.is_open:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def seek_idx(self, idx):
        self.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek_idx(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


# packed image record header (reference recordio.py IRHeader)
IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack an image record (reference recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        out = struct.pack(_IR_FORMAT, header.flag, float(header.label),
                          header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        out = struct.pack(_IR_FORMAT, len(label), 0.0, header.id, header.id2)
        out += label.tobytes()
    return out + s


def unpack(s: bytes):
    """Unpack an image record -> (IRHeader, payload)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg") -> bytes:
    """Pack a numpy image (HWC uint8) into a record; JPEG via PIL if present."""
    try:
        from PIL import Image
        import io as _io
        buf = _io.BytesIO()
        fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
        Image.fromarray(np.asarray(img, dtype=np.uint8)).save(
            buf, format=fmt, quality=quality)
        return pack(header, buf.getvalue())
    except ImportError:
        # raw fallback: store CHW bytes
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        return pack(header, arr.tobytes())


def unpack_img(s: bytes, iscolor=-1):
    header, img_bytes = unpack(s)
    try:
        from PIL import Image
        import io as _io
        img = np.asarray(Image.open(_io.BytesIO(img_bytes)))
    except ImportError:
        img = np.frombuffer(img_bytes, dtype=np.uint8)
    return header, img
