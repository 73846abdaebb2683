"""Seekable record file format (.edlr) (counterpart of
elasticdl_tpu/data/recordfile.py; the same bytes on disk, so files move
between the two packages).

    [magic "EDLR"][u32 version]
    v2 record: [u32 len][u32 crc32(payload)][payload] ...
    [u64 offset] * num_records           # footer: offset of each record
    [u64 num_records][u64 index_offset][magic "EDLI"]

Version 2 carries a per-record CRC32 (zlib polynomial) so corruption is
detected at read time; v1 files (no CRC) remain readable. Range reads go
through the host library's scanner (native/recordio.cc: one mmap, a C loop,
the CRC checks), which raises if it cannot be built; EDL_NO_NATIVE=1 reads
with the Python scan here instead, the plain reference the tests hold the
scanner against.

Written records are opaque bytes; the framework stores Example messages in
them but any payload works.
"""

import ctypes
import os
import struct
import zlib

import numpy as np

_MAGIC = b"EDLR"
_FOOTER_MAGIC = b"EDLI"
_VERSION = 2
_READABLE_VERSIONS = (1, 2)
_FOOTER_TAIL = struct.Struct("<QQ4s")  # num_records, index_offset, magic
_LEN = struct.Struct("<I")
_LEN_CRC = struct.Struct("<II")
_OFF = struct.Struct("<Q")


class RecordFileWriter:
    def __init__(self, path):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<I", _VERSION))
        self._offsets = []
        self._closed = False

    def write(self, record: bytes):
        self._offsets.append(self._f.tell())
        self._f.write(_LEN_CRC.pack(len(record), zlib.crc32(record)))
        self._f.write(record)

    def close(self):
        if self._closed:
            return
        index_offset = self._f.tell()
        for off in self._offsets:
            self._f.write(_OFF.pack(off))
        self._f.write(
            _FOOTER_TAIL.pack(len(self._offsets), index_offset, _FOOTER_MAGIC)
        )
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordFile:
    """Random-access reader over a .edlr file."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "rb")
        if self._f.read(4) != _MAGIC:
            raise ValueError(f"{path} is not a record file (bad magic)")
        (self._version,) = struct.unpack("<I", self._f.read(4))
        if self._version not in _READABLE_VERSIONS:
            raise ValueError(
                f"{path}: unsupported record file version {self._version}"
            )
        self._f.seek(-_FOOTER_TAIL.size, os.SEEK_END)
        num, index_offset, magic = _FOOTER_TAIL.unpack(
            self._f.read(_FOOTER_TAIL.size)
        )
        if magic != _FOOTER_MAGIC:
            raise ValueError(
                f"{path}: truncated or corrupt record file (bad footer)"
            )
        self.num_records = num
        self._index_offset = index_offset

    def _record_offset(self, i, f):
        """Index lookup on an explicit handle — callers each open their
        own so concurrent range scans never share a seek cursor."""
        f.seek(self._index_offset + i * _OFF.size)
        (off,) = _OFF.unpack(f.read(_OFF.size))
        return off

    def read(self, start: int, count: int):
        """Yield `count` records beginning at record index `start`.

        Records are contiguous on disk, so after one seek the range is a
        sequential scan — the access pattern task dispatch relies on.
        """
        if start < 0 or start + count > self.num_records:
            raise IndexError(
                f"range [{start}, {start + count}) out of bounds "
                f"for {self.num_records} records"
            )
        if count == 0:
            return
        if not os.environ.get("EDL_NO_NATIVE"):
            yield from self._read_native(start, count)
            return
        # Per-call handle: readers cache RecordFile objects, and with the
        # prefetch reader a range scan runs on a producer thread — a
        # shared seek/read cursor would interleave across threads.
        with open(self.path, "rb") as f:
            f.seek(self._record_offset(start, f))
            for i in range(count):
                if self._version >= 2:
                    length, want = _LEN_CRC.unpack(f.read(_LEN_CRC.size))
                    payload = f.read(length)
                    if zlib.crc32(payload) != want:
                        raise ValueError(
                            f"{self.path}: CRC mismatch in record "
                            f"{start + i} (corrupt file)"
                        )
                else:
                    (length,) = _LEN.unpack(f.read(_LEN.size))
                    payload = f.read(length)
                yield payload

    def _read_native(self, start, count):
        from elasticdl_tpu_torch import native

        lib = native.lib()
        # Payload span upper bound: from the first record's offset to the
        # end of the range (headers included). Own handle for the index
        # reads, as in the scan above.
        with open(self.path, "rb") as f:
            first = self._record_offset(start, f)
            end = (
                self._index_offset
                if start + count == self.num_records
                else self._record_offset(start + count, f)
            )
        # The offsets come from the file's index: check them before
        # allocating, so a flipped bit raises the corrupt-file error.
        if not 0 <= first <= end <= self._index_offset:
            raise ValueError(
                f"{self.path}: index entries out of bounds for records "
                f"[{start}, {start + count}) (corrupt file)"
            )
        buf = np.empty(end - first, dtype=np.uint8)
        lens = np.empty(count, dtype=np.int64)
        total = lib.edl_records_read(
            self.path.encode(), start, count,
            buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if total == -5:
            raise ValueError(
                f"{self.path}: CRC mismatch in range [{start}, "
                f"{start + count}) (corrupt file)"
            )
        if total < 0:
            raise ValueError(
                f"{self.path}: native record read failed (code {total})"
            )
        pos = 0
        view = memoryview(buf)
        for n in lens.tolist():
            yield bytes(view[pos:pos + n])
            pos += n

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, records):
    with RecordFileWriter(path) as w:
        for r in records:
            w.write(r)
