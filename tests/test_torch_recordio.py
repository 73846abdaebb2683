"""The native range read of `.edlr` files (elasticdl_tpu_torch/native/
recordio.cc behind data/recordfile.py) against the port's Python scan and
the JAX package's RecordFile on both of its paths: every range of v1 and v2
files bitwise equal, the same CRC error on a corrupted payload, and a
failed build of the host library raises instead of falling back."""

import os
import struct
import zlib

import numpy as np
import pytest

from elasticdl_tpu import native as jax_native
from elasticdl_tpu.data import recordfile as jax_recordfile
from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.data import recordfile

RECORDS = 97


def _payloads(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 300, size=RECORDS)
    sizes[[3, 40]] = 0  # empty records
    sizes[50] = 70000  # one larger than the slicing loop's blocks
    return [rng.bytes(int(n)) for n in sizes]


def _write_v1(path, payloads):
    """A version-1 file (no CRC), as the JAX package's first writer made
    them."""
    with open(path, "wb") as f:
        f.write(b"EDLR" + struct.pack("<I", 1))
        offsets = []
        for p in payloads:
            offsets.append(f.tell())
            f.write(struct.pack("<I", len(p)) + p)
        index = f.tell()
        for off in offsets:
            f.write(struct.pack("<Q", off))
        f.write(struct.pack("<QQ4s", len(offsets), index, b"EDLI"))


def _write(path, payloads, version):
    if version == 1:
        _write_v1(path, payloads)
    else:
        recordfile.write_records(path, payloads)
    return str(path)


def _read(module, path, start, count, no_native):
    env = os.environ.pop("EDL_NO_NATIVE", None)
    if no_native:
        os.environ["EDL_NO_NATIVE"] = "1"
    try:
        with module.RecordFile(path) as rf:
            return list(rf.read(start, count))
    finally:
        os.environ.pop("EDL_NO_NATIVE", None)
        if env is not None:
            os.environ["EDL_NO_NATIVE"] = env


READERS = {
    "port_native": (recordfile, False),
    "port_python": (recordfile, True),
    "jax_native": (jax_recordfile, False),
    "jax_python": (jax_recordfile, True),
}


@pytest.mark.parametrize("version", [1, 2])
def test_every_range_is_bitwise_equal_on_all_four_paths(tmp_path, version):
    assert jax_native.lib() is not None  # the JAX native path is exercised
    payloads = _payloads(version)
    path = _write(tmp_path / f"v{version}.edlr", payloads, version)
    ranges = [(0, RECORDS), (0, 1), (RECORDS - 1, 1), (3, 1), (10, 41),
              (49, 3), (0, 0), (RECORDS, 0)]
    for start, count in ranges:
        want = payloads[start:start + count]
        for name, (module, no_native) in READERS.items():
            got = _read(module, path, start, count, no_native)
            assert got == want, (name, start, count)
    for module, no_native in READERS.values():
        with pytest.raises(IndexError):
            _read(module, path, RECORDS - 2, 3, no_native)


def test_a_corrupted_payload_raises_the_same_crc_error(tmp_path):
    payloads = _payloads(5)
    path = _write(tmp_path / "bad.edlr", payloads, 2)
    with recordfile.RecordFile(path) as rf:
        with open(path, "rb") as f:
            off = rf._record_offset(20, f)
    with open(path, "r+b") as f:
        f.seek(off + 8)  # the first payload byte of record 20
        byte = f.read(1)
        f.seek(off + 8)
        f.write(bytes([byte[0] ^ 0x40]))
    assert zlib.crc32(payloads[20]) != zlib.crc32(
        bytes([payloads[20][0] ^ 0x40]) + payloads[20][1:])
    errors = {}
    for name, (module, no_native) in READERS.items():
        with pytest.raises(ValueError, match="CRC mismatch") as err:
            _read(module, path, 10, 20, no_native)
        errors[name] = str(err.value)
        # Ranges before the corrupt record still read.
        assert _read(module, path, 0, 20, no_native) == payloads[:20]
    assert errors["port_native"] == errors["jax_native"]
    assert errors["port_python"] == errors["jax_python"]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    path = _write(tmp_path / "ok.edlr", _payloads(1), 2)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: str(tmp_path / "libedl_ps-missing.so"))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host library failed"):
        _read(recordfile, path, 0, 5, no_native=False)
    # EDL_NO_NATIVE=1 is the one explicit way to the Python scan.
    assert len(_read(recordfile, path, 0, 5, no_native=True)) == 5
