"""Size-capped rotation for the append-only observability logs
(counterpart of elasticdl_tpu/observability/rotation.py).

`traces.jsonl`/`events.jsonl` grow unbounded in long jobs — a week-long
online-learning run would eat the disk with spans nobody will read.
`SizeCappedFile` gives both writers the same policy: when the live file
crosses the cap it is atomically renamed to `<path>.1` (replacing the
previous generation — total footprint is bounded by ~2x the cap) and a
fresh file is opened, so at least one cap's worth of the most recent
history always survives. The writer is told about each rotation so it
can stamp a marker record (the `rotated` event / trace metadata line)
into the new generation — readers then know the stream has a cut, not a
gap.

The cap comes from ELASTICDL_OBS_MAX_LOG_MB (0 disables rotation).
Thread-safety is the CALLER's job (both writers already serialize under
their own lock — this object is their locked internals).
"""

import os

from elasticdl_tpu_torch.common import knobs

MAX_LOG_MB_ENV = "ELASTICDL_OBS_MAX_LOG_MB"


def max_log_bytes():
    mb = knobs.get_float(MAX_LOG_MB_ENV)
    return int(mb * (1 << 20)) if mb > 0 else 0


class SizeCappedFile:
    """Line-append file with single-generation size rotation."""

    def __init__(self, path, max_bytes=None, on_rotate=None):
        self.path = path
        self.max_bytes = (
            max_log_bytes() if max_bytes is None else max_bytes
        )
        self.rotations = 0
        self._on_rotate = on_rotate
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a", buffering=1)
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    @property
    def closed(self):
        return self._file.closed

    def maybe_rotate(self, upcoming_len):
        """Rotate now if a record of `upcoming_len` bytes would push the
        live file past the cap. Split out of write_line for writers that
        must stamp per-record state (the event log's seq) AFTER the
        rotation marker: check first, then build + append the record."""
        if self._file.closed:
            return
        if (
            self.max_bytes
            and self._size
            and self._size + upcoming_len + 1 > self.max_bytes
        ):
            self._rotate()

    def append_line(self, line):
        """Raw append without a rotation check (callers paired it with
        maybe_rotate, or are the rotation callback itself)."""
        if self._file.closed:
            return
        self._file.write(line + "\n")
        # Byte length, not character length: the cap and the initial
        # getsize() are bytes, and non-ASCII payloads would otherwise
        # under-count and overshoot the cap on disk.
        self._size += len(line.encode("utf-8", "replace")) + 1

    def write_line(self, line):
        """Append one newline-terminated record, rotating first when the
        record would push the live file past the cap."""
        self.maybe_rotate(len(line.encode("utf-8", "replace")))
        self.append_line(line)

    def _rotate(self):
        self._file.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass  # rotation must never kill the writer
        self._file = open(self.path, "a", buffering=1)
        self._size = 0
        self.rotations += 1
        if self._on_rotate is not None:
            try:
                self._on_rotate(self.rotations)
            except Exception:
                pass

    def close(self):
        if not self._file.closed:
            self._file.close()
