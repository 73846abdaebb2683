"""Data readers: turn a Task's (shard_name, start, end) into records
(counterpart of elasticdl_tpu/data/reader.py:17-194).

`read_records(task)` yields raw records for the task's range;
`create_shards()` returns {shard_name: (start, num_records)} for the master
to partition into tasks. An `odps://` origin goes to data/odps_reader.py.
"""

import csv
import glob
import os
from abc import ABC, abstractmethod

from elasticdl_tpu_torch.data.recordfile import RecordFile


class Metadata:
    def __init__(self, column_names=None):
        self.column_names = column_names or []


class AbstractDataReader(ABC):
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @abstractmethod
    def read_records(self, task):
        """Yield records (bytes or tuples) for task.start..task.end within
        task.shard_name."""

    @abstractmethod
    def create_shards(self):
        """Return {shard_name: (start_index, num_records)}."""

    @property
    def metadata(self):
        return Metadata()


class RecordFileReader(AbstractDataReader):
    """Reads .edlr record files; one shard per file. `data_origin` may be
    a directory (every *.edlr inside becomes a shard) or one .edlr file
    (exactly that file — siblings in the same directory are NOT pulled in,
    they may belong to other datasets)."""

    def __init__(self, data_origin, **kwargs):
        super().__init__(**kwargs)
        self._origin = data_origin
        self._files = {}  # path -> RecordFile, opened lazily and cached

    def _record_file(self, path):
        if path not in self._files:
            self._files[path] = RecordFile(path)
        return self._files[path]

    def read_records(self, task):
        rf = self._record_file(task.shard_name)
        yield from rf.read(task.start, task.end - task.start)

    def create_shards(self):
        if os.path.isdir(self._origin):
            paths = sorted(
                glob.glob(os.path.join(self._origin, "*.edlr"))
            )
        else:
            paths = [self._origin] if os.path.exists(self._origin) else []
        shards = {
            path: (0, RecordFile(path).num_records) for path in paths
        }
        if not shards:
            raise ValueError(f"no .edlr record files at {self._origin}")
        return shards

    def close(self):
        for rf in self._files.values():
            rf.close()
        self._files.clear()


class CSVDataReader(AbstractDataReader):
    """Reads rows of one CSV file by index range. Records are tuples of
    strings."""

    def __init__(self, data_path, sep=",", with_header=False, **kwargs):
        super().__init__(**kwargs)
        self._path = data_path
        self._sep = sep
        self._with_header = with_header
        self._columns = None
        if with_header:
            with open(self._path, newline="") as f:
                self._columns = next(csv.reader(f, delimiter=self._sep))

    def read_records(self, task):
        skip = 1 if self._with_header else 0
        with open(self._path, newline="") as f:
            reader = csv.reader(f, delimiter=self._sep)
            for i, row in enumerate(reader):
                idx = i - skip
                if idx < task.start:
                    continue
                if idx >= task.end:
                    break
                yield tuple(row)

    def create_shards(self):
        skip = 1 if self._with_header else 0
        with open(self._path, newline="") as f:
            count = sum(1 for _ in csv.reader(f, delimiter=self._sep)) - skip
        return {self._path: (0, count)}

    @property
    def metadata(self):
        return Metadata(column_names=self._columns)


class InMemoryReader(AbstractDataReader):
    """Serves records from an in-memory list (tests and local runs)."""

    def __init__(self, records, shard_name="memory", **kwargs):
        super().__init__(**kwargs)
        self._records = list(records)
        self._shard_name = shard_name

    def read_records(self, task):
        yield from self._records[task.start : task.end]

    def create_shards(self):
        return {self._shard_name: (0, len(self._records))}


class CompositeReader(AbstractDataReader):
    """Routes tasks to the sub-reader owning the task's shard.

    A worker doing training + interleaved evaluation holds one reader, but
    training and validation data are distinct origins: the master names
    shards after each origin's own shard keys, so routing by shard_name
    keeps evaluation tasks reading validation rows (a single-origin reader
    that ignores shard_name would silently evaluate on training data)."""

    def __init__(self, readers, **kwargs):
        super().__init__(**kwargs)
        self._readers = list(readers)
        self._shard_to_reader = {}
        for reader in self._readers:
            for shard_name in reader.create_shards():
                self._shard_to_reader[shard_name] = reader

    def _reader_for(self, shard_name):
        reader = self._shard_to_reader.get(shard_name)
        if reader is None:
            raise ValueError(
                f"no reader owns shard {shard_name!r}; known: "
                f"{sorted(self._shard_to_reader)}"
            )
        return reader

    def read_records(self, task):
        yield from self._reader_for(task.shard_name).read_records(task)

    def create_shards(self):
        shards = {}
        for reader in self._readers:
            shards.update(reader.create_shards())
        return shards

    @property
    def metadata(self):
        return self._readers[0].metadata


def create_data_reader(data_origin, records_per_task=None, **kwargs):
    """Factory sniffing the origin type."""
    if isinstance(data_origin, AbstractDataReader):
        return data_origin
    if isinstance(data_origin, (list, tuple)):
        return InMemoryReader(data_origin, **kwargs)
    if isinstance(data_origin, str) and data_origin.startswith("odps://"):
        from elasticdl_tpu_torch.data.odps_reader import (
            OdpsReader,
            parse_odps_origin,
        )

        return OdpsReader(**{**parse_odps_origin(data_origin), **kwargs})
    if os.path.isdir(data_origin):
        return RecordFileReader(data_origin, **kwargs)
    if data_origin.endswith(".csv"):
        return CSVDataReader(data_origin, **kwargs)
    if data_origin.endswith(".edlr"):
        return RecordFileReader(data_origin, **kwargs)
    raise ValueError(f"cannot infer a data reader for: {data_origin!r}")
