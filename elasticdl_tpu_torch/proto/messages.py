"""The messages of elasticdl_tpu.proto that the port uses, in the proto3 wire
format, without a protobuf runtime (counterpart of the generated
elasticdl_tpu/proto/elasticdl_tpu_pb2.py).

Each message is a plain Python class whose fields carry the schema's names
and numbers (proto/elasticdl_tpu.proto, a copy of the JAX package's), so the
bytes move between the two packages: `SerializeToString()` writes what the
protobuf runtime writes for the same values, and `FromString()` reads what it
writes. The encoding rules kept here:

- scalars at their default (0, False, "", b"", enum 0) are left out;
- int32, int64, uint64 and enum values are varints, negative ones as
  ten-byte two's-complement varints (a Task with task_id -1 is the "no task"
  answer);
- float is a little-endian fixed32;
- repeated numeric fields are written packed and read packed or unpacked;
- a map is a repeated entry message (key = 1, value = 2), each entry
  written with both key and value, as the protobuf runtime writes them;
- a singular message field is written when it is set (not None), even when
  empty;
- fields unknown to this schema are skipped when reading.

Attribute access follows the generated classes: scalars read their default
when unset, repeated fields are lists (a repeated message field also has
`add(**fields)`), maps are dicts. A singular message field reads None when
unset, where the generated class returns an empty message.
"""

import struct

_MASK64 = (1 << 64) - 1

# Wire types.
_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5

_VARINT_KINDS = ("int32", "int64", "uint64", "bool", "enum")


class EnumType:
    """A proto enum: `Name(number)` as the generated EnumTypeWrapper has
    it."""

    def __init__(self, name, values):
        self._name = name
        self._by_number = {number: key for key, number in values}

    def Name(self, number):
        try:
            return self._by_number[number]
        except KeyError:
            raise ValueError(
                f"Enum {self._name} has no name defined for value {number!r}"
            ) from None


TaskType = EnumType("TaskType", [
    ("TRAINING", 0), ("EVALUATION", 1), ("PREDICTION", 2), ("WAIT", 3),
    ("TRAIN_END_CALLBACK", 4),
])
TRAINING, EVALUATION, PREDICTION, WAIT, TRAIN_END_CALLBACK = range(5)

DataType = EnumType("DataType", [
    ("DT_INVALID", 0), ("DT_FLOAT32", 1), ("DT_FLOAT64", 2),
    ("DT_FLOAT16", 3), ("DT_BFLOAT16", 4), ("DT_INT8", 5), ("DT_INT16", 6),
    ("DT_INT32", 7), ("DT_INT64", 8), ("DT_UINT8", 9), ("DT_UINT32", 10),
    ("DT_UINT64", 11), ("DT_BOOL", 12), ("DT_STRING", 13), ("DT_BYTES", 14),
])
(DT_INVALID, DT_FLOAT32, DT_FLOAT64, DT_FLOAT16, DT_BFLOAT16, DT_INT8,
 DT_INT16, DT_INT32, DT_INT64, DT_UINT8, DT_UINT32, DT_UINT64, DT_BOOL,
 DT_STRING, DT_BYTES) = range(15)


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


# ---------- wire primitives ----------


def _put_varint(out, value):
    value &= _MASK64  # negative values: 64-bit two's complement
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _get_varint(buf, pos):
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed(value, bits):
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _from_varint(kind, value):
    if kind == "bool":
        return value != 0
    if kind == "int64":
        return _signed(value, 64)
    if kind == "uint64":
        return value & _MASK64
    return _signed(value, 32)  # int32 and (open) enums


def _put_tag(out, number, wire_type):
    _put_varint(out, (number << 3) | wire_type)


def _put_scalar(chunks, number, kind, value):
    """Appends one scalar or message field, always written (callers decide
    on defaults), as chunks; returns the bytes added. Payloads are appended
    as they are, not copied: a message's bytes are joined once, at the top
    (an evaluation report carries the model's logits, gigabytes at the
    flagship's width)."""
    head = bytearray()
    if kind in _VARINT_KINDS:
        _put_tag(head, number, _VARINT)
        _put_varint(head, int(value))
        payload = b""
    elif kind == "float":
        _put_tag(head, number, _FIXED32)
        payload = struct.pack("<f", value)
    else:
        _put_tag(head, number, _LEN)
        if kind == "string":
            payload = value.encode("utf-8")
        elif kind == "bytes":
            payload = value
        else:  # a message class
            payload = []
            size = value._chunks(payload)
            _put_varint(head, size)
            chunks.append(head)
            chunks.extend(payload)
            return len(head) + size
        _put_varint(head, len(payload))
    chunks.append(head)
    if payload:
        chunks.append(payload)
    return len(head) + len(payload)


def _is_default(kind, value):
    if kind == "float":
        # The runtime tests the float's bits: -0.0 is written.
        return struct.pack("<f", value) == b"\0\0\0\0"
    return not value


def _default(kind):
    return {"int32": 0, "int64": 0, "uint64": 0, "enum": 0, "bool": False,
            "float": 0.0, "string": "", "bytes": b""}.get(kind)


def _read_field(buf, pos, wire_type):
    """(raw value, new pos): an int for varint/fixed, a memoryview for
    length-delimited fields."""
    if wire_type == _VARINT:
        return _get_varint(buf, pos)
    if wire_type == _FIXED64:
        if pos + 8 > len(buf):
            raise DecodeError("truncated fixed64")
        return bytes(buf[pos:pos + 8]), pos + 8
    if wire_type == _FIXED32:
        if pos + 4 > len(buf):
            raise DecodeError("truncated fixed32")
        return bytes(buf[pos:pos + 4]), pos + 4
    if wire_type == _LEN:
        n, pos = _get_varint(buf, pos)
        if pos + n > len(buf):
            raise DecodeError("truncated length-delimited field")
        return buf[pos:pos + n], pos + n
    raise DecodeError(f"unsupported wire type {wire_type}")


def _decode_scalar(kind, wire_type, raw):
    if kind in _VARINT_KINDS:
        if wire_type != _VARINT:
            raise DecodeError(f"{kind} field with wire type {wire_type}")
        return _from_varint(kind, raw)
    if kind == "float":
        if wire_type != _FIXED32:
            raise DecodeError(f"float field with wire type {wire_type}")
        return struct.unpack("<f", raw)[0]
    if wire_type != _LEN:
        raise DecodeError(f"{kind} field with wire type {wire_type}")
    if kind == "string":
        return bytes(raw).decode("utf-8")
    if kind == "bytes":
        return bytes(raw)
    return kind.FromString(raw)


# ---------- fields and messages ----------


class Field:
    """One field of a message: number, name, kind ("int32", "int64",
    "uint64", "bool", "float", "string", "bytes", "enum" or a Message class)
    and label ("single", "repeated" or "map"; a map's key kind is `key`)."""

    __slots__ = ("number", "name", "kind", "label", "key")

    def __init__(self, number, name, kind, label="single", key=None):
        self.number = number
        self.name = name
        self.kind = kind
        self.label = label
        self.key = key

    def empty(self):
        if self.label == "repeated":
            if isinstance(self.kind, type):
                return RepeatedMessages(self.kind)
            return []
        if self.label == "map":
            return {}
        return _default(self.kind)


class RepeatedMessages(list):
    """A repeated message field: a list with the generated `add()`."""

    def __init__(self, cls, items=()):
        super().__init__(items)
        self._cls = cls

    def add(self, **fields):
        item = self._cls(**fields)
        self.append(item)
        return item


class Message:
    """Base of the message classes below; subclasses list FIELDS."""

    FIELDS = ()

    def __init_subclass__(cls):
        cls._by_name = {f.name: f for f in cls.FIELDS}
        cls._by_number = {f.number: f for f in cls.FIELDS}

    def __init__(self, **values):
        for f in self.FIELDS:
            object.__setattr__(self, f.name, f.empty())
        for name, value in values.items():
            f = self._by_name.get(name)
            if f is None:
                raise ValueError(
                    f'Protocol message {type(self).__name__} has no '
                    f'"{name}" field.'
                )
            if f.label == "repeated":
                getattr(self, name).extend(value)
            elif f.label == "map":
                getattr(self, name).update(value)
            else:
                setattr(self, name, value)

    def __setattr__(self, name, value):
        if name not in self._by_name:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}"
            )
        object.__setattr__(self, name, value)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f.name) == getattr(other, f.name)
            for f in self.FIELDS
        )

    def __repr__(self):
        shown = ", ".join(
            f"{f.name}={getattr(self, f.name)!r}" for f in self.FIELDS
            if getattr(self, f.name) != f.empty()
        )
        return f"{type(self).__name__}({shown})"

    # ---------- encoding ----------

    def SerializeToString(self):
        return b"".join(self.serialize_parts())

    def serialize_parts(self):
        """The encoding as a list of buffers whose concatenation is
        SerializeToString(): payload fields appear as they were set, so a
        transport can send them without joining them first."""
        chunks = []
        self._chunks(chunks)
        return chunks

    def ByteSize(self):
        """The encoded size, without joining the encoding."""
        return self._chunks([])

    def _chunks(self, chunks):
        """Appends this message's encoding to `chunks`; returns its size."""
        size = 0
        for f in self.FIELDS:
            value = getattr(self, f.name)
            if f.label == "single":
                if isinstance(f.kind, type):
                    if value is not None:
                        size += _put_scalar(chunks, f.number, f.kind, value)
                elif not _is_default(f.kind, value):
                    size += _put_scalar(chunks, f.number, f.kind, value)
            elif f.label == "repeated":
                if not value:
                    continue
                if f.kind in _VARINT_KINDS or f.kind == "float":
                    packed = bytearray()
                    for item in value:
                        if f.kind == "float":
                            packed += struct.pack("<f", item)
                        else:
                            _put_varint(packed, int(item))
                    size += _put_scalar(chunks, f.number, "bytes", packed)
                else:
                    for item in value:
                        size += _put_scalar(chunks, f.number, f.kind, item)
            else:  # map: one entry message per item, key and value written
                for key, item in value.items():
                    entry = []
                    entry_size = _put_scalar(entry, 1, f.key, key)
                    entry_size += _put_scalar(entry, 2, f.kind, item)
                    head = bytearray()
                    _put_tag(head, f.number, _LEN)
                    _put_varint(head, entry_size)
                    chunks.append(head)
                    chunks.extend(entry)
                    size += len(head) + entry_size
        return size

    # ---------- decoding ----------

    @classmethod
    def FromString(cls, data):
        msg = cls()
        msg.ParseFromString(data)
        return msg

    def ParseFromString(self, data):
        """Replaces this message's fields with those decoded from `data`
        (fields missing from `data` read their defaults)."""
        for f in self.FIELDS:
            object.__setattr__(self, f.name, f.empty())
        # A view, not a copy: only the bytes and string fields decoded
        # below copy their payloads out.
        buf = memoryview(data)
        pos = 0
        while pos < len(buf):
            tag, pos = _get_varint(buf, pos)
            number, wire_type = tag >> 3, tag & 7
            raw, pos = _read_field(buf, pos, wire_type)
            f = self._by_number.get(number)
            if f is None:
                continue  # unknown field: skipped
            if f.label == "single":
                object.__setattr__(
                    self, f.name, _decode_scalar(f.kind, wire_type, raw)
                )
            elif f.label == "repeated":
                items = getattr(self, f.name)
                packable = f.kind in _VARINT_KINDS or f.kind == "float"
                if packable and wire_type == _LEN:
                    items.extend(_unpack(f.kind, raw))
                else:
                    items.append(_decode_scalar(f.kind, wire_type, raw))
            else:
                if wire_type != _LEN:
                    raise DecodeError(f"map field {f.name} not length-"
                                      "delimited")
                key, item = _decode_entry(f, raw)
                getattr(self, f.name)[key] = item
        return len(buf)


def _unpack(kind, raw):
    values, pos = [], 0
    if kind == "float":
        if len(raw) % 4:
            raise DecodeError("packed floats not a multiple of 4 bytes")
        return list(struct.unpack(f"<{len(raw) // 4}f", raw))
    while pos < len(raw):
        value, pos = _get_varint(raw, pos)
        values.append(_from_varint(kind, value))
    return values


def _decode_entry(field, raw):
    key, item = _default(field.key), None
    pos = 0
    while pos < len(raw):
        tag, pos = _get_varint(raw, pos)
        number, wire_type = tag >> 3, tag & 7
        value, pos = _read_field(raw, pos, wire_type)
        if number == 1:
            key = _decode_scalar(field.key, wire_type, value)
        elif number == 2:
            item = _decode_scalar(field.kind, wire_type, value)
    if item is None:
        item = field.kind() if isinstance(field.kind, type) else _default(
            field.kind)
    return key, item


# ---------- the schema's messages (field numbers from the .proto) ----------


class Empty(Message):
    FIELDS = ()


class Task(Message):
    FIELDS = (
        Field(1, "task_id", "int32"),
        Field(2, "shard_name", "string"),
        Field(3, "start", "int64"),
        Field(4, "end", "int64"),
        Field(5, "type", "enum"),
        Field(6, "model_version", "int32"),
        Field(7, "extended_config", "string", "map", key="string"),
        Field(8, "lease_token", "int64"),
    )


class Tensor(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "dims", "int64", "repeated"),
        Field(3, "dtype", "enum"),
        Field(4, "content", "bytes"),
        Field(5, "string_lengths", "int64", "repeated"),
    )


class Example(Message):
    FIELDS = (Field(1, "features", Tensor, "map", key="string"),)


class GetTaskRequest(Message):
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "task_type", "enum"),
        Field(3, "max_tasks", "int32"),
    )


class ReportTaskResultRequest(Message):
    FIELDS = (
        Field(1, "task_id", "int32"),
        Field(2, "err_message", "string"),
        Field(3, "exec_counters", "int32", "map", key="string"),
        Field(4, "lease_token", "int64"),
    )


class ReportEvaluationMetricsRequest(Message):
    FIELDS = (
        Field(1, "model_outputs", Tensor, "repeated"),
        Field(2, "labels", Tensor),
        Field(3, "worker_id", "int32"),
    )


class ReportVersionRequest(Message):
    FIELDS = (Field(1, "model_version", "int32"),)


class GetJobStatusRequest(Message):
    FIELDS = ()


class JobStatusResponse(Message):
    FIELDS = (
        Field(1, "todo_tasks", "int32"),
        Field(2, "doing_tasks", "int32"),
        Field(3, "epoch", "int32"),
        Field(4, "num_epochs", "int32"),
        Field(5, "model_version", "int32"),
        Field(6, "alive_workers", "int32"),
        Field(7, "finished", "bool"),
        Field(8, "job_failed", "bool"),
        Field(9, "records_done", "int64"),
        Field(10, "last_eval_metrics", "float", "map", key="string"),
        Field(11, "last_eval_version", "int32"),
        Field(12, "worker_last_seen_ago", "float", "map", key="int32"),
        Field(13, "worker_doing_tasks", "int32", "map", key="int32"),
        Field(14, "relaunches", "int32"),
        Field(15, "tasks_recovered", "int64"),
        Field(16, "metrics_port", "int32"),
        Field(17, "membership_epoch", "int32"),
        Field(18, "tasks_abandoned", "int64"),
        Field(19, "stragglers", "string", "repeated"),
        Field(20, "alerts_fired", "int64"),
        Field(21, "policy_actions", "int64"),
        Field(22, "policy_blacklisted", "string", "repeated"),
        Field(23, "backup_tasks_inflight", "int32"),
        Field(24, "backup_wins", "int64"),
        Field(25, "master_incarnation", "int64"),
    )


class TaskBatch(Message):
    FIELDS = (
        Field(1, "tasks", Task, "repeated"),
        Field(2, "finished", "bool"),
    )


class ReportTaskResultsRequest(Message):
    FIELDS = (Field(1, "results", ReportTaskResultRequest, "repeated"),)



# ---------- elastic AllReduce: membership, step leases, world hint ----------


class GetCommRankRequest(Message):
    FIELDS = (
        Field(1, "worker_host", "string"),
        Field(2, "ready_epoch_plus_one", "int32"),
    )


class GetCommRankResponse(Message):
    FIELDS = (
        Field(1, "rank_id", "int32"),
        Field(2, "world_size", "int32"),
        Field(3, "rendezvous_id", "int32"),
        Field(4, "rendezvous_port", "int32"),
        Field(5, "coordinator_addr", "string"),
        Field(6, "world_ready", "bool"),
    )


class ReportWorkerLivenessRequest(Message):
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "host", "string"),
    )


class LeaseStepsRequest(Message):
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "worker_host", "string"),
        Field(3, "batch_size", "int32"),
    )


class LeaseRange(Message):
    FIELDS = (
        Field(1, "shard_name", "string"),
        Field(2, "start", "int64"),
        Field(3, "end", "int64"),
    )


class LeaseStepsResponse(Message):
    # The nested enum Status.
    Status = EnumType("Status", [("OK", 0), ("WAIT", 1), ("FINISHED", 2)])
    OK, WAIT, FINISHED = range(3)
    FIELDS = (
        Field(1, "status", "enum"),
        Field(2, "lease_id", "int64"),
        Field(3, "epoch", "int32"),
        Field(4, "rank", "int32"),
        Field(5, "world_size", "int32"),
        Field(6, "n_steps", "int32"),
        Field(7, "ranges", LeaseRange, "repeated"),
    )


class ReportLeaseRequest(Message):
    FIELDS = (
        Field(1, "lease_id", "int64"),
        Field(2, "worker_id", "int32"),
        Field(3, "rank", "int32"),
        Field(4, "success", "bool"),
        Field(5, "err_message", "string"),
    )


class GetWorldHintRequest(Message):
    FIELDS = (Field(1, "worker_id", "int32"),)


class WorldHintResponse(Message):
    FIELDS = (
        Field(1, "hint_seq", "int64"),
        Field(2, "target_world_size", "int32"),
        Field(3, "reason", "string"),
        Field(4, "age_seconds", "float"),
    )


# ---------- the parameter server's messages ----------


class IndexedSlices(Message):
    FIELDS = (
        Field(1, "concat_tensors", Tensor),
        Field(2, "ids", "int64", "repeated"),
        Field(3, "ids_bytes", "bytes"),
    )


class EmbeddingTableInfo(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "dim", "int64"),
        Field(3, "initializer", "string"),
        Field(4, "dtype", "enum"),
    )


class Model(Message):
    FIELDS = (
        Field(1, "version", "int32"),
        Field(2, "dense_parameters", Tensor, "repeated"),
        Field(3, "embedding_tables", IndexedSlices, "map", key="string"),
        Field(4, "embedding_table_infos", EmbeddingTableInfo, "repeated"),
        Field(5, "total_records", "int64"),
    )


class PullDenseParametersRequest(Message):
    FIELDS = (Field(1, "version", "int32"),)


class PullDenseParametersResponse(Message):
    FIELDS = (
        Field(1, "initialized", "bool"),
        Field(2, "version", "int32"),
        Field(3, "dense_parameters", Tensor, "repeated"),
    )


class PullEmbeddingVectorsRequest(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "ids", "int64", "repeated"),
        Field(3, "ids_bytes", "bytes"),
        Field(4, "value_dtype", "enum"),
    )


class PullEmbeddingTableRequest(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "start_row", "int64"),
        Field(3, "max_rows", "int64"),
    )


class PushGradientsRequest(Message):
    FIELDS = (
        Field(1, "gradients", Model),
        Field(2, "learning_rate", "float"),
        Field(3, "worker_id_plus_one", "int32"),
        Field(4, "batch_size", "int32"),
    )


class PushGradientsResponse(Message):
    FIELDS = (
        Field(1, "accepted", "bool"),
        Field(2, "version", "int32"),
        Field(3, "apply_seconds", "float"),
    )


class TensorSpan(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "dims", "int64", "repeated"),
        Field(3, "dtype", "enum"),
        Field(4, "offset", "int64"),
        Field(5, "nbytes", "int64"),
        Field(6, "scales_offset", "int64"),
        Field(7, "scales_nbytes", "int64"),
        Field(8, "block_size", "int32"),
    )


class SlicesSpan(Message):
    FIELDS = (
        Field(1, "values", TensorSpan),
        Field(2, "ids_offset", "int64"),
        Field(3, "ids_nbytes", "int64"),
    )


class PushGradientsPackedRequest(Message):
    FIELDS = (
        Field(1, "version", "int32"),
        Field(2, "learning_rate", "float"),
        Field(3, "worker_id_plus_one", "int32"),
        Field(4, "batch_size", "int32"),
        Field(5, "dense", TensorSpan, "repeated"),
        Field(6, "sparse", SlicesSpan, "repeated"),
        Field(7, "push_id", "uint64"),
        Field(8, "chunk_index", "int32"),
        Field(9, "chunk_count", "int32"),
        Field(10, "payload_offset", "int64"),
        Field(11, "payload_total_bytes", "int64"),
        Field(12, "payload", "bytes"),
    )


class TelemetrySnapshot(Message):
    FIELDS = (
        Field(1, "role", "string"),
        Field(2, "pid", "int64"),
        Field(3, "seq", "int64"),
        Field(4, "full", "bool"),
        Field(5, "payload", "string"),
    )


class ReportTelemetryRequest(Message):
    FIELDS = (
        Field(1, "snapshots", TelemetrySnapshot, "repeated"),
        Field(2, "origin", "string"),
    )


class ReportTelemetryResponse(Message):
    FIELDS = (
        Field(1, "accepted", "int32"),
        Field(2, "need_full", "string", "repeated"),
    )


MESSAGES = (
    Empty, Task, Tensor, Example, GetTaskRequest, ReportTaskResultRequest,
    ReportEvaluationMetricsRequest, ReportVersionRequest,
    GetJobStatusRequest, JobStatusResponse, TaskBatch,
    ReportTaskResultsRequest, GetCommRankRequest, GetCommRankResponse,
    ReportWorkerLivenessRequest, LeaseStepsRequest, LeaseRange,
    LeaseStepsResponse, ReportLeaseRequest, GetWorldHintRequest,
    WorldHintResponse, IndexedSlices, EmbeddingTableInfo, Model,
    PullDenseParametersRequest, PullDenseParametersResponse,
    PullEmbeddingVectorsRequest, PullEmbeddingTableRequest,
    PushGradientsRequest, PushGradientsResponse, TensorSpan, SlicesSpan,
    PushGradientsPackedRequest, TelemetrySnapshot, ReportTelemetryRequest,
    ReportTelemetryResponse,
)
