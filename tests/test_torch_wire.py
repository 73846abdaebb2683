"""The port's wire format against the JAX package's: the proto3 messages
(elasticdl_tpu_torch/proto/messages.py against the generated
elasticdl_tpu_pb2), the tensor codec, and the .edlr record files."""

import os
import re
import struct

import ml_dtypes
import numpy as np
import pytest

from elasticdl_tpu.common import tensor_utils as jax_tensor_utils
from elasticdl_tpu.data import recordfile as jax_recordfile
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data import recordfile
from elasticdl_tpu_torch.data.example import decode_example, encode_example
from elasticdl_tpu_torch.proto import messages as pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TENSOR = dict(name="w", dims=[2, 3], dtype=pb.DT_FLOAT32,
               content=np.arange(6, dtype=np.float32).tobytes())
_STRINGS = dict(name="s", dims=[2], dtype=pb.DT_STRING, content=b"abcd",
                string_lengths=[1, 3])
_TASK = dict(task_id=7, shard_name="train.edlr", start=1024, end=2048,
             type=pb.EVALUATION, model_version=-3, lease_token=2**40)
# (message, field values) for every message the port has; maps hold at most
# one entry where bytes are compared (the protobuf runtime orders map
# entries its own way).
CASES = {
    "Empty": ("Empty", {}),
    "Task": ("Task", _TASK),
    "Task_no_task": ("Task", dict(task_id=-1)),
    "Task_wait": ("Task", dict(task_id=-1, type=pb.WAIT)),
    "Task_map": ("Task", dict(_TASK, extended_config={"a": "1", "b": ""})),
    "Tensor": ("Tensor", _TENSOR),
    "Tensor_strings": ("Tensor", _STRINGS),
    "Example": ("Example", dict(features={"w": _TENSOR})),
    "Example_two": ("Example", dict(features={"w": _TENSOR,
                                              "s": _STRINGS})),
    "GetTaskRequest": ("GetTaskRequest", dict(
        worker_id=3, task_type=pb.EVALUATION, max_tasks=4)),
    "ReportTaskResultRequest": ("ReportTaskResultRequest", dict(
        task_id=-1, err_message="boom é", lease_token=-2)),
    "ReportTaskResultRequest_map": ("ReportTaskResultRequest", dict(
        task_id=5, exec_counters={"a": 0, "b": -7})),
    "ReportTaskResultsRequest": ("ReportTaskResultsRequest", dict(results=[
        dict(task_id=1), dict(task_id=2, err_message="x", lease_token=9)])),
    "TaskBatch": ("TaskBatch", dict(tasks=[_TASK, dict(task_id=8)],
                                    finished=True)),
    "TaskBatch_empty": ("TaskBatch", dict(finished=False)),
    "ReportEvaluationMetricsRequest": ("ReportEvaluationMetricsRequest", dict(
        model_outputs=[_TENSOR, _STRINGS], labels=dict(dims=[0]),
        worker_id=2)),
    "ReportVersionRequest": ("ReportVersionRequest",
                             dict(model_version=123456)),
    "GetJobStatusRequest": ("GetJobStatusRequest", {}),
    "JobStatusResponse": ("JobStatusResponse", dict(
        todo_tasks=1, doing_tasks=2, epoch=3, num_epochs=4,
        model_version=5, alive_workers=6, finished=True, job_failed=False,
        records_done=2**35, last_eval_version=7, relaunches=8,
        tasks_recovered=9, metrics_port=10, membership_epoch=11,
        tasks_abandoned=12, stragglers=["worker-1", "worker-2"],
        alerts_fired=13, policy_actions=14, policy_blacklisted=["worker-3"],
        backup_tasks_inflight=15, backup_wins=16, master_incarnation=17,
        last_eval_metrics={"token_ce": 1.5})),
    "IndexedSlices": ("IndexedSlices", dict(
        concat_tensors=_TENSOR, ids_bytes=np.arange(3, dtype=np.int64)
        .tobytes())),
    "IndexedSlices_repeated_ids": ("IndexedSlices", dict(
        concat_tensors=_TENSOR, ids=[5, -1, 2**40])),
    "EmbeddingTableInfo": ("EmbeddingTableInfo", dict(
        name="deep", dim=8, initializer="uniform(-0.05,0.05)",
        dtype=pb.DT_FLOAT32)),
    "Model": ("Model", dict(
        version=7, dense_parameters=[_TENSOR, _TENSOR],
        embedding_tables={"deep": dict(concat_tensors=_TENSOR,
                                       ids_bytes=b"\1" * 16)},
        embedding_table_infos=[dict(name="deep", dim=8)],
        total_records=2**33)),
    "Model_empty": ("Model", {}),
    "PullDenseParametersRequest": ("PullDenseParametersRequest",
                                   dict(version=-1)),
    "PullDenseParametersResponse": ("PullDenseParametersResponse", dict(
        initialized=True, version=3, dense_parameters=[_TENSOR])),
    "PullEmbeddingVectorsRequest": ("PullEmbeddingVectorsRequest", dict(
        name="wide", ids=[1, 2], ids_bytes=b"\0" * 8,
        value_dtype=pb.DT_BFLOAT16)),
    "PullEmbeddingTableRequest": ("PullEmbeddingTableRequest", dict(
        name="wide", start_row=65536, max_rows=1024)),
    "PushGradientsRequest": ("PushGradientsRequest", dict(
        gradients=dict(version=2, dense_parameters=[_TENSOR]),
        learning_rate=0.125, worker_id_plus_one=1, batch_size=16384)),
    "PushGradientsResponse": ("PushGradientsResponse", dict(
        accepted=True, version=9, apply_seconds=0.03125)),
    "PushGradientsResponse_rejected": ("PushGradientsResponse", dict(
        accepted=False, version=9)),
    "TensorSpan": ("TensorSpan", dict(
        name="w", dims=[3, 4], dtype=pb.DT_INT8, offset=64, nbytes=12,
        scales_offset=76, scales_nbytes=4, block_size=256)),
    "SlicesSpan": ("SlicesSpan", dict(
        values=dict(name="deep", dims=[2, 8], dtype=pb.DT_BFLOAT16,
                    nbytes=32), ids_offset=32, ids_nbytes=16)),
    "PushGradientsPackedRequest": ("PushGradientsPackedRequest", dict(
        version=4, learning_rate=0.5, worker_id_plus_one=2, batch_size=8,
        dense=[dict(name="w", dims=[2], dtype=pb.DT_FLOAT32, nbytes=8)],
        sparse=[dict(values=dict(name="deep", dims=[1, 2], nbytes=8),
                     ids_offset=16, ids_nbytes=8)],
        push_id=(2**63) + 12345, chunk_index=1, chunk_count=3,
        payload_offset=1 << 20, payload_total_bytes=3 << 20,
        payload=b"\x00\xff" * 12)),
    "ReportTelemetryRequest": ("ReportTelemetryRequest", dict(
        snapshots=[dict(role="worker-0", pid=4242, seq=3, full=True,
                        payload="edl_worker_steps_total 7\n"),
                   dict(role="ps-1", pid=-1, seq=2**40)],
        origin="worker-0")),
    "ReportTelemetryResponse": ("ReportTelemetryResponse", dict(
        accepted=2, need_full=["ps-1", "worker-3"])),
    "TelemetrySnapshot": ("TelemetrySnapshot", dict(role="master")),
    "GetCommRankRequest": ("GetCommRankRequest", dict(
        worker_host="10.0.0.2:40123", ready_epoch_plus_one=8)),
    "GetCommRankRequest_empty": ("GetCommRankRequest", {}),
    "GetCommRankResponse": ("GetCommRankResponse", dict(
        rank_id=1, world_size=2, rendezvous_id=7, rendezvous_port=51007,
        coordinator_addr="10.0.0.1:40000", world_ready=True)),
    "GetCommRankResponse_not_admitted": ("GetCommRankResponse",
                                         dict(rank_id=-1)),
    "ReportWorkerLivenessRequest": ("ReportWorkerLivenessRequest", dict(
        worker_id=3, host="127.0.0.1:5000")),
    "ReportWorkerLivenessRequest_empty": ("ReportWorkerLivenessRequest", {}),
    "LeaseStepsRequest": ("LeaseStepsRequest", dict(
        worker_id=1, worker_host="h:1", batch_size=4)),
    "LeaseStepsRequest_empty": ("LeaseStepsRequest", {}),
    "LeaseRange": ("LeaseRange", dict(shard_name="train.edlr", start=16,
                                      end=2**33)),
    "LeaseRange_empty": ("LeaseRange", {}),
    "LeaseStepsResponse": ("LeaseStepsResponse", dict(
        status=pb.LeaseStepsResponse.OK, lease_id=2**35, epoch=4, rank=1,
        world_size=2, n_steps=8, ranges=[
            dict(shard_name="a", start=0, end=16),
            dict(shard_name="b", start=16, end=32)])),
    "LeaseStepsResponse_wait": ("LeaseStepsResponse", dict(
        status=pb.LeaseStepsResponse.WAIT)),
    "LeaseStepsResponse_finished": ("LeaseStepsResponse", dict(
        status=pb.LeaseStepsResponse.FINISHED)),
    "ReportLeaseRequest": ("ReportLeaseRequest", dict(
        lease_id=9, worker_id=0, rank=1, success=True)),
    "ReportLeaseRequest_failed": ("ReportLeaseRequest", dict(
        lease_id=9, worker_id=1, rank=0, success=False,
        err_message="Connection closed by peer é")),
    "GetWorldHintRequest": ("GetWorldHintRequest", dict(worker_id=5)),
    "GetWorldHintRequest_empty": ("GetWorldHintRequest", {}),
    "WorldHintResponse": ("WorldHintResponse", dict(
        hint_seq=3, target_world_size=4, reason="deadline_scale_up",
        age_seconds=1.5)),
    "WorldHintResponse_none": ("WorldHintResponse", {}),
    "JobStatusResponse_maps": ("JobStatusResponse", dict(
        records_done=64, last_eval_metrics={"token_ce": 1.5, "z": -0.0},
        worker_last_seen_ago={0: 0.25, -1: 3.0},
        worker_doing_tasks={0: 2, 7: 0})),
}


def _build(module, cls_name, values):
    """A message of `module` (the port's or pb2) from plain field values."""
    cls = getattr(module, cls_name)
    msg = cls()
    for name, value in values.items():
        field = getattr(msg, name)
        sub = _sub_class(module, cls_name, name)
        if isinstance(value, dict) and sub is None:  # scalar map
            field.update(value)
        elif isinstance(value, dict) and _is_map(cls_name, name):
            for key, item in value.items():  # message map
                _assign(field, key, _build(module, sub, item), module)
        elif isinstance(value, dict):  # singular message
            if module is pb:
                setattr(msg, name, _build(module, sub, value))
            else:
                field.CopyFrom(_build(module, sub, value))
        elif isinstance(value, list) and sub is not None:
            for item in value:
                field.append(_build(module, sub, item))
        elif isinstance(value, list):
            field.extend(value)
        else:
            setattr(msg, name, value)
    return msg


def _assign(mapping, key, value, module):
    if module is pb:
        mapping[key] = value
    else:
        mapping[key].CopyFrom(value)


def _is_map(cls_name, field_name):
    return getattr(pb, cls_name)._by_name[field_name].label == "map"


def _sub_class(module, cls_name, field_name):
    """The message class name of a message-typed field, else None."""
    field = getattr(pb, cls_name)._by_name[field_name]
    return field.kind.__name__ if isinstance(field.kind, type) else None


def _plain(msg):
    """A port or pb2 message -> nested plain values, for comparing."""
    out = {}
    for f in getattr(pb, type(msg).__name__).FIELDS:
        value = getattr(msg, f.name)
        unset = (isinstance(f.kind, type) and f.label == "single"
                 and not isinstance(msg, pb.Message)
                 and not msg.HasField(f.name))
        out[f.name] = None if unset else _plain_value(value)
    return out


def _plain_value(value):
    if value is None or isinstance(value, (int, float, str, bytes, bool)):
        return value
    if hasattr(value, "items"):
        return {k: _plain_value(v) for k, v in value.items()}
    if hasattr(value, "SerializeToString"):
        return _plain(value)
    return [_plain_value(v) for v in value]


@pytest.mark.parametrize("case", sorted(CASES))
def test_messages_round_trip_through_protobuf(case):
    """Port bytes parse with pb2 to the message pb2 builds from the same
    values, pb2 bytes decode with the port to the same values, and the bytes
    are equal where the message holds at most one map entry."""
    cls_name, values = CASES[case]
    ours = _build(pb, cls_name, values)
    theirs = _build(pb2, cls_name, values)
    ours_bytes = ours.SerializeToString()
    theirs_bytes = theirs.SerializeToString()
    parsed = getattr(pb2, cls_name).FromString(ours_bytes)
    assert parsed == theirs
    decoded = getattr(pb, cls_name).FromString(theirs_bytes)
    assert decoded == ours
    assert _plain(decoded) == _plain(theirs)
    multi_entry_map = any(
        isinstance(v, dict) and len(v) > 1 for v in values.values()
    )
    if not multi_entry_map:
        assert ours_bytes == theirs_bytes


def test_decoder_takes_unpacked_repeated_unknown_fields_and_negatives():
    # dims unpacked (one varint per element), then an unknown varint field
    # 99, an unknown length-delimited field 98 and an unknown fixed32 97.
    raw = bytearray()
    for dim in (2, 3):
        raw += bytes([0x10, dim])
    raw += bytes([0x98, 0x06, 0x05])  # field 99, varint 5
    raw += bytes([0x92, 0x06, 0x02]) + b"hi"  # field 98, 2 bytes
    raw += bytes([0x8D, 0x06]) + struct.pack("<f", 1.0)  # field 97, fixed32
    raw += bytes([0x18, pb.DT_INT8])
    tensor = pb.Tensor.FromString(bytes(raw))
    assert tensor.dims == [2, 3] and tensor.dtype == pb.DT_INT8
    assert pb2.Tensor.FromString(bytes(raw)).dims == [2, 3]
    # task_id -1 is a ten-byte varint; model_version -1 too.
    task = pb.Task(task_id=-1, model_version=-1)
    assert len(task.SerializeToString()) == 2 * 11
    assert pb.Task.FromString(task.SerializeToString()) == task
    with pytest.raises(pb.DecodeError):
        pb.Task.FromString(b"\x08")  # truncated varint
    with pytest.raises(ValueError, match="has no name"):
        pb.TaskType.Name(9)
    assert pb.TaskType.Name(pb.WAIT) == pb2.TaskType.Name(pb2.WAIT)


def test_schema_copy_matches_and_messages_follow_it():
    """The port's .proto copy declares what the JAX package's does, and
    every message class has the schema's field names, numbers and types."""

    def declarations(path):
        with open(path) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        return [line.strip() for line in text.splitlines() if line.strip()]

    ours = os.path.join(REPO, "elasticdl_tpu_torch/proto/elasticdl_tpu.proto")
    theirs = os.path.join(REPO, "elasticdl_tpu/proto/elasticdl_tpu.proto")
    assert declarations(ours) == declarations(theirs)

    with open(ours) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    # A message's nested enum (LeaseStepsResponse.Status) is a field type:
    # its body leaves the message body, its name reads as an enum.
    nested_enums = re.findall(r"\benum (\w+) \{[^}]*\}", text)
    text = re.sub(r"\benum (\w+) \{[^}]*\}", "", text)
    scalar = {"int32": "int32", "int64": "int64", "uint64": "uint64",
              "bool": "bool",
              "float": "float", "string": "string", "bytes": "bytes",
              "TaskType": "enum", "DataType": "enum",
              **{name: "enum" for name in nested_enums}}
    for cls in pb.MESSAGES:
        body = re.search(r"message %s \{([^}]*)\}" % cls.__name__, text)
        assert body, cls.__name__
        declared = {}
        for m in re.finditer(
                r"(repeated\s+|map<(\w+),\s*)?(\w+)>?\s+(\w+)\s*=\s*(\d+);",
                body.group(1)):
            label = ("map" if m.group(2) else
                     "repeated" if m.group(1) else "single")
            declared[int(m.group(5))] = (m.group(4), m.group(3), label,
                                         m.group(2))
        fields = {
            f.number: (f.name,
                       f.kind.__name__ if isinstance(f.kind, type)
                       else f.kind, f.label, f.key)
            for f in cls.FIELDS
        }
        expected = {
            n: (name, scalar.get(kind, kind), label, key)
            for n, (name, kind, label, key) in declared.items()
        }
        assert fields == expected, cls.__name__


TENSOR_CASES = [
    np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    np.float32(2.5),  # 0-d
    np.linspace(-3, 3, 7).astype(np.float64),
    np.array([[1.5, -2.25]], np.float16),
    np.array([-128, 0, 127], np.int8),
    np.arange(-5, 5, dtype=np.int32).reshape(2, 5),
    np.array([2**40, -1], np.int64),
    np.int64(-7),  # 0-d
    np.array([True, False, True]),
    np.array(["tok", "été", ""]),
    np.array([b"\x00\xff", b"raw"], dtype=object),
    np.array("zero-d"),  # 0-d string
    np.zeros((0, 3), np.float32),
]


@pytest.mark.parametrize("i", range(len(TENSOR_CASES)))
def test_tensor_codec_matches_jax_package(i):
    arr = TENSOR_CASES[i]
    ours = tensor_utils.ndarray_to_tensor_pb(arr, "x").SerializeToString()
    theirs = jax_tensor_utils.ndarray_to_tensor_pb(arr, "x")
    assert ours == theirs.SerializeToString()
    back = tensor_utils.tensor_pb_to_ndarray(pb.Tensor.FromString(
        theirs.SerializeToString()))
    want = jax_tensor_utils.tensor_pb_to_ndarray(theirs)
    assert back.shape == want.shape and back.dtype == want.dtype
    np.testing.assert_array_equal(back, want)


def test_bfloat16_rounds_as_ml_dtypes():
    """bfloat16 without ml_dtypes: round to nearest even on the float32
    bits, NaN kept; decoded to float32 holding the same values."""
    rng = np.random.default_rng(0)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 3.4e38, -3.4e38,
                        1e-40, -0.0, 0.0, 1.00390625, 1.01171875, 1.0],
                       np.float32)
    random_bits = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    values = np.concatenate([
        special, rng.standard_normal(4096).astype(np.float32) * 1e3,
        random_bits.astype(np.uint32).view(np.float32),
    ]).reshape(2, -1)
    with np.errstate(invalid="ignore"):
        as_bf16 = values.astype(ml_dtypes.bfloat16)
    for arr, bf in ((values, as_bf16), (values[0, 0], as_bf16[0, 0])):
        ours = tensor_utils.ndarray_to_tensor_pb(
            arr, "b", wire_dtype=pb.DT_BFLOAT16)
        theirs = jax_tensor_utils.ndarray_to_tensor_pb(bf, "b")
        assert ours.SerializeToString() == theirs.SerializeToString()
        back = tensor_utils.tensor_pb_to_ndarray(pb.Tensor.FromString(
            theirs.SerializeToString()))
        assert back.dtype == np.float32 and back.shape == np.shape(arr)
        np.testing.assert_array_equal(back, np.asarray(bf, np.float32))


def test_example_codec_matches_jax_package():
    from elasticdl_tpu.data.example import (
        decode_example as jax_decode, encode_example as jax_encode,
    )

    features = {"tokens": np.arange(17, dtype=np.int32),
                "label": np.float32(1.0), "text": np.array(["a b"])}
    for record in (encode_example(features), jax_encode(features)):
        for decoded in (decode_example(record), jax_decode(record)):
            assert sorted(decoded) == sorted(features)
            for name, value in features.items():
                np.testing.assert_array_equal(decoded[name], value)
                assert decoded[name].shape == np.shape(value)


def _lm_records(n):
    rng = np.random.default_rng(1)
    return [encode_example({"tokens": rng.integers(0, 50, 9).astype(
        np.int32)}) for _ in range(n)]


def test_record_files_move_between_packages(tmp_path):
    records = _lm_records(23) + [b"", b"\x00" * 300]
    ours, theirs = tmp_path / "ours.edlr", tmp_path / "theirs.edlr"
    recordfile.write_records(str(ours), records)
    jax_recordfile.write_records(str(theirs), records)
    assert ours.read_bytes() == theirs.read_bytes()

    reader = recordfile.RecordFile(str(theirs))
    assert reader.num_records == len(records)
    assert list(reader.read(0, len(records))) == records
    assert list(reader.read(5, 3)) == records[5:8]
    with pytest.raises(IndexError):
        list(reader.read(20, 10))
    reader.close()
    jax_reader = jax_recordfile.RecordFile(str(ours))
    assert list(jax_reader.read(0, len(records))) == records
    jax_reader.close()


def test_record_file_v1_and_corruption(tmp_path):
    records = _lm_records(4)
    # A version-1 file (no CRC), as older writers made it.
    body = bytearray(b"EDLR" + struct.pack("<I", 1))
    offsets = []
    for r in records:
        offsets.append(len(body))
        body += struct.pack("<I", len(r)) + r
    index = len(body)
    for off in offsets:
        body += struct.pack("<Q", off)
    body += struct.pack("<QQ4s", len(records), index, b"EDLI")
    v1 = tmp_path / "v1.edlr"
    v1.write_bytes(bytes(body))
    with recordfile.RecordFile(str(v1)) as rf:
        assert list(rf.read(1, 3)) == records[1:]

    v2 = tmp_path / "v2.edlr"
    recordfile.write_records(str(v2), records)
    data = bytearray(v2.read_bytes())
    data[8 + 8 + 2] ^= 0xFF  # a payload byte of the first record
    v2.write_bytes(bytes(data))
    with recordfile.RecordFile(str(v2)) as rf:
        with pytest.raises(ValueError, match="CRC mismatch"):
            list(rf.read(0, 1))
    bad = tmp_path / "bad.edlr"
    bad.write_bytes(b"NOPE" + bytes(40))
    with pytest.raises(ValueError, match="bad magic"):
        recordfile.RecordFile(str(bad))
