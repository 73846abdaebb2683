"""Example codec: dict[str, np.ndarray] <-> bytes via the Example message
(counterpart of elasticdl_tpu/data/example.py:14-40; the bytes are the JAX
package's, so record files move between the two).

`batch_examples` decodes a batch column by column in the host library
(native/codec.cc): one array per feature, filled straight from the records'
bytes. The columnar decode takes a batch whose records all carry record 0's
features with record 0's dtypes and shapes, none of them strings; any other
batch (ragged shapes, string features, features that come and go) goes
through the Python codec, record by record. The data decides which way a
batch goes: bytes that are not an Example raise either way, and a failed
build of the library raises. `stack_examples`, the Python codec's batch, is
the plain version the tests hold the columnar decode against.
"""

import ctypes

import numpy as np

from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.proto import messages as pb

# The columnar decode's limit on a feature's rank (native/codec.cc kMaxDims).
_MAX_DIMS = 16
# Errors of edl_decode_examples, by code.
_DECODE_ERRORS = {
    -1: "truncated varint",
    -2: "varint longer than ten bytes",
    -3: "truncated fixed-width field",
    -4: "truncated length-delimited field",
    -5: "unsupported wire type",
    -6: "field with the wrong wire type",
    -7: "string field is not valid UTF-8",
}


def encode_example(features: dict) -> bytes:
    ex = pb.Example()
    for name, value in features.items():
        ex.features[name] = tensor_utils.ndarray_to_tensor_pb(
            np.asarray(value), name
        )
    return ex.SerializeToString()


def decode_example(data: bytes) -> dict:
    ex = pb.Example.FromString(data)
    return {
        name: tensor_utils.tensor_pb_to_ndarray(t)
        for name, t in ex.features.items()
    }


def stack_examples(records):
    """The Python codec's batch: decode each record, then stack each
    feature: {name: array of shape [batch, ...]}."""
    decoded = [decode_example(r) for r in records]
    if not decoded:
        return {}
    return {
        name: np.stack([d[name] for d in decoded]) for name in decoded[0]
    }


def _schema(record):
    """Record 0's features as the columnar decode's schema: [(name, dtype
    enum, dims, wire bytes, output array dtype)], or None when a feature
    is a string or has a shape the columnar decode does not take."""
    ex = pb.Example.FromString(record)
    schema = []
    for name, t in ex.features.items():
        arr = tensor_utils.tensor_pb_to_ndarray(t)  # raises as decode does
        if t.dtype in (pb.DT_STRING, pb.DT_BYTES):
            return None
        dims = [int(d) for d in t.dims]
        if len(dims) > _MAX_DIMS or any(d < 0 for d in dims):
            return None
        # The native decode writes rows of this many bytes (twice as many
        # for bfloat16, widened): hold it to the output array's row.
        if len(t.content) * (2 if t.dtype == pb.DT_BFLOAT16 else 1) != (
                arr.nbytes):
            return None
        schema.append((name, t.dtype, dims, len(t.content), arr.dtype,
                       arr.shape))
    return schema


def _decode_columnar(records, schema):
    """The batch through edl_decode_examples: {name: [batch, ...] array},
    or None when some record does not fit the schema."""
    n = len(records)
    data = b"".join(records)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in records], out=offsets[1:])
    names = [name.encode("utf-8") for name, *_ in schema]
    name_offsets = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(x) for x in names], out=name_offsets[1:])
    dims_offsets = np.zeros(len(schema) + 1, np.int64)
    np.cumsum([len(s[2]) for s in schema], out=dims_offsets[1:])
    dims = np.asarray([d for s in schema for d in s[2]], np.int64)
    dtypes = np.asarray([s[1] for s in schema], np.int64)
    content = np.asarray([s[3] for s in schema], np.int64)
    widen = np.asarray([s[1] == pb.DT_BFLOAT16 for s in schema], np.int64)
    outs = {name: np.empty((n, *shape), dtype)
            for name, _, _, _, dtype, shape in schema}
    out_ptrs = (ctypes.c_void_p * len(schema))(
        *(arr.ctypes.data for arr in outs.values()))
    seen_at = np.empty(len(schema), np.int64)
    where = np.zeros(1, np.int64)
    status = native.lib().edl_decode_examples(
        data, native.i64p(offsets), n, len(schema), b"".join(names),
        native.i64p(name_offsets), native.i64p(dtypes),
        native.i64p(dims if dims.size else np.zeros(1, np.int64)),
        native.i64p(dims_offsets), native.i64p(content), native.i64p(widen),
        out_ptrs, native.i64p(seen_at), native.i64p(where),
    )
    if status == 1:
        return None
    if status:
        raise pb.DecodeError(
            f"record {int(where[0])}: "
            f"{_DECODE_ERRORS.get(status, f'error {status}')}")
    return outs


def batch_examples(records):
    """Decode and stack a list of serialized Examples into a feature batch:
    {name: array of shape [batch, ...]}, the arrays `stack_examples` gives,
    decoded column by column where the batch allows (module docstring)."""
    records = [bytes(r) for r in records]
    if not records:
        return {}
    schema = _schema(records[0])
    if schema:
        out = _decode_columnar(records, schema)
        if out is not None:
            return out
    return stack_examples(records)
