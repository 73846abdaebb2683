"""numpy <-> Tensor message codec (counterpart of
elasticdl_tpu/common/tensor_utils.py:31-118).

Tensors go on the wire as (dtype enum, dims, raw little-endian bytes), and
variable-length strings as their concatenated bytes plus per-element
lengths, exactly as the JAX package writes them.

bfloat16 without ml_dtypes: numpy has no bfloat16 dtype here, so
- encoding takes a float array and `wire_dtype=DT_BFLOAT16`, and rounds each
  float32 to bfloat16 to nearest, ties to even, on the float32 bits, as
  ml_dtypes does (NaN stays a quiet NaN of the same sign; values past the
  bfloat16 range round to infinity);
- decoding a DT_BFLOAT16 tensor gives a float32 array holding the bfloat16
  values exactly (every bfloat16 is a float32), not a bfloat16 array.

The parameter server's pieces follow (:120-461 there): indexed slices, ids
as raw int64 bytes, the int8 block-quantized codec, and the packed push (a
slim span header plus one out-of-band payload joined from views of the
gradient arrays). Under the bfloat16 wire a sparse span carries bfloat16
bits rounded from float32 as above, and decodes to float32; an int8 span
carries int8 values and one float32 scale per block, and dequantizes to
float32 where it is decoded.
"""

import numpy as np

from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.proto import messages as pb

_NP_TO_PB = {
    np.dtype(np.float32): pb.DT_FLOAT32,
    np.dtype(np.float64): pb.DT_FLOAT64,
    np.dtype(np.float16): pb.DT_FLOAT16,
    np.dtype(np.int8): pb.DT_INT8,
    np.dtype(np.int16): pb.DT_INT16,
    np.dtype(np.int32): pb.DT_INT32,
    np.dtype(np.int64): pb.DT_INT64,
    np.dtype(np.uint8): pb.DT_UINT8,
    np.dtype(np.uint32): pb.DT_UINT32,
    np.dtype(np.uint64): pb.DT_UINT64,
    np.dtype(np.bool_): pb.DT_BOOL,
}
_PB_TO_NP = {v: k for k, v in _NP_TO_PB.items()}


def np_dtype_to_pb(dtype) -> int:
    try:
        return _NP_TO_PB[np.dtype(dtype)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype for wire transfer: {dtype}"
        ) from None


def pb_dtype_to_np(dtype_enum: int) -> np.dtype:
    """The numpy dtype a wire dtype decodes to (float32 for bfloat16)."""
    if dtype_enum == pb.DT_BFLOAT16:
        return np.dtype(np.float32)
    try:
        return _PB_TO_NP[dtype_enum]
    except KeyError:
        raise ValueError(f"unknown wire dtype enum: {dtype_enum}") from None


def float32_to_bfloat16_bits(values) -> np.ndarray:
    """float32 values -> uint16 bfloat16 bit patterns, rounded to nearest
    with ties to even (ml_dtypes' rounding); NaN -> quiet NaN, sign kept.
    Rounds in the host library (native/codec.cc)."""
    # order="C" copies only a non-contiguous array and, unlike
    # np.ascontiguousarray, keeps a 0-d array 0-d.
    floats = np.asarray(values, dtype=np.float32, order="C")
    out = np.empty(floats.shape, np.uint16)
    if out.size:
        native.lib().edl_f32_to_bf16(floats.ctypes.data, out.ctypes.data,
                                     out.size)
    return out


def float32_to_bfloat16_bits_plain(values) -> np.ndarray:
    """The numpy version of float32_to_bfloat16_bits, its plain reference
    in the tests."""
    # np.array copies to a C-contiguous array and, unlike
    # np.ascontiguousarray, keeps a 0-d array 0-d.
    floats = np.array(values, dtype=np.float32)
    bits = floats.reshape(-1).view(np.uint32)
    # In uint32: no bit pattern but a NaN's (above 0xFF800000) can carry
    # past 32 bits, and NaNs are replaced below.
    rounded = (bits >> np.uint32(16)) & np.uint32(1)
    rounded += bits
    rounded += np.uint32(0x7FFF)
    rounded >>= np.uint32(16)
    nan = np.isnan(floats.reshape(-1))
    if nan.any():
        rounded[nan] = (bits[nan] >> np.uint32(16)) & np.uint32(0x8000) | (
            np.uint32(0x7FC0))
    return rounded.astype(np.uint16).reshape(floats.shape)


def bfloat16_bits_to_float32(bits) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the same values as float32."""
    wide = np.asarray(bits, np.uint16).astype(np.uint32) << np.uint32(16)
    return wide.view(np.float32)


def _is_string_array(arr):
    if arr.dtype.kind in ("U", "S", "T"):
        return True
    if arr.dtype.kind == "O":
        # Object arrays are accepted ONLY when they hold text/bytes — a
        # numeric/ragged object array must keep the loud unsupported-dtype
        # error instead of serializing reprs.
        if arr.size == 0:
            return True
        if all(isinstance(s, (str, bytes)) for s in arr.reshape(-1)):
            return True
        raise ValueError(
            "object-dtype array holds non-string elements; convert to a "
            "numeric dtype before wire transfer"
        )
    return False


def ndarray_to_tensor_pb(arr, name: str = "", wire_dtype=None) -> pb.Tensor:
    """`wire_dtype=pb.DT_BFLOAT16` sends a float array as bfloat16 (see the
    module docstring); otherwise the array's own dtype goes on the wire."""
    arr = np.asarray(arr)  # not ascontiguousarray: that promotes 0-d to 1-d
    if wire_dtype == pb.DT_BFLOAT16:
        if arr.dtype.kind != "f":
            raise ValueError(
                f"bfloat16 wire transfer needs a float array, got {arr.dtype}"
            )
        return pb.Tensor(
            name=name,
            dims=list(arr.shape),
            dtype=pb.DT_BFLOAT16,
            content=float32_to_bfloat16_bits(arr).tobytes(),
        )
    if wire_dtype is not None:
        raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
    if _is_string_array(arr):
        # One wire type per tensor: any bytes element makes the whole tensor
        # DT_BYTES (every element decodes as bytes), otherwise DT_STRING.
        flat = list(arr.reshape(-1))
        any_bytes = any(isinstance(s, bytes) for s in flat) or (
            arr.dtype.kind == "S"
        )
        encoded = [
            s if isinstance(s, bytes) else str(s).encode("utf-8")
            for s in flat
        ]
        return pb.Tensor(
            name=name,
            dims=list(arr.shape),
            dtype=pb.DT_BYTES if any_bytes else pb.DT_STRING,
            content=b"".join(encoded),
            string_lengths=[len(e) for e in encoded],
        )
    return pb.Tensor(
        name=name,
        dims=list(arr.shape),
        dtype=np_dtype_to_pb(arr.dtype),
        content=arr.tobytes(),
    )


def tensor_pb_to_ndarray(tensor_pb: pb.Tensor) -> np.ndarray:
    if tensor_pb.dtype in (pb.DT_STRING, pb.DT_BYTES):
        as_bytes = tensor_pb.dtype == pb.DT_BYTES
        parts, offset = [], 0
        for length in tensor_pb.string_lengths:
            raw = tensor_pb.content[offset:offset + length]
            if as_bytes:
                parts.append(raw)
            else:
                try:
                    parts.append(raw.decode("utf-8"))
                except UnicodeDecodeError:
                    # Record files written before DT_BYTES existed stored
                    # binary features as DT_STRING; keep reading them.
                    parts.append(raw)
            offset += length
        return np.asarray(parts, dtype=object).reshape(tuple(tensor_pb.dims))
    if tensor_pb.dtype == pb.DT_BFLOAT16:
        bits = np.frombuffer(tensor_pb.content, dtype=np.uint16)
        return bfloat16_bits_to_float32(bits).reshape(tuple(tensor_pb.dims))
    dtype = pb_dtype_to_np(tensor_pb.dtype)
    arr = np.frombuffer(tensor_pb.content, dtype=dtype)
    return arr.reshape(tuple(tensor_pb.dims)).copy()


# ---------------------------------------------------------------------------
# indexed slices and ids
# ---------------------------------------------------------------------------


def ndarray_to_indexed_slices_pb(values, ids, name: str = "",
                                 wire_dtype=None) -> pb.IndexedSlices:
    if values.ndim != 2 or len(ids) != values.shape[0]:
        raise ValueError(
            f"IndexedSlices needs values [len(ids), dim]; "
            f"got values {values.shape}, {len(ids)} ids"
        )
    return pb.IndexedSlices(
        concat_tensors=ndarray_to_tensor_pb(values, name, wire_dtype),
        ids_bytes=ids_to_bytes(ids),
    )


def indexed_slices_pb_to_ndarrays(slices_pb: pb.IndexedSlices):
    values = tensor_pb_to_ndarray(slices_pb.concat_tensors)
    if slices_pb.ids_bytes:
        ids = ids_from_bytes(slices_pb.ids_bytes)
    else:  # older writers used the repeated form
        ids = np.asarray(slices_pb.ids, dtype=np.int64)
    return values, ids


def ids_to_bytes(ids) -> bytes:
    """Embedding ids -> raw little-endian int64 bytes (the wire form of
    every ids field)."""
    return np.ascontiguousarray(ids, dtype=np.int64).tobytes()


def ids_from_bytes(buf) -> np.ndarray:
    """Raw little-endian int64 id bytes -> ndarray VIEW (no copy)."""
    return np.frombuffer(buf, dtype=np.int64)


def tensor_pb_to_bfloat16_bits(tensor_pb: pb.Tensor) -> np.ndarray:
    """A DT_BFLOAT16 tensor -> its uint16 bit patterns, not widened (a
    caller that uploads them to a device widens there, moving half the
    bytes)."""
    if tensor_pb.dtype != pb.DT_BFLOAT16:
        raise ValueError(
            f"tensor {tensor_pb.name!r} is not bfloat16 "
            f"(dtype {pb.DataType.Name(tensor_pb.dtype)})"
        )
    return np.frombuffer(tensor_pb.content, dtype=np.uint16).reshape(
        tuple(tensor_pb.dims))


# ---------------------------------------------------------------------------
# int8 block-scaled codec
# ---------------------------------------------------------------------------

DEFAULT_INT8_BLOCK = 256


def quantize_int8_blocks(arr, block_size=DEFAULT_INT8_BLOCK):
    """float array -> (int8 flat [n], float32 scales [ceil(n/block)]).

    Per-block absmax scaling: scale = max(|x|)/127 over each block of
    `block_size` consecutive elements (row-major), q = round(x/scale). An
    all-zero block gets scale 0 and decodes to exact zeros. The round-trip
    error of an element is at most scale/2; a caller that pushes gradients
    keeps it out of the training trajectory with error feedback
    (worker/ps_client.py)."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    n = flat.size
    if n == 0:
        return np.empty(0, np.int8), np.empty(0, np.float32)
    nblocks = -(-n // block_size)
    nfull = nblocks * block_size
    padded = flat
    if nfull != n:
        padded = np.zeros(nfull, np.float32)
        padded[:n] = flat
    blocks = padded.reshape(nblocks, block_size)
    scales = np.abs(blocks).max(axis=1) / 127.0
    inv = np.zeros_like(scales)
    np.divide(1.0, scales, out=inv, where=scales > 0)
    q = np.rint(blocks * inv[:, None]).astype(np.int8)
    return q.reshape(-1)[:n], scales.astype(np.float32)


def dequantize_int8_blocks(q, scales, block_size=DEFAULT_INT8_BLOCK):
    """Inverse of quantize_int8_blocks -> float32 flat [n]."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    q = np.asarray(q, dtype=np.int8)
    scales = np.asarray(scales, dtype=np.float32)
    n = q.size
    if n == 0:
        return np.empty(0, np.float32)
    nblocks = -(-n // block_size)
    if nblocks != scales.size:
        raise ValueError(
            f"{n} quantized elements at block {block_size} need "
            f"{nblocks} scales, got {scales.size}"
        )
    nfull = nblocks * block_size
    padded = q
    if nfull != n:
        padded = np.zeros(nfull, np.int8)
        padded[:n] = q
    out = padded.reshape(nblocks, block_size).astype(np.float32)
    out *= scales[:, None]
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# out-of-band (packed) tensor transport
# ---------------------------------------------------------------------------
#
# A packed push is a slim span header plus ONE payload. PackedPayload keeps
# zero-copy byte views over the source arrays; PackedPushRequest joins the
# header with those views when it serializes, so the payload is copied once
# between the arrays and the wire. The receiver decodes float32 spans as
# np.frombuffer views into the received bytes.

# field 12, wire type 2 (length-delimited): (12 << 3) | 2.
_PACKED_PAYLOAD_TAG = bytes([(12 << 3) | 2])


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _byte_view(arr: np.ndarray) -> memoryview:
    """Zero-copy uint8 view of a C-contiguous array's bytes."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


class PackedPayload:
    """Ordered zero-copy byte parts forming one contiguous payload."""

    def __init__(self):
        self._parts = []
        self.nbytes = 0

    def add_array(self, arr) -> tuple:
        """Append an array's bytes; returns (offset, nbytes). Keeps a VIEW
        over the array: the caller must not mutate it before the request
        serializes."""
        view = _byte_view(arr)
        offset = self.nbytes
        self._parts.append(view)
        self.nbytes += len(view)
        return offset, len(view)

    @property
    def parts(self):
        return list(self._parts)

    def slice_parts(self, start: int, end: int):
        """Zero-copy views covering payload bytes [start, end) (the chunked
        push splitter)."""
        out, pos = [], 0
        for part in self._parts:
            plen = len(part)
            lo, hi = max(start, pos), min(end, pos + plen)
            if lo < hi:
                out.append(part[lo - pos:hi - pos])
            pos += plen
            if pos >= end:
                break
        return out


def pack_tensor_span(name, arr, payload: PackedPayload,
                     wire_dtype=None, block_size=0) -> pb.TensorSpan:
    """Append one tensor to the payload; returns its TensorSpan header.
    `wire_dtype=pb.DT_BFLOAT16` rounds a float array to bfloat16 (to
    nearest, ties to even); "int8" block-quantizes it (use
    pack_quantized_span when the caller quantized itself, as error feedback
    does); otherwise the array's own dtype ships byte-exact."""
    arr = np.asarray(arr)
    if wire_dtype == "int8":
        block_size = block_size or DEFAULT_INT8_BLOCK
        q, scales = quantize_int8_blocks(arr, block_size)
        return pack_quantized_span(name, arr.shape, q, scales, block_size,
                                   payload)
    if wire_dtype == pb.DT_BFLOAT16:
        span = pb.TensorSpan(name=name, dims=list(arr.shape),
                             dtype=pb.DT_BFLOAT16)
        arr = float32_to_bfloat16_bits(arr)
    elif wire_dtype is None:
        span = pb.TensorSpan(name=name, dims=list(arr.shape),
                             dtype=np_dtype_to_pb(arr.dtype))
    else:
        raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
    span.offset, span.nbytes = payload.add_array(arr)
    return span


def pack_quantized_span(name, shape, q, scales, block_size,
                        payload: PackedPayload) -> pb.TensorSpan:
    """An int8 block-quantized tensor (quantize_int8_blocks' q and scales)
    into the payload."""
    span = pb.TensorSpan(name=name, dims=list(shape), dtype=pb.DT_INT8,
                         block_size=int(block_size))
    span.offset, span.nbytes = payload.add_array(q)
    span.scales_offset, span.scales_nbytes = payload.add_array(scales)
    return span


def pack_slices_span(name, values, ids, payload: PackedPayload,
                     wire_dtype=None) -> pb.SlicesSpan:
    """Sparse rows (values [k, dim] + int64 ids [k]) into the payload."""
    span = pb.SlicesSpan(
        values=pack_tensor_span(name, values, payload, wire_dtype))
    span.ids_offset, span.ids_nbytes = payload.add_array(
        np.ascontiguousarray(ids, dtype=np.int64)
    )
    return span


def _payload_view(buf, offset, nbytes, dtype, what):
    if offset < 0 or nbytes < 0 or offset + nbytes > len(buf):
        raise ValueError(
            f"packed {what} range [{offset}, {offset + nbytes}) outside "
            f"the {len(buf)}-byte payload (truncated or corrupt push)"
        )
    dtype = np.dtype(dtype)
    if nbytes % dtype.itemsize:
        raise ValueError(
            f"packed {what}: {nbytes} bytes is not a multiple of "
            f"{dtype} itemsize"
        )
    return np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize,
                         offset=offset)


def unpack_tensor_span(span: pb.TensorSpan, payload_buf) -> np.ndarray:
    """TensorSpan -> ndarray: a read-only VIEW into payload_buf for most
    dtypes (zero copy); bfloat16 spans widen to float32 and int8
    block-quantized spans dequantize to float32 here, their one
    materialization on the receiving side. Raises ValueError on any
    out-of-bounds range (truncated payload)."""
    buf = memoryview(payload_buf)
    what = f"span {span.name!r}"
    if span.scales_nbytes:
        q = _payload_view(buf, span.offset, span.nbytes, np.int8, what)
        scales = _payload_view(buf, span.scales_offset, span.scales_nbytes,
                               np.float32, f"{what} scales")
        flat = dequantize_int8_blocks(
            q, scales, span.block_size or DEFAULT_INT8_BLOCK)
    elif span.dtype == pb.DT_BFLOAT16:
        flat = bfloat16_bits_to_float32(_payload_view(
            buf, span.offset, span.nbytes, np.uint16, what))
    else:
        flat = _payload_view(buf, span.offset, span.nbytes,
                             pb_dtype_to_np(span.dtype), what)
    shape = tuple(span.dims)
    expected = 1
    for d in shape:
        expected *= int(d)
    if flat.size != expected:
        raise ValueError(
            f"span {span.name!r}: {flat.size} elements cannot fill "
            f"shape {shape}"
        )
    return flat.reshape(shape)


def unpack_slices_span(span: pb.SlicesSpan, payload_buf):
    """SlicesSpan -> (values [k, dim], ids [k] int64), both views where the
    dtype allows (see unpack_tensor_span)."""
    values = unpack_tensor_span(span.values, payload_buf)
    ids = _payload_view(
        memoryview(payload_buf), span.ids_offset, span.ids_nbytes,
        np.int64, f"slices {span.values.name!r} ids",
    )
    if values.ndim != 2 or ids.size != values.shape[0]:
        raise ValueError(
            f"slices {span.values.name!r}: {ids.size} ids for values "
            f"{values.shape}"
        )
    return values, ids


class PackedPushRequest:
    """A PushGradientsPackedRequest as a slim header message plus an
    out-of-band payload: `SerializeToString()` emits the serialized header
    followed by the payload field's wire bytes (tag, varint length, raw
    parts), valid proto3 that the ordinary FromString decodes. `header`
    must leave `payload` unset."""

    def __init__(self, header, parts, nbytes):
        self._header = header
        self._parts = parts
        self._nbytes = int(nbytes)

    def SerializeToString(self) -> bytes:  # noqa: N802 (message contract)
        return b"".join(self.serialize_parts())

    def serialize_parts(self):
        """The encoding as buffers: the header's, then the payload field's
        tag and length, then the payload views as they are."""
        head = self._header.serialize_parts()
        if not self._nbytes:
            return head
        return head + [_PACKED_PAYLOAD_TAG, _encode_varint(self._nbytes),
                       *self._parts]


def merge_indexed_slices(values_list, ids_list):
    """Concatenate sparse updates, then sum duplicate ids."""
    values = np.concatenate(values_list, axis=0)
    ids = np.concatenate(ids_list, axis=0)
    return deduplicate_indexed_slices(values, ids)


def deduplicate_indexed_slices(values, ids):
    """float32 rows [n, dim] with int64 ids [n] -> (rows summed per id,
    unique ids ascending), by the host library's radix sort."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if values.ndim != 2 or len(ids) != values.shape[0]:
        raise ValueError(
            f"dedup needs values [len(ids), dim]; got values "
            f"{values.shape}, {len(ids)} ids"
        )
    out_ids = np.empty(len(ids), dtype=np.int64)
    out_values = np.empty_like(values)
    if not len(ids):
        return out_values, out_ids
    n = native.lib().edl_dedup_sum(
        native.i64p(ids), native.f32p(values), len(ids), values.shape[1],
        native.i64p(out_ids), native.f32p(out_values),
    )
    return out_values[:n], out_ids[:n]
