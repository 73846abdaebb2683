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
The packed and quantized parameter-server codec (:143-461 there) comes with
the parameter-server slice.
"""

import numpy as np

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
    with ties to even (ml_dtypes' rounding); NaN -> quiet NaN, sign kept."""
    # np.array copies to a C-contiguous array and, unlike
    # np.ascontiguousarray, keeps a 0-d array 0-d.
    floats = np.array(values, dtype=np.float32)
    bits = floats.view(np.uint32).astype(np.uint64)  # no overflow below
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan_bits = ((bits >> 16) & 0x8000) | 0x7FC0
    return np.where(np.isnan(floats), nan_bits, rounded).astype(np.uint16)


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
