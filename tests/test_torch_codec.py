"""The port's host codecs against their plain versions and the JAX package:
the columnar Example decode (native/codec.cc) against the Python codec and
the JAX package's batch_examples, the bfloat16 rounding against ml_dtypes,
the chunked token_ce against the unchunked formula, the int8 block codec and
its packed spans against the JAX package's, and the Criteo records built
column by column against encode_example."""

import ml_dtypes
import numpy as np
import pytest

from elasticdl_tpu.common import tensor_utils as jax_tensor_utils
from elasticdl_tpu.data.example import batch_examples as jax_batch_examples
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data import example
from elasticdl_tpu_torch.data.example import (
    batch_examples,
    encode_example,
    stack_examples,
)
from elasticdl_tpu_torch.data.gen.criteo import (
    encode_columns,
    iter_criteo_records,
    synthetic_criteo_arrays,
)
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.models.dac_ctr import feature_config as fc
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.proto import messages as pb

from test_torch_ps import _Pair, _model_bytes, _packed_push_bytes

# ---------- the columnar Example decode ----------


def _mixed_records(n, seed=0):
    """Records mixing dtypes and ranks: int64, float32, bfloat16 (encoded
    as the JAX package encodes ml_dtypes arrays), int8, bool; 0-d, 1-d and
    2-d."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bf = rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16)
        t = pb.Tensor(name="bf", dims=[2, 3], dtype=pb.DT_BFLOAT16,
                      content=bf.tobytes())
        ex = pb.Example.FromString(encode_example({
            "i64": rng.integers(-2**40, 2**40, dtype=np.int64),
            "f32": rng.normal(size=(4,)).astype(np.float32),
            "grid": rng.integers(-128, 127, size=(3, 2), dtype=np.int8),
            "flag": np.array(bool(rng.integers(2))),
        }))
        ex.features["bf"] = t
        out.append(ex.SerializeToString())
    return out


def _lm_records(n):
    tokens = synthetic_lm_tokens(n, 17, vocab=50, seed=0)
    return [encode_example({"tokens": row}) for row in tokens]


RECORD_SETS = {
    "criteo": lambda: list(iter_criteo_records(37, seed=2, chunk=16)),
    "lm": lambda: _lm_records(9),
    "mixed": lambda: _mixed_records(7),
}


def _assert_same_batch(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        if want[name].dtype == object:  # strings: compare the values
            assert got[name].tolist() == want[name].tolist(), name
        else:
            assert got[name].tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("kind", sorted(RECORD_SETS))
def test_columnar_decode_is_bitwise_the_python_and_jax_decode(
        kind, monkeypatch):
    records = RECORD_SETS[kind]()
    calls = []
    inner = example._decode_columnar
    monkeypatch.setattr(example, "_decode_columnar",
                        lambda r, s: calls.append(1) or inner(r, s))
    got = batch_examples(records)
    assert calls and example._schema(records[0])  # the columnar path ran
    _assert_same_batch(got, stack_examples(records))
    theirs = jax_batch_examples(records)
    assert sorted(got) == sorted(theirs)
    for name, value in theirs.items():
        # bfloat16 decodes to float32 holding the same values in the port.
        want = (value.astype(np.float32)
                if value.dtype == ml_dtypes.bfloat16 else value)
        assert got[name].dtype == want.dtype, name
        assert got[name].tobytes() == want.tobytes(), name


def test_records_off_the_schema_take_the_python_codec():
    strings = [encode_example({"id": np.int64(i), "text": np.array(f"t{i}")})
               for i in range(4)]
    ragged = [encode_example({"tokens": np.arange(n, dtype=np.int32)})
              for n in (3, 3, 4)]
    extra = _lm_records(3)
    width = example.decode_example(extra[0])["tokens"].size
    extra[2] = encode_example({"tokens": np.arange(width, dtype=np.int64),
                               "more": np.float32(1)})
    for records in (strings, extra):
        _assert_same_batch(batch_examples(records), stack_examples(records))
    got = batch_examples(strings)
    assert got["text"].tolist() == ["t0", "t1", "t2", "t3"]
    with pytest.raises(ValueError):  # np.stack refuses ragged shapes
        batch_examples(ragged)
    # A feature missing from a later record: the Python codec's KeyError.
    with pytest.raises(KeyError):
        batch_examples(_lm_records(2) + [encode_example(
            {"other": np.int32(1)})])


def test_truncated_or_garbage_records_raise():
    records = _lm_records(4)
    good = records[0]
    bad_cases = [
        good[:-3],  # truncated inside the content
        good[:5],  # truncated inside a length
        good + b"\x80",  # a truncated varint
        good + b"\x0b",  # wire type 3 (a group): unsupported
        good + b"\x08" + b"\xff" * 10 + b"\x01",  # varint past ten bytes
        good + b"\x0d\x00\x00",  # a truncated fixed32
        good + b"\x0a\x03\x0a\x01\xff",  # a map key that is not UTF-8
        good.replace(b"tokens", b"tok\xffns"),  # the same, in place
    ]
    for bad in bad_cases:
        for decode in (stack_examples, batch_examples):
            with pytest.raises(ValueError):
                decode(records[:2] + [bad] + records[2:])
        with pytest.raises(Exception):
            jax_batch_examples(records[:2] + [bad])
    # Unknown fields are skipped, as the Python codec skips them.
    padded = [good + b"\x78\x05" + b"\x82\x01\x02ab"] * 2
    _assert_same_batch(batch_examples(padded), stack_examples(padded))


# ---------- bfloat16 rounding ----------


def test_bfloat16_rounding_matches_ml_dtypes_on_every_high_half():
    rng = np.random.default_rng(0)
    high = np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)
    low = rng.integers(0, 1 << 16, size=(3, 1 << 16)).astype(np.uint32)
    edges = np.array([0, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    values = np.concatenate([
        (high | low).reshape(-1),
        (high[:, None] | edges).reshape(-1),
    ]).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = values.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = tensor_utils.float32_to_bfloat16_bits(values)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tensor_utils.float32_to_bfloat16_bits_plain(values))
    # Shapes, 0-d and non-contiguous input.
    grid = values[:24].reshape(4, 6)
    for arr in (grid, grid[:, ::2], grid.T, values[7]):
        np.testing.assert_array_equal(
            tensor_utils.float32_to_bfloat16_bits(arr),
            tensor_utils.float32_to_bfloat16_bits_plain(arr))
        assert tensor_utils.float32_to_bfloat16_bits(arr).shape == np.shape(
            arr)


# ---------- the chunked token_ce ----------


@pytest.mark.parametrize("shape,vocab", [((2, 9), 50), ((3,), 7),
                                         ((2, 70), 40000)])
def test_token_ce_matches_the_unchunked_formula(shape, vocab):
    rng = np.random.default_rng(vocab)
    logits = (rng.normal(size=shape + (vocab,)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab, size=shape)
    before = logits.copy()
    got = tlm.token_ce(logits, labels)
    want = tlm.token_ce_plain(logits, labels)
    assert got.shape == want.shape == shape + (1,)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(logits, before)  # the input is untouched


# ---------- the int8 block codec ----------


@pytest.mark.parametrize("block", [1, 7, 64, 256])
@pytest.mark.parametrize("n", [0, 1, 5, 256, 1000])
def test_int8_codec_is_bitwise_the_jax_codec(block, n):
    rng = np.random.default_rng(n * 1000 + block)
    x = (rng.normal(size=n) * rng.uniform(0.01, 100)).astype(np.float32)
    q, scales = tensor_utils.quantize_int8_blocks(x, block)
    jq, jscales = jax_tensor_utils.quantize_int8_blocks(x, block)
    assert q.dtype == np.int8 and scales.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scales, jscales)
    dq = tensor_utils.dequantize_int8_blocks(q, scales, block)
    np.testing.assert_array_equal(
        dq, jax_tensor_utils.dequantize_int8_blocks(jq, jscales, block))
    # The codec's contract: error at most half the block's scale.
    assert np.all(np.abs(dq - x) <= np.repeat(scales, block)[:n] / 2 + 1e-12)


def test_int8_zero_blocks_shapes_and_validation():
    q, scales = tensor_utils.quantize_int8_blocks(np.zeros(300), 256)
    assert np.all(scales == 0)
    np.testing.assert_array_equal(
        tensor_utils.dequantize_int8_blocks(q, scales, 256), np.zeros(300))
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    q, scales = tensor_utils.quantize_int8_blocks(x, 4)
    np.testing.assert_array_equal(q, jax_tensor_utils.quantize_int8_blocks(
        x, 4)[0])
    with pytest.raises(ValueError, match="block_size"):
        tensor_utils.quantize_int8_blocks(np.ones(4), 0)
    with pytest.raises(ValueError, match="block_size"):
        tensor_utils.dequantize_int8_blocks(np.ones(4, np.int8),
                                            np.ones(1, np.float32), -1)
    with pytest.raises(ValueError, match="scales"):
        tensor_utils.dequantize_int8_blocks(np.ones(300, np.int8),
                                            np.ones(1, np.float32), 256)


def test_packed_int8_spans_parse_as_the_jax_decode():
    rng = np.random.default_rng(3)
    grads = {"w": rng.normal(size=(33, 17)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    payload = tensor_utils.PackedPayload()
    header = pb.PushGradientsPackedRequest(version=1)
    for name, arr in grads.items():
        header.dense.append(tensor_utils.pack_tensor_span(
            name, arr, payload, wire_dtype="int8", block_size=64))
    data = tensor_utils.PackedPushRequest(
        header, payload.parts, payload.nbytes).SerializeToString()
    ours = pb.PushGradientsPackedRequest.FromString(data)
    theirs = pb2.PushGradientsPackedRequest.FromString(data)
    for span, jspan in zip(ours.dense, theirs.dense):
        assert span.dtype == pb.DT_INT8 and span.block_size == 64
        got = tensor_utils.unpack_tensor_span(span, ours.payload)
        want = jax_tensor_utils.unpack_tensor_span(jspan, theirs.payload)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, grads[span.name],
                                   atol=np.abs(grads[span.name]).max() / 127)
    # A truncated payload: the scales lie past its end.
    with pytest.raises(ValueError, match="outside"):
        tensor_utils.unpack_tensor_span(ours.dense[0], ours.payload[:500])


def test_int8_pushes_reach_both_servicers_alike():
    """The port's client's int8 pushes (error feedback across them) into a
    JAX and a port servicer: the same responses and the same stores."""
    pair = _Pair()
    pair.call("push_model", _model_bytes())
    for version, seed in ((0, 1), (1, 2), (2, 3)):
        ours, theirs = pair.call(
            "push_gradients_packed",
            _packed_push_bytes(version, seed, wire="int8")[0])
        assert ours == theirs
    pair.assert_same_store()


# ---------- the Criteo records, built column by column ----------


def test_criteo_columns_encode_as_encode_example():
    dense, cats, labels = synthetic_criteo_arrays(40, seed=9)
    columns = [("label", labels)]
    columns += [(n, dense[:, k]) for k, n in enumerate(fc.DENSE_FEATURES)]
    columns += [(n, cats[:, k])
                for k, n in enumerate(fc.CATEGORICAL_FEATURES)]
    records = encode_columns(columns)
    for i in (0, 17, 39):
        assert records[i] == encode_example(
            {name: column[i] for name, column in columns})


def _best_ms(fn, repeat=3):
    import time

    best = float("inf")
    for _ in range(repeat):
        start = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - start)
    return 1e3 * best


def main():
    """Times the codecs on this host's CPU, the port's against the JAX
    package's, best of 3: from the repo's root,
    `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_codec.py`.
    """
    import json

    from elasticdl_tpu.models.dac_ctr.transform import feed as jax_feed
    from elasticdl_tpu_torch.models.dac_ctr.transform import feed

    records = list(iter_criteo_records(2048, seed=0))
    per_record = {
        "port_batch_examples": lambda: batch_examples(records),
        "port_stack_examples": lambda: stack_examples(records),
        "jax_batch_examples": lambda: jax_batch_examples(records),
        "port_feed": lambda: feed(records, "training", None),
        "jax_feed": lambda: jax_feed(records, "training", None),
    }
    result = {"records": len(records), "ms_per_record": {
        k: _best_ms(fn) / len(records) for k, fn in per_record.items()}}
    floats = np.random.default_rng(0).standard_normal(
        (600000, 8)).astype(np.float32)
    result["bfloat16_ms_600000x8"] = {
        "port": _best_ms(lambda: tensor_utils.float32_to_bfloat16_bits(
            floats)),
        "port_plain": _best_ms(
            lambda: tensor_utils.float32_to_bfloat16_bits_plain(floats)),
        "ml_dtypes": _best_ms(lambda: floats.astype(ml_dtypes.bfloat16)),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
