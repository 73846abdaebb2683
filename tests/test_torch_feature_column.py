"""The port's feature columns, preprocessing layers and analyzer utilities
(elasticdl_tpu_torch/preprocessing/) against the JAX package's on the same
seeded inputs and, for tables, the same weights carried by the weight
bridge.

Tolerances, as a share of the largest value compared: float32 outputs
1e-5, gradients 1e-4 (float32 summed in another order); ids bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.preprocessing import analyzer_utils as janalyzer
from elasticdl_tpu.preprocessing import feature_column as jfc
from elasticdl_tpu.preprocessing import layers as jlayers
from elasticdl_tpu_torch.common.params import (
    flax_leaves,
    params_to_flax,
)
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.preprocessing import analyzer_utils
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.preprocessing import layers

torch.set_num_threads(1)

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
BIG_IDS = np.array([[0, 1, 2**32 + 5, -7], [2**40 + 123, -(2**35) - 1,
                                            2**63 - 1, 4294967295]],
                   np.int64)


def _close(got, want, what, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


def _nest(named):
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _both(make_columns):
    """The same column specs built by both packages' constructors."""
    return make_columns(fc), make_columns(jfc)


def _numeric_identity(m):
    item = m.categorical_column_with_identity("item", num_buckets=10)
    return (
        m.numeric_column("price", normalizer_fn=lambda x: (x - 3.0) / 2.0),
        m.numeric_column("pair", shape=(2,)),
        m.embedding_column(item, 4, combiner="sum"),
        m.indicator_column(item),
    )


def _combiners(m):
    return tuple(
        m.embedding_column(m.categorical_column_with_identity(k, 10), 3,
                           combiner=c)
        for k, c in (("a", "sum"), ("b", "mean"), ("c", "sqrtn")))


def _hashed_vocab(m):
    return (
        m.embedding_column(m.categorical_column_with_hash_bucket("cat", 32),
                           4),
        m.indicator_column(m.categorical_column_with_vocabulary_list(
            "color", ["red", "green", "blue"], num_oov_indices=2)),
        m.embedding_column(m.categorical_column_with_hash_bucket("big", 97),
                           2, combiner="sum", initializer_stddev=0.3),
        m.indicator_column(m.categorical_column_with_hash_bucket("big2", 7)),
    )


def _bucketized(m):
    age = m.bucketized_column("age", [40, 20, 60])
    return (m.embedding_column(age, 2), m.indicator_column(age),
            m.indicator_column(m.categorical_column_with_identity("k", 4)))


CASES = {
    "numeric_identity": (_numeric_identity, lambda rng: {
        "price": rng.normal(size=(6, 1)).astype(np.float32),
        "pair": rng.normal(size=(6, 2)).astype(np.float32),
        "item": rng.integers(0, 12, (6, 3)),  # 10, 11 out of range
    }),
    "combiners": (_combiners, lambda rng: {
        "a": rng.integers(0, 10, (5, 4)),
        "b": rng.integers(0, 10, (5, 4)),
        "c": rng.integers(0, 10, (5, 4)),
    }),
    "hashed_vocab": (_hashed_vocab, lambda rng: {
        "cat": np.array([["a"], ["b"], ["a"], ["zzz"]]),
        "color": np.array([["red"], ["purple"], ["blue"], [b"green"]],
                          dtype=object),
        "big": BIG_IDS.reshape(4, 2),
        "big2": BIG_IDS.reshape(4, 2)[:, 1:],
    }),
    "bucketized": (_bucketized, lambda rng: {
        "age": np.array([[19.0], [20.0], [39.5], [60.0], [75.0]],
                        np.float32),
        "k": np.array([[0], [3], [4], [-1], [2]], np.int64),
    }),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_features_match_jax(case):
    """Each column type and combiner: the output, and the tables'
    gradients of sum(out * weights); string columns through the module
    itself and through preprocess, int64 ids above 2**32 and negative."""
    make_columns, make_features = CASES[case]
    columns, jcolumns = _both(make_columns)
    features = make_features(np.random.default_rng(0))
    model = fc.DenseFeatures(columns)
    init_flax_defaults(model, torch.Generator().manual_seed(0))
    named = params_to_flax(model)
    jmodel = jfc.DenseFeatures(jcolumns)
    jout = np.asarray(jmodel.apply({"params": _nest(named)}, features))
    weights = np.random.default_rng(1).normal(size=jout.shape).astype(
        np.float32)

    out = model(features)
    _close(out.detach(), jout, "output", OUT_RTOL)
    pre = model.preprocess(features)
    np.testing.assert_array_equal(model(pre).detach().numpy(),
                                  out.detach().numpy())
    if not named:
        return
    jgrads = flatten_params(jax.grad(lambda p: jnp.sum(
        jmodel.apply({"params": p}, features) * weights))(
            _nest(named)))[0]
    (out * torch.tensor(weights)).sum().backward()
    for leaf in flax_leaves(model):
        _close(leaf.to_flax(leaf.param.grad), jgrads[leaf.name], leaf.name,
               GRAD_RTOL)


def test_hashed_ids_bitwise_including_int64_above_2_32():
    """The in-graph hash of raw int64 ids (wrapped to their low 32 bits,
    as the JAX module receives them without 64-bit types), of strings via
    their raw 63-bit hash, and the Hashing layer on numpy and on tensors:
    bitwise the JAX package's."""
    rng = np.random.default_rng(3)
    ids = np.concatenate([
        BIG_IDS.reshape(-1),
        rng.integers(-(2**63), 2**63 - 1, 200, dtype=np.int64),
        rng.integers(0, 2**33, 200, dtype=np.int64)])
    for buckets in (1, 7, 10000, 2**31 - 1):
        col = fc.categorical_column_with_hash_bucket("x", buckets)
        jcol = jfc.categorical_column_with_hash_bucket("x", buckets)
        got = fc._categorical_ids(
            col, {"x": ids}, torch.device("cpu"))
        want = np.asarray(jfc._categorical_ids(jcol, {"x": ids}))
        np.testing.assert_array_equal(got.numpy(), want)
        words = np.array(["a", "b", "occ17", "", "Private"])
        got = fc._categorical_ids(
            col, {"x": words}, torch.device("cpu"))
        want = np.asarray(jfc._categorical_ids(jcol, {"x": words}))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            fc.preprocess((fc.indicator_column(col),), {"x": words})["x"],
            jfc.DenseFeatures((jfc.indicator_column(jcol),)).preprocess(
                {"x": words})["x"])

    hashing, jhashing = layers.Hashing(97), jlayers.Hashing(97)
    np.testing.assert_array_equal(hashing(ids), jhashing(ids))
    small = ids[ids.astype(np.int32) == ids]  # what a device array holds
    np.testing.assert_array_equal(
        hashing(torch.tensor(small)).numpy(),
        np.asarray(jhashing(jnp.asarray(small.astype(np.int32)))))
    np.testing.assert_array_equal(
        hashing(torch.tensor(ids)).numpy(),
        np.asarray(jhashing(jnp.asarray(ids.astype(np.int32)))))


def test_vocabulary_oov_and_out_of_range_ids():
    """A vocabulary maps unknown tokens to its OOV buckets; an indicator
    drops an out-of-range id to a zero row, an embedding clips it."""
    color = fc.categorical_column_with_vocabulary_list(
        "color", ["red", "green", "blue"])
    model = fc.DenseFeatures((fc.indicator_column(color),))
    out = model({"color": np.array([["red"], ["purple"]])})
    assert out.tolist() == [[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
    k = fc.categorical_column_with_identity("k", 3)
    model = fc.DenseFeatures((fc.indicator_column(k),
                              fc.embedding_column(k, 2)))
    init_flax_defaults(model, torch.Generator().manual_seed(0))
    out = model({"k": np.array([[-1], [3], [1]])}).detach()
    assert out[:, :3].tolist() == [[0.0] * 3, [0.0] * 3, [0.0, 1.0, 0.0]]
    table = model.emb_k.weight.detach()
    assert torch.equal(out[:, 3:], table[[0, 2, 1]])


def test_preprocess_matches_jax():
    features = {
        "cat": np.array(["x", "y", "x"]),
        "color": np.array([b"blue", b"nope", b"red"], dtype=object),
        "ids": np.array([5, 2**40, -3], np.int64),
        "num": np.array([1.5, 2.5, 3.5], np.float32),
    }

    def columns(m):
        return (
            m.indicator_column(m.categorical_column_with_hash_bucket(
                "cat", 11)),
            m.embedding_column(m.categorical_column_with_vocabulary_list(
                "color", ["red", "green", "blue"]), 2),
            m.embedding_column(m.categorical_column_with_hash_bucket(
                "ids", 11), 2),
            m.numeric_column("num"),
        )

    ours, theirs = _both(columns)
    got = fc.preprocess(ours, features)
    want = jfc.DenseFeatures(theirs).preprocess(features)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    assert got["ids"] is features["ids"]  # integers pass through


def test_bad_columns():
    with pytest.raises(ValueError):
        fc.embedding_column(fc.categorical_column_with_identity("x", 5), 0)
    model = fc.DenseFeatures((fc.embedding_column(
        fc.categorical_column_with_identity("x", 5), 2,
        combiner="median"),))
    with pytest.raises(ValueError, match="median"):
        model({"x": np.array([[1, 2]], np.int64)})
    with pytest.raises(TypeError):
        fc.DenseFeatures((fc.categorical_column_with_identity("x", 5),))


# ---------- the preprocessing layers ----------


def test_preprocessing_layers_match_jax_on_numpy_and_tensors():
    """The patterns of tests/test_preprocessing.py, each layer against the
    JAX package's on the same numpy input, and on a tensor against the
    numpy result."""
    x = np.asarray([[1.2], [1.6], [0.2], [3.1], [4.9], [2.5], [100.0]])
    for ours, theirs in (
            (layers.RoundIdentity(6), jlayers.RoundIdentity(6)),
            (layers.LogRound(16, base=2), jlayers.LogRound(16, base=2)),
            (layers.LogRound(4), jlayers.LogRound(4)),
            (layers.Discretization([10, 2, 3]),
             jlayers.Discretization([10, 2, 3])),
            (layers.Normalizer(10.0, 2.0), jlayers.Normalizer(10.0, 2.0))):
        want = theirs(x)
        got = ours(x)
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(ours(torch.tensor(x)).numpy(), want)
    assert layers.RoundIdentity(6)(x)[:5].ravel().tolist() == [1, 2, 0, 3, 5]

    words = np.asarray([["1.5"], [b"2"], ["oops"]], dtype=object)
    np.testing.assert_array_equal(
        layers.ToNumber(np.float32, -1)(words),
        jlayers.ToNumber(np.float32, -1)(words))
    lookup = layers.IndexLookup(["apple", "banana"], num_oov_indices=3)
    tokens = np.asarray([["apple"], [b"banana"], ["durian"], ["fig"]],
                        dtype=object)
    np.testing.assert_array_equal(
        lookup(tokens),
        jlayers.IndexLookup(["apple", "banana"], num_oov_indices=3)(tokens))
    assert lookup.vocab_size() == 5

    f1 = layers.to_padded([[1, 2], [3]], max_len=2)
    f2 = layers.to_padded([[0], [1, 1, 7]], max_len=2)
    jf = [jlayers.to_padded(r, max_len=2) for r in ([[1, 2], [3]],
                                                   [[0], [1, 1, 7]])]
    for got, want in ((f1, jf[0]), (f2, jf[1])):
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.mask, want.mask)
    merged = layers.ConcatenateWithOffset([0, 10])([f1, f2])
    jmerged = jlayers.ConcatenateWithOffset([0, 10])(jf)
    np.testing.assert_array_equal(merged.values, jmerged.values)
    np.testing.assert_array_equal(merged.mask, jmerged.mask)
    tmerged = layers.ConcatenateWithOffset([0, 10])([
        layers.PaddedFeature(torch.tensor(f.values), torch.tensor(f.mask))
        for f in (f1, f2)])
    np.testing.assert_array_equal(tmerged.values.numpy(), merged.values)
    hashed = layers.Hashing(5)(f1)
    np.testing.assert_array_equal(hashed.values,
                                  jlayers.Hashing(5)(jf[0]).values)
    assert hashed.mask is f1.mask
    with pytest.raises(ValueError):
        layers.ConcatenateWithOffset([0])([f1, f2])


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_sparse_embedding_matches_jax(combiner):
    """Padded multivalent ids with a masked combiner; padding never leaks
    in. Output and the table's gradient against flax's SparseEmbedding."""
    feature = layers.to_padded([[1, 2, 5], [3], [7, 7]], max_len=3)
    layer = layers.SparseEmbedding(8, 4, combiner)
    init_flax_defaults(layer, torch.Generator().manual_seed(0))
    table = layer.table.detach().numpy()
    assert 0.0 <= table.min() and table.max() < 0.05
    jlayer = jlayers.SparseEmbedding(vocab_size=8, dim=4, combiner=combiner)
    jfeature = jlayers.PaddedFeature(feature.values, feature.mask)

    def jout_of(t):
        return jlayer.apply({"params": {"table": t}}, jfeature)

    jout = np.asarray(jout_of(table))
    jgrad = np.asarray(jax.grad(lambda t: jnp.sum(jout_of(t) ** 2))(table))
    out = layer(feature)
    (out**2).sum().backward()
    _close(out.detach(), jout, "output", OUT_RTOL)
    _close(layer.table.grad, jgrad, "table gradient", GRAD_RTOL)
    assert [x.name for x in flax_leaves(layer)] == ["table"]
    scale = {"sum": 1.0, "mean": 3.0, "sqrtn": np.sqrt(3.0)}[combiner]
    np.testing.assert_allclose(out[0].detach().numpy(),
                               table[[1, 2, 5]].sum(0) / scale, rtol=1e-6)


def test_analyzer_utils_env_contract(monkeypatch):
    calls = (("get_min", "age", 3.0), ("get_max", "age", 9.0),
             ("get_avg", "other", 7.5), ("get_stddev", "age", 1.0),
             ("get_bucket_boundaries", "fare", []),
             ("get_vocabulary", "city", []),
             ("get_distinct_count", "city", 0))

    def both():
        return [(getattr(analyzer_utils, f)(k, d),
                 getattr(janalyzer, f)(k, d)) for f, k, d in calls]

    assert all(got == want == d for (got, want), (_, _, d)
               in zip(both(), calls))
    for name, value in (("_age_min", "18"), ("_age_max", "90"),
                        ("_age_stddev", "2.5"),
                        ("_fare_boundaries", "30,10,,20"),
                        ("_city_vocab", "bj,sh,,sz"),
                        ("_city_distinct_count", "3")):
        monkeypatch.setenv(name, value)
    results = both()
    assert all(got == want for got, want in results)
    assert [got for got, _ in results] == [
        18.0, 90.0, 7.5, 2.5, [10.0, 20.0, 30.0], ["bj", "sh", "sz"], 3]
