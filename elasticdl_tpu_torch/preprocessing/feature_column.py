"""Feature columns: declarative specs lowered into one dense input tensor
(counterpart of elasticdl_tpu/preprocessing/feature_column.py).

The column specs and constructors are the JAX package's. `DenseFeatures`
is an nn.Module holding one table per embedding column, named
`emb_<key>` (flax's Embed `embedding` [N, dim], nn.Embedding.weight's
layout), so a model's `wide`/`deep` DenseFeatures carry the JAX model's
weight names through the weight bridge. Like the JAX module it works in
two steps:
- `preprocess(columns, features)` (or the module's `preprocess`) on the
  host, in the feed: hashed string columns
  become raw 63-bit hashes and vocabulary columns ids; integer arrays pass
  through;
- `forward(features)` on the module's device: numeric columns (with their
  normalizer_fn, written against torch tensors), bucketized columns
  (searchsorted, side right, over float32 boundaries), the hash of integer
  ids, embeddings and indicators.

What the forward copies exactly:
- the JAX module runs without 64-bit types, so an int64 raw id (a string
  hash, a large Criteo id) reaches its hash as its low 32 bits; then the
  lowbias32 mix and the unsigned modulo. Here in int64 on the low 32 bits
  (preprocessing/layers.mul_u32), bitwise the JAX ids;
- identity and vocabulary ids are int32 there: wrapped to 32 bits here;
- embedding ids are clipped to the bucket range; an indicator drops an
  out-of-range id to a zero row;
- the `sqrtn` combiner divides by sqrt of the padded width (the JAX
  module's, not the count of real ids); a combiner that is not sum, mean
  or sqrtn raises at the first multivalent lookup.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.preprocessing.layers import (
    _U32,
    IndexLookup,
    _stable_hash64,
    mul_u32,
)


@dataclasses.dataclass(frozen=True)
class NumericColumn:
    key: str
    shape: tuple = (1,)
    normalizer_fn: object = None  # callable tensor -> tensor


@dataclasses.dataclass(frozen=True)
class IdentityCategoricalColumn:
    key: str
    num_buckets: int


@dataclasses.dataclass(frozen=True)
class HashedCategoricalColumn:
    key: str
    hash_bucket_size: int


@dataclasses.dataclass(frozen=True)
class VocabularyCategoricalColumn:
    key: str
    vocabulary: tuple
    num_oov_indices: int = 1

    @property
    def num_buckets(self):
        return len(self.vocabulary) + self.num_oov_indices


@dataclasses.dataclass(frozen=True)
class BucketizedColumn:
    key: str
    boundaries: tuple

    @property
    def num_buckets(self):
        return len(self.boundaries) + 1


@dataclasses.dataclass(frozen=True)
class EmbeddingColumn:
    categorical: object
    dimension: int
    combiner: str = "mean"
    initializer_stddev: float = None  # default 1/sqrt(dim)


@dataclasses.dataclass(frozen=True)
class IndicatorColumn:
    categorical: object


def numeric_column(key, shape=(1,), normalizer_fn=None):
    return NumericColumn(key, tuple(shape), normalizer_fn)


def categorical_column_with_identity(key, num_buckets):
    return IdentityCategoricalColumn(key, num_buckets)


def categorical_column_with_hash_bucket(key, hash_bucket_size):
    return HashedCategoricalColumn(key, hash_bucket_size)


def categorical_column_with_vocabulary_list(
    key, vocabulary, num_oov_indices=1
):
    return VocabularyCategoricalColumn(
        key, tuple(vocabulary), num_oov_indices
    )


def bucketized_column(key, boundaries):
    """Numeric -> bucket id by boundaries, in the forward (no host
    step)."""
    return BucketizedColumn(key, tuple(sorted(boundaries)))


def embedding_column(
    categorical, dimension, combiner="mean", initializer_stddev=None
):
    if dimension is None or dimension < 1:
        raise ValueError(f"invalid embedding dimension {dimension}")
    return EmbeddingColumn(categorical, dimension, combiner,
                           initializer_stddev)


def indicator_column(categorical):
    return IndicatorColumn(categorical)


def _bucket_count(categorical):
    if isinstance(categorical, HashedCategoricalColumn):
        return categorical.hash_bucket_size
    return categorical.num_buckets


def _is_int(raw):
    """An integer numpy array or tensor (bool is not)."""
    if isinstance(raw, torch.Tensor):
        return not (raw.is_floating_point() or raw.is_complex()
                    or raw.dtype == torch.bool)
    dtype = getattr(raw, "dtype", None)
    return dtype is not None and np.issubdtype(dtype, np.integer)


def _int32(ids):
    """int64 ids wrapped to int32's range, as the JAX package's 32-bit ids
    hold them."""
    return ((ids + 2**31) & _U32) - 2**31


def int_hash(ids):
    """The JAX module's in-graph lowbias32 mix on the low 32 bits of int64
    ids -> int64 in [0, 2**32)."""
    x = ids & _U32
    x = mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _raw_string_hashes(raw):
    """Strings -> raw 63-bit hashes (int64), the host step of a hashed
    column."""
    arr = np.asarray(raw)
    return np.asarray(
        [_stable_hash64(s) & 0x7FFFFFFFFFFFFFFF for s in arr.reshape(-1)],
        np.int64,
    ).reshape(arr.shape)


@functools.lru_cache(maxsize=256)
def _lookup_for(categorical):
    """One IndexLookup per frozen column spec: preprocess runs per batch in
    the feed and must not rebuild the vocabulary dict each call."""
    return IndexLookup(
        list(categorical.vocabulary),
        num_oov_indices=categorical.num_oov_indices,
    )


def _walk_categoricals(columns):
    for col in columns:
        if isinstance(col, (EmbeddingColumn, IndicatorColumn)):
            yield col.categorical


def _combine(embedded, combiner):
    if embedded.dim() == 2:  # single id per example: nothing to combine
        return embedded
    if combiner == "sum":
        return embedded.sum(dim=-2)
    if combiner == "mean":
        return embedded.mean(dim=-2)
    if combiner == "sqrtn":
        return embedded.sum(dim=-2) / math.sqrt(embedded.shape[-2])
    raise ValueError(f"unknown combiner {combiner!r}")


def preprocess(columns, features):
    """The host-side pass of `columns` (DenseFeatures.preprocess, without
    building the module's tables): hashed string columns -> raw 63-bit
    hashes (bucketed once, in the forward), vocabulary columns -> ids, under
    the same keys. Integer inputs pass through."""
    out = dict(features)
    for cat in _walk_categoricals(columns):
        raw = out.get(cat.key)
        if raw is None or _is_int(raw):
            continue
        if isinstance(cat, HashedCategoricalColumn):
            out[cat.key] = _raw_string_hashes(raw)
        elif isinstance(cat, VocabularyCategoricalColumn):
            out[cat.key] = np.asarray(_lookup_for(cat)(np.asarray(raw)))
    return out


def output_width(columns):
    """The width of DenseFeatures(columns)'s output for single-valued
    categorical features."""
    width = 0
    for col in columns:
        if isinstance(col, NumericColumn):
            width += math.prod(col.shape)
        elif isinstance(col, EmbeddingColumn):
            width += col.dimension
        else:
            width += _bucket_count(col.categorical)
    return width


def _tensor(raw, device):
    if isinstance(raw, torch.Tensor):
        return raw
    return torch.as_tensor(np.asarray(raw)).to(device)


def _categorical_ids(categorical, features, device):
    """Column spec + feature batch -> int64 ids on `device`. Strings not
    yet preprocessed are hashed or looked up here, on the host."""
    raw = features[categorical.key]
    if isinstance(categorical, BucketizedColumn):
        boundaries = torch.tensor(categorical.boundaries,
                                  dtype=torch.float32, device=device)
        values = _tensor(raw, device).float().contiguous()
        return torch.searchsorted(boundaries, values, right=True)
    if isinstance(categorical, HashedCategoricalColumn):
        if not _is_int(raw) and not isinstance(raw, torch.Tensor):
            raw = _raw_string_hashes(raw)
        ids = _tensor(raw, device).long()
        return int_hash(ids) % categorical.hash_bucket_size
    if isinstance(categorical, IdentityCategoricalColumn) or _is_int(raw):
        return _int32(_tensor(raw, device).long())
    if isinstance(categorical, VocabularyCategoricalColumn):
        ids = _lookup_for(categorical)(np.asarray(raw))
        return _int32(_tensor(ids, device))
    raise TypeError(f"not a categorical column: {categorical!r}")


class ColumnEmbedding(nn.Embedding):
    """An embedding column's table, initialized as flax's
    truncated_normal(stddev): a normal of that stddev truncated to two of
    them (`init_flax`)."""

    def __init__(self, num_embeddings, features, stddev):
        super().__init__(num_embeddings, features)
        self.stddev = stddev

    @torch.no_grad()
    def init_flax(self, generator):
        std = self.stddev
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


class DenseFeatures(nn.Module):
    """Lowers column specs against a feature dict into one dense [batch,
    total_width] float32 tensor, the columns' outputs concatenated in
    order."""

    def __init__(self, columns):
        super().__init__()
        self.columns = tuple(columns)
        for col in self.columns:
            if isinstance(col, EmbeddingColumn):
                name = f"emb_{col.categorical.key}"
                if hasattr(self, name):
                    raise ValueError(f"two embedding columns named {name}")
                self.add_module(name, ColumnEmbedding(
                    _bucket_count(col.categorical), col.dimension,
                    col.initializer_stddev or 1.0 / math.sqrt(
                        col.dimension)))
            elif not isinstance(col, (NumericColumn, IndicatorColumn)):
                raise TypeError(f"unsupported column {col!r}")

    def preprocess(self, features):
        return preprocess(self.columns, features)

    def forward(self, features):
        on = [v for v in features.values() if isinstance(v, torch.Tensor)]
        on += list(self.parameters())
        device = on[0].device if on else torch.device("cpu")
        pieces = []
        for col in self.columns:
            if isinstance(col, NumericColumn):
                value = _tensor(features[col.key], device).float()
                if col.normalizer_fn is not None:
                    value = col.normalizer_fn(value)
                pieces.append(value.reshape(value.shape[0], -1))
            elif isinstance(col, EmbeddingColumn):
                n = _bucket_count(col.categorical)
                ids = _categorical_ids(col.categorical, features,
                                       device).clamp(0, n - 1)
                table = getattr(self, f"emb_{col.categorical.key}")
                embedded = _combine(table(ids), col.combiner)
                pieces.append(embedded.reshape(embedded.shape[0], -1))
            else:  # IndicatorColumn: multi-hot, multivalent ids sum
                n = _bucket_count(col.categorical)
                ids = _categorical_ids(col.categorical, features, device)
                ids = ids.reshape(ids.shape[0], -1)
                # Out-of-range ids count in an extra column, cut off.
                ids = torch.where((ids >= 0) & (ids < n), ids, n)
                counts = torch.zeros(ids.shape[0], n + 1, device=device)
                counts.scatter_add_(1, ids, torch.ones_like(
                    ids, dtype=counts.dtype))
                pieces.append(counts[:, :n])
        return torch.cat(pieces, dim=-1)
