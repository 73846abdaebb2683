"""Synthetic Criteo-DAC-shaped CTR data (a copy of
elasticdl_tpu/data/gen/criteo.py): 13 heavy-tailed integer features, 26
categorical ids and a clicked/not label with real signal in both parts,
drawn from the distribution family of models/dac_ctr/feature_config.py.
The label depends on a linear score over the log-dense features and on
per-id propensities from a splitmix-style mix of the raw categorical ids, so
embeddings have something to learn. The same seed gives the JAX package's
feature values.
"""

import numpy as np

from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.models.dac_ctr import feature_config as fc


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: uint64 -> uint64, decorrelates consecutive ids."""
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _id_propensity(ids: np.ndarray, feature_idx: int) -> np.ndarray:
    """Deterministic per-id weight in [-0.5, 0.5): works for 10M-sized id
    spaces without materializing a weight table."""
    salted = _mix64(ids.astype(np.uint64) ^ np.uint64(0xC1 + feature_idx))
    return (salted >> np.uint64(40)).astype(np.float64) / 2**24 - 0.5


def synthetic_criteo_arrays(num_examples, seed=0):
    """Returns (dense [N,13] float32 with -1 missing, cats [N,26] int64,
    labels [N] int64)."""
    rng = np.random.default_rng(seed)
    dense = np.round(
        rng.lognormal(
            mean=fc.DENSE_LOG_MU,
            sigma=fc.DENSE_LOG_SIGMA,
            size=(num_examples, fc.NUM_DENSE),
        )
    ).astype(np.float32) - 1.0
    # ~4% missing entries, encoded -1 as in the raw DAC dump.
    dense[rng.random(dense.shape) < 0.04] = -1.0

    cards = np.array(
        [fc.CATEGORICAL_CARDINALITY[c] for c in fc.CATEGORICAL_FEATURES],
        dtype=np.int64,
    )
    # Zipf-ish skew: squaring a uniform concentrates mass on low ids, the
    # shape real id frequency tables have.
    u = rng.random((num_examples, fc.NUM_CATEGORICAL))
    cats = np.minimum((u * u * cards).astype(np.int64), cards - 1)

    # Label logit: linear in log1p(dense) + id propensities on every
    # categorical field, temperature-scaled to a ~25% positive rate. The
    # dense weights are a FIXED dataset property (independent of `seed`):
    # iter_criteo_records re-seeds per chunk, and per-chunk weights would
    # average the dense signal to inter-chunk noise.
    log_dense = np.log1p(np.maximum(dense, 0.0))
    w = np.random.default_rng(0xDAC).normal(scale=0.5, size=fc.NUM_DENSE)
    logit = (log_dense - log_dense.mean(axis=0)) @ w
    for j in range(fc.NUM_CATEGORICAL):
        logit += 2.0 * _id_propensity(cats[:, j], j)
    logit = logit - np.percentile(logit, 75)
    labels = (rng.random(num_examples) < 1 / (1 + np.exp(-logit))).astype(
        np.int64
    )
    return dense, cats, labels


def encode_columns(columns):
    """[(name, array [n])] of 0-d numeric features -> n serialized Example
    records, each the bytes encode_example gives for {name: column[i]} in
    this order, built column by column: a scalar feature's encoding is a
    fixed prefix (key, name, dtype, content length) and then its content,
    the last field, so the record is a fixed pattern with the values'
    bytes in place."""
    n = len(columns[0][1])
    pieces = []
    for name, column in columns:
        column = np.ascontiguousarray(column)
        size = column.dtype.itemsize
        sample = encode_example({name: column[0]})
        if not sample.endswith(column[:1].tobytes()):
            raise ValueError(f"feature {name!r} does not end its encoding")
        prefix = np.frombuffer(sample[:-size], np.uint8)
        pieces.append(np.broadcast_to(prefix, (n, prefix.size)))
        pieces.append(column.view(np.uint8).reshape(n, size))
    table = np.concatenate(pieces, axis=1)
    return [row.tobytes() for row in table]


def iter_criteo_records(num_examples, seed=0, chunk=4096):
    """Yields serialized Example records with label, I1..I13, C1..C26."""
    remaining, part = num_examples, 0
    while remaining > 0:
        n = min(chunk, remaining)
        dense, cats, labels = synthetic_criteo_arrays(
            n, seed=seed * 1_000_003 + part
        )
        columns = [("label", labels)]
        columns += [(name, dense[:, k])
                    for k, name in enumerate(fc.DENSE_FEATURES)]
        columns += [(name, cats[:, k])
                    for k, name in enumerate(fc.CATEGORICAL_FEATURES)]
        yield from encode_columns(columns)
        remaining -= n
        part += 1
