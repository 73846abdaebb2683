"""Host-side Criteo feature transform: raw records -> arrays for the device
(counterpart of elasticdl_tpu/models/dac_ctr/transform.py).

Normalizer on the 13 I-features; Discretization on I and Hashing on C,
offset into ONE shared id space, so the model gathers all 39 fields from one
table. The transform runs in `feed` on the host (numpy); the device only
sees {"dense": [B,13] float32, "ids": [B,F] int32}.
"""

import numpy as np

from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.example import batch_examples
from elasticdl_tpu_torch.models.dac_ctr import feature_config as fc
from elasticdl_tpu_torch.preprocessing.layers import (
    Discretization,
    Hashing,
    Normalizer,
)

_normalizers = {
    name: Normalizer(subtractor=fc.DENSE_MEAN[i], divisor=fc.DENSE_STD[i])
    for i, name in enumerate(fc.DENSE_FEATURES)
}
_bucketizers = {
    name: Discretization(fc.DENSE_BOUNDARIES[i])
    for i, name in enumerate(fc.DENSE_FEATURES)
}
_hashers = {
    name: Hashing(fc.hash_bins(name)) for name in fc.CATEGORICAL_FEATURES
}


def _id_space_sizes():
    sizes = []
    for name in fc.DENSE_FEATURES:
        sizes.append(len(_bucketizers[name].bins) + 1)
    for name in fc.CATEGORICAL_FEATURES:
        sizes.append(fc.hash_bins(name))
    return np.asarray(sizes, dtype=np.int64)


ID_SPACE_SIZES = _id_space_sizes()
ID_OFFSETS = np.concatenate([[0], np.cumsum(ID_SPACE_SIZES)[:-1]])
TOTAL_IDS = int(ID_SPACE_SIZES.sum())
NUM_FIELDS = len(ID_SPACE_SIZES)  # 39


def transform_batch(features_by_name):
    """dict name->[B] raw arrays  ->  {"dense": [B,13] f32, "ids": [B,F] i32}
    with ids already offset into the shared vocabulary."""
    some = next(iter(features_by_name.values()))
    batch = np.asarray(some).shape[0]

    dense = np.empty((batch, fc.NUM_DENSE), np.float32)
    ids = np.empty((batch, NUM_FIELDS), np.int64)
    col = 0
    for i, name in enumerate(fc.DENSE_FEATURES):
        raw = np.asarray(features_by_name[name], np.float32).reshape(batch)
        dense[:, i] = _normalizers[name](np.maximum(raw, 0.0))
        ids[:, col] = _bucketizers[name](raw) + ID_OFFSETS[col]
        col += 1
    for name in fc.CATEGORICAL_FEATURES:
        raw = np.asarray(features_by_name[name]).reshape(batch)
        ids[:, col] = _hashers[name](raw) + ID_OFFSETS[col]
        col += 1
    return {"dense": dense, "ids": ids.astype(np.int32)}


def feed(records, mode, metadata):
    """The zoo-contract feed shared by every dac_ctr variant."""
    batch = batch_examples(records)
    labels = (
        batch.pop(fc.LABEL_KEY).astype(np.int64).reshape(-1)
        if fc.LABEL_KEY in batch
        else None
    )
    features = transform_batch(batch)
    if mode == Modes.PREDICTION:
        return features, None
    return features, labels
