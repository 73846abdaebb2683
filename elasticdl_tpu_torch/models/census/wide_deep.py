"""Census wide & deep (counterpart of elasticdl_tpu/models/census/
wide_deep.py): 4 hashed categorical features and 2 bucketized numeric ones,
offset into one shared id space, a wide part (dim-1 embeddings summed) and
a deep part (dim-8 embeddings -> Dense 16 x 3 -> Dense 1) summed into a
sigmoid logit; Adam 0.01. The transforms run on the host in `feed`
(preprocessing/layers.py), so the device sees id arrays.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.example import batch_examples, encode_example
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.common import (
    add_dense_layers,
    dense_tower,
    logit_accuracy,
    sigmoid_cross_entropy,
)
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.preprocessing.layers import Discretization, Hashing

# Feature config: 4 categorical (hashed) + 2 numeric (bucketized) features.
CATEGORICAL_BINS = {"workclass": 30, "education": 30, "occupation": 50,
                    "relationship": 20}
AGE_BOUNDARIES = [25, 35, 45, 55, 65]
HOURS_BOUNDARIES = [20, 35, 45]

_hashers = {name: Hashing(bins) for name, bins in CATEGORICAL_BINS.items()}
_age_bucket = Discretization(AGE_BOUNDARIES)
_hours_bucket = Discretization(HOURS_BOUNDARIES)

# Offsets concatenate all id spaces into one vocabulary for the shared
# wide/deep tables.
_SIZES = list(CATEGORICAL_BINS.values()) + [
    len(AGE_BOUNDARIES) + 1,
    len(HOURS_BOUNDARIES) + 1,
]
OFFSETS = np.concatenate([[0], np.cumsum(_SIZES)[:-1]])
TOTAL_IDS = int(np.sum(_SIZES))
NUM_GROUPS = len(_SIZES)
DEEP_DIM = 8


class WideDeep(nn.Module):
    def __init__(self):
        super().__init__()
        self.wide = nn.Parameter(torch.empty(TOTAL_IDS, 1))
        self.deep = nn.Parameter(torch.empty(TOTAL_IDS, DEEP_DIM))
        add_dense_layers(self, NUM_GROUPS * DEEP_DIM, (16, 16, 16, 1))

    def init_weights(self, generator):
        init_flax_defaults(self, generator)
        with torch.no_grad():
            self.wide.zero_()
            self.deep.uniform_(0.0, 0.05, generator=generator)

    def forward(self, features):
        ids = features["ids"].long()  # [B, n_groups] offset ids
        wide = F.embedding(ids, self.wide).sum(dim=1)  # [B, 1]
        deep = F.embedding(ids, self.deep).reshape(ids.shape[0], -1)
        return (wide + dense_tower(self, deep, 4)).reshape(-1)


def custom_model():
    with torch.device("meta"):
        return WideDeep()


loss = sigmoid_cross_entropy


def optimizer(lr=0.01):
    return optimizers.adam(learning_rate=lr)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    cols = []
    for i, name in enumerate(CATEGORICAL_BINS):
        cols.append(_hashers[name](batch[name]) + OFFSETS[i])
    cols.append(
        _age_bucket(batch["age"]) + OFFSETS[len(CATEGORICAL_BINS)]
    )
    cols.append(
        _hours_bucket(batch["hours"]) + OFFSETS[len(CATEGORICAL_BINS) + 1]
    )
    ids = np.stack([np.asarray(c).reshape(-1) for c in cols], axis=1)
    labels = (
        batch["label"].astype(np.float32)
        if mode != Modes.PREDICTION
        else None
    )
    return {"ids": ids.astype(np.int64)}, labels


def eval_metrics_fn():
    return {"accuracy": logit_accuracy()}


def make_records(n, seed=0):
    """Synthetic census-like rows with a learnable relationship between
    the hashed groups and the label (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    weights = rng.normal(size=TOTAL_IDS).astype(np.float32)
    records = []
    for _ in range(n):
        row = {
            name: np.int64(rng.integers(0, 1000))
            for name in CATEGORICAL_BINS
        }
        row["age"] = np.float32(rng.uniform(18, 80))
        row["hours"] = np.float32(rng.uniform(5, 60))
        score = weights[feed_row(row)].sum()
        row["label"] = np.int64(score > 0)
        records.append(encode_example(row))
    return records


def feed_row(row):
    """One row's offset ids."""
    cols = []
    for i, name in enumerate(CATEGORICAL_BINS):
        cols.append(
            int(_hashers[name](np.asarray([row[name]]))[0]) + OFFSETS[i]
        )
    cols.append(
        int(_age_bucket(np.asarray([row["age"]]))[0])
        + OFFSETS[len(CATEGORICAL_BINS)]
    )
    cols.append(
        int(_hours_bucket(np.asarray([row["hours"]]))[0])
        + OFFSETS[len(CATEGORICAL_BINS) + 1]
    )
    return np.asarray(cols, np.int64)
