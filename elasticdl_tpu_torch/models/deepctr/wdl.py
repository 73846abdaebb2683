"""WDL (wide & deep learning) declared deepctr-style via feature columns
(counterpart of elasticdl_tpu/models/deepctr/wdl.py).

The 26 Criteo categoricals hash into 10000 buckets each; the deep tower
embeds them (dim 4) beside the 13 log-normalized numerics through Dense
128 -> 64 -> 1, and the wide tower is dim-1 embeddings of the same hashed
ids beside the same numerics, summed into the logit (deepctr's linear
feature columns). The feed keeps the raw integer Criteo ids: the model
hashes them in its forward, on its device
(preprocessing/feature_column.int_hash).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import AUCMetric
from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.example import batch_examples
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.common import (
    add_dense_layers,
    sigmoid_cross_entropy,
)
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.preprocessing import feature_column as fc

NUM_DENSE = 13
NUM_SPARSE = 26
HASH_BUCKETS = 10000
EMB_DIM = 4
HIDDEN_UNITS = (128, 64)

SPARSE_KEYS = [f"C{i}" for i in range(1, NUM_SPARSE + 1)]
DENSE_KEYS = [f"I{i}" for i in range(1, NUM_DENSE + 1)]


def _log_norm(x):
    return torch.log1p(torch.clamp_min(x, 0.0))


def build_columns():
    cats = {
        key: fc.categorical_column_with_hash_bucket(key, HASH_BUCKETS)
        for key in SPARSE_KEYS
    }
    deep = tuple(
        fc.embedding_column(cats[key], EMB_DIM) for key in SPARSE_KEYS
    ) + tuple(
        fc.numeric_column(key, normalizer_fn=_log_norm)
        for key in DENSE_KEYS
    )
    # Wide tower: dim-1 embeddings = a learned weight per hash bucket.
    wide = tuple(
        fc.embedding_column(cats[key], 1) for key in SPARSE_KEYS
    ) + tuple(
        fc.numeric_column(key, normalizer_fn=_log_norm)
        for key in DENSE_KEYS
    )
    return wide, deep


class WDL(nn.Module):
    def __init__(self, wide_columns, deep_columns,
                 hidden_units=HIDDEN_UNITS):
        super().__init__()
        self.wide = fc.DenseFeatures(wide_columns)
        self.deep = fc.DenseFeatures(deep_columns)
        self.n_hidden = len(hidden_units)
        add_dense_layers(self, fc.output_width(deep_columns),
                         tuple(hidden_units) + (1,))

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, features):
        wide = self.wide(features)
        deep = self.deep(features)
        for i in range(self.n_hidden):
            deep = F.relu(getattr(self, f"Dense_{i}")(deep))
        deep = getattr(self, f"Dense_{self.n_hidden}")(deep)
        return wide.sum(dim=-1) + deep.reshape(-1)


_WIDE, _DEEP = build_columns()


def custom_model():
    """The model on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return WDL(_WIDE, _DEEP)


loss = sigmoid_cross_entropy


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    # Raw integer Criteo ids hash in the forward; preprocess only rewrites
    # string-typed columns.
    features = {key: batch[key] for key in DENSE_KEYS + SPARSE_KEYS}
    features = fc.preprocess(_WIDE + _DEEP, features)
    labels = (
        batch["label"].astype(np.float32)
        if mode != Modes.PREDICTION
        else None
    )
    return features, labels


def eval_metrics_fn():
    return {"auc": AUCMetric()}
