"""Census wide & deep declared entirely as feature columns (counterpart of
elasticdl_tpu/models/census_fc/wide_deep_fc.py).

The wide part is indicator columns over two vocabularies, a hash bucket and
two bucketized numerics; the deep part embeds the same five categoricals
(dim 8) beside the two normalized numerics, through Dense 32 -> 16, and
Dense 1 reads [wide, deep]. Boundaries, vocabularies and the normalizers'
statistics come from the analyzer's environment variables
(preprocessing/analyzer_utils.py) with the JAX package's defaults. The
feed turns the string columns into ids on the host
(feature_column.preprocess); the model sees only numbers.
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
    logit_accuracy,
    sigmoid_cross_entropy,
)
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.preprocessing import analyzer_utils
from elasticdl_tpu_torch.preprocessing import feature_column as fc

WORKCLASS_VOCAB = [
    "Private",
    "Self-emp-not-inc",
    "Self-emp-inc",
    "Federal-gov",
    "Local-gov",
    "State-gov",
    "Without-pay",
    "Never-worked",
]
EDUCATION_VOCAB = [
    "Bachelors",
    "HS-grad",
    "11th",
    "Masters",
    "9th",
    "Some-college",
    "Assoc-acdm",
    "Assoc-voc",
    "Doctorate",
    "Prof-school",
]


def build_columns():
    """Analyzer-statistics-driven column specs (env-overridable)."""
    age_boundaries = analyzer_utils.get_bucket_boundaries(
        "age", [25, 35, 45, 55, 65]
    )
    hours_boundaries = analyzer_utils.get_bucket_boundaries(
        "hours", [20, 35, 45]
    )
    workclass = fc.categorical_column_with_vocabulary_list(
        "workclass", analyzer_utils.get_vocabulary(
            "workclass", WORKCLASS_VOCAB
        )
    )
    education = fc.categorical_column_with_vocabulary_list(
        "education", analyzer_utils.get_vocabulary(
            "education", EDUCATION_VOCAB
        )
    )
    occupation = fc.categorical_column_with_hash_bucket("occupation", 50)
    age_bucket = fc.bucketized_column("age", age_boundaries)
    hours_bucket = fc.bucketized_column("hours", hours_boundaries)

    wide = tuple(
        fc.indicator_column(cat)
        for cat in (workclass, education, occupation, age_bucket,
                    hours_bucket)
    )
    deep = (
        fc.embedding_column(workclass, 8),
        fc.embedding_column(education, 8),
        fc.embedding_column(occupation, 8),
        fc.embedding_column(age_bucket, 8),
        fc.embedding_column(hours_bucket, 8),
        fc.numeric_column(
            "age",
            normalizer_fn=lambda x: (
                x - analyzer_utils.get_avg("age", 38.0)
            ) / analyzer_utils.get_stddev("age", 13.0),
        ),
        fc.numeric_column(
            "hours",
            normalizer_fn=lambda x: (
                x - analyzer_utils.get_avg("hours", 40.0)
            ) / analyzer_utils.get_stddev("hours", 12.0),
        ),
    )
    return wide, deep


class WideDeepFC(nn.Module):
    def __init__(self, wide_columns, deep_columns):
        super().__init__()
        self.wide = fc.DenseFeatures(wide_columns)
        self.deep = fc.DenseFeatures(deep_columns)
        add_dense_layers(self, fc.output_width(deep_columns), (32, 16))
        self.Dense_2 = nn.Linear(fc.output_width(wide_columns) + 16, 1)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, features):
        wide = self.wide(features)
        deep = self.deep(features)
        for i in range(2):
            deep = F.relu(getattr(self, f"Dense_{i}")(deep))
        return self.Dense_2(torch.cat([wide, deep], dim=-1)).reshape(-1)


_COLUMNS = None


def _columns():
    """The column specs, built from the environment at first use."""
    global _COLUMNS
    if _COLUMNS is None:
        _COLUMNS = build_columns()
    return _COLUMNS


def custom_model():
    """The model on the meta device; the trainer materializes it."""
    wide, deep = _columns()
    with torch.device("meta"):
        return WideDeepFC(wide, deep)


loss = sigmoid_cross_entropy


def optimizer(lr=0.01):
    return optimizers.adam(learning_rate=lr)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    wide, deep = _columns()
    # Host-side pass: hash/vocab string columns become int ids; the model
    # sees only numbers.
    features = fc.preprocess(wide + deep, batch)
    labels = (
        batch["label"].astype(np.float32)
        if mode != Modes.PREDICTION
        else None
    )
    features.pop("label", None)
    return features, labels


def eval_metrics_fn():
    return {"accuracy": logit_accuracy()}


def make_records(n, seed=0):
    """Synthetic census-like rows with a learnable relationship (the JAX
    package's draws)."""
    rng = np.random.default_rng(seed)
    w_work = rng.normal(size=len(WORKCLASS_VOCAB) + 1)
    w_edu = rng.normal(size=len(EDUCATION_VOCAB) + 1)
    records = []
    for _ in range(n):
        wi = int(rng.integers(0, len(WORKCLASS_VOCAB)))
        ei = int(rng.integers(0, len(EDUCATION_VOCAB)))
        age = float(rng.uniform(18, 80))
        hours = float(rng.uniform(5, 60))
        score = w_work[wi] + w_edu[ei] + 0.03 * (age - 45)
        records.append(
            encode_example(
                {
                    "workclass": WORKCLASS_VOCAB[wi],
                    "education": EDUCATION_VOCAB[ei],
                    "occupation": f"occ{int(rng.integers(0, 30))}",
                    "age": np.float32(age),
                    "hours": np.float32(hours),
                    "label": np.int64(score > 0),
                }
            )
        )
    return records
