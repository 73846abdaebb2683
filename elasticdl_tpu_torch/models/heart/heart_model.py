"""Heart-disease classifier (counterpart of elasticdl_tpu/models/heart/
heart_model.py): 5 normalized numeric columns, a hashed `thal` and a
bucketized age through dim-4 embeddings, Dense 32 -> 16 -> 1; Adam 0.01.
"""

import numpy as np
import torch
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
from elasticdl_tpu_torch.preprocessing.layers import (
    Discretization,
    Hashing,
    Normalizer,
)

NUMERIC = ["age", "trestbps", "chol", "thalach", "oldpeak"]
_norms = {
    "age": Normalizer(54.0, 9.0),
    "trestbps": Normalizer(131.0, 17.0),
    "chol": Normalizer(246.0, 51.0),
    "thalach": Normalizer(149.0, 22.0),
    "oldpeak": Normalizer(1.0, 1.1),
}
_thal_hash = Hashing(8)
_age_bucket = Discretization([40, 50, 60])
THAL_BINS = 8
AGE_BINS = 4


class HeartModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.Embed_0 = nn.Embedding(THAL_BINS, 4)
        self.Embed_1 = nn.Embedding(AGE_BINS, 4)
        add_dense_layers(self, len(NUMERIC) + 8, (32, 16, 1))

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, features):
        thal = self.Embed_0(features["thal_id"].long())
        age = self.Embed_1(features["age_bucket"].long())
        x = torch.cat([features["numeric"].float(), thal, age], dim=-1)
        return dense_tower(self, x, 3).reshape(-1)


def custom_model():
    with torch.device("meta"):
        return HeartModel()


loss = sigmoid_cross_entropy


def optimizer(lr=0.01):
    return optimizers.adam(learning_rate=lr)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    numeric = np.stack(
        [_norms[name](batch[name].astype(np.float32)) for name in NUMERIC],
        axis=1,
    )
    features = {
        "numeric": numeric.astype(np.float32),
        "thal_id": _thal_hash(batch["thal"].astype(np.int64)),
        "age_bucket": _age_bucket(batch["age"].astype(np.float32)),
    }
    labels = (
        batch["label"].astype(np.float32)
        if mode != Modes.PREDICTION
        else None
    )
    return features, labels


def eval_metrics_fn():
    return {"accuracy": logit_accuracy()}


def make_records(n, seed=0):
    """Synthetic rows (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(n):
        age = rng.uniform(29, 77)
        chol = rng.uniform(150, 400)
        thalach = rng.uniform(90, 200)
        label = int(0.03 * age + 0.004 * chol - 0.02 * thalach > 0)
        records.append(
            encode_example(
                {
                    "age": np.float32(age),
                    "trestbps": np.float32(rng.uniform(100, 170)),
                    "chol": np.float32(chol),
                    "thalach": np.float32(thalach),
                    "oldpeak": np.float32(rng.uniform(0, 4)),
                    "thal": np.int64(rng.integers(0, 30)),
                    "label": np.int64(label),
                }
            )
        )
    return records
