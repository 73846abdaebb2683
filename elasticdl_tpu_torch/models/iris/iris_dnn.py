"""Iris DNN (counterpart of elasticdl_tpu/models/iris/iris_dnn.py): 4
numeric features -> Dense 16 -> Dense 16 -> 3-way softmax; Adagrad 0.1.
Its feed parses CSV rows of strings (data/reader.py's CSVDataReader)."""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import accuracy_metric
from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.common import (
    add_dense_layers,
    dense_tower,
    softmax_cross_entropy,
)
from elasticdl_tpu_torch.ops import optimizers


class IrisDNN(nn.Module):
    def __init__(self):
        super().__init__()
        add_dense_layers(self, 4, (16, 16, 3))

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, x):
        return dense_tower(self, x.float(), 3)


def custom_model():
    with torch.device("meta"):
        return IrisDNN()


loss = softmax_cross_entropy


def optimizer(lr=0.1):
    return optimizers.adagrad(learning_rate=lr)


def feed(records, mode, metadata):
    """Records are CSV row tuples of strings: sepal_len, sepal_w,
    petal_len, petal_w, label."""
    rows = np.asarray(
        [[float(v) for v in row] for row in records], np.float32
    )
    features = rows[:, :4]
    labels = rows[:, 4] if mode != Modes.PREDICTION else None
    return features, labels


def eval_metrics_fn():
    return {"accuracy": accuracy_metric()}


def make_csv(path, n=150, seed=0):
    """Synthetic separable iris-like CSV (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(
        [[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.1]],
        np.float32,
    )
    with open(path, "w") as f:
        for _ in range(n):
            label = rng.integers(0, 3)
            row = centers[label] + rng.normal(scale=0.15, size=4)
            f.write(
                ",".join(f"{v:.3f}" for v in row) + f",{label}\n"
            )
    return path
