"""DeepFM with local tables (counterpart of elasticdl_tpu/models/deepfm/
deepfm_functional.py): a fixed number of id fields, the first-order term
(`w_linear` [V, 1]), the FM second-order term over `v_factors` [V, D] by
the (sum^2 - sum of squares)/2 identity, and a deep MLP (64, 32, 1), summed
into a sigmoid logit; Adam 1e-3."""

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
from elasticdl_tpu_torch.models.dac_ctr.common import fm_interaction
from elasticdl_tpu_torch.ops import optimizers

VOCAB = 5000
FIELDS = 10
EMB_DIM = 8


class DeepFM(nn.Module):
    def __init__(self, vocab=VOCAB, emb_dim=EMB_DIM):
        super().__init__()
        self.w_linear = nn.Parameter(torch.empty(vocab, 1))
        self.v_factors = nn.Parameter(torch.empty(vocab, emb_dim))
        add_dense_layers(self, FIELDS * emb_dim, (64, 32, 1))

    def init_weights(self, generator):
        init_flax_defaults(self, generator)
        with torch.no_grad():
            self.w_linear.zero_()
            self.v_factors.normal_(0.0, 0.01, generator=generator)

    def forward(self, ids):
        ids = ids.long()  # [B, FIELDS]
        linear = F.embedding(ids, self.w_linear).sum(dim=(1, 2))  # [B]
        v = F.embedding(ids, self.v_factors)  # [B, F, D]
        deep = dense_tower(self, v.reshape(v.shape[0], -1), 3).reshape(-1)
        return linear + fm_interaction(v) + deep


def custom_model():
    with torch.device("meta"):
        return DeepFM()


loss = sigmoid_cross_entropy


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    labels = (
        batch["label"].astype(np.float32)
        if mode != Modes.PREDICTION
        else None
    )
    return batch["ids"].astype(np.int64), labels


def eval_metrics_fn():
    return {"accuracy": logit_accuracy()}


def make_records(n, seed=0, vocab=VOCAB, fields=FIELDS):
    """Synthetic CTR rows, the label from a sparse linear ground truth (the
    JAX package's draws)."""
    rng = np.random.default_rng(seed)
    weights = rng.normal(scale=1.0, size=vocab).astype(np.float32)
    ids = rng.integers(0, vocab, size=(n, fields))
    scores = weights[ids].sum(axis=1)
    labels = (scores > 0).astype(np.int64)
    return [
        encode_example(
            {"ids": ids[i].astype(np.int64), "label": labels[i]}
        )
        for i in range(n)
    ]
