"""Shared pieces of the dac_ctr family (counterpart of
elasticdl_tpu/models/dac_ctr/common.py): the device-resident embeddings,
the DNN tower, the DeepFM head, the FM interaction, the CTR loss and
metrics.

Submodules carry flax's names (CTREmbeddings_0 holding wide, deep and
dense_linear; DNN_0 holding Dense_0, Dense_1, ...), so common/params.py
maps wire names to them mechanically. flax's Dense defaults are kept
(layers/init.py `init_flax_defaults`): lecun-normal kernels and zero
biases. With a `shard_group` (the JAX package's `shard_mesh`) the tables'
rows are sharded over the group's members and looked up by collectives
(parallel/sharded_embedding.py): each member holds its block of the
tables padded to padded_vocab, under the names `wide` and `deep`.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import AUCMetric, MeanMetric
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.dac_ctr import feature_config as fc
from elasticdl_tpu_torch.models.common import sigmoid_cross_entropy
from elasticdl_tpu_torch.models.dac_ctr.transform import NUM_FIELDS, TOTAL_IDS
from elasticdl_tpu_torch.parallel.sharded_embedding import (
    padded_vocab,
    sharded_embedding_lookup,
)

class CTREmbeddings(nn.Module):
    """wide [V, 1] and deep [V, D] tables over the shared offset id space,
    plus the dense features' linear term.

    Returns (linear_logits [B, F+1], field_embs [B, F, D], dense [B, 13]):
    what every head (wide&deep, FM, CIN, cross) consumes. One gather per
    table serves all 39 fields.

    shard_group: an AxisGroup (parallel/distributed.py) whose members hold
    the tables' rows in blocks, the vocab padded to padded_vocab(vocab,
    size); each member looks up its batch shard's ids by collectives."""

    def __init__(self, deep_dim=8, vocab=TOTAL_IDS, shard_group=None):
        super().__init__()
        self.shard_group = shard_group
        rows = vocab
        if shard_group is not None:
            rows = padded_vocab(vocab, shard_group.size) // shard_group.size
        self.wide = nn.Parameter(torch.empty(rows, 1))
        self.deep = nn.Parameter(torch.empty(rows, deep_dim))
        self.dense_linear = nn.Linear(fc.NUM_DENSE, 1, bias=False)

    def init_weights(self, generator):
        """flax's initializers: wide zeros, deep normal(0.01), lecun-normal
        dense_linear."""
        with torch.no_grad():
            self.wide.zero_()
            self.deep.normal_(0.0, 0.01, generator=generator)
        init_flax_defaults(self, generator)

    def forward(self, features):
        ids = features["ids"].long()  # [B, F]
        dense = features["dense"].float()  # [B, 13]
        if self.shard_group is not None:
            linear = sharded_embedding_lookup(
                self.wide, ids, self.shard_group)[..., 0]
            field_embs = sharded_embedding_lookup(
                self.deep, ids, self.shard_group)
        else:
            linear = F.embedding(ids, self.wide)[..., 0]  # [B, F]
            field_embs = F.embedding(ids, self.deep)  # [B, F, D]
        dense_logit = self.dense_linear(dense)  # [B, 1]
        return torch.cat([linear, dense_logit], dim=1), field_embs, dense


def dnn_input_width(deep_dim, num_fields=NUM_FIELDS):
    """Width of [dense, flattened field embeddings], every tower's input."""
    return fc.NUM_DENSE + num_fields * deep_dim


def concat_dense_fields(dense, field_embs):
    return torch.cat(
        [dense, field_embs.reshape(field_embs.shape[0], -1)], dim=1)


class DNN(nn.Module):
    """relu(Dense) per hidden width, named Dense_0, Dense_1, ..."""

    def __init__(self, in_features, hidden_units=(16, 4)):
        super().__init__()
        self.widths = tuple(hidden_units)
        for i, width in enumerate(self.widths):
            self.add_module(f"Dense_{i}", nn.Linear(in_features, width))
            in_features = width

    def forward(self, x):
        for i in range(len(self.widths)):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return x


def fm_interaction(field_embs):
    """Second-order FM term via the (sum^2 - sum of squares)/2 identity:
    [B, F, D] -> [B]."""
    sum_sq = torch.square(field_embs.sum(dim=1))
    sq_sum = torch.square(field_embs).sum(dim=1)
    return 0.5 * (sum_sq - sq_sum).sum(dim=1)


def deepfm_head(linear_logits, field_embs, dense, dnn, out):
    """The DeepFM output assembly: first-order logits + FM second-order
    term + `out`(`dnn`([dense, flattened field embeddings]))."""
    fm = fm_interaction(field_embs)
    dnn_logit = out(dnn(concat_dense_fields(dense, field_embs)))
    return linear_logits.sum(dim=1) + fm + dnn_logit.reshape(-1)


# Mean sigmoid binary cross-entropy (optax's, in its stable form).
ctr_loss = sigmoid_cross_entropy


class _LogitAUC(AUCMetric):
    """AUCMetric over fixed [0,1] thresholds, fed raw logits: squash
    first."""

    def update(self, outputs, labels):
        probs = 1.0 / (1.0 + np.exp(-np.asarray(outputs, np.float64)))
        super().update(probs, labels)


def ctr_metrics():
    return {
        "auc": _LogitAUC(),
        "accuracy": MeanMetric(
            lambda outputs, labels: (
                (np.asarray(outputs).reshape(-1) > 0)
                == np.asarray(labels).reshape(-1).astype(bool)
            ).astype(np.float64)
        ),
    }
