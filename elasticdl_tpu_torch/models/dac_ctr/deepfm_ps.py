"""Criteo DeepFM with PS-RESIDENT embedding tables (counterpart of
elasticdl_tpu/models/dac_ctr/deepfm_ps.py), the system's headline
deployment: the wide [V, 1] and deep [V, D] tables over the shared id space
(V = 5,546,673) live in the parameter server, and only a batch's rows reach
the device. The dense side (dense_linear, the DNN and its output layer) is
an ordinary parameter set, pulled and pushed per step.

The model takes the looked-up rows as its `rows` argument (see
layers/embedding.py): {"wide": [B*F, 1], "deep": [B*F, D]} float32.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.layers.embedding import DistributedEmbedding
from elasticdl_tpu_torch.models.dac_ctr import feature_config as fc
from elasticdl_tpu_torch.models.dac_ctr.common import (
    DNN,
    ctr_loss,
    ctr_metrics,
    deepfm_head,
)
from elasticdl_tpu_torch.models.dac_ctr.transform import (  # noqa: F401
    NUM_FIELDS,
    feed,
)
from elasticdl_tpu_torch.ops import optimizers


class DeepFMCriteoPS(nn.Module):
    def __init__(self, deep_dim=8, dnn_hidden_units=(16, 4),
                 num_fields=NUM_FIELDS):
        super().__init__()
        self.DistributedEmbedding_0 = DistributedEmbedding("wide", 1)
        self.DistributedEmbedding_1 = DistributedEmbedding("deep", deep_dim)
        self.dense_linear = nn.Linear(fc.NUM_DENSE, 1, bias=False)
        self.DNN_0 = DNN(fc.NUM_DENSE + num_fields * deep_dim,
                         dnn_hidden_units)
        self.Dense_0 = nn.Linear(dnn_hidden_units[-1], 1, bias=False)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, features, rows):
        ids = features["ids"]  # [B, F]
        dense = features["dense"].float()  # [B, 13]
        linear = self.DistributedEmbedding_0(ids, rows)[..., 0]  # [B, F]
        field_embs = self.DistributedEmbedding_1(ids, rows)  # [B, F, D]
        dense_logit = self.dense_linear(dense)  # [B, 1]
        linear_logits = torch.cat([linear, dense_logit], dim=1)
        return deepfm_head(linear_logits, field_embs, dense, self.DNN_0,
                           self.Dense_0)


def custom_model():
    """The model on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return DeepFMCriteoPS()


def embedding_inputs(features):
    """Both PS tables key off the shared offset id space."""
    return {"wide": features["ids"], "deep": features["ids"]}


loss = ctr_loss


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def eval_metrics_fn():
    return ctr_metrics()
