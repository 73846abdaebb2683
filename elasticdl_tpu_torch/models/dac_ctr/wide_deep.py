"""Criteo wide & deep (counterpart of
elasticdl_tpu/models/dac_ctr/wide_deep.py): the wide part is the
first-order logits (dim-1 embeddings and the dense linear term), the deep
part a DNN over [dense, field embeddings]; the logit is their sum.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.dac_ctr.common import (
    CTREmbeddings,
    DNN,
    concat_dense_fields,
    ctr_loss,
    ctr_metrics,
    dnn_input_width,
)
from elasticdl_tpu_torch.models.dac_ctr.transform import (  # noqa: F401
    TOTAL_IDS,
    feed,
)
from elasticdl_tpu_torch.ops import optimizers


class WideDeep(nn.Module):
    def __init__(self, deep_dim=8, dnn_hidden_units=(16, 4), vocab=None):
        super().__init__()
        self.CTREmbeddings_0 = CTREmbeddings(deep_dim, vocab or TOTAL_IDS)
        self.DNN_0 = DNN(dnn_input_width(deep_dim), dnn_hidden_units)
        self.Dense_0 = nn.Linear(dnn_hidden_units[-1], 1, bias=False)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)
        self.CTREmbeddings_0.init_weights(generator)

    def forward(self, features):
        linear_logits, field_embs, dense = self.CTREmbeddings_0(features)
        dnn_logit = self.Dense_0(self.DNN_0(
            concat_dense_fields(dense, field_embs)))
        return torch.cat([linear_logits, dnn_logit], dim=1).sum(dim=1)


def custom_model():
    """The model on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return WideDeep()


loss = ctr_loss


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def eval_metrics_fn():
    return ctr_metrics()
