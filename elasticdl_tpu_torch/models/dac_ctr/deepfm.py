"""Criteo DeepFM with device-resident tables (counterpart of
elasticdl_tpu/models/dac_ctr/deepfm.py): first-order logits + the FM
second-order term + a DNN over [dense, field embeddings]. The wide [V, 1]
and deep [V, D] tables live on the device (CTREmbeddings); deepfm_ps.py is
the variant with the tables in the parameter server. The JAX package's
custom_sharded_model / sharded_param_specs (tables row-sharded over a mesh)
belong to parallel/sharded_embedding.py, which is not ported.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.dac_ctr.common import (
    CTREmbeddings,
    DNN,
    ctr_loss,
    ctr_metrics,
    deepfm_head,
    dnn_input_width,
)
from elasticdl_tpu_torch.models.dac_ctr.transform import (  # noqa: F401
    TOTAL_IDS,
    feed,
)
from elasticdl_tpu_torch.ops import optimizers


class DeepFMCriteo(nn.Module):
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
        return deepfm_head(linear_logits, field_embs, dense, self.DNN_0,
                           self.Dense_0)


def custom_model():
    """The model on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return DeepFMCriteo()


loss = ctr_loss


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def eval_metrics_fn():
    return ctr_metrics()
