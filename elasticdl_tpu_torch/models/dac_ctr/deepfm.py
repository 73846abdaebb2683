"""Criteo DeepFM with device-resident tables (counterpart of
elasticdl_tpu/models/dac_ctr/deepfm.py): first-order logits + the FM
second-order term + a DNN over [dense, field embeddings]. The wide [V, 1]
and deep [V, D] tables live on the device (CTREmbeddings); deepfm_ps.py is
the variant with the tables in the parameter server, and
custom_sharded_model the one with the tables' rows sharded over a group
(parallel/sharded_embedding.py), each member holding a block.
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
from elasticdl_tpu_torch.parallel.mesh import DATA_AXIS
from elasticdl_tpu_torch.parallel.sharded_embedding import sharded_embed_spec


class DeepFMCriteo(nn.Module):
    def __init__(self, deep_dim=8, dnn_hidden_units=(16, 4), vocab=None,
                 shard_group=None):
        super().__init__()
        self.CTREmbeddings_0 = CTREmbeddings(deep_dim, vocab or TOTAL_IDS,
                                             shard_group)
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


def custom_sharded_model(group, vocab=None):
    """DeepFM whose wide and deep tables are row-sharded over `group` (an
    AxisGroup): this member's model, on the meta device, holding its
    block of each table."""
    with torch.device("meta"):
        return DeepFMCriteo(vocab=vocab, shard_group=group)


def sharded_param_specs(names, axis=DATA_AXIS):
    """Specs of custom_sharded_model's wire names (parallel/
    tensor_parallel's form): the two tables row-sharded over `axis`,
    everything else replicated."""
    return {name: (sharded_embed_spec(axis) if name.rsplit("/", 1)[-1]
                   in ("wide", "deep") else ())
            for name in names}


loss = ctr_loss


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def eval_metrics_fn():
    return ctr_metrics()
