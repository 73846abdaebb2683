"""DeepFM with PS-resident tables (counterpart of elasticdl_tpu/models/
deepfm/deepfm_distributed.py): the first-order weights (`fm_linear`, dim 1)
and the FM factors (`fm_factors`, dim D) live in the parameter server as
DistributedEmbedding tables (layers/embedding.py), so the vocabulary never
reaches the device; the rest is deepfm_functional's. `embedding_inputs`
feeds the PS trainer's pulls."""

import torch
from torch import nn

from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.layers.embedding import DistributedEmbedding
from elasticdl_tpu_torch.models.common import add_dense_layers, dense_tower
from elasticdl_tpu_torch.models.dac_ctr.common import fm_interaction
from elasticdl_tpu_torch.models.deepfm.deepfm_functional import (  # noqa: F401
    EMB_DIM,
    FIELDS,
    eval_metrics_fn,
    feed,
    loss,
    make_records,
    optimizer,
)


class DeepFMDistributed(nn.Module):
    def __init__(self, emb_dim=EMB_DIM):
        super().__init__()
        self.DistributedEmbedding_0 = DistributedEmbedding("fm_linear", 1)
        self.DistributedEmbedding_1 = DistributedEmbedding("fm_factors",
                                                           emb_dim)
        add_dense_layers(self, FIELDS * emb_dim, (64, 32, 1))

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, ids, rows):
        linear = self.DistributedEmbedding_0(ids, rows).sum(dim=(1, 2))
        v = self.DistributedEmbedding_1(ids, rows)  # [B, F, D]
        deep = dense_tower(self, v.reshape(v.shape[0], -1), 3).reshape(-1)
        return linear + fm_interaction(v) + deep


def custom_model():
    with torch.device("meta"):
        return DeepFMDistributed()


def embedding_inputs(features):
    """Both PS tables key off the same field-id array."""
    return {"fm_linear": features, "fm_factors": features}
