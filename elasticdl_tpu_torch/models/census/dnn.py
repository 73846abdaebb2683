"""Census DNN (counterpart of elasticdl_tpu/models/census/dnn.py): dim-16
embeddings of the census ids -> Dense 64 -> Dense 32 -> Dense 1; Adam 1e-3.
The feed and records are wide_deep's."""

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.census.wide_deep import (  # noqa: F401
    NUM_GROUPS,
    TOTAL_IDS,
    eval_metrics_fn,
    feed,
    make_records,
)
from elasticdl_tpu_torch.models.common import (
    add_dense_layers,
    dense_tower,
    sigmoid_cross_entropy,
)
from elasticdl_tpu_torch.ops import optimizers

EMB_DIM = 16


class CensusDNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Parameter(torch.empty(TOTAL_IDS, EMB_DIM))
        add_dense_layers(self, NUM_GROUPS * EMB_DIM, (64, 32, 1))

    def init_weights(self, generator):
        init_flax_defaults(self, generator)
        with torch.no_grad():
            self.emb.uniform_(0.0, 0.05, generator=generator)

    def forward(self, features):
        ids = features["ids"].long()
        x = F.embedding(ids, self.emb).reshape(ids.shape[0], -1)
        return dense_tower(self, x, 3).reshape(-1)


def custom_model():
    with torch.device("meta"):
        return CensusDNN()


loss = sigmoid_cross_entropy


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)
