"""Criteo Deep & Cross (counterpart of elasticdl_tpu/models/dac_ctr/dcn.py):
rank-1 cross layers x_{l+1} = x_0 * (x_l . w_l) + b_l + x_l over the
[dense, field embeddings] vector, beside a DNN tower; one output layer over
both, plus the first-order logits.
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


class CrossNetwork(nn.Module):
    """Cross layers with weights w{i} (normal, std 0.01) and biases b{i}
    (zeros), each of the input's width, as flax names them."""

    def __init__(self, dim, num_layers=3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w{i}", nn.Parameter(torch.empty(dim)))
            self.register_parameter(f"b{i}", nn.Parameter(torch.empty(dim)))

    def init_weights(self, generator):
        with torch.no_grad():
            for i in range(self.num_layers):
                getattr(self, f"w{i}").normal_(0.0, 0.01,
                                               generator=generator)
                getattr(self, f"b{i}").zero_()

    def forward(self, x0):
        x = x0
        for i in range(self.num_layers):
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            x = x0 * (x @ w)[:, None] + b + x
        return x


class DCN(nn.Module):
    def __init__(self, deep_dim=8, num_cross_layers=3,
                 dnn_hidden_units=(16, 4), vocab=None):
        super().__init__()
        width = dnn_input_width(deep_dim)
        self.CTREmbeddings_0 = CTREmbeddings(deep_dim, vocab or TOTAL_IDS)
        self.CrossNetwork_0 = CrossNetwork(width, num_cross_layers)
        self.DNN_0 = DNN(width, dnn_hidden_units)
        self.Dense_0 = nn.Linear(width + dnn_hidden_units[-1], 1, bias=False)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)
        self.CTREmbeddings_0.init_weights(generator)
        self.CrossNetwork_0.init_weights(generator)

    def forward(self, features):
        linear_logits, field_embs, dense = self.CTREmbeddings_0(features)
        x0 = concat_dense_fields(dense, field_embs)
        head = torch.cat([self.CrossNetwork_0(x0), self.DNN_0(x0)], dim=1)
        return linear_logits.sum(dim=1) + self.Dense_0(head).reshape(-1)


def custom_model():
    """The model on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return DCN()


loss = ctr_loss


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def eval_metrics_fn():
    return ctr_metrics()
