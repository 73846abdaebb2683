"""Criteo xDeepFM (counterpart of elasticdl_tpu/models/dac_ctr/xdeepfm.py):
a Compressed Interaction Network, a DNN and the first-order logits. CIN
layer k computes X^{k+1}[b,h,d] = sum_{i,j} W^k[h,i,j] X^k[b,i,d] X^0[b,j,d]
as one einsum, and each layer's output summed over d joins the head.
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
    NUM_FIELDS,
    TOTAL_IDS,
    feed,
)
from elasticdl_tpu_torch.ops import optimizers


class CIN(nn.Module):
    """Layer weights w{k} of shape [h, F_k, F_0] (normal, std 0.01), the
    flax layout."""

    def __init__(self, num_fields, layer_sizes=(16, 16)):
        super().__init__()
        self.layer_sizes = tuple(layer_sizes)
        fields = num_fields
        for k, h in enumerate(self.layer_sizes):
            self.register_parameter(
                f"w{k}", nn.Parameter(torch.empty(h, fields, num_fields)))
            fields = h

    def init_weights(self, generator):
        with torch.no_grad():
            for k in range(len(self.layer_sizes)):
                getattr(self, f"w{k}").normal_(0.0, 0.01,
                                               generator=generator)

    def forward(self, x0):  # x0: [B, F, D] field embeddings
        xk, pooled = x0, []
        for k in range(len(self.layer_sizes)):
            xk = torch.einsum("hij,bid,bjd->bhd", getattr(self, f"w{k}"),
                              xk, x0)
            pooled.append(xk.sum(dim=2))  # [B, h]
        return torch.cat(pooled, dim=1)


class XDeepFM(nn.Module):
    def __init__(self, deep_dim=8, cin_layer_sizes=(16, 16),
                 dnn_hidden_units=(16, 4), vocab=None):
        super().__init__()
        self.CTREmbeddings_0 = CTREmbeddings(deep_dim, vocab or TOTAL_IDS)
        self.CIN_0 = CIN(NUM_FIELDS, cin_layer_sizes)
        self.DNN_0 = DNN(dnn_input_width(deep_dim), dnn_hidden_units)
        self.Dense_0 = nn.Linear(
            sum(cin_layer_sizes) + dnn_hidden_units[-1], 1, bias=False)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)
        self.CTREmbeddings_0.init_weights(generator)
        self.CIN_0.init_weights(generator)

    def forward(self, features):
        linear_logits, field_embs, dense = self.CTREmbeddings_0(features)
        head = torch.cat([
            self.CIN_0(field_embs),
            self.DNN_0(concat_dense_fields(dense, field_embs)),
        ], dim=1)
        return linear_logits.sum(dim=1) + self.Dense_0(head).reshape(-1)


def custom_model():
    """The model on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return XDeepFM()


loss = ctr_loss


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def eval_metrics_fn():
    return ctr_metrics()
