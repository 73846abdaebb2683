"""Shared pieces of the dac_ctr family (counterpart of
elasticdl_tpu/models/dac_ctr/common.py): the DNN tower, the DeepFM head,
the FM interaction, the CTR loss and metrics.

Submodules carry flax's names (DNN_0 holding Dense_0, Dense_1, ...), so
common/params.py maps wire names to them mechanically. flax's Dense
defaults are kept: lecun-normal kernels (a normal truncated at two standard
deviations) and zero biases. CTREmbeddings and the other heads (wide&deep,
DCN, xDeepFM) are not ported yet.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import AUCMetric, MeanMetric

# Standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def init_dense_layers(module, generator):
    """flax's Dense initializers on every nn.Linear under `module`, drawn
    from `generator` (which lives on the parameters' device)."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            std = mod.in_features**-0.5 / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            if mod.bias is not None:
                with torch.no_grad():
                    mod.bias.zero_()


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
    dnn_input = torch.cat(
        [dense, field_embs.reshape(field_embs.shape[0], -1)], dim=1)
    dnn_logit = out(dnn(dnn_input))
    return linear_logits.sum(dim=1) + fm + dnn_logit.reshape(-1)


def ctr_loss(labels, logits):
    """Mean sigmoid binary cross-entropy (optax's, in its stable form)."""
    labels = torch.as_tensor(labels, device=logits.device)
    return F.binary_cross_entropy_with_logits(
        logits.reshape(-1), labels.reshape(-1).to(logits.dtype))


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
