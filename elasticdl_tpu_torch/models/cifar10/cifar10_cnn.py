"""CIFAR-10 CNN (counterpart of elasticdl_tpu/models/cifar10/cifar10_cnn.py):
three stages of (SAME 3x3 conv, BatchNorm with eps 1e-6 and momentum 0.9,
relu) x 2, a 2x2 max-pool and Dropout 0.2 at 32, 64 and 128 channels, the
flatten in NHWC order, a Dense head; Adam 1e-3.

Dropout draws torch's bits, not jax's: the same rate, other masks (a
documented divergence; with dropout off the two packages agree).
"""

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import accuracy_metric
from elasticdl_tpu_torch.layers.conv import BatchNorm, Conv, max_pool
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.common import (
    image_feed,
    softmax_cross_entropy,
)
from elasticdl_tpu_torch.ops import optimizers

NUM_CLASSES = 10
CHANNELS = (32, 64, 128)
DROPOUT_RATE = 0.2


class Cifar10CNN(nn.Module):
    def __init__(self, num_classes=NUM_CLASSES):
        super().__init__()
        in_features = 3
        for stage, channels in enumerate(CHANNELS):
            for j in range(2):
                i = 2 * stage + j
                self.add_module(f"Conv_{i}", Conv(in_features, channels,
                                                  (3, 3)))
                self.add_module(f"BatchNorm_{i}", BatchNorm(
                    channels, momentum=0.9, epsilon=1e-6))
                in_features = channels
        self.Dense_0 = nn.Linear(4 * 4 * CHANNELS[-1], num_classes)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], 32, 32, 3).permute(0, 3, 1, 2)
        for stage in range(len(CHANNELS)):
            for j in range(2):
                i = 2 * stage + j
                x = getattr(self, f"Conv_{i}")(x)
                x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
            x = max_pool(x, (2, 2), (2, 2))
            x = F.dropout(x, DROPOUT_RATE, self.training)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        return self.Dense_0(x)


def custom_model():
    with torch.device("meta"):
        return Cifar10CNN()


loss = softmax_cross_entropy


def optimizer(lr=0.001):
    return optimizers.adam(learning_rate=lr)


def feed(records, mode, metadata):
    return image_feed(records, mode)


def eval_metrics_fn():
    return {"accuracy": accuracy_metric()}

