"""MNIST CNN, the zoo's hello-world model (counterpart of
elasticdl_tpu/models/mnist/mnist_model.py): two SAME 3x3 convs (32, 64),
BatchNorm (flax's defaults: momentum 0.99, eps 1e-5), a 2x2 max-pool, the
flatten in NHWC order, Dense 1024 and Dense 10; momentum SGD 0.01.

Submodules carry flax's names (Conv_0, Conv_1, BatchNorm_0, Dense_0,
Dense_1) for the weight bridge (common/params.py). custom_model() returns
the module on the meta device; the trainer materializes it and initializes
it from its seed (init_weights).
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


class MnistCNN(nn.Module):
    def __init__(self, num_classes=10):
        super().__init__()
        self.Conv_0 = Conv(1, 32, (3, 3))
        self.Conv_1 = Conv(32, 64, (3, 3))
        self.BatchNorm_0 = BatchNorm(64)
        self.Dense_0 = nn.Linear(14 * 14 * 64, 1024)
        self.Dense_1 = nn.Linear(1024, num_classes)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, x):
        # [B, 28*28] or [B, 28, 28] -> NCHW.
        x = x.reshape(x.shape[0], 28, 28, 1).permute(0, 3, 1, 2)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = self.BatchNorm_0(x)
        x = max_pool(x, (2, 2), (2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)


def custom_model():
    with torch.device("meta"):
        return MnistCNN()


loss = softmax_cross_entropy


def optimizer(lr=0.01):
    return optimizers.momentum(learning_rate=lr)


def feed(records, mode, metadata):
    return image_feed(records, mode)


def eval_metrics_fn():
    return {"accuracy": accuracy_metric()}

