"""ResNet-50 (counterpart of elasticdl_tpu/models/resnet50/resnet50.py), the
throughput workload: bottleneck v1, stages [3, 4, 6, 3], convs in the
activation dtype (bfloat16 by default; the parameters stay float32),
BatchNorm in float32 (momentum 0.9, eps 1e-5) cast back to the activation
dtype, a zero-initialized scale on each block's last BatchNorm, a
`proj`/`proj_bn` shortcut where the shape changes, the 7x7/2 stem with
explicit (3, 3) padding, a SAME 3x3/2 max-pool (XLA's (0, 1) split), a
spatial mean and a Dense head in its parameters' dtype (float32; a model
moved to float64 with dtype="float64" computes in float64 throughout, which
is how a float64 reference runs it); momentum SGD 0.1/0.9.

Features arrive NHWC from the feed; the model permutes them once to NCHW,
which keeps them NHWC in memory (channels_last), so on the card cuDNN runs
its NHWC kernels and every layer after keeps that format. Submodules carry
flax's names (Conv_0, BatchNorm_0, BottleneckBlock_0/Conv_1, .../proj_bn,
Dense_0) for the weight bridge.
"""

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import accuracy_metric
from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.example import batch_examples
from elasticdl_tpu_torch.layers.conv import BatchNorm, Conv, max_pool
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.common import softmax_cross_entropy
from elasticdl_tpu_torch.ops import optimizers

NUM_CLASSES = 1000
STAGE_SIZES = [3, 4, 6, 3]  # ResNet-50


def _norm(features, **kwargs):
    return BatchNorm(features, momentum=0.9, epsilon=1e-5, **kwargs)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features, filters, strides=1, dtype="bfloat16"):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        out = 4 * filters
        self.Conv_0 = Conv(in_features, filters, (1, 1), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = _norm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides=strides,
                           use_bias=False, dtype=dtype)
        self.BatchNorm_1 = _norm(filters)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False, dtype=dtype)
        self.BatchNorm_2 = _norm(out, zero_scale=True)
        # flax compares the shapes at run time; they differ exactly when
        # the stride or the channel count changes.
        if strides != 1 or in_features != out:
            self.proj = Conv(in_features, out, (1, 1), strides=strides,
                             use_bias=False, dtype=dtype)
            self.proj_bn = _norm(out)
        else:
            self.proj = None

    def forward(self, x):
        dtype = self.dtype
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)).to(dtype))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)).to(dtype))
        y = self.BatchNorm_2(self.Conv_2(y)).to(dtype)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(self.proj(x)).to(dtype)
        return F.relu(residual + y)


class ResNet50(nn.Module):
    def __init__(self, num_classes=NUM_CLASSES, dtype="bfloat16"):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.Conv_0 = Conv(3, 64, (7, 7), strides=2,
                           padding=((3, 3), (3, 3)), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = _norm(64)
        in_features, i = 64, 0
        for stage, block_count in enumerate(STAGE_SIZES):
            for block in range(block_count):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = 64 * 2**stage
                self.add_module(f"BottleneckBlock_{i}", BottleneckBlock(
                    in_features, filters, strides, dtype))
                in_features, i = 4 * filters, i + 1
        self.num_blocks = i
        self.Dense_0 = nn.Linear(in_features, num_classes)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)).to(self.dtype))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for i in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x.to(self.Dense_0.weight.dtype))


def custom_model():
    with torch.device("meta"):
        return ResNet50()


loss = softmax_cross_entropy


def optimizer(lr=0.1):
    return optimizers.momentum(learning_rate=lr, momentum_value=0.9)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    features = batch["image"].astype("float32")
    labels = batch["label"] if mode != Modes.PREDICTION else None
    return features, labels


def eval_metrics_fn():
    return {"accuracy": accuracy_metric()}
