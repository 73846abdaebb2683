"""MobileNetV2 (counterpart of elasticdl_tpu/models/mobilenetv2/
mobilenetv2.py) at ImageNet shapes: the V2 paper's block table, channel
counts through _round_channels, inverted residual blocks (1x1 expansion
where the expansion is not 1, depthwise 3x3 (groups = hidden channels),
linear 1x1 projection; the residual only at stride 1 with matching
channels), relu6, the 1280-channel head, a spatial mean and a Dense head
in its parameters' dtype (float32, as in resnet50.py). Convs in the
activation dtype (bfloat16 by default), BatchNorm in float32 (momentum 0.9,
eps 1e-5) cast back; momentum SGD 0.05/0.9.

The stem and the strided depthwise convs pad SAME as XLA does ((0, 1) on an
even input at stride 2; layers/conv.py). Features arrive NHWC and stay NHWC
in memory after the one permute at the entry (channels_last). Submodules
carry flax's names (Conv_0, BatchNorm_0, InvertedResidual_0/Conv_0, ...).
"""

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import accuracy_metric
from elasticdl_tpu_torch.layers.conv import BatchNorm, Conv
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.common import softmax_cross_entropy
from elasticdl_tpu_torch.models.resnet50.resnet50 import feed  # noqa: F401
from elasticdl_tpu_torch.ops import optimizers

# (expansion t, out channels c, repeats n, stride s): the V2 paper's table.
_BLOCKS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _round_channels(c, multiplier, divisor=8):
    c = c * multiplier
    rounded = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if rounded < 0.9 * c:
        rounded += divisor
    return int(rounded)


def _norm(features):
    return BatchNorm(features, momentum=0.9)


class InvertedResidual(nn.Module):
    def __init__(self, in_channels, out_channels, stride, expansion,
                 dtype="bfloat16"):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.residual = stride == 1 and in_channels == out_channels
        hidden = in_channels * expansion
        convs = []
        if expansion != 1:
            convs.append(Conv(in_channels, hidden, (1, 1), use_bias=False,
                              dtype=dtype))
        convs.append(Conv(hidden, hidden, (3, 3), strides=stride,
                          use_bias=False, groups=hidden, dtype=dtype))
        convs.append(Conv(hidden, out_channels, (1, 1), use_bias=False,
                          dtype=dtype))
        self.num_convs = len(convs)
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}", _norm(conv.out_channels))

    def forward(self, x):
        y = x
        for i in range(self.num_convs):
            y = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(y))
            y = y.to(self.dtype)
            if i < self.num_convs - 1:  # the projection is linear
                y = F.relu6(y)
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self, num_classes=1000, width_multiplier=1.0,
                 dtype="bfloat16"):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        channels = _round_channels(32, width_multiplier)
        self.Conv_0 = Conv(3, channels, (3, 3), strides=2, use_bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = _norm(channels)
        i = 0
        for t, c, n, s in _BLOCKS:
            out = _round_channels(c, width_multiplier)
            for j in range(n):
                self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                    channels, out, s if j == 0 else 1, t, dtype))
                channels, i = out, i + 1
        self.num_blocks = i
        head = _round_channels(1280, max(1.0, width_multiplier))
        self.Conv_1 = Conv(channels, head, (1, 1), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = _norm(head)
        self.Dense_0 = nn.Linear(head, num_classes)

    def init_weights(self, generator):
        init_flax_defaults(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.relu6(self.BatchNorm_0(self.Conv_0(x)).to(self.dtype))
        for i in range(self.num_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = F.relu6(self.BatchNorm_1(self.Conv_1(x)).to(self.dtype))
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x.to(self.Dense_0.weight.dtype))


def custom_model():
    with torch.device("meta"):
        return MobileNetV2()


loss = softmax_cross_entropy


def optimizer(lr=0.05):
    return optimizers.momentum(learning_rate=lr, momentum_value=0.9)


def eval_metrics_fn():
    return {"accuracy": accuracy_metric()}
