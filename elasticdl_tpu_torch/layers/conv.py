"""What flax.linen gives the JAX package's image models, in PyTorch: `Conv`,
`BatchNorm` and `max_pool` (flax's default initializers are in
layers/init.py). The port's own module: the JAX package has no file of its
own for these.

Tensors are NCHW here (on the card the models hand them over in
channels_last memory, which is NHWC in memory, so cuDNN takes its NHWC
kernels); the models permute the feed's NHWC images once at their entry.

Where flax differs from torch's stock layers, these follow flax:
- SAME padding is XLA's: the total padding of a spatial axis is
  max((ceil(n / s) - 1) * s + k - n, 0), split low = total // 2,
  high = total - low. Under stride 2 on an even input a 3x3 window gets
  (0, 1), where torch's padding=1 gives (1, 1): the same output shape with
  every window one pixel off. Asymmetric padding goes through F.pad (zeros
  for a conv, -inf for a max-pool).
- `Conv(dtype=...)` casts its input, kernel and bias to `dtype` and computes
  in it (flax's promote_dtype); the parameters stay float32.
- `BatchNorm` is flax's nn.BatchNorm with force_float32_reductions and
  use_fast_variance: the batch statistics in float32 as
  var = max(0, E[x^2] - E[x]^2), the running statistics updated with that
  biased variance as ra = m * ra + (1 - m) * batch (torch's BatchNorm2d uses
  the unbiased variance and the momentum 1 - m), no num_batches_tracked,
  and y = (x - mean) * (rsqrt(var + eps) * scale) + bias in float32. Its
  buffers `mean` and `var` are the flax `batch_stats` leaves of the same
  names (common/params.py). In eval mode it reads them and updates nothing.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.parallel.collectives import all_reduce_sum

def same_pads(size, kernel, stride):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x, kernel, strides, padding):
    """((low_h, high_h), (low_w, high_w)) for an NCHW input."""
    if padding == "SAME":
        return tuple(same_pads(x.shape[2 + i], kernel[i], strides[i])
                     for i in range(2))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    return tuple(tuple(p) for p in padding)


def _pad(x, pads, value):
    """x padded by `pads`; returns (x, symmetric padding left to the op)."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        return x, (lh, lw)
    return F.pad(x, (lw, hw, lh, hh), value=value), (0, 0)


class Conv(nn.Conv2d):
    """flax nn.Conv over NCHW: `padding` "SAME" (flax's default), "VALID"
    or ((low_h, high_h), (low_w, high_w)); `groups` is flax's
    feature_group_count. The weight is torch's [out, in/groups, kh, kw]
    (flax's kernel is [kh, kw, in/groups, out]; common/params.py moves it
    between the two)."""

    def __init__(self, in_features, features, kernel_size, strides=1,
                 padding="SAME", use_bias=True, groups=1, dtype=None):
        kernel_size = tuple(kernel_size)
        strides = (strides, strides) if isinstance(strides, int) \
            else tuple(strides)
        super().__init__(in_features, features, kernel_size, stride=strides,
                         groups=groups, bias=use_bias)
        self.flax_padding = padding
        self.compute_dtype = None if dtype is None else getattr(torch, dtype)

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            weight = weight.to(self.compute_dtype)
            bias = None if bias is None else bias.to(self.compute_dtype)
        pads = _pads(x, self.kernel_size, self.stride, self.flax_padding)
        x, padding = _pad(x, pads, 0.0)
        return F.conv2d(x, weight, bias, self.stride, padding, 1,
                        self.groups)


def max_pool(x, window, strides, padding="VALID"):
    """flax nn.max_pool over NCHW (SAME pads with -inf)."""
    pads = _pads(x, window, strides, padding)
    x, padding = _pad(x, pads, -math.inf)
    return F.max_pool2d(x, window, strides, padding)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the channel axis of NCHW input, output in
    float32 (the models cast it back to their activation dtype). The
    training forward updates `mean` and `var` under no_grad; the gradient
    flows through the batch statistics, as in flax.

    `stats_group` (set by `bind_batch_stats`) makes the statistics the
    global batch's: E[x] and E[x^2] in f32 are averaged over the group's
    members (equal batch shards) by a differentiable all-reduce
    (parallel/collectives.py), so the backward sums too and every member's
    running statistics come out equal. None (the default) takes them over
    the module's own batch."""

    stats_group = None

    def __init__(self, features, momentum=0.99, epsilon=1e-5,
                 zero_scale=False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.zero_scale = zero_scale  # flax's scale_init=zeros
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def init_flax(self, generator=None):
        """flax's initializers (layers/init.py calls this): scale ones
        (zeros with zero_scale), bias zeros, running mean 0 and variance
        1."""
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        if self.training:
            # The statistics read one copy of x promoted to at least
            # float32; the normalization below promotes x itself. On
            # bfloat16 input the two paths' gradients thus meet in bfloat16,
            # as in flax (whose _compute_stats casts and whose _normalize
            # promotes).
            dims = (0, 2, 3)
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xs.mean(dims)
            group = self.stats_group
            if group is not None and group.size > 1:
                both = all_reduce_sum(torch.stack(
                    [mean, torch.square(xs).mean(dims)]), group) / group.size
                mean, mean_sq = both[0], both[1]
                var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
            else:
                var = torch.clamp_min(torch.square(xs).mean(dims)
                                      - torch.square(mean), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def bind_batch_stats(model, group):
    """Sets every BatchNorm of `model` to take its statistics over `group`
    (None: over its own batch). Returns the number of BatchNorms."""
    count = 0
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.stats_group = group
            count += 1
    return count
