"""flax's default initializers for the port's modules: lecun-normal
kernels (`lecun_normal_`) and `init_flax_defaults`, which the zoo models and
the CTR heads draw their weights from; and `materialize`, which gives a
model built on the meta device its storage.
"""

import torch
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated-normal variance_scaling divides the stddev by it.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight, fan_in, generator):
    """flax's default kernel initializer (variance_scaling(1, fan_in,
    truncated_normal): a normal truncated to two of its standard
    deviations), in place. Drawn by rejection: each value outside the
    bounds is drawn again until none is, which gives the truncated
    distribution at a fraction of nn.init.trunc_normal_'s cost on large
    kernels."""
    std = fan_in**-0.5 / _TRUNC_STD
    with torch.no_grad():
        flat = weight.view(-1)
        flat.normal_(0.0, std, generator=generator)
        redraw = (flat.abs() > 2 * std).nonzero().squeeze(1)
        while redraw.numel():
            values = torch.empty(redraw.numel(), device=flat.device,
                                 dtype=flat.dtype).normal_(
                0.0, std, generator=generator)
            flat[redraw] = values
            redraw = redraw[values.abs() > 2 * std]


def init_flax_defaults(module, generator):
    """flax's default initializers on every conv, nn.Linear and
    nn.Embedding under `module`, drawn from `generator` (which lives on the
    parameters' device): lecun-normal kernels, zero biases, embeddings
    normal with stddev 1/sqrt(features) (flax's default_embed_init); a
    module with initializers of its own (layers/conv.py's BatchNorm,
    layers/moe.py's experts, an embedding column's table) applies them
    through its `init_flax(generator)` instead. The draws differ from
    flax's: parity with the JAX package needs imported weights."""
    for mod in module.modules():
        if hasattr(mod, "init_flax"):
            mod.init_flax(generator)
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            lecun_normal_(mod.weight, fan_in, generator)
            if mod.bias is not None:
                with torch.no_grad():
                    mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            with torch.no_grad():
                mod.weight.normal_(0.0, mod.embedding_dim**-0.5,
                                   generator=generator)


def materialize(module, device):
    """Module.to_empty(device) for a module built on the meta device:
    uninitialized storage for every parameter and buffer, shared ones kept
    shared. torch.empty from each shape, where to_empty's empty_like of a
    meta tensor goes through torch._refs and imports sympy (4.2 s of a
    worker's start on an H100 host, PERF.md)."""
    made = {}

    def empty(t):
        if id(t) not in made:
            made[id(t)] = torch.empty(t.shape, dtype=t.dtype, device=device)
        return made[id(t)]

    params = {}
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                if id(p) not in params:
                    params[id(p)] = nn.Parameter(empty(p), p.requires_grad)
                mod._parameters[name] = params[id(p)]
        for name, b in list(mod._buffers.items()):
            if b is not None:
                mod._buffers[name] = empty(b)
    return module
