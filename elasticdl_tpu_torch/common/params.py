"""Weight bridge between the JAX package's flax parameters and torch modules.

Flax parameters travel as a flat {wire name: array} dict, the names being
'/'-joined paths as elasticdl_tpu/common/pytree_utils.py:flatten_params
makes them ('Block_0/Dense_1/kernel'). The port names its submodules as
flax does (Block_0, MultiHeadAttention_0, Dense_1, ...), so a wire name maps
to a state_dict key by joining with '.' and renaming the leaf:

  flax leaf   torch leaf  layout
  kernel      weight      [in, *out] -> [prod(out), in] (nn.Linear)
  bias        bias        [*out] -> [prod(out)]
  scale       weight      LayerNorm scale, unchanged
  embedding   weight      [num, features], unchanged

A DenseGeneral kernel such as the LM's qkv [d, 3, H, Dh] flattens its
output axes in order, which is the (3, H, Dh) order the model splits.
"""

import numpy as np
import torch
from torch import nn

_LEAF_TO_TORCH = {"kernel": "weight", "bias": "bias", "scale": "weight",
                  "embedding": "weight"}


def params_from_flax(named):
    """{flax wire name: array} -> state_dict of float32 CPU tensors."""
    state = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        if leaf not in _LEAF_TO_TORCH:
            raise ValueError(f"no torch counterpart for flax leaf {name!r}")
        value = np.asarray(value, np.float32)
        if leaf == "kernel":
            value = value.reshape(value.shape[0], -1).T
        elif leaf == "bias":
            value = value.reshape(-1)
        key = ".".join(path + [_LEAF_TO_TORCH[leaf]])
        state[key] = torch.tensor(value)
    return state


def params_to_flax(module):
    """The inverse: module -> {flax wire name: float32 numpy array}.

    The module tells which flax leaf each weight is: an nn.Linear's weight
    is a kernel (reshaped to [in, *features] where the module carries a
    `features` tuple, as a DenseGeneral does), an nn.Embedding's an
    embedding, any other weight a LayerNorm scale."""
    named = {}
    for mod_name, mod in module.named_modules():
        prefix = mod_name.replace(".", "/")
        features = getattr(mod, "features", None)
        for leaf_name, param in mod.named_parameters(recurse=False):
            value = param.detach().float().cpu().numpy()
            if leaf_name == "weight":
                if isinstance(mod, nn.Linear):
                    leaf, value = "kernel", value.T
                    if features is not None:
                        value = value.reshape(value.shape[0], *features)
                elif isinstance(mod, nn.Embedding):
                    leaf = "embedding"
                else:
                    leaf = "scale"
            elif leaf_name == "bias":
                leaf = "bias"
                if features is not None:
                    value = value.reshape(features)
            else:
                raise ValueError(
                    f"no flax counterpart for {mod_name}.{leaf_name}"
                )
            name = f"{prefix}/{leaf}" if prefix else leaf
            named[name] = np.ascontiguousarray(value)
    return named
