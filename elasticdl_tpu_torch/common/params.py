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
  any other   the same    a parameter the module declares itself, by its
                          flax name, unchanged: a local DistributedEmbedding
                          `table`, CTREmbeddings' `wide` [V, 1] and `deep`
                          [V, D], DCN's cross `w{i}`/`b{i}` [d], xDeepFM's
                          CIN `w{k}` [h, F_k, F_0] (no transpose)

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
        if leaf == "weight":
            raise ValueError(f"no torch counterpart for flax leaf {name!r}")
        key = ".".join(path + [_LEAF_TO_TORCH.get(leaf, leaf)])
        state[key] = FlaxLeaf(name, None, leaf, None).from_flax(value)
    return state


class FlaxLeaf:
    """One parameter of a torch module as a flax leaf: its wire name, the
    parameter, and the layout maps between the two frameworks, which also
    carry anything shaped like the parameter (an optimizer's moments)."""

    __slots__ = ("name", "param", "leaf", "features")

    def __init__(self, name, param, leaf, features):
        self.name = name
        self.param = param
        self.leaf = leaf
        self.features = features

    def to_flax(self, value):
        """torch-layout tensor -> flax-layout tensor (same device)."""
        if self.leaf == "kernel":
            value = value.T
            if self.features is not None:
                value = value.reshape(value.shape[0], *self.features)
        elif self.leaf == "bias" and self.features is not None:
            value = value.reshape(self.features)
        return value

    def from_flax(self, value):
        """flax-layout array (or tensor) -> torch-layout float32 CPU
        tensor."""
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = np.asarray(value, np.float32)
        if self.leaf == "kernel":
            value = value.reshape(value.shape[0], -1).T
        elif self.leaf == "bias":
            value = value.reshape(-1)
        return torch.tensor(value)


def flax_leaves(module):
    """Every parameter of `module` as a FlaxLeaf, in the order jax flattens
    the flax params tree (dict keys sorted at every level).

    The module tells which flax leaf each weight is: an nn.Linear's weight
    is a kernel (reshaped to [in, *features] where the module carries a
    `features` tuple, as a DenseGeneral does), an nn.Embedding's an
    embedding, any other weight a LayerNorm scale. Any other parameter
    keeps its name as the flax leaf's."""
    leaves = []
    for mod_name, mod in module.named_modules():
        prefix = mod_name.replace(".", "/")
        features = getattr(mod, "features", None)
        for leaf_name, param in mod.named_parameters(recurse=False):
            if leaf_name == "weight":
                if isinstance(mod, nn.Linear):
                    leaf = "kernel"
                elif isinstance(mod, nn.Embedding):
                    leaf = "embedding"
                else:
                    leaf = "scale"
            else:
                leaf = leaf_name
            name = f"{prefix}/{leaf}" if prefix else leaf
            leaves.append(FlaxLeaf(name, param, leaf, features))
    return sorted(leaves, key=lambda x: tuple(x.name.split("/")))


def leaves_to_flax(leaves):
    """FlaxLeafs -> {wire name: float32 numpy array}. The arrays are
    copies, as jax.device_get's are: on the CPU a view would follow the
    parameters as they train."""
    return {
        x.name: np.ascontiguousarray(
            x.to_flax(x.param.detach()).float().to("cpu", copy=True).numpy()
        )
        for x in leaves
    }


def params_to_flax(module):
    """The inverse of params_from_flax: module -> {flax wire name: float32
    numpy array}."""
    return leaves_to_flax(flax_leaves(module))
