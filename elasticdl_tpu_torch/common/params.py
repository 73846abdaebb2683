"""Weight bridge between the JAX package's flax parameters and torch modules.

Flax parameters travel as a flat {wire name: array} dict, the names being
'/'-joined paths as elasticdl_tpu/common/pytree_utils.py:flatten_params
makes them ('Block_0/Dense_1/kernel'). The port names its submodules as
flax does (Block_0, MultiHeadAttention_0, Dense_1, ...), so a wire name maps
to a state_dict key by joining with '.' and renaming the leaf:

  flax leaf   torch leaf  layout
  kernel      weight      [in, *out] -> [prod(out), in] (nn.Linear)
  kernel      weight      [kh, kw, in/groups, out] -> [out, in/groups,
                          kh, kw] (a Conv2d, layers/conv.py; a depthwise
                          kernel is [kh, kw, 1, C] <-> [C, 1, kh, kw])
  bias        bias        [*out] -> [prod(out)]
  scale       weight      LayerNorm or BatchNorm scale, unchanged
  embedding   weight      [num, features], unchanged
  any other   the same    a parameter the module declares itself, by its
                          flax name, unchanged: a local DistributedEmbedding
                          or SparseEmbedding `table`, CTREmbeddings' `wide`
                          [V, 1] and `deep` [V, D], DCN's cross `w{i}`/`b{i}`
                          [d], xDeepFM's CIN `w{k}` [h, F_k, F_0], SwitchMoE's
                          `w_in` [E, D, H] and `w_out` [E, H, D] (no
                          transpose)

The MoE LM's expert layer is MoEBlock_k/SwitchMoE_0: its `router` is an
nn.Linear, so router/kernel [D, E] is a Dense kernel (transposed), and
w_in/w_out are raw params. flax numbers Block_i and MoEBlock_i apart, so
the port's module names carry that count (models/transformer/moe_lm.py).
A feature-column table is `<scope>/emb_<key>/embedding` (an nn.Embedding
in a DenseFeatures named `wide` or `deep`).

A DenseGeneral kernel such as the LM's qkv [d, 3, H, Dh] flattens its
output axes in order, which is the (3, H, Dh) order the model splits. It is
4-D like a conv kernel: the module, not the array's rank, decides the
layout (`params_from_flax(named, module)`, `load_flax`).

Non-parameter state is flax's `batch_stats` collection: every buffer of a
module (BatchNorm's `mean` and `var`) is the leaf of the same name under
"batch_stats/<module path>", unchanged in layout (`state_to_flax`,
`state_from_flax`). flax keeps no num_batches_tracked, and nor does the
port's BatchNorm.
"""

import numpy as np
import torch
from torch import nn

_LEAF_TO_TORCH = {"kernel": "weight", "bias": "bias", "scale": "weight",
                  "embedding": "weight"}


STATE_COLLECTION = "batch_stats"


def params_from_flax(named, module):
    """{flax wire name: array} -> state_dict of float32 CPU tensors for
    `module`, each leaf in the layout of the module's parameter of that
    name."""
    layouts = {x.name: x for x in flax_leaves(module)}
    state = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        if leaf == "weight" or name not in layouts:
            raise ValueError(f"no torch counterpart for flax leaf {name!r}")
        key = ".".join(path + [_LEAF_TO_TORCH.get(leaf, leaf)])
        state[key] = layouts[name].from_flax(value)
    return state


def state_to_flax(module):
    """The module's buffers as flax state: {"batch_stats/<path>/<buffer>":
    float32 numpy copy}, in jax's flatten order (empty without buffers)."""
    return {
        f"{STATE_COLLECTION}/{name.replace('.', '/')}":
            buf.detach().float().to("cpu", copy=True).numpy()
        for name, buf in sorted(module.named_buffers(),
                                key=lambda kv: tuple(kv[0].split(".")))
    }


def state_from_flax(state):
    """The inverse of state_to_flax: {"batch_stats/...": array} ->
    {buffer key: float32 CPU tensor}."""
    out = {}
    prefix = STATE_COLLECTION + "/"
    for name, value in state.items():
        if not name.startswith(prefix):
            raise ValueError(f"no torch counterpart for flax state {name!r}")
        out[name[len(prefix):].replace("/", ".")] = torch.tensor(
            np.asarray(value, np.float32))
    return out


def load_flax(module, named, state=None):
    """Loads flax-named weights, and the `batch_stats` state where given,
    into `module` in place (the buffers keep their values without it)."""
    tensors = dict(module.named_buffers()) if state is None \
        else state_from_flax(state)
    tensors.update(params_from_flax(named, module))
    module.load_state_dict(tensors)


class FlaxLeaf:
    """One parameter of a torch module as a flax leaf: its wire name, the
    parameter, and the layout maps between the two frameworks, which also
    carry anything shaped like the parameter (an optimizer's moments)."""

    __slots__ = ("name", "param", "leaf", "features", "conv")

    def __init__(self, name, param, leaf, features, conv=False):
        self.name = name
        self.param = param
        self.leaf = leaf
        self.features = features
        self.conv = conv  # a Conv2d kernel

    def to_flax(self, value):
        """torch-layout tensor -> flax-layout tensor (same device)."""
        if self.conv:
            value = value.permute(2, 3, 1, 0)
        elif self.leaf == "kernel":
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
        if self.conv:
            value = np.ascontiguousarray(value.transpose(3, 2, 0, 1))
        elif self.leaf == "kernel":
            value = value.reshape(value.shape[0], -1).T
        elif self.leaf == "bias":
            value = value.reshape(-1)
        return torch.tensor(value)


def flax_leaves(module):
    """Every parameter of `module` as a FlaxLeaf, in the order jax flattens
    the flax params tree (dict keys sorted at every level).

    The module tells which flax leaf each weight is: an nn.Linear's weight
    is a kernel (reshaped to [in, *features] where the module carries a
    `features` tuple, as a DenseGeneral does), an nn.Conv2d's a conv
    kernel, an nn.Embedding's an embedding, any other weight a LayerNorm
    or BatchNorm scale. Any other parameter keeps its name as the flax
    leaf's."""
    leaves = []
    for mod_name, mod in module.named_modules():
        prefix = mod_name.replace(".", "/")
        features = getattr(mod, "features", None)
        conv = isinstance(mod, nn.Conv2d)
        for leaf_name, param in mod.named_parameters(recurse=False):
            if leaf_name == "weight":
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    leaf = "kernel"
                elif isinstance(mod, nn.Embedding):
                    leaf = "embedding"
                else:
                    leaf = "scale"
            else:
                leaf = leaf_name
            name = f"{prefix}/{leaf}" if prefix else leaf
            leaves.append(FlaxLeaf(name, param, leaf, features,
                                   conv and leaf_name == "weight"))
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
