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

The pipelined LM's staged tree (parallel/pipeline.py:StagedLM) is the JAX
package's {"embed", "stages", "head"} tree: `embed/tok_emb/embedding`,
`embed/pos_emb/embedding`, `head/LayerNorm_0/{scale,bias}`,
`head/lm_head/{kernel,bias}`, and every leaf of a stage row under
`stages/Block_<j>/...` with a leading dim of rows, the rows stacked in
layer order. A module marked `stacked_rows` holds such leaves as one
parameter each, [rows, *torch layout]; the layouts above apply to each row
(`FlaxLeaf.stacked`). `staged_to_monolithic` and `monolithic_to_staged`
move a {wire name: array} dict between that tree and the plain LM's
(`Block_<i>/...` with i = row * layers per row + j).

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

    __slots__ = ("name", "param", "leaf", "features", "conv", "stacked")

    def __init__(self, name, param, leaf, features, conv=False,
                 stacked=False):
        self.name = name
        self.param = param
        self.leaf = leaf
        self.features = features
        self.conv = conv  # a Conv2d kernel
        # A stage row's leaf stacked over rows: the layout maps apply to
        # each row of the leading dim.
        self.stacked = stacked

    def to_flax(self, value):
        """torch-layout tensor -> flax-layout tensor (same device)."""
        if self.stacked:
            rows = value.shape[0]
            if self.leaf == "kernel":
                value = value.transpose(-1, -2)
                if self.features is not None:
                    value = value.reshape(rows, value.shape[1],
                                          *self.features)
            elif self.leaf == "bias" and self.features is not None:
                value = value.reshape(rows, *self.features)
            return value
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
        if self.stacked:
            rows = value.shape[0]
            if self.leaf == "kernel":
                value = np.ascontiguousarray(value.reshape(
                    rows, value.shape[1], -1).transpose(0, 2, 1))
            elif self.leaf == "bias":
                value = value.reshape(rows, -1)
            return torch.tensor(value)
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
        stacked = getattr(mod, "stacked_rows", False)
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
                                   conv and leaf_name == "weight", stacked))
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


# ---------- the pipelined LM's staged tree <-> the plain LM's ----------

_STAGED_EMBED = ("tok_emb/", "pos_emb/")


def staged_to_monolithic(named):
    """{wire name: array} of the staged tree -> the plain LM's names: each
    stage row's leaves unstacked into the Block_<i> they are, in layer
    order (row r's Block_j is layer r * layers per row + j)."""
    blocks = sorted({int(n.split("/")[1].split("_")[1])
                     for n in named if n.startswith("stages/")})
    per_row = len(blocks)
    out = {}
    for name, value in named.items():
        head, _, rest = name.partition("/")
        if head in ("embed", "head"):
            out[rest] = np.asarray(value)
            continue
        if head != "stages":
            raise ValueError(f"not a staged-tree leaf: {name!r}")
        block, _, leaf = rest.partition("/")
        j = int(block.split("_")[1])
        for r, row in enumerate(np.asarray(value)):
            out[f"Block_{r * per_row + j}/{leaf}"] = row
    return out


def monolithic_to_staged(named, total_rows):
    """The plain LM's {wire name: array} -> the staged tree of
    `total_rows` rows (the layers divide by it): Block_<i> becomes row
    i // per_row's Block_<i % per_row>, the rows stacked in layer order."""
    layers = sorted({int(n.split("/")[0].split("_")[1])
                     for n in named if n.startswith("Block_")})
    if len(layers) % total_rows:
        raise ValueError(f"{len(layers)} layers do not divide into "
                         f"{total_rows} stage rows")
    per_row = len(layers) // total_rows
    rows = {}
    out = {}
    for name, value in named.items():
        if name.startswith("Block_"):
            block, _, leaf = name.partition("/")
            i = int(block.split("_")[1])
            key = f"stages/Block_{i % per_row}/{leaf}"
            rows.setdefault(key, [None] * total_rows)[i // per_row] = \
                np.asarray(value)
        elif name.startswith(_STAGED_EMBED):
            out[f"embed/{name}"] = np.asarray(value)
        else:
            out[f"head/{name}"] = np.asarray(value)
    for key, values in rows.items():
        out[key] = np.stack(values)
    return out
