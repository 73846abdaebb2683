"""Tensor (Megatron) and expert parallelism over the model axis
(counterpart of elasticdl_tpu/parallel/tensor_parallel.py and the EP half
of elasticdl_tpu/layers/moe.py).

The JAX package states the layout as PartitionSpecs on the param tree and
lets XLA insert the collectives. The port keeps the same rules, on the
flat wire names of common/params.py ({'Block_0/Dense_0/kernel': spec}),
each spec a tuple with the axis name at the split dimension of the flax
layout, and writes the collectives out (parallel/collectives.py):

- `shard_state` cuts a full flax-layout state into the shards' states and
  `gather_state` joins them again. The split runs on the flax layout, so
  the head split of `qkv` ([D, 3, H, Dh], split on H) takes rows
  [t, h_shard, :] of each of q, k and v, which is no contiguous slice of
  the torch weight [3*H*Dh, D].
- `parallelize` turns a model (on the meta device) into one shard of it:
  each Dense whose kernel splits its output dims becomes a
  ColumnParallelDense (its input through `copy_to`), each that splits its
  input dim a RowParallelDense (its partial product through
  `reduce_from`; the replicated bias added once, after the sum), the
  vocab-split embedding a VocabParallelEmbed, the LM head a
  VocabParallelHead and a SwitchMoE with split experts an
  ExpertParallelMoE. The attention of a shard then sees H / mp heads.
- The LM head stays float32. In training it hands the loss a VocabShard
  (this shard's vocab slice of the logits), and the LM's loss takes the
  cross-entropy vocab-parallel: three all-reduces of [B, S] values instead
  of gathering the logits (2 GiB at the flagship's widths). Outside
  training the head gathers the full logits. The trainer evaluates and
  predicts on its full model, which returns full logits as the JAX model
  does.
"""

import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.parallel.collectives import copy_to, reduce_from
from elasticdl_tpu_torch.parallel.mesh import MODEL_AXIS, AxisDemand


def model_axis_demand(model_parallel):
    """Tensor parallelism's mesh-axis contribution to world resolution:
    an intra-process "model" axis (TP collectives stay inside one process
    and params stay fully addressable for elastic regroup snapshots)."""
    return AxisDemand(MODEL_AXIS, int(model_parallel), intra_process=True)


# (wire-name regex, spec) — first match wins; default replicated. Shapes in
# the flax layout:
#   qkv/kernel  [D, 3, H, Dh]   heads column-split
#   qkv/bias       [3, H, Dh]
#   proj/kernel [D, D]          row-split (input dim = concat of heads)
#   Dense_0     [D, 4D]         MLP up, column-split
#   Dense_1     [4D, D]         MLP down, row-split
#   tok_emb     [V, D]          vocab-split
#   lm_head     [D, V]          vocab column-split
_RULES = (
    (r".*/qkv/kernel$", lambda ax: (None, None, ax, None)),
    (r".*/qkv/bias$", lambda ax: (None, ax, None)),
    (r".*/proj/kernel$", lambda ax: (ax, None)),
    (r".*/Dense_0/kernel$", lambda ax: (None, ax)),
    (r".*/Dense_0/bias$", lambda ax: (ax,)),
    (r".*/Dense_1/kernel$", lambda ax: (ax, None)),
    (r"(^|.*/)tok_emb/embedding$", lambda ax: (ax, None)),
    (r"(^|.*/)lm_head/kernel$", lambda ax: (None, ax)),
    (r"(^|.*/)lm_head/bias$", lambda ax: (ax,)),
)
# The module whose column split is the vocabulary of the output.
_HEAD = r"(^|.*/)lm_head$"


def transformer_param_specs(names, model_axis=MODEL_AXIS):
    """Wire names -> specs (Megatron layout over `model_axis`; everything
    unmatched — LayerNorms, proj/Dense_1 biases, pos_emb — replicated,
    the empty spec)."""
    specs = {}
    for name in names:
        spec = ()
        for pattern, make in _RULES:
            if re.match(pattern, name):
                spec = make(model_axis)
                break
        specs[name] = spec
    return specs


def moe_param_specs(variables, expert_axis=MODEL_AXIS):
    """Specs of {wire name: array} holding SwitchMoE layers: the expert
    weights w_in/w_out (leading dim E) split over `expert_axis`,
    everything else (the router, and any layer around the experts)
    replicated."""
    specs = {}
    for name, value in variables.items():
        if name.rsplit("/", 1)[-1] in ("w_in", "w_out"):
            specs[name] = (expert_axis,) + (None,) * (np.ndim(value) - 1)
        else:
            specs[name] = ()
    return specs


def validate_divisibility(config, model_parallel):
    """TP requires the split dimensions to divide evenly."""
    if config.n_heads % model_parallel:
        raise ValueError(
            f"n_heads {config.n_heads} not divisible by model-parallel "
            f"size {model_parallel}"
        )
    if (4 * config.d_model) % model_parallel:
        raise ValueError(
            f"MLP hidden dim d_model*4 ({4 * config.d_model}) not "
            f"divisible by model-parallel size {model_parallel}"
        )
    if config.vocab % model_parallel:
        raise ValueError(
            f"vocab ({config.vocab}) not divisible by model-parallel "
            f"size {model_parallel}"
        )


def split_dim(spec, axis=MODEL_AXIS):
    """The flax dimension `spec` splits over `axis` (None: replicated)."""
    return next((i for i, a in enumerate(spec) if a == axis), None)


def spec_violations(shapes, specs, model_parallel):
    """Split dims that do not divide by the model-axis size, as human
    messages ([] = the layout is valid); shapes are {wire name: flax
    shape}."""
    bad = []
    for name, shape in shapes.items():
        spec = specs.get(name, ())
        if len(spec) > len(shape):
            bad.append(f"{name}: spec rank {len(spec)} exceeds param rank "
                       f"{len(shape)}")
            continue
        dim = split_dim(spec)
        if dim is not None and model_parallel > 1 \
                and shape[dim] % model_parallel:
            bad.append(f"{name}: dim {dim} ({shape[dim]}) % "
                       f"{model_parallel} != 0")
    return bad


def _take(value, spec, index, size):
    dim = split_dim(spec)
    if dim is None or size == 1:
        return value
    n = value.shape[dim] // size
    cut = [slice(None)] * value.ndim
    cut[dim] = slice(index * n, (index + 1) * n)
    return value[tuple(cut)]


def _join(parts, spec):
    dim = split_dim(spec)
    if dim is None or len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=dim)
    return np.concatenate(parts, axis=dim)


def shard_state(named, specs, model_parallel):
    """A full state {wire name: flax-layout array} -> one such dict per
    model shard, each split dim cut into equal contiguous pieces (numpy
    arrays come out as views, torch tensors as views too)."""
    return [{name: _take(value, specs.get(name, ()), i, model_parallel)
             for name, value in named.items()}
            for i in range(model_parallel)]


def gather_state(parts, specs):
    """The inverse of shard_state: the shards' dicts -> the full state
    (a replicated leaf is taken from shard 0)."""
    return {name: _join([p[name] for p in parts], specs.get(name, ()))
            for name in parts[0]}


# ---------- the sharded modules ----------


class VocabShard:
    """This shard's vocabulary slice of the logits, [..., V / mp] float32,
    with the group and the slice's first id: what a VocabParallelHead
    hands the loss in training."""

    def __init__(self, logits, group, start):
        self.logits = logits
        self.group = group
        self.start = start

    def __getitem__(self, rows):
        return VocabShard(self.logits[rows], self.group, self.start)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy of vocab-sharded logits: the max, the sum
    of exponentials and the target's logit are all-reduced over the group;
    the gradient softmax - onehot stays on each shard's slice."""

    @staticmethod
    def forward(ctx, logits, labels, group, start):
        n_local = logits.shape[-1]
        m = group.all_reduce(logits.amax(-1), op="max")
        exp = (logits - m[..., None]).exp_()
        total = group.all_reduce(exp.sum(-1))
        local = labels.long() - start
        inside = (local >= 0) & (local < n_local)
        idx = local.clamp(0, n_local - 1)[..., None]
        target = logits.gather(-1, idx)[..., 0].masked_fill(~inside, 0.0)
        target = group.all_reduce(target)
        exp.div_(total[..., None])
        ctx.save_for_backward(exp, idx, inside)
        return total.log() + m - target

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, idx, -inside.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def vocab_parallel_cross_entropy(shard, labels):
    """Per-token CE [...] of a VocabShard against int labels [...]."""
    return _VocabParallelCE.apply(shard.logits.float(), labels, shard.group,
                                  shard.start)


class ColumnParallelDense(nn.Linear):
    """A Dense whose output dims are this shard's slice; the replicated
    input enters through copy_to."""

    def __init__(self, dense, features, out_local, group):
        super().__init__(dense.in_features, out_local)
        self.compute_dtype = dense.compute_dtype
        if features is not None:
            self.features = features
        self.group = group

    def forward(self, x):
        dt = self.compute_dtype
        x = copy_to(x, self.group)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class VocabParallelHead(ColumnParallelDense):
    """The LM head over this shard's vocabulary slice [start, start +
    V / mp): a VocabShard in training, the gathered logits otherwise."""

    def __init__(self, dense, features, out_local, group):
        super().__init__(dense, features, out_local, group)
        self.start = group.rank * out_local

    def forward(self, x):
        logits = super().forward(x)
        if self.training:
            return VocabShard(logits, self.group, self.start)
        return self.group.all_gather(logits, dim=-1)


class RowParallelDense(nn.Linear):
    """A Dense whose input dim is this shard's slice: the partial product
    is summed over the group (reduce_from), then the replicated bias is
    added once."""

    def __init__(self, dense, in_local, group):
        super().__init__(in_local, dense.out_features)
        self.compute_dtype = dense.compute_dtype
        self.group = group

    def forward(self, x):
        dt = self.compute_dtype
        partial = F.linear(x.to(dt), self.weight.to(dt))
        return reduce_from(partial, self.group) + self.bias.to(dt)


class VocabParallelEmbed(nn.Embedding):
    """An embedding over this shard's rows [start, start + V / mp): ids
    outside give zeros, and the rows are summed over the group (each id
    lives on one shard, so the sum is exact)."""

    def __init__(self, embed, rows, group):
        super().__init__(rows, embed.embedding_dim)
        self.compute_dtype = embed.compute_dtype
        self.group = group
        self.start = group.rank * rows

    def forward(self, ids):
        local = ids.long() - self.start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(local.clamp(0, self.num_embeddings - 1),
                           self.weight.to(self.compute_dtype))
        return reduce_from(rows * inside[..., None].to(rows.dtype),
                           self.group)


def _local_shape(shape, spec, size):
    dim = split_dim(spec)
    shape = list(shape)
    if dim is not None:
        shape[dim] //= size
    return tuple(shape)


def _flax_kernel_shape(linear):
    features = getattr(linear, "features", None)
    return (linear.in_features,) + (tuple(features) if features is not None
                                    else (linear.out_features,))


def parallelize(model, specs, group):
    """Turns `model` (on the meta device, flax-named submodules) into one
    model-axis shard of it, in place, by `specs`: {wire name: spec} as
    transformer_param_specs or moe_param_specs give them. Returns the
    model. Modules without a split parameter stay as they are
    (replicated)."""
    from elasticdl_tpu_torch.layers.moe import ExpertParallelMoE, SwitchMoE

    with torch.device("meta"):
        _replace(model, specs, group, ExpertParallelMoE, SwitchMoE)
    return model


def _replace(model, specs, group, ExpertParallelMoE, SwitchMoE):
    size = group.size
    for name, mod in list(model.named_modules()):
        prefix = name.replace(".", "/")
        new = None
        if isinstance(mod, SwitchMoE) and split_dim(
                specs.get(f"{prefix}/w_in", ())) == 0:
            new = ExpertParallelMoE(mod, group)
        elif isinstance(mod, nn.Linear):
            spec = specs.get(f"{prefix}/kernel", ())
            dim = split_dim(spec)
            if dim == 0:
                new = RowParallelDense(mod, mod.in_features // size, group)
            elif dim is not None:
                shape = _local_shape(_flax_kernel_shape(mod), spec, size)
                features = shape[1:] if hasattr(mod, "features") else None
                cls = (VocabParallelHead if re.match(_HEAD, prefix)
                       else ColumnParallelDense)
                new = cls(mod, features, int(np.prod(shape[1:])), group)
        elif isinstance(mod, nn.Embedding) and split_dim(
                specs.get(f"{prefix}/embedding", ())) == 0:
            new = VocabParallelEmbed(mod, mod.num_embeddings // size, group)
        if new is None:
            continue
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, leaf, new)
