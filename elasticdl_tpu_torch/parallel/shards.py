"""The shards of one worker process in one resolved world: the intra-process
model and seq axes (and data positions inside the process) of the JAX
package's mesh, as threads.

A worker process runs `local_devices` shards (parallel/mesh.py). Shard i
lives on cuda:(i mod device count), or on the CPU when the trainer was
asked for it, and runs in a thread of its own. The process keeps its WHOLE
state — the full model and its optimizer, in the JAX layout through
common/params.py — as the JAX package keeps (variables, opt_state) fully
addressable on every host, so the elastic regroup, rank 0's state sync,
checkpoints and export work on it unchanged. Each shard holds a copy of
its part of the parameters:

- its model-axis slice (parallel/tensor_parallel.py: `parallelize` and the
  spec's split dims, cut in the flax layout), or the whole parameter where
  it is replicated;
- on the seq axis, the same parameters, and a model whose attention the
  model spec's context_parallel_model hook bound to the shard's seq group
  (ring, zigzag or Ulysses attention); the shard embeds its block of
  positions.

A step copies the full parameters into the shards (device to device), runs
every shard's forward and backward on its rows and sequence block, and
gathers the gradients back into the full model: the model-axis slices
joined along their split dims (a replicated parameter's gradient is equal
on every model shard and taken from the first), then summed over the data
positions and seq blocks of this process in a fixed order. The loss is the
JAX step's: each shard's loss is weighted by its share of the label
elements, so the sum is the mean over the batch's tokens, not a mean of
the shards' means. The trainer then all-reduces the process's gradients
over the processes of the world (parallel/distributed.py:World), the data
axis across processes, and steps its optimizer once.

The model and seq groups are gloo groups among the shard threads over an
in-process HashStore (parallel/distributed.py:join_axis_group), built with
the world and dropped with it. Where the step needs the data axis among
shards (`data_group`: BatchNorm's statistics over the global batch, or the
quantized reduction of a one-process world), each shard also joins a group
of every data position of the world with its model and seq coordinates:
over the in-process store in a one-process world, over the epoch's
rendezvous store (`batch_store`, one client per shard) across processes.

The model's buffers (BatchNorm's running statistics) go into the shards
with the parameters, and `gather_buffers` brings them back: the first data
position's where the statistics were the global batch's (every position
holds the same), the mean over the data positions where each shard
normalized with its own (the quantized step's).
"""

import collections
import concurrent.futures
import copy

import numpy as np
import torch
import torch.distributed

from elasticdl_tpu_torch.common.params import flax_leaves
from elasticdl_tpu_torch.layers.conv import bind_batch_stats
from elasticdl_tpu_torch.layers.init import materialize
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel import tensor_parallel as tp
from elasticdl_tpu_torch.parallel.distributed import (
    AxisGroup,
    CommStats,
    join_axis_group,
)
from elasticdl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    ShardLayout,
    first_leaf,
    tree_map,
)


def torch_layout(leaf, value):
    """A flax-layout tensor -> the torch layout of `leaf` (FlaxLeaf), on
    value's device: FlaxLeaf.from_flax without the trip through numpy."""
    if leaf.conv:
        return value.permute(3, 2, 0, 1)
    if leaf.leaf == "kernel":
        return value.reshape(value.shape[0], -1).T
    if leaf.leaf == "bias":
        return value.reshape(-1)
    return value


def shard_device(base, i):
    """The device of local shard i for a trainer on `base`."""
    if base.type != "cuda":
        return base
    return torch.device("cuda", i % torch.cuda.device_count())


def _rows(value, n):
    """value's first n rows where its leading dim is the batch's."""
    if isinstance(value, dict):
        return {k: _rows(v, n) for k, v in value.items()}
    if isinstance(value, tp.VocabShard) or getattr(value, "ndim", 0) >= 1:
        return value[:n]
    return value


class ProcessShards:
    """The shards of this process for one world spec."""

    def __init__(self, model, spec, process_rank, device, epoch,
                 param_specs_fn=None, context_parallel_model_fn=None,
                 context_parallel_impl="zigzag", axis_stats=None,
                 launches=None, local_host="127.0.0.1", data_group=False,
                 batch_store=None, bind_stats=False):
        self.layout = ShardLayout(spec, process_rank)
        self.n = self.layout.local_devices
        self.mp = self.layout.size(MODEL_AXIS)
        self.sp = self.layout.size(SEQ_AXIS)
        self.impl = context_parallel_impl
        self._full_leaves = {x.name: x for x in flax_leaves(model)}
        self._full_buffers = dict(model.named_buffers())
        self._template = meta_copy(model)
        self._specs = (param_specs_fn(meta_variables(self._template))
                       if self.mp > 1 else {})
        self.axis_stats = axis_stats or {}
        for axis in (MODEL_AXIS, SEQ_AXIS, DATA_AXIS):
            self.axis_stats.setdefault(axis, CommStats())
        self._data_group = data_group
        self._batch_store = batch_store
        self._bind_stats = bind_stats
        # Each shard's kernel launches (its thread's).
        self.launches = launches or [collections.Counter()
                                     for _ in range(self.n)]
        self.devices = [shard_device(device, i) for i in range(self.n)]
        self._pool = concurrent.futures.ThreadPoolExecutor(
            self.n, thread_name_prefix="shard")
        store = torch.distributed.HashStore()
        self.groups = [None] * self.n
        self.models = self._run(lambda i: self._build(
            i, store, epoch, context_parallel_model_fn, local_host))
        self._leaves = [{x.name: x for x in flax_leaves(m)}
                        for m in self.models]
        self._buffers = [dict(m.named_buffers()) for m in self.models]

    # ---------- building ----------

    def _build(self, i, store, epoch, cp_model_fn, local_host):
        layout = self.layout
        coords = layout.coords(i)
        groups = {}
        for axis in (MODEL_AXIS, SEQ_AXIS):
            groups[axis] = join_axis_group(
                store, epoch, axis, layout.group_key(i, axis),
                coords[axis], layout.size(axis), self.axis_stats[axis],
                local_host)
        if self._data_group:
            groups[DATA_AXIS] = join_axis_group(
                self._batch_store() if self._batch_store else store, epoch,
                DATA_AXIS, (coords[MODEL_AXIS], coords[SEQ_AXIS]),
                coords[DATA_AXIS], layout.data_size,
                self.axis_stats[DATA_AXIS], local_host)
        self.groups[i] = groups
        if self.sp > 1:
            model = cp_model_fn(
                group=groups[SEQ_AXIS],
                head_axis=MODEL_AXIS if self.mp > 1 else None,
                impl=self.impl)
        else:
            model = copy.deepcopy(self._template)
        if self.mp > 1:
            tp.parallelize(model, self._specs, groups[MODEL_AXIS])
        materialize(model, self.devices[i])
        model.train()
        if self._bind_stats:
            bind_batch_stats(model, groups[DATA_AXIS])
        return model

    def _run(self, fn):
        """fn(i) in every shard's thread; the results in shard order. A
        shard that raises drops its groups, so that peers blocked in a
        collective with it fail at once instead of at their timeout."""

        def call(i):
            try:
                with fa.counting_into(self.launches[i]):
                    if self.devices[i].type == "cuda":
                        with torch.cuda.device(self.devices[i]):
                            return fn(i)
                    return fn(i)
            except BaseException:
                for group in (self.groups[i] or {}).values():
                    group.close()
                raise

        futures = [self._pool.submit(call, i) for i in range(self.n)]
        return [f.result() for f in futures]

    # ---------- state ----------

    @torch.no_grad()
    def _load_params(self, i):
        """Copies the full model's parameters and buffers into shard i."""
        for name, full in self._full_buffers.items():
            self._buffers[i][name].copy_(full)
        m = self.layout.coords(i)[MODEL_AXIS]
        for name, leaf in self._leaves[i].items():
            full = self._full_leaves[name]
            spec = self._specs.get(name, ())
            if tp.split_dim(spec) is None:
                leaf.param.copy_(full.param)
                continue
            part = tp.shard_state({name: full.to_flax(full.param)},
                                  {name: spec}, self.mp)[m][name]
            leaf.param.copy_(torch_layout(leaf, part))

    def _positions(self):
        """[{model coordinate: local shard}] per (data position, seq block)
        of this process, in order."""
        by_position = {}
        for i in range(self.n):
            c = self.layout.coords(i)
            by_position.setdefault((c[DATA_AXIS], c[SEQ_AXIS]), {})[
                c[MODEL_AXIS]] = i
        return [by_position[k] for k in sorted(by_position)]

    @torch.no_grad()
    def gather_grads(self, first_only=False):
        """Sets the full model's gradients: the model slices joined, then
        the sum over the data positions and seq blocks of this process (the
        first position's alone with `first_only`: the data axis was reduced
        among the shards)."""
        positions = self._positions()
        if first_only:
            positions = positions[:1]
        for name, full in self._full_leaves.items():
            spec = self._specs.get(name, ())
            total = None
            for shards in positions:
                parts = [self._flax_grad(shards[m], name)
                         for m in range(self.mp)]
                grad = (tp.gather_state([{name: p} for p in parts],
                                        {name: spec})[name]
                        if tp.split_dim(spec) is not None else parts[0])
                grad = grad.to(full.param.device)
                total = grad if total is None else total + grad
            full.param.grad = torch_layout(full, total).contiguous()

    def _flax_grad(self, i, name):
        leaf = self._leaves[i][name]
        grad = leaf.param.grad
        if grad is None:
            grad = torch.zeros_like(leaf.param)
        return leaf.to_flax(grad)

    def shard_grads(self, name):
        """{local shard: flax-layout gradient of `name`} (the tests hold
        the model-replicated ones equal across the model group)."""
        return {i: self._flax_grad(i, name).detach().cpu()
                for i in range(self.n)}

    # ---------- the step ----------

    def split(self, features, labels, real_n):
        """Shard i's (features, labels, real rows, loss weight): the rows
        of its data position and the columns of its seq block, weighted by
        its share of the real label elements."""
        layout = self.layout
        dl = layout.data_local
        first = self.layout.process_rank * dl
        b = np.shape(first_leaf(labels))[0]
        rows = b // dl
        total = real_n * int(np.prod(np.shape(first_leaf(labels))[1:]))
        out = []
        for i in range(self.n):
            c = layout.coords(i)
            r0 = (c[DATA_AXIS] - first) * rows
            feats, labs = (tree_map(lambda x: self._cut(
                x, r0, rows, c[SEQ_AXIS]), t) for t in (features, labels))
            real = max(0, min(rows, real_n - r0))
            per_row = int(np.prod(np.shape(first_leaf(labs))[1:]))
            out.append((feats, labs, real, real * per_row / total))
        return out

    def _cut(self, x, r0, rows, seq):
        x = np.asarray(x)[r0:r0 + rows]
        if self.sp > 1:
            s = x.shape[1]
            if s % self.sp:
                raise ValueError(
                    f"sequence length {s} does not divide by the seq axis "
                    f"({self.sp})")
            n = s // self.sp
            x = x[:, seq * n:(seq + 1) * n]
        return x

    @torch.no_grad()
    def gather_buffers(self, mean=False):
        """Sets the full model's buffers from the shards: the first data
        position's, or the mean over this process's data positions."""
        if not self._full_buffers:
            return
        firsts = [shards[0] for shards in self._positions()]
        for name, full in self._full_buffers.items():
            if not mean:
                full.copy_(self._buffers[firsts[0]][name])
                continue
            total = None
            for i in firsts:
                value = self._buffers[i][name].to(full.device)
                total = value if total is None else total + value
            full.copy_(total / len(firsts))

    def step(self, loss_fn, features, labels, real_n, unweighted=False,
             after_backward=None):
        """Every shard's forward and backward, the gradients gathered into
        the full model. Returns the loss (0-d, on the full model's
        device). `unweighted`: each shard's backward runs on its own mean
        loss (the quantized step reduces the gradients by a mean over the
        data axis); `after_backward(i, leaves, groups)` then runs in shard
        i's thread, and the gradients are taken from the first data
        position."""
        pieces = self.split(features, labels, real_n)

        def shard_step(i):
            model = self.models[i]
            device = self.devices[i]
            self._load_params(i)
            model.zero_grad(set_to_none=True)
            feats, labs, real, weight = pieces[i]
            feats, labs = (tree_map(
                lambda x: torch.as_tensor(x).to(device), t)
                for t in (feats, labs))
            if self.sp > 1:
                model.position_offset = (self.layout.coords(i)[SEQ_AXIS]
                                         * np.shape(first_leaf(labs))[1])
            outputs = model(feats)
            if real:
                loss = loss_fn(_rows(labs, real), _rows(outputs, real))
            else:
                loss = loss_fn(labs, outputs)
            (loss if unweighted else loss * weight).backward()
            if after_backward is not None:
                after_backward(i, list(self._leaves[i].values()),
                               self.groups[i])
            return (loss * weight).detach()

        losses = self._run(shard_step)
        self.gather_grads(first_only=unweighted)
        device = next(iter(self._full_leaves.values())).param.device
        total = None
        for i, loss in enumerate(losses):
            if self.layout.coords(i)[MODEL_AXIS] == 0:
                loss = loss.to(device)
                total = loss if total is None else total + loss
        return total

    def close(self):
        for groups in self.groups:
            for group in (groups or {}).values():
                group.close()
        self._pool.shutdown(wait=True)


def meta_copy(model):
    """A structure-only copy of `model` on the meta device."""
    params = dict(model.named_parameters())
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                      p.requires_grad)
            for p in params.values()}
    for name, buf in model.named_buffers():
        memo[id(buf)] = torch.empty_like(buf, device="meta")
    return copy.deepcopy(model, memo)


def meta_variables(model):
    """{wire name: flax-layout tensor} of a meta-device model: what the
    param_specs hooks take, at no cost."""
    return {x.name: x.to_flax(x.param) for x in flax_leaves(model)}


def placeholder_group(axis, size):
    """An AxisGroup without a process group, for building a model whose
    collectives never run (the trainer's dry call of a hook)."""
    return AxisGroup(axis, 0, size)


def run_group(n, fn, axis=SEQ_AXIS, local_host="127.0.0.1"):
    """fn(group) in n threads, each a member of one n-wide gloo group on
    `axis` over a fresh in-process store; the results in rank order (the
    tests and chip_smoke.py run the seq-axis functions so)."""
    store = torch.distributed.HashStore()
    groups = [None] * n

    def member(rank):
        groups[rank] = join_axis_group(store, 0, axis, (0,), rank, n,
                                       local_host=local_host)
        try:
            return fn(groups[rank])
        except BaseException:
            groups[rank].close()
            raise

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        futures = [pool.submit(member, r) for r in range(n)]
        return [f.result() for f in futures]
