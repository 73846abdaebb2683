"""Cross-replica weight-update sharding (ZeRO-1) over the shards of one
process (counterpart of elasticdl_tpu/parallel/zero1.py).

In pure data parallelism the optimizer state is the same on every replica;
ZeRO-1 keeps each leaf whose leading dim divides the axis size as row
slices, one per shard, and replicates every other leaf
(`weight_update_specs`, the JAX package's rule on the flax layout). The
JAX package states it as shardings and GSPMD compiles the update as
reduce-scatter, shard-local optimizer math, all-gather. The port writes it
out as a per-leaf plan of row slices (`row_slices`) and an optimizer that
holds each shard's slices (`ShardedOptimizer`):

- the gradients arrive reduced, as without ZeRO-1 (the trainer's step);
- each shard updates only its rows of each sharded leaf, with its own
  optimizer over its own slices of the parameters and of the state;
- the updated rows go back into the process's full parameters, from which
  every shard takes its copy at the next step: the all-gather.

Every optimizer of ops/optimizers.py is elementwise, so the parameters
equal the replicated update's bit for bit. The JAX package keeps the
state fully addressable on every host; here the full state exists only
as the shards' slices, and `state` (what ops/optimizers.optax_state_leaves
reads) gathers it: the rank-0 pull and broadcast, worker checkpoints and a
regroup read that gathered copy, and `from_full` reshards one.

Where the shards of a process share one card (ELASTICDL_LOCAL_DEVICES),
the card's peak memory cannot drop: `state_bytes` tells what each shard
allocates against the replicated state.
"""

import torch

from elasticdl_tpu_torch.parallel.mesh import DATA_AXIS, zero_axis_demand

__all__ = ["zero_axis_demand", "weight_update_specs", "row_slices",
           "ShardedOptimizer"]


def weight_update_specs(shapes, size, axis=DATA_AXIS):
    """{leaf name: spec} for {leaf name: flax shape}: dim-0 sharding over
    `axis` (`(axis, None, ...)`) for every leaf whose leading dim divides
    `size`, replicated (`()`) otherwise."""
    specs = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        if len(shape) >= 1 and shape[0] and shape[0] % size == 0:
            specs[name] = (axis,) + (None,) * (len(shape) - 1)
        else:
            specs[name] = ()
    return specs


def row_slices(shapes, size, index):
    """Shard `index`'s rows of each leaf: {name: slice} for the sharded
    leaves of weight_update_specs, None for the replicated ones."""
    out = {}
    for name, spec in weight_update_specs(shapes, size).items():
        if not spec:
            out[name] = None
            continue
        rows = tuple(shapes[name])[0] // size
        out[name] = slice(index * rows, (index + 1) * rows)
    return out


def _flax_shape(leaf):
    return tuple(leaf.to_flax(leaf.param.detach()).shape)


class ShardedOptimizer:
    """The optimizer of a process whose state is row-sharded over `n`
    shards: shard i's torch optimizer (optimizer_spec.to_torch) over its
    slices of the sharded leaves, in the flax layout, on devices[i], and
    one optimizer on the process's device over the replicated leaves.
    `leaves` are the full model's parameters as common/params.flax_leaves
    lists them."""

    def __init__(self, optimizer_spec, leaves, n, devices):
        self.spec = optimizer_spec
        self.leaves = list(leaves)
        self.n = int(n)
        shapes = {x.name: _flax_shape(x) for x in self.leaves}
        self.plans = [row_slices(shapes, self.n, i) for i in range(self.n)]
        # Per shard: [(FlaxLeaf, rows, slice parameter)].
        self.parts = []
        with torch.no_grad():
            for i in range(self.n):
                parts = []
                for x in self.leaves:
                    rows = self.plans[i][x.name]
                    if rows is None:
                        continue
                    value = x.to_flax(x.param.detach())[rows]
                    parts.append((x, rows, torch.nn.Parameter(
                        value.to(devices[i], copy=True).contiguous())))
                self.parts.append(parts)
        self.optimizers = [optimizer_spec.to_torch([p for _, _, p in parts])
                           if parts else None for parts in self.parts]
        self.replicated_leaves = [x for x in self.leaves
                                  if self.plans[0][x.name] is None]
        self.replicated = (optimizer_spec.to_torch(
            [x.param for x in self.replicated_leaves])
            if self.replicated_leaves else None)

    # ---------- the step ----------

    def zero_grad(self, set_to_none=True):
        for x in self.leaves:
            x.param.grad = None
        for parts in self.parts:
            for _, _, p in parts:
                p.grad = None

    @torch.no_grad()
    def step(self):
        """Each shard updates its rows from the reduced gradients of the
        full parameters, then writes them back into the full parameters;
        the replicated leaves step once, on the process's device."""
        for parts, opt in zip(self.parts, self.optimizers):
            if opt is None:
                continue
            for x, rows, p in parts:
                grad = x.param.grad
                if grad is None:
                    p.grad = None
                    continue
                p.grad = x.to_flax(grad)[rows].to(p.device).contiguous()
            opt.step()
            for x, rows, p in parts:
                x.to_flax(x.param.data)[rows].copy_(p)
        if self.replicated is not None:
            self.replicated.step()

    # ---------- the full state ----------

    @property
    def state(self):
        """{full parameter: {field: tensor in its layout}}: the shards'
        slices gathered (a fresh copy), beside the replicated leaves'
        state; what ops/optimizers.optax_state_leaves reads."""
        out = {}
        if self.replicated is not None:
            for x in self.replicated_leaves:
                st = self.replicated.state.get(x.param)
                if st:
                    out[x.param] = dict(st)
        for parts, opt in zip(self.parts, self.optimizers):
            for x, rows, p in parts:
                st = opt.state.get(p)
                if not st:
                    continue
                fields = out.setdefault(x.param, {})
                for key, value in st.items():
                    if torch.is_tensor(value) and value.shape == p.shape:
                        if key not in fields:
                            fields[key] = torch.empty_like(x.param)
                        x.to_flax(fields[key])[rows].copy_(value)
                    else:
                        fields.setdefault(key, value)
        return out

    @classmethod
    def from_full(cls, optimizer, optimizer_spec, leaves, n, devices):
        """A ShardedOptimizer holding `optimizer`'s state (a torch optimizer
        over the full parameters, or another ShardedOptimizer) cut into n
        shards' slices."""
        full = optimizer.state
        sharded = cls(optimizer_spec, leaves, n, devices)
        with torch.no_grad():
            if sharded.replicated is not None:
                for x in sharded.replicated_leaves:
                    if x.param in full:
                        sharded.replicated.state[x.param] = {
                            k: _copy(v) for k, v in full[x.param].items()}
            for parts, opt in zip(sharded.parts, sharded.optimizers):
                for x, rows, p in parts:
                    st = full.get(x.param)
                    if not st:
                        continue
                    opt.state[p] = {
                        k: (x.to_flax(v)[rows].to(p.device, copy=True)
                            .contiguous()
                            if torch.is_tensor(v) and v.shape
                            == x.param.shape else _copy(v))
                        for k, v in st.items()}
        return sharded

    def to_full(self, params):
        """A torch optimizer over the full parameters `params` holding this
        optimizer's state, gathered."""
        full = self.spec.to_torch(params)
        gathered = self.state
        for p, st in gathered.items():
            full.state[p] = {k: _copy(v) for k, v in st.items()}
        return full

    def state_bytes(self):
        """{"shards": [bytes of each shard's optimizer state], "replicated":
        bytes of the replicated leaves' state} (0 before the first step)."""

        def nbytes(opt):
            if opt is None:
                return 0
            return sum(v.numel() * v.element_size()
                       for st in opt.state.values() for v in st.values()
                       if torch.is_tensor(v) and v.dim())

        return {"shards": [nbytes(o) for o in self.optimizers],
                "replicated": nbytes(self.replicated)}


def _copy(value):
    """A step count or a tensor of its own (torch's Adam increments its
    step tensor in place: two parameters must never share one)."""
    return value.clone() if torch.is_tensor(value) else value
