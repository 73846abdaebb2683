"""Batch padding and the WORLD SPEC — the single deterministic map from
(parallel config, world topology) to the axes an elastic trainer lays its
shards out on (counterpart of elasticdl_tpu/parallel/mesh.py).

The JAX package names the axes of a `jax.sharding.Mesh`: data parallelism
is the "data" axis, tensor/model parallelism "model", sequence/context
parallelism "seq". The port has no mesh object. A worker process runs
`local_devices` shards, one thread each (worker/allreduce_trainer.py), and
a world of N processes has N * local_devices shards; shard i of process p
is shard p * local_devices + i of the world, and `ShardLayout` gives its
coordinate on each axis in the spec's order, as a flat reshape of the
process-grouped device list gives it in JAX. The model, seq (and stage and
zero) axes lie inside one process, the data axis crosses processes.

World spec (`resolve_world_spec`): every parallel feature — ZeRO-1,
tensor parallelism (tensor_parallel.py), pipelining, sequence parallelism
(ring_attention.py / ulysses.py) — contributes an `AxisDemand` naming the
mesh axis it needs; the resolver composes them under one precedence policy
(stage excludes model/seq; seq drops before model; zero only factors pure
DP) into a `WorldSpec`. The spec is a pure function of `(ParallelConfig,
WorldTopology)`: given the same config, an N-device world always maps to
the same axes, and its fingerprint is the JAX package's. The trainer keeps
the fingerprint of the world it formed.
"""

import math
from typing import Callable, NamedTuple, Optional

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
# Pipeline-parallel stage axis. Like MODEL_AXIS it never crosses process
# boundaries.
STAGE_AXIS = "stage"
# Intra-process slice of the data dimension, used by multi-host ZeRO-1:
# optimizer state shards over it while staying replicated across processes.
ZERO_AXIS = "zero"


def tree_map(fn, batch):
    """fn over the arrays of a batch: an array, or a dict, list or tuple of
    them (the CTR models' features are dicts)."""
    if isinstance(batch, dict):
        return {k: tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(tree_map(fn, v) for v in batch)
    return fn(batch)


def first_leaf(batch):
    if isinstance(batch, dict):
        return next((leaf for leaf in map(first_leaf, batch.values())
                     if leaf is not None), None)
    if isinstance(batch, (list, tuple)):
        return next((leaf for leaf in map(first_leaf, batch)
                     if leaf is not None), None)
    return batch


def pad_batch_to_multiple(batch, multiple):
    """Pad a numpy batch's leading dim up to a multiple by cyclic
    repetition. Returns (padded_batch, real_n)."""
    leaf = first_leaf(batch)
    if leaf is None:
        return batch, 0
    real_n = np.shape(leaf)[0]
    padded_n = -(-real_n // multiple) * multiple
    if padded_n == real_n:
        return batch, real_n
    idx = np.arange(padded_n) % real_n
    padded = tree_map(lambda x: np.take(np.asarray(x), idx, axis=0), batch)
    return padded, real_n


# ---------------------------------------------------------------------------
# World spec: deterministic (config, topology) -> axes resolution
# ---------------------------------------------------------------------------


class WorldTopology(NamedTuple):
    """The device shape of one world: everything resolution may depend on.
    In the port a device is a shard: n_devices is the shards of the world,
    local_devices the shards of each process."""

    n_devices: int
    local_devices: int
    n_processes: int

    @staticmethod
    def current(n_processes=1, local_devices=None):
        """The topology of a world of `n_processes` processes with
        `local_devices` shards each (default: this process's,
        `local_device_count()`)."""
        local = local_devices or local_device_count()
        n = max(1, int(n_processes))
        return WorldTopology(n_devices=n * local, local_devices=local,
                             n_processes=n)

    @property
    def multi_process(self):
        return self.n_processes > 1


def microbatch(x, num_microbatches):
    """[B, ...] -> [M, B//M, ...]; B must divide evenly."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible by {num_microbatches} microbatches"
        )
    return x.reshape(num_microbatches, b // num_microbatches,
                     *x.shape[1:])


def unmicrobatch(y):
    """[M, mb, ...] -> [M*mb, ...]."""
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])


def data_shard(x, num_microbatches, data_size, index):
    """Data position `index`'s rows of a batch [B, ...], as JAX shards
    microbatches over the data axis: of each of the M microbatches [mb]
    the index-th of data_size equal slices, concatenated in microbatch
    order (microbatch() of the result gives its [M, mb / data_size])."""
    x = np.asarray(x)
    micro = microbatch(x, num_microbatches)
    mb = micro.shape[1]
    if mb % data_size:
        raise ValueError(
            f"microbatch size {mb} not divisible by 'data' axis size "
            f"{data_size}; adjust the batch size or num_microbatches"
        )
    part = mb // data_size
    return unmicrobatch(micro[:, index * part:(index + 1) * part])


def local_device_count():
    """Shards per worker process: the CUDA devices torch sees (1 without
    any), unless ELASTICDL_LOCAL_DEVICES asks for more, as the JAX tests
    ask XLA for 8 host devices. Shard i lives on cuda:(i mod count), so on
    one card the shards share it."""
    import torch

    from elasticdl_tpu_torch.common import knobs

    return max(1, torch.cuda.device_count(),
               knobs.get_int("ELASTICDL_LOCAL_DEVICES"))


class AxisDemand(NamedTuple):
    """One parallel feature's request for a mesh axis. Feature modules
    (zero1 / tensor_parallel / pipeline / ring_attention) construct
    these; the resolver composes them. `intra_process` demands must lie
    entirely inside one process's device slice in multi-process worlds —
    the composition invariant that keeps (variables, opt_state) fully
    addressable on every host for elastic regroup snapshots."""

    axis: str
    size: int
    intra_process: bool = True

    def infeasible_reason(self, topo: WorldTopology, trailing: int = 1):
        """Why this demand cannot be laid out on `topo` (None = it can).
        `trailing` is the product of other already-granted trailing-axis
        sizes it must co-divide with (e.g. model x seq)."""
        want = self.size * trailing
        if topo.n_devices % want:
            return (
                f"{self.axis} axis of {self.size} (x{trailing} trailing) "
                f"does not divide {topo.n_devices} devices"
            )
        if (
            self.intra_process
            and topo.multi_process
            and topo.local_devices % want
        ):
            return (
                f"{self.axis} axis of {self.size} (x{trailing} trailing) "
                f"does not divide the {topo.local_devices} local devices "
                f"of each process (intra-process axis)"
            )
        return None


def stage_axis_demand(n_stages):
    """Pipelining's mesh-axis contribution (the JAX package keeps it in
    parallel/pipeline.py, which imports it from here): an intra-process
    "stage" axis that excludes model/seq — all three lay out the same
    intra-process device slice."""
    return AxisDemand(STAGE_AXIS, int(n_stages), intra_process=True)


def zero_axis_demand(local_devices):
    """ZeRO-1's mesh-axis contribution (parallel/zero1.py in the JAX
    package): an intra-process "zero" axis over each host's local device
    slice."""
    return AxisDemand(ZERO_AXIS, int(local_devices), intra_process=True)


class ParallelConfig(NamedTuple):
    """The trainer-config slice world resolution consumes. Hook PRESENCE
    is a bool (the hooks themselves stay on the trainer); `sp_suspended`
    carries the per-world ulysses/ring downgrade bit."""

    model_parallel: int = 1
    has_param_specs: bool = False
    zero1: bool = False
    pipeline_stages: int = 1
    has_pipeline_spec: bool = False
    context_parallel: int = 1
    has_context_parallel_model: bool = False
    sp_suspended: bool = False


class WorldSpec:
    """A resolved world: ordered axes + which features are active.

    Hashable by `fingerprint()`, the JAX package's identity of a world:
    two worlds with the same fingerprint run the same step, so a
    membership epoch bump that resolves to the same fingerprint keeps the
    shards it has."""

    __slots__ = (
        "axes",
        "process_grouped",
        "topology",
        "tp",
        "sp",
        "pp",
        "zero1",
        "notes",
    )

    def __init__(self, axes, process_grouped, topology, tp=1, sp=1, pp=1,
                 zero1=False, notes=()):
        self.axes = tuple(axes)  # ((name, size), ...) ordered
        self.process_grouped = bool(process_grouped)
        self.topology = topology
        self.tp = tp
        self.sp = sp
        self.pp = pp
        self.zero1 = zero1
        self.notes = tuple(notes)

    def fingerprint(self):
        # Process structure is part of the program identity, not just
        # the axes: the step branches on the process count (loss over the
        # real or the padded rows), so an 8-device/1-process and an
        # 8-device/2-process pure-DP world must NOT share a fingerprint
        # even though their axes match.
        body = ",".join(f"{name}={size}" for name, size in self.axes)
        if self.process_grouped:
            body += "|pg"
        if self.topology.n_processes > 1:
            body += f"|p{self.topology.n_processes}"
        return body

    def axis_sizes(self):
        return dict(self.axes)

    def __eq__(self, other):
        return (
            isinstance(other, WorldSpec)
            and self.fingerprint() == other.fingerprint()
        )

    def __hash__(self):
        return hash(self.fingerprint())

    def __repr__(self):
        return f"WorldSpec({self.fingerprint()})"


def resolve_world_spec(
    config: ParallelConfig,
    topo: WorldTopology,
    param_check: Optional[Callable[[int], list]] = None,
) -> WorldSpec:
    """The one deterministic (config, topology) -> WorldSpec map.

    Precedence ladder (unchanged semantics from the pre-spec trainer):
    the stage axis excludes model/seq (both lay out the intra-process
    slice); seq drops before model when their product stops dividing;
    zero only factors pure multi-process DP. Every degrade lands in
    `spec.notes` as a human sentence — the trainer logs them, so the
    fallback behavior stays as loud as the ad-hoc ladder was.

    `param_check(mp) -> [violation messages]` lets the caller veto TP
    with knowledge the resolver lacks (live param shapes vs the model
    axis); resolution stays deterministic for a fixed check outcome.
    """
    notes = []
    n, local_n = topo.n_devices, topo.local_devices
    multi = topo.multi_process

    def _dp(extra_note=None):
        if extra_note:
            notes.append(extra_note)
        return WorldSpec(
            ((DATA_AXIS, n),), False, topo, notes=notes
        )

    pp = config.pipeline_stages
    if pp > 1 and config.has_pipeline_spec:
        demand = stage_axis_demand(pp)
        why = demand.infeasible_reason(topo)
        if why is None:
            return WorldSpec(
                ((DATA_AXIS, n // pp), (demand.axis, pp)),
                multi,
                topo,
                pp=pp,
                notes=notes,
            )
        notes.append(
            f"pipeline_stages {pp} infeasible on this world ({why}); "
            "running the staged model sequentially under pure data "
            "parallelism for this world"
        )
        return _dp()

    mp_eff = 1
    mp = config.model_parallel
    if mp > 1:
        if not config.has_param_specs:
            notes.append(
                f"model_parallel_size {mp} requested but the model spec "
                "has no param_specs hook; falling back to pure data "
                "parallelism"
            )
        else:
            from elasticdl_tpu_torch.parallel.tensor_parallel import (
                model_axis_demand,
            )

            demand = model_axis_demand(mp)
            why = demand.infeasible_reason(topo)
            bad = param_check(mp) if param_check is not None and not why \
                else []
            if why is not None:
                notes.append(
                    f"model_parallel_size {mp} infeasible on this world "
                    f"({why}); falling back to pure data parallelism "
                    "for this world"
                )
            elif bad:
                notes.append(
                    f"param_specs incompatible with model_parallel_size "
                    f"{mp} ({'; '.join(bad[:3])}); falling back to pure "
                    "data parallelism"
                )
            else:
                mp_eff = mp

    sp_eff = 1
    sp = config.context_parallel
    if sp > 1 and config.has_context_parallel_model and not (
        config.sp_suspended
    ):
        from elasticdl_tpu_torch.parallel.ring_attention import (
            seq_axis_demand,
        )

        demand = seq_axis_demand(sp)
        why = demand.infeasible_reason(topo, trailing=mp_eff)
        if why is None:
            sp_eff = sp
        else:
            notes.append(
                f"context_parallel_size {sp} (x model_parallel "
                f"{mp_eff}) infeasible on this world ({why}); running "
                "without sequence parallelism for this world"
            )

    if mp_eff > 1 or sp_eff > 1:
        axes = [(DATA_AXIS, n // (mp_eff * sp_eff))]
        if mp_eff > 1:
            axes.append((MODEL_AXIS, mp_eff))
        if sp_eff > 1:
            axes.append((SEQ_AXIS, sp_eff))
        return WorldSpec(
            axes, multi, topo, tp=mp_eff, sp=sp_eff, notes=notes
        )

    if config.zero1 and multi and local_n > 1:
        demand = zero_axis_demand(local_n)
        if demand.infeasible_reason(topo) is None:
            # Factor pure DP into (data across processes, zero within):
            # the batch shards over both; optimizer state shards over
            # "zero" only, staying replicated across processes.
            return WorldSpec(
                ((DATA_AXIS, topo.n_processes), (demand.axis, local_n)),
                True,
                topo,
                zero1=True,
                notes=notes,
            )
    return _dp()


def world_fingerprint(world_size):
    """The fingerprint of a data-parallel world of `world_size` one-device
    processes: the pure-DP case of `WorldSpec.fingerprint()`. The process
    count is part of it: a one-process world takes its loss over the real
    rows, a multi-process one over the padded batch."""
    n = max(1, int(world_size))
    return resolve_world_spec(
        ParallelConfig(), WorldTopology(n, 1, n)).fingerprint()


class ShardLayout:
    """Where the shards of one process sit in a resolved world: local shard
    i of process `process_rank` is shard process_rank * local_devices + i
    of the world, and its coordinate on each axis is that index unravelled
    over the spec's axes in order (the last axis fastest), as JAX reshapes
    the process-grouped device list into the mesh. Axes the spec lacks
    have size 1."""

    def __init__(self, spec: WorldSpec, process_rank=0):
        self.spec = spec
        self.process_rank = int(process_rank)
        topo = spec.topology
        self.local_devices = topo.local_devices
        self.sizes = spec.axis_sizes()
        total = math.prod(self.sizes.values())
        if total != topo.n_devices:
            raise ValueError(
                f"world spec {spec.fingerprint()} lays out {total} of "
                f"{topo.n_devices} devices")
        names = [name for name, _ in spec.axes]
        self._names = names
        self._strides = {}
        stride = 1
        for name in reversed(names):
            self._strides[name] = stride
            stride *= self.sizes[name]

    def size(self, axis):
        return self.sizes.get(axis, 1)

    @property
    def data_size(self):
        """Data positions of the world: the batch shards over the data axis
        and, in a ZeRO-1 world, the zero axis within it."""
        return self.size(DATA_AXIS) * self.size(ZERO_AXIS)

    @property
    def data_local(self):
        """Data positions inside one process."""
        return self.local_devices // (self.size(MODEL_AXIS)
                                      * self.size(SEQ_AXIS)
                                      * self.size(STAGE_AXIS))

    def coords(self, i):
        """{axis: coordinate} of local shard i (0 on absent axes). The data
        coordinate is the shard's data position: in a ZeRO-1 world (data x
        zero) data * zero size + zero, as the batch shards over both."""
        g = self.process_rank * self.local_devices + i
        out = {DATA_AXIS: 0, MODEL_AXIS: 0, SEQ_AXIS: 0, STAGE_AXIS: 0}
        for name in self._names:
            out[name] = (g // self._strides[name]) % self.sizes[name]
        if ZERO_AXIS in self.sizes:
            out[DATA_AXIS] = (out[DATA_AXIS] * self.sizes[ZERO_AXIS]
                              + out.pop(ZERO_AXIS))
        return out

    def group_key(self, i, axis):
        """Local shards with equal keys form one group along `axis`: they
        differ only in their coordinate on it."""
        c = self.coords(i)
        return tuple(v for k, v in sorted(c.items()) if k != axis)
