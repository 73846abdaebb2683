"""Elastic AllReduce trainer (counterpart of
elasticdl_tpu/worker/allreduce_trainer.py): data parallelism across
processes, and the intra-process model and seq axes of tensor, expert and
sequence parallelism.

Two modes, as in the JAX package:

- Without multi_host each worker is a world of its own: its step is the
  LocalTrainer step on its device. Membership matters only for the
  regroup: on a membership-epoch change a non-zero rank pulls rank 0's
  (variables, opt_state, version) from rank 0's COLLECTIVE service
  (parallel/broadcast.py). An epoch change that leaves the process group as
  it is keeps everything (the fast regroup).
- With multi_host the ranks of one membership epoch form one world: a
  process group of their own (parallel/distributed.py; gloo, no global
  default group). Each rank trains its part of every global minibatch:
  after backward the gradients are summed across ranks in flat buckets of
  at most 256 MiB and divided by the world's data-parallel size, then the
  optimizer steps, so every rank holds the same bits after every step.
  The loss is the all-reduced mean, taken over the padded batch (each
  rank pads its batch to a multiple of the data-parallel size by cyclic
  repetition), as the JAX step takes it over the padded global batch.
  Training goes through step leases (worker/worker.py); ranks meet at the
  master's join gate before they form a world, and a new world takes rank
  0's state by a broadcast over the group.

The JAX trainer's XLA machinery has no counterpart: no compiled steps to
keep or rebuild (a regroup rebuilds only the process group), no AOT
speculator (the world hint is polled at the world check and recorded
only), no compile
tracker (the join gate's budget is ELASTICDL_JOIN_GATE_SECONDS, else 90 s),
and no donated buffers (a failed collective leaves the trainer's state
intact: the optimizer steps only after the all-reduce returned).

Each world is resolved by the JAX package's ladder (parallel/mesh.py:
resolve_world_spec) from the trainer's parallel config and the world's
topology (processes x local shards, ELASTICDL_LOCAL_DEVICES), with the
model spec's param_specs layout checked against the parameters' shapes;
its notes are logged and its fingerprint is the JAX package's. When the
world lays out more than one shard per process (a model axis from
model_parallel_size and the param_specs hook, a seq axis from
context_parallel_size and the context_parallel_model hook, or several
data positions), the process runs them as threads (parallel/shards.py):
the full state stays the trainer's, the shards compute the step's
gradients, and the process's gradients cross processes as before. A
world of one shard per process steps as above, unchanged.

The data axis (parallel/zero1.py, parallel/quantized.py): with zero1 the
optimizer state is row-sharded over the shards of a process in a pure-DP
world (over its data positions in a one-process world, over the zero axis
the resolver lays out across processes), each shard updating its rows and
writing them back into the full parameters; with one shard per process it
does not shard, and under TP or while the seq axis is active it is ignored
or suspended, as in JAX. With quantized_grads the data axis' mean of the
gradients is int8 on the wire: among the shards of a one-process world
(the all_to_all form, or psum_lanes per model shard under TP), across the
processes of a multi-process world after an exact f32 sum of the process's
own data positions (the zero leg); the loss is then taken over the whole
padded batch. BatchNorm takes its statistics over the global batch in the
plain step (a differentiable all-reduce over every data position of the
world, layers/conv.py), and each data shard's own in the quantized step,
whose new running statistics are then averaged, as the JAX step does. The
pipeline raises NotImplementedError (a later slice, ROADMAP Queue 1 item
4).
"""

import collections
import contextlib
import functools
import hashlib
import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.params import (
    STATE_COLLECTION,
    flax_leaves,
    params_to_flax,
    state_to_flax,
)
from elasticdl_tpu_torch.common.rpc import RpcError, StatusCode
from elasticdl_tpu_torch.layers.conv import bind_batch_stats
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.parallel import broadcast
from elasticdl_tpu_torch.parallel.distributed import CommStats, World
from elasticdl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    ParallelConfig,
    WorldTopology,
    first_leaf,
    local_device_count,
    pad_batch_to_multiple,
    resolve_world_spec,
)
from elasticdl_tpu_torch.parallel.shards import (
    ProcessShards,
    meta_copy,
    meta_variables,
    placeholder_group,
)
from elasticdl_tpu_torch.parallel.quantized import quantized_pmean
from elasticdl_tpu_torch.parallel.tensor_parallel import spec_violations
from elasticdl_tpu_torch.parallel.zero1 import ShardedOptimizer
from elasticdl_tpu_torch.worker.trainer import TorchTrainer

logger = get_logger("worker.allreduce_trainer")

_C_REGROUPS = default_registry().counter(
    "edl_regroups_total",
    "Elastic world changes absorbed, by path (fast = no re-mesh / no "
    "re-lowering; rebuild = mesh and steps rebuilt)",
    labelnames=("mode",),
)

STEPS_PER_WORLD_CHECK = 20
MAX_COMM_RETRIES = 5
# Join-gate poll interval (tests set it to 0).
GATE_POLL_SECONDS = 0.25

# What counts as a communication failure worth a regroup and a retry:
# collective errors surface as RuntimeError, master calls fail as RpcError.
RETRYABLE_ERRORS = (RpcError, RuntimeError)

UNPORTED = {
    "pipeline_stages": "the pipeline slice (pipeline.py, "
                       "pipeline_interleaved.py, pipeline_schedule.py), "
                       "ROADMAP Queue 1 item 4",
}


def join_gate_budget():
    """The join-gate wait budget: ELASTICDL_JOIN_GATE_SECONDS when set, else
    90 s. The JAX function scales the default with the longest step compile
    it measured; the port compiles nothing."""
    budget = knobs.get_float("ELASTICDL_JOIN_GATE_SECONDS")
    return budget if budget > 0 else 90.0


def step_seed(seed, version):
    """The seed of the step after `version` steps: a function of the job
    seed and the shared model version only (jax's fold_in(fold_in(key(seed),
    0x5EED), version) role), so ranks agree after a join."""
    digest = hashlib.sha256(
        f"{int(seed)}:{0x5EED}:{int(version)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class AllReduceTrainer(TorchTrainer):
    def __init__(
        self,
        model,
        loss_fn,
        optimizer_spec,
        master_client,
        multi_host=False,
        seed=0,
        model_parallel_size=1,
        param_specs_fn=None,
        zero1=False,
        quantized_grads=False,
        pipeline_stages=1,
        context_parallel_size=1,
        context_parallel_impl="zigzag",
        context_parallel_model_fn=None,
        device=None,
    ):
        if (pipeline_stages or 1) != 1:
            raise NotImplementedError(
                f"AllReduceTrainer pipeline_stages={pipeline_stages} is not "
                f"ported to elasticdl_tpu_torch yet: "
                f"{UNPORTED['pipeline_stages']}")
        super().__init__(model, loss_fn, optimizer_spec, seed=seed,
                         device=device)
        self._model_parallel_size = max(1, int(model_parallel_size or 1))
        self._param_specs_fn = param_specs_fn
        self._context_parallel_size = max(
            1, int(context_parallel_size or 1))
        self._context_parallel_impl = context_parallel_impl
        self._context_parallel_model_fn = context_parallel_model_fn
        if (self._context_parallel_size > 1
                and context_parallel_model_fn is None):
            logger.warning(
                "context_parallel_size %d requested but the model spec "
                "has no context_parallel_model hook; running without "
                "sequence parallelism", self._context_parallel_size)
            self._context_parallel_size = 1
        # zero1 and quantized_grads are suspended while the seq axis is
        # active and apply again in worlds that cannot host it; zero1 is
        # ignored under TP (the JAX trainer's rules and warnings).
        self._zero1 = bool(zero1)
        self._quantized_grads = bool(quantized_grads)
        if self._context_parallel_size > 1:
            for flag, on in (("zero1", zero1),
                             ("quantized_grads", quantized_grads)):
                if on:
                    logger.warning(
                        "%s is suspended while the seq axis is active; it "
                        "applies again in worlds that cannot host sequence "
                        "parallelism", flag)
        if zero1 and self._model_parallel_size > 1:
            logger.warning(
                "zero1 is ignored when tensor parallelism is active (the "
                "optimizer layout follows the param layout); per-chip "
                "optimizer memory will NOT drop")
        # Shards per process (parallel/mesh.py); tests pin it.
        self._local_devices = local_device_count()
        # The resolved world and, where it lays out more than one shard
        # per process, the shards; with the seconds and bytes of their
        # model and seq groups.
        self._spec = None
        self._shards = None
        self.axis_stats = {MODEL_AXIS: CommStats(), SEQ_AXIS: CommStats(),
                           DATA_AXIS: CommStats()}
        # Each local shard's kernel launches, over every world it ran in.
        self.shard_launches = []
        self._seed = seed
        self._mc = master_client
        self._multi_host = multi_host
        self._group_id = -1
        self._rank = -1
        self._world_size = 0
        # The fingerprint of the world this trainer formed (None before).
        self._fingerprint = None
        self._steps_since_check = 0
        # The master-announced next world (policy scale events), polled
        # every ELASTICDL_POLICY_HINT_POLL_SECONDS (0 disables) and
        # recorded: the port has no speculator to hand it to.
        self._hint_poll_s = knobs.get_float(
            "ELASTICDL_POLICY_HINT_POLL_SECONDS")
        self._last_hint_poll = 0.0
        self.hint_seq_seen = 0
        self.hinted_world = 0
        # Guards (variables, opt_state, version): the broadcast server reads
        # them from its threads while the training thread steps.
        self._state_lock = threading.RLock()
        ip = (master_client.worker_host or "127.0.0.1").split(":")[0]
        self._world = World(local_host=ip)
        # Every worker serves its state; only rank 0's is pulled. The bound
        # port goes into the worker's host string, which the master hands
        # out verbatim as coordinator_addr.
        self._broadcast_server = broadcast.BroadcastServer(
            self._state_provider)
        master_client.worker_host = f"{ip}:{self._broadcast_server.port}"

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def group_id(self):
        """Membership epoch this trainer last joined."""
        return self._group_id

    @property
    def world(self):
        """The process group of the current epoch and its collective
        statistics."""
        return self._world

    @property
    def world_fingerprint(self):
        return self._fingerprint

    @property
    def world_spec(self):
        """The resolved WorldSpec of the current world (None before)."""
        return self._spec

    @property
    def shards(self):
        """This process's ProcessShards in the current world (None where
        the world has one shard per process)."""
        return self._shards

    # ---------- state ----------

    def restore_variables(self, exported):
        # The broadcast server reads the state from its threads; a restore
        # swaps all of it, under the same lock, and reshards the optimizer
        # for the current world.
        with self._state_lock:
            super().restore_variables(exported)
            self._place_optimizer()

    def optimizer_state_bytes(self):
        """{"shards": [bytes of each shard's optimizer state], "replicated":
        bytes of the state every shard would share}: under ZeRO-1 the
        shards' slices and the replicated leaves' state, else no shard and
        the whole state."""
        if isinstance(self._optimizer, ShardedOptimizer):
            return self._optimizer.state_bytes()
        if self._optimizer is None:
            return {"shards": [], "replicated": 0}
        return {"shards": [], "replicated": sum(
            v.numel() * v.element_size()
            for st in self._optimizer.state.values() for v in st.values()
            if torch.is_tensor(v) and v.dim())}

    def _host_state(self):
        """(variables, opt_state, version) as host copies, in the form
        parallel/broadcast.py moves."""
        variables = {**state_to_flax(self._model),
                     **params_to_flax(self._model)}
        opt_state = [np.require(leaf.detach().to("cpu", copy=True).numpy(),
                                requirements="C")
                     for leaf in self.optimizer_state_leaves()]
        return variables, opt_state, self._version

    def _state_provider(self):
        # Bounded retry, the lock released between attempts: only state
        # that cannot be read at all answers None.
        for attempt in range(3):
            with self._state_lock:
                if self._optimizer is None:
                    return None
                try:
                    return self._host_state()
                except Exception:
                    if attempt == 2:
                        logger.warning(
                            "Local state unreadable; not offering it",
                            exc_info=True)
                        return None
            time.sleep(0.05 * (attempt + 1))
        return None

    def _apply_host_state(self, host_state):
        variables, opt_state, version = host_state
        prefix = STATE_COLLECTION + "/"
        self.restore_variables({
            "variables": {k: v for k, v in variables.items()
                          if not k.startswith(prefix)},
            "state": {k: v for k, v in variables.items()
                      if k.startswith(prefix)} or None,
            "opt_state": opt_state,
            "version": version,
        })

    def state_digest(self):
        """sha256 of the model's parameters' and buffers' bytes, in
        state_dict order: equal on every rank of a world after each step
        (None before the first batch)."""
        if self._optimizer is None:
            return None
        h = hashlib.sha256()
        with self._state_lock:
            for t in self._model.state_dict().values():
                h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    # ---------- world management ----------

    def init_world_if_needed(self, force=False):
        """Poll the master for the current comm world; on a membership-epoch
        change, form the new world and take rank 0's state."""
        self._poll_world_hint()
        resp = self._mc.get_comm_rank()
        if self._world.broken and resp.rendezvous_id == self._group_id:
            # A collective of this epoch's group failed: a peer died (the
            # master drops it from the membership within its watch
            # interval) or timed out. The group cannot be re-entered at
            # its own epoch; wait for the membership to move.
            resp = self._await_epoch_change(resp)
        if resp.rank_id < 0:
            # Not registered in the group yet: announce and re-poll.
            self._mc.report_liveness()
            resp = self._mc.get_comm_rank()
        if resp.rank_id < 0:
            raise RuntimeError("master did not admit this worker to the group")
        if resp.rendezvous_id == self._group_id and not force:
            return
        logger.info(
            "World change: epoch %d -> %d (rank %d of %d)",
            self._group_id, resp.rendezvous_id, resp.rank_id,
            resp.world_size,
        )
        if self._multi_host and resp.world_size > 1:
            # Two-phase join: every rank of the epoch arrives at the
            # master's gate before any enters the rendezvous.
            resp = self._await_join_gate(resp)
        self._rank = resp.rank_id
        self._world_size = resp.world_size
        if not force and self._try_fast_regroup(resp):
            return
        if self._multi_host:
            coordinator_ip = resp.coordinator_addr.rsplit(":", 1)[0]
            self._world.ensure_world(
                f"{coordinator_ip}:{resp.rendezvous_port}",
                resp.world_size, resp.rank_id, epoch=resp.rendezvous_id)
        self._form_shards(resp.rendezvous_id)
        if self._world.is_live():
            # A multi-process world syncs through a broadcast every member
            # runs right after the rendezvous.
            self._sync_state_over_world()
        elif self._rank != 0 and resp.coordinator_addr:
            pulled = self._pull_from_rank0(resp.coordinator_addr)
            if pulled is not None:
                self._apply_host_state(pulled)
        self._group_id = resp.rendezvous_id
        _C_REGROUPS.labels(mode="rebuild").inc()
        emit_event(
            "elastic_regroup", mode="rebuild", epoch=resp.rendezvous_id,
            spec=self._fingerprint, world_size=resp.world_size,
        )

    # ---------- the world spec and the shards ----------

    def _parallel_config(self, sp_suspended=False):
        return ParallelConfig(
            model_parallel=self._model_parallel_size,
            has_param_specs=self._param_specs_fn is not None,
            zero1=self._zero1,
            context_parallel=self._context_parallel_size,
            has_context_parallel_model=(
                self._context_parallel_model_fn is not None),
            sp_suspended=sp_suspended,
        )

    def _param_check(self, mp):
        """The param_specs layout against the parameters' shapes: split
        dims that do not divide by mp (as the JAX trainer's
        _spec_violations checks them)."""
        variables = meta_variables(meta_copy(self._model))
        return spec_violations(
            {name: tuple(v.shape) for name, v in variables.items()},
            self._param_specs_fn(variables), mp)

    def _resolve_spec(self, sp_suspended=False):
        topo = WorldTopology.current(self._world.size, self._local_devices)
        return resolve_world_spec(self._parallel_config(sp_suspended), topo,
                                  param_check=self._param_check)

    def _form_shards(self, epoch):
        """Resolves this world's spec, logs its notes, and builds the
        shards where it lays out more than one per process."""
        spec = self._resolve_spec()
        if spec.sp > 1:
            # A hook rejection that depends on this world (ulysses under a
            # model axis) drops the seq axis for this world only.
            try:
                self._context_parallel_model_fn(
                    group=placeholder_group(SEQ_AXIS, spec.sp),
                    head_axis=MODEL_AXIS if spec.tp > 1 else None,
                    impl=self._context_parallel_impl)
            except ValueError as e:
                logger.warning(
                    "context_parallel_model hook rejected this world's "
                    "configuration (%s); running without sequence "
                    "parallelism for this world", e)
                spec = self._resolve_spec(sp_suspended=True)
        for note in spec.notes:
            logger.warning("%s", note)
        if self._shards is not None:
            self._shards.close()
            self._shards = None
        self._spec = spec
        self._fingerprint = spec.fingerprint()
        live = self._world.is_live()
        quantized = self._quantized_active()
        # BatchNorm's statistics: the global batch's in the plain step, each
        # data shard's own in the quantized one.
        cross_bn = not quantized and any(
            True for _ in self._model.buffers())
        bind_batch_stats(self._model, None)
        if spec.topology.local_devices > 1:
            self._shards = ProcessShards(
                self._model, spec, self._world.rank, self._device, epoch,
                param_specs_fn=self._param_specs_fn,
                context_parallel_model_fn=self._context_parallel_model_fn,
                context_parallel_impl=self._context_parallel_impl,
                axis_stats=self.axis_stats, launches=self._launches(
                    spec.topology.local_devices),
                local_host=self._world._local_host,
                data_group=cross_bn or (quantized and not live),
                batch_store=self._world.shard_store if live else None,
                bind_stats=cross_bn)
        elif cross_bn and live:
            bind_batch_stats(self._model, self._world.axis_group())
        self._place_optimizer()
        logger.info("World spec %s: %d shard(s) per process",
                    self._fingerprint, spec.topology.local_devices)

    def _quantized_active(self):
        """quantized_grads in this world: suspended while the seq axis is
        active."""
        return self._quantized_grads and (self._spec is None
                                          or self._spec.sp == 1)

    def _zero_shards(self):
        """The shards ZeRO-1 splits the optimizer state over in this world
        (0: it does not): every shard of the process in a pure-DP world
        with more than one."""
        spec = self._spec
        if not self._zero1 or spec is None or spec.tp > 1 or spec.sp > 1:
            return 0
        if spec.topology.local_devices <= 1:
            if spec.topology.n_processes > 1:
                logger.warning(
                    "zero1 has no effect in this world: each process holds "
                    "one device, so there is no intra-process axis to shard "
                    "optimizer state over")
            return 0
        return spec.topology.local_devices

    def _place_optimizer(self):
        """The optimizer in this world's layout: row-sharded over the
        shards (ZeRO-1), else over the full parameters; a change of layout
        gathers the full state first and reshards it after."""
        if self._optimizer is None:
            return
        n = self._zero_shards()
        current = self._optimizer
        if isinstance(current, ShardedOptimizer):
            if n == current.n:
                return
            current = current.to_full(list(self._model.parameters()))
        if n > 1:
            current = ShardedOptimizer.from_full(
                current, self._optimizer_spec, flax_leaves(self._model), n,
                self._shards.devices)
        self._optimizer = current

    def _launches(self, n):
        while len(self.shard_launches) < n:
            self.shard_launches.append(collections.Counter())
        return self.shard_launches[:n]

    def _try_fast_regroup(self, resp):
        """Membership moved but no process group has to change (every
        world without multi_host, and a world of 1 that stays one): adopt
        the epoch, and take rank 0's state if this rank is not rank 0 (it
        may be the joiner)."""
        if self._fingerprint is None:
            return False
        if self._multi_host and (resp.world_size > 1
                                 or self._world.is_live()):
            return False
        if self._rank != 0 and resp.coordinator_addr:
            pulled = self._pull_from_rank0(resp.coordinator_addr)
            if pulled is not None:
                self._apply_host_state(pulled)
        self._group_id = resp.rendezvous_id
        _C_REGROUPS.labels(mode="fast").inc()
        emit_event(
            "elastic_regroup", mode="fast", epoch=resp.rendezvous_id,
            spec=self._fingerprint, world_size=resp.world_size,
        )
        logger.info(
            "World change to epoch %d absorbed without a regroup (spec %s "
            "unchanged)", resp.rendezvous_id, self._fingerprint)
        return True

    def _await_join_gate(self, resp, timeout=None):
        """Poll the master's join gate until the whole world of
        resp.rendezvous_id has arrived (world_ready), following any epoch
        bump to the newest world. Falls through with a warning after the
        budget; the rendezvous timeout is then the backstop."""
        if timeout is None:
            timeout = join_gate_budget()
        deadline = time.time() + timeout
        last_liveness = 0.0
        while time.time() < deadline:
            # The gate can outlast the master's silent-worker window; a
            # polling worker must not look dead (re-registering the same
            # host is a membership no-op).
            if time.time() - last_liveness > 5.0:
                self._mc.report_liveness()
                last_liveness = time.time()
            gated = self._mc.get_comm_rank(ready_epoch=resp.rendezvous_id)
            if gated.rendezvous_id != resp.rendezvous_id:
                if gated.rank_id < 0:
                    # Dropped from the group mid-gate; announce and rejoin.
                    self._mc.report_liveness()
                    time.sleep(GATE_POLL_SECONDS)
                    continue
                logger.info(
                    "Membership moved at the join gate: epoch %d -> %d "
                    "(rank %d of %d)", resp.rendezvous_id,
                    gated.rendezvous_id, gated.rank_id, gated.world_size)
                resp = gated
                if resp.world_size <= 1:
                    return resp
                continue
            if gated.world_ready:
                return resp
            time.sleep(GATE_POLL_SECONDS)
        logger.warning(
            "Join gate for epoch %d did not fill within %.0fs; proceeding "
            "to the rendezvous anyway", resp.rendezvous_id, timeout)
        return resp

    def _await_epoch_change(self, resp, timeout=None):
        """Poll the membership until its epoch moves past
        resp.rendezvous_id (within the join-gate budget); returns the last
        answer."""
        deadline = time.time() + (timeout or join_gate_budget())
        while time.time() < deadline:
            fresh = self._mc.get_comm_rank()
            if fresh.rendezvous_id != resp.rendezvous_id:
                logger.info("Membership moved past the failed epoch %d: "
                            "epoch %d (rank %d of %d)", resp.rendezvous_id,
                            fresh.rendezvous_id, fresh.rank_id,
                            fresh.world_size)
                return fresh
            time.sleep(GATE_POLL_SECONDS)
        logger.warning("Membership stayed at the failed epoch %d for %.0fs",
                       resp.rendezvous_id, timeout or join_gate_budget())
        return resp

    def _zero_template(self):
        """The host state's shapes, zero-filled: what a rank whose state
        cannot be read offers to the broadcast (it receives rank 0's)."""
        variables = {name: np.zeros(a.shape, a.dtype)
                     for name, a in {**state_to_flax(self._model),
                                     **params_to_flax(self._model)}.items()}
        opt_state = [np.zeros(tuple(leaf.shape),
                              leaf.detach().cpu().numpy().dtype)
                     for leaf in self.optimizer_state_leaves()]
        return variables, opt_state, 0

    def _sync_state_over_world(self):
        """Every rank takes rank 0's (variables, opt_state, version) by a
        broadcast over the new world's process group."""
        if self._optimizer is None:
            return
        host_state = self._state_provider() or self._zero_template()
        synced = broadcast.sync_state_over_world(self._world, host_state)
        if self._rank != 0:
            self._apply_host_state(synced)
        logger.info(
            "Collective state sync complete (version %d, source rank 0, "
            "this rank %d)", synced[2], self._rank)

    def _pull_from_rank0(self, coordinator_addr):
        if self._optimizer is None:
            return None  # nothing local to align; init will seed from data
        try:
            state = broadcast.pull_state(
                coordinator_addr, broadcast.variable_names(self._model))
        except Exception as e:
            logger.warning(
                "Broadcast pull from %s failed (%s); keeping local state",
                coordinator_addr, e)
            return None
        if state is not None:
            logger.info("Pulled rank-0 state (version %d) from %s",
                        state[2], coordinator_addr)
        return state

    def _poll_world_hint(self):
        """Throttled get_world_hint poll, at the world check and so never
        inside a step; a new announcement (hint_seq advanced) is recorded
        in hint_seq_seen and hinted_world."""
        if self._hint_poll_s <= 0:
            return
        now = time.time()
        if now - self._last_hint_poll < self._hint_poll_s:
            return
        self._last_hint_poll = now
        try:
            hint = self._mc.get_world_hint()
        except RpcError as e:
            if e.code() == StatusCode.UNIMPLEMENTED:
                self._hint_poll_s = 0.0  # a master without the board
            return
        if hint.hint_seq > self.hint_seq_seen:
            self.hint_seq_seen = hint.hint_seq
            self.hinted_world = hint.target_world_size
            logger.info("World hint #%d: target world %d (%s)",
                        hint.hint_seq, hint.target_world_size, hint.reason)

    # ---------- Trainer interface ----------

    def init_variables_if_needed(self, features):
        if self._optimizer is None:
            with self._state_lock:
                super().init_variables_if_needed(features)
        if self._fingerprint is None:
            self.init_world_if_needed(force=True)

    def train_minibatch(self, features, labels):
        self.init_variables_if_needed(features)
        self._steps_since_check += 1
        if self._steps_since_check >= STEPS_PER_WORLD_CHECK:
            self._steps_since_check = 0
            self.init_world_if_needed()
        for attempt in range(MAX_COMM_RETRIES):
            try:
                loss = self._run_step(features, labels)
                return True, self._version, loss
            except RETRYABLE_ERRORS:
                if attempt == MAX_COMM_RETRIES - 1:
                    raise
                logger.warning(
                    "Step failed (attempt %d); re-checking world",
                    attempt + 1, exc_info=True)
                time.sleep(min(3, 0.1 * 2**attempt))
                self.init_world_if_needed(force=True)

    def train_lease_minibatch(self, features, labels):
        """One step with NO world check and NO retry: in step-lease mode
        every rank must run the same step sequence, so recovery belongs to
        the lease loop (which abandons the lease and regroups)."""
        self.init_variables_if_needed(features)
        return self._run_step(features, labels)

    @contextlib.contextmanager
    def _step_rng(self):
        """The default generators seeded from (seed, version) for the step,
        restored after it."""
        devices = [self._device] if self._device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices,
                                   device_type=self._device.type):
            torch.manual_seed(step_seed(self._seed, self._version))
            yield

    def _run_step(self, features, labels):
        if self._shards is not None:
            return self._run_sharded_step(features, labels)
        world = self._world
        quantized = self._quantized_active()
        # One rank of a one-process world pads nothing, and its step is
        # the LocalTrainer step.
        features, _ = pad_batch_to_multiple(features, world.size)
        labels, _ = pad_batch_to_multiple(labels, world.size)
        features, labels = self._to_device(features), self._to_device(labels)
        with self._step_rng():
            self._model.train()
            loss = self._loss_fn(labels, self._model(features))
            self._optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss = loss.detach()
        if world.is_live() or quantized:
            for p in self._model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if quantized:
            # A world of one still rounds, as the JAX step does.
            _quantized_mean(flax_leaves(self._model), world.axis_group(),
                            "all_to_all")
            loss = self._world_mean_loss(loss)
            self._mean_buffers_over_world()
        elif world.is_live():
            grads = [p.grad for p in self._model.parameters()]
            total = loss.reshape(1).clone()
            world.all_reduce_sum_(grads + [total])
            torch._foreach_div_(grads, world.size)
            loss = total[0] / world.size
        with self._state_lock:
            self._optimizer.step()
            self._version += 1
        return loss

    def _run_sharded_step(self, features, labels):
        """One step across this process's shards (parallel/shards.py): the
        batch padded to a multiple of the world's data positions, as the JAX
        step pads the global batch, and the loss over the real rows in a
        one-process world, over the padded batch across processes and in
        the quantized step."""
        world, shards = self._world, self._shards
        live = world.is_live()
        quantized = self._quantized_active()
        form = "psum_lanes" if shards.mp > 1 else "all_to_all"
        multiple = (shards.layout.data_size if live
                    else shards.layout.data_local)
        features, real_n = pad_batch_to_multiple(features, multiple)
        labels, _ = pad_batch_to_multiple(labels, multiple)
        if live or quantized:
            real_n = np.shape(first_leaf(labels))[0]
        # The quantized data leg inside the process: each shard's gradients
        # of its own mean loss, reduced among the shards in their threads.
        in_process_q = quantized and not live
        self._optimizer.zero_grad(set_to_none=True)
        with self._step_rng():
            loss = shards.step(
                self._loss_fn, features, labels, real_n,
                unweighted=in_process_q,
                after_backward=(functools.partial(_quantize_shard, form=form)
                                if in_process_q else None))
        shards.gather_buffers(mean=quantized)
        if live and quantized:
            # The process's data positions summed exactly (the zero leg),
            # then the data axis across processes in int8.
            _quantized_mean(flax_leaves(self._model), world.axis_group(),
                            form)
            loss = self._world_mean_loss(loss)
            self._mean_buffers_over_world()
        elif live:
            grads = [p.grad for p in self._model.parameters()]
            total = loss.reshape(1).clone()
            world.all_reduce_sum_(grads + [total])
            torch._foreach_div_(grads, world.size)
            loss = total[0] / world.size
        with self._state_lock:
            self._optimizer.step()
            self._version += 1
        return loss

    def _world_mean_loss(self, loss):
        """The loss averaged over the world's processes (exact f32)."""
        if not self._world.is_live():
            return loss
        total = loss.reshape(1).clone()
        self._world.all_reduce_sum_([total])
        return total[0] / self._world.size

    def _mean_buffers_over_world(self):
        """The quantized step's BatchNorm running statistics: each process's
        averaged over the world (the JAX step's pmean of the new state)."""
        buffers = list(self._model.buffers())
        if buffers and self._world.is_live():
            self._world.all_reduce_sum_(buffers)
            torch._foreach_div_(buffers, self._world.size)

    def close(self):
        if self._shards is not None:
            self._shards.close()
            self._shards = None
        self._broadcast_server.stop()
        self._world.leave_world()


def _quantized_mean(leaves, group, form):
    """The gradients of `leaves` (FlaxLeafs, every gradient set) replaced
    by their int8-wire mean over `group`, flattened in the JAX tree's order
    and layout (parallel/quantized.py)."""
    grads = [x.to_flax(x.param.grad) for x in leaves]
    reduced = quantized_pmean(grads, group, form)
    with torch.no_grad():
        for grad, value in zip(grads, reduced):
            grad.copy_(value)


def _quantize_shard(i, leaves, groups, form):
    """In shard i's thread after its backward: its gradients' mean over
    its data-axis group."""
    for x in leaves:
        if x.param.grad is None:
            x.param.grad = torch.zeros_like(x.param)
    _quantized_mean(leaves, groups[DATA_AXIS], form)
