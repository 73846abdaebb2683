"""Rank 0's state for elastic AllReduce regroups (counterpart of
elasticdl_tpu/parallel/broadcast.py).

A trainer's state crosses as its host form: `variables`, an ordered
{name: numpy array} of the model's `batch_stats` (BatchNorm buffers,
"batch_stats/<path>/<buffer>") and then its parameters (flax wire names),
in the order jax flattens a flax variables tree; `opt_state`, optax's
state leaves (ops/optimizers.optax_state_leaves); and the model version.

Two ways to move it:
- over the port's transport (`BroadcastServer`, `pull_state`): every
  worker serves its state on the COLLECTIVE service, and a regrouping
  rank of a one-process world pulls rank 0's. Leaves travel
  position-indexed, `v{i}` and `o{i}`, as in the JAX module: every worker
  runs the same model code, so the receiver names them with its own
  order;
- over the epoch's process group (`sync_state_over_world`): every rank
  of a multi-process world takes part in a broadcast of every leaf and
  the version from rank 0.
"""

import time

import numpy as np
import torch

from elasticdl_tpu_torch.common import rpc, tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.params import STATE_COLLECTION, flax_leaves
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("parallel.broadcast")


def variable_names(module):
    """The names of `module`'s host-form variables, in order: its buffers
    as batch_stats leaves, then its parameters, each sorted as jax
    flattens them."""
    buffers = sorted((name for name, _ in module.named_buffers()),
                     key=lambda n: tuple(n.split(".")))
    return ([f"{STATE_COLLECTION}/{n.replace('.', '/')}" for n in buffers]
            + [x.name for x in flax_leaves(module)])


def state_to_model_pb(variables, opt_state, version):
    model = pb.Model(version=version)
    for prefix, leaves in (("v", variables.values()), ("o", opt_state)):
        for i, leaf in enumerate(leaves):
            model.dense_parameters.append(
                tensor_utils.ndarray_to_tensor_pb(
                    np.asarray(leaf), f"{prefix}{i}"
                )
            )
    return model


def model_pb_to_state(model, names):
    """-> (variables {name: array} in `names` order, opt_state leaves,
    version)."""
    v_leaves, o_leaves = {}, {}
    for t in model.dense_parameters:
        arr = tensor_utils.tensor_pb_to_ndarray(t)
        (v_leaves if t.name[0] == "v" else o_leaves)[int(t.name[1:])] = arr
    if len(v_leaves) != len(names):
        raise ValueError(
            f"rank 0 sent {len(v_leaves)} variables, this model has "
            f"{len(names)}")
    variables = {name: v_leaves[i] for i, name in enumerate(names)}
    return (variables, [o_leaves[i] for i in range(len(o_leaves))],
            model.version)


class BroadcastServicer:
    """Serves the owning trainer's current state. `provider` returns
    (variables, opt_state, version) or None while uninitialized."""

    def __init__(self, provider):
        self._provider = provider

    def pull_model(self, request, context):
        state = self._provider()
        if state is None:
            return pb.Model(version=-1)
        return state_to_model_pb(*state)


class BroadcastServer:
    def __init__(self, provider, port=0):
        self._server, self.port = rpc.serve(
            BroadcastServicer(provider), rpc.COLLECTIVE_SERVICE, port=port
        )
        logger.info("Broadcast server on port %d", self.port)

    def stop(self):
        self._server.stop(0)


def pull_state(coordinator_addr, names, timeout=30):
    """Pull rank 0's state over the transport. Returns (variables,
    opt_state, version), or None if the coordinator has no state yet. The
    readiness probe and the call share one `timeout` budget."""
    start = time.time()
    channel = rpc.build_channel(coordinator_addr, ready_timeout=timeout)
    try:
        stub = rpc.Stub(channel, rpc.COLLECTIVE_SERVICE)
        remaining = max(1.0, timeout - (time.time() - start))
        model = stub.pull_model(
            pb.PullDenseParametersRequest(), timeout=remaining
        )
        if model.version < 0:
            return None
        return model_pb_to_state(model, names)
    finally:
        channel.close()


def sync_state_over_world(world, host_state):
    """Every rank's `host_state` (variables, opt_state, version) becomes
    rank 0's, through a broadcast over the world's process group; the
    other ranks' contents only give the shapes. Returns the synced
    triple."""
    variables, opt_state, version = host_state
    leaves = [np.require(a, requirements=("C", "W")) for a in
              list(variables.values()) + list(opt_state)]
    stamp = torch.tensor([version], dtype=torch.int64)
    world.broadcast_([torch.from_numpy(a) for a in leaves] + [stamp], src=0)
    n = len(variables)
    return (dict(zip(variables, leaves[:n])), leaves[n:], int(stamp[0]))
