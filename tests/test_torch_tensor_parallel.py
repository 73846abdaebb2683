"""The port's tensor parallelism (elasticdl_tpu_torch/parallel/
tensor_parallel.py, parallel/shards.py) against the JAX package's: the
rules split what the PartitionSpecs split; shard_state then gather_state
round-trips JAX-initialized weights bitwise, each shard bitwise the JAX
array's shard on a model mesh (the head split of qkv included); and a
DP x TP step in one process of 8 shards against the JAX step on its
8-device CPU mesh (data 2 x model 4), as test_dp_tp_step_matches_replicated
runs it: loss and gradients within 1e-5 of the largest value (float32, the
same arithmetic summed in another order)."""

import socket

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from elasticdl_tpu.common.pytree_utils import flatten_params, walk_dict
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.parallel.tensor_parallel import transformer_param_specs
from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.common.params import flax_leaves
from elasticdl_tpu_torch.master.membership import MembershipManager
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers as toptim
from elasticdl_tpu_torch.parallel import tensor_parallel as tp
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient

torch.set_num_threads(1)

RTOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0}
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, max_len=16,
           activation_dtype="float32")


@pytest.fixture(scope="module")
def jax_lm():
    model = jlm.custom_model(jlm.LMConfig(**CFG))
    tokens = (np.arange(4 * (CFG["max_len"] + 1)).reshape(
        4, CFG["max_len"] + 1) * 7) % CFG["vocab"]
    features, labels = tokens[:, :-1], tokens[:, 1:]
    params = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(0)}, x, training=False)).lower(
        features).compile(compiler_options=FAST_COMPILE)(features)["params"]
    return model, params, features, labels


def _named(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree)[0].items()}


def _jax_specs(params):
    return {"/".join(path): tuple(spec) for path, spec in
            walk_dict(transformer_param_specs(params))}


def test_spec_rules_cover_split_dims(jax_lm):
    _, params, _, _ = jax_lm
    named = _named(params)
    got = tp.transformer_param_specs(named)
    assert got == _jax_specs(params)
    assert got["Block_0/MultiHeadAttention_0/qkv/kernel"] == (
        None, None, "model", None)
    assert got["Block_0/Dense_1/bias"] == ()
    assert got["LayerNorm_0/scale"] == ()
    tp.validate_divisibility(tlm.LMConfig(**CFG), 4)
    with pytest.raises(ValueError):
        tp.validate_divisibility(tlm.LMConfig(**CFG), 3)
    assert tp.spec_violations({k: v.shape for k, v in named.items()}, got,
                              4) == []
    assert tp.spec_violations({k: v.shape for k, v in named.items()}, got,
                              3)


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_then_gather_is_bitwise_and_matches_jax_shards(jax_lm, mp):
    _, params, _, _ = jax_lm
    named = _named(params)
    specs = tp.transformer_param_specs(named)
    parts = tp.shard_state(named, specs, mp)
    joined = tp.gather_state(parts, specs)
    assert set(joined) == set(named)
    for name, value in named.items():
        assert joined[name].dtype == value.dtype
        assert np.array_equal(joined[name], value), name
    # Each shard is the JAX array's shard on a 1-D model mesh.
    mesh = Mesh(np.array(jax.devices()[:mp]), ("model",))
    flat = flatten_params(jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        transformer_param_specs(params),
        is_leaf=lambda x: isinstance(x, P)))[0]
    for name, array in flat.items():
        shards = sorted(array.addressable_shards, key=lambda s: s.device.id)
        for m, shard in enumerate(shards):
            assert np.array_equal(parts[m][name], np.asarray(shard.data)), (
                name, m)
    # The qkv head split: shard m holds heads [m*H/mp, (m+1)*H/mp) of each
    # of q, k and v.
    h = CFG["n_heads"] // mp
    qkv = named["Block_0/MultiHeadAttention_0/qkv/kernel"]
    assert np.array_equal(
        parts[1]["Block_0/MultiHeadAttention_0/qkv/kernel"],
        qkv[:, :, h:2 * h])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dp_tp_step_matches_jax_mesh(jax_lm):
    model, params, features, labels = jax_lm

    def loss_fn(p, x, y):
        return jlm.loss(y, model.apply({"params": p}, x, training=False))

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    param_sh = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), transformer_param_specs(params),
        is_leaf=lambda x: isinstance(x, P))
    batch_sh = NamedSharding(mesh, P("data", None))
    repl = NamedSharding(mesh, P())
    args = (jax.device_put(params, param_sh),
            jax.device_put(features, batch_sh),
            jax.device_put(labels, batch_sh))
    want_loss, want = jax.jit(
        jax.value_and_grad(loss_fn), in_shardings=(param_sh, batch_sh,
                                                   batch_sh),
        out_shardings=(repl, param_sh)).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)

    membership = MembershipManager(coordinator_port=_free_port())
    servicer = MasterServicer(TaskDispatcher({}), None, membership)
    mc = MasterClient(rpc.InProcessStub(servicer, rpc.MASTER_SERVICE), 0,
                      worker_host="127.0.0.1")
    t = AllReduceTrainer(tlm.custom_model(tlm.LMConfig(**CFG)), tlm.loss,
                         toptim.sgd(0.1), mc, device="cpu",
                         model_parallel_size=4,
                         param_specs_fn=tlm.param_specs)
    t._local_devices = 8
    try:
        t.load_flax_params(_named(params))
        _, _, loss = t.train_minibatch(np.asarray(features),
                                       np.asarray(labels))
        assert t.world_fingerprint == "data=2,model=4"
        assert abs(float(loss) - float(want_loss)) <= RTOL * abs(
            float(want_loss))
        grads = {x.name: x.to_flax(x.param.grad).detach().numpy()
                 for x in flax_leaves(t._model)}
        for name, g in _named(jax.device_get(want)).items():
            scale = np.abs(g).max()
            assert np.abs(grads[name] - g).max() <= RTOL * scale, name
    finally:
        t.close()
