"""The data axis of the port's AllReduceTrainer (elasticdl_tpu_torch/
parallel/{zero1,quantized}.py, worker/allreduce_trainer.py, layers/conv.py
BatchNorm) against the port's own replicated step and the JAX package on
the same inputs and weights: ZeRO-1 bitwise against the replicated update
for every optimizer and through the pull, the checkpoint and a regroup;
the quantized mean in both forms against the JAX functions under
shard_map; the quantized trainer against the exact one and the JAX
trainer, with and without TP; BatchNorm over shards and over ranks against
LocalTrainer on the whole batch and the JAX trainer's 8-device step. Shards
and ranks are threads of this process on gloo."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import test_module
from elasticdl_tpu.common.jax_compat import shard_map
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.mnist import mnist_model as jmnist
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.ops import optimizers as joptim
from elasticdl_tpu.parallel import quantized as jq
from elasticdl_tpu.worker.allreduce_trainer import (
    AllReduceTrainer as JaxAllReduceTrainer,
)
from elasticdl_tpu.worker.master_client import MasterClient as JaxClient
from elasticdl_tpu_torch.common.params import params_to_flax, state_to_flax
from elasticdl_tpu_torch.common.save_utils import (
    restore_trainer_checkpoint,
    save_trainer_checkpoint,
)
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.layers.conv import BatchNorm
from elasticdl_tpu_torch.models.mnist import mnist_model
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers as toptim
from elasticdl_tpu_torch.parallel import quantized as tq
from elasticdl_tpu_torch.parallel import zero1
from elasticdl_tpu_torch.parallel.shards import run_group
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.trainer import LocalTrainer
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_allreduce import (
    _Control,
    _Linear,
    _assert_state_equal,
    _in_threads,
    _linear_loss,
    _no_waits,  # noqa: F401 - the autouse fixture
    _state,
)
from test_utils import start_master

torch.set_num_threads(1)

N = 8  # the JAX side's CPU devices (tests/conftest.py)
# XLA's backend at optimization level 0 where the test compiles: the same
# IEEE arithmetic in a fraction of the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0}
LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, max_len=16,
          activation_dtype="float32")
OPTIMIZERS = {
    "sgd": lambda: toptim.sgd(0.1),
    "momentum": lambda: toptim.momentum(0.1),
    "adam": lambda: toptim.adam(0.01),
    "amsgrad": lambda: toptim.adam(0.01, amsgrad=True),
    "adagrad": lambda: toptim.adagrad(0.1),
}


def _lm_batch(n, seed=0):
    tokens = synthetic_lm_tokens(n, LM["max_len"], vocab=LM["vocab"],
                                 branching=4, seed=seed)
    return tokens[:, :-1], tokens[:, 1:]


def _lm_trainer(control, worker_id, local, opt, **kw):
    t = AllReduceTrainer(tlm.custom_model(tlm.LMConfig(**LM)), tlm.loss,
                         opt, control.client(worker_id), device="cpu",
                         seed=1, **kw)
    t._local_devices = local
    return t


def _jax_trainer(master, model, loss, opt, x, **kw):
    mc = JaxClient(master["addr"], worker_id=0, worker_host="127.0.0.1")
    trainer = JaxAllReduceTrainer(model, loss, opt, mc, seed=7, **kw)
    key = jax.random.PRNGKey(7)
    variables = jax.jit(model.init).lower(key, x).compile(
        compiler_options=FAST_COMPILE)(key, x)
    trainer.restore_variables({"variables": dict(variables), "version": 0})
    return trainer, mc


def _jax_flat(trainer, collection="params"):
    return {k: np.asarray(v) for k, v in flatten_params(
        trainer._variables[collection])[0].items()}


@pytest.fixture
def warnings_of_trainer(monkeypatch):
    """The trainer's logged warnings, as text (the port's loggers do not
    propagate to pytest's capture)."""
    from elasticdl_tpu_torch.worker import allreduce_trainer as art

    seen = []
    monkeypatch.setattr(art.logger, "warning",
                        lambda msg, *a, **kw: seen.append(msg % a))
    return seen


def _close_to(ours, theirs, rtol):
    """assert_allclose(rtol, atol=rtol * the largest value) per key, in one
    vectorized pass (the MNIST CNN's 12.8M-weight Dense makes numpy's
    report-building slow)."""
    assert set(ours) == set(theirs)
    for k, want in theirs.items():
        got, want = np.asarray(ours[k]), np.asarray(want)
        limit = rtol * (np.abs(want).max() + np.abs(want))
        assert np.all(np.abs(got - want) <= limit), (
            k, float(np.abs(got - want).max()), float(np.abs(want).max()))


# ---------- ZeRO-1 ----------


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_zero1_is_the_replicated_update_bitwise(name):
    """Two data shards of one process, four steps: the losses, parameters
    and gathered optimizer leaves of zero1 equal the replicated update's
    bit for bit, and each shard holds half of every divisible leaf."""
    control = _Control()
    base = _lm_trainer(control, 0, 2, OPTIMIZERS[name]())
    z = _lm_trainer(_Control(), 0, 2, OPTIMIZERS[name](), zero1=True)
    try:
        for step in range(4):
            x, y = _lm_batch(8, step)
            assert torch.equal(base.train_minibatch(x, y)[2],
                               z.train_minibatch(x, y)[2]), step
        _assert_state_equal(_state(base), _state(z))
        assert z.world_fingerprint == "data=2"
        opt = z._optimizer
        assert isinstance(opt, zero1.ShardedOptimizer) and opt.n == 2
        for i, parts in enumerate(opt.parts):
            for leaf, rows, p in parts:
                full = leaf.to_flax(leaf.param).shape
                assert p.shape[0] * 2 == full[0] and rows.start == i * (
                    full[0] // 2)
        got = z.optimizer_state_bytes()
        whole = base.optimizer_state_bytes()["replicated"]
        assert got["shards"][0] == got["shards"][1]
        assert sum(got["shards"]) + got["replicated"] == whole
    finally:
        base.close()
        z.close()


def test_weight_update_specs_shard_divisible_leading_dims():
    specs = zero1.weight_update_specs(
        {"a": (8, 3), "b": (3, 8), "c": (), "d": (4,)}, 4)
    assert specs == {"a": ("data", None), "b": (), "c": (),
                     "d": ("data",)}
    assert zero1.row_slices({"a": (8, 3), "b": (3,)}, 4, 2) == {
        "a": slice(4, 6), "b": None}


def test_zero1_matches_the_jax_trainer():
    """Momentum (a state leaf per parameter) on the LM: the port's zero1
    world of 2 shards against the JAX trainer's zero1=True on its 8-device
    mesh, within 1e-5 of the largest value."""
    x, y = _lm_batch(16)
    with start_master(training_shards={"f": (0, 100)},
                      with_membership=True) as master:
        jt, jmc = _jax_trainer(master, jlm.custom_model(jlm.LMConfig(**LM)),
                               jlm.loss, joptim.momentum(learning_rate=0.1),
                               x, zero1=True)
        pt = _lm_trainer(_Control(), 0, 2, toptim.momentum(0.1), zero1=True)
        try:
            pt.load_flax_params(_jax_flat(jt))
            for step in range(3):
                x, y = _lm_batch(16, step)
                jloss = float(jt.train_minibatch(x, y)[2])
                loss = float(pt.train_minibatch(x, y)[2])
                assert loss == pytest.approx(jloss, rel=1e-5)
            _close_to(params_to_flax(pt._model), _jax_flat(jt), 1e-5)
        finally:
            jt.close()
            jmc.close()
            pt.close()


def test_zero1_pull_checkpoint_and_regroup_are_bitwise(tmp_path):
    """The full state of a zero1 trainer, gathered: a joiner's rank-0 pull,
    the worker checkpoint's round trip and a regroup 2 -> 1 -> 2 shards
    keep (variables, Adam moments, version) bit for bit."""
    control = _Control()
    t = _lm_trainer(control, 0, 2, toptim.adam(0.01), zero1=True)
    x, y = _lm_batch(8)
    try:
        t.train_minibatch(x, y)
        t.train_minibatch(x, y)
        before = _state(t)
        joiner = _lm_trainer(control, 1, 2, toptim.adam(0.01), zero1=True)
        try:
            joiner.init_variables_if_needed(x)
            assert (joiner.rank, joiner.world_size) == (1, 2)
            assert isinstance(joiner._optimizer, zero1.ShardedOptimizer)
            _assert_state_equal(_state(joiner), before)
        finally:
            joiner.close()
        save_trainer_checkpoint(t, str(tmp_path / "ckpt"))
        fresh = _lm_trainer(_Control(), 0, 2, toptim.adam(0.01), zero1=True)
        try:
            fresh.init_variables_if_needed(x)
            restore_trainer_checkpoint(fresh, str(tmp_path / "ckpt"))
            _assert_state_equal(_state(fresh), before)
        finally:
            fresh.close()
        for local, sharded in ((1, False), (2, True)):
            t._local_devices = local
            t.init_world_if_needed(force=True)
            assert isinstance(t._optimizer,
                              zero1.ShardedOptimizer) is sharded
            _assert_state_equal(_state(t), before)
        t.train_minibatch(x, y)
        assert t.get_model_version() == 3
    finally:
        t.close()


def test_zero1_falls_back_under_tp_and_with_one_shard_per_process(
        warnings_of_trainer):
    control = _Control()
    tp = _lm_trainer(control, 0, 2, toptim.adam(0.01), zero1=True,
                     model_parallel_size=2, param_specs_fn=tlm.param_specs)
    try:
        tp.train_minibatch(*_lm_batch(4))
        assert not isinstance(tp._optimizer, zero1.ShardedOptimizer)
        assert any("zero1 is ignored" in w for w in warnings_of_trainer)
    finally:
        tp.close()
    control = _Control()
    ranks = [_lm_trainer(control, i, 1, toptim.adam(0.01), zero1=True,
                         multi_host=True) for i in range(2)]
    for t in ranks:
        t._mc.report_liveness()
    x, y = _lm_batch(8)
    try:
        _in_threads(*[(lambda t=t, i=i: t.train_minibatch(
            x[4 * i:4 * i + 4], y[4 * i:4 * i + 4])) for i, t in
            enumerate(ranks)])
        assert not isinstance(ranks[0]._optimizer, zero1.ShardedOptimizer)
        assert any("zero1 has no effect in this world" in w
                   for w in warnings_of_trainer)
    finally:
        for t in ranks:
            t.close()


# ---------- the quantized mean ----------


def _jax_pmean(tree, collectives):
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
    fn = jax.jit(shard_map(
        lambda t: jax.tree_util.tree_map(
            lambda v: v[None], jq.quantized_pmean(
                jax.tree_util.tree_map(lambda v: v[0], t), "data",
                collectives=collectives)),
        mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: P("data"), tree),),
        out_specs=jax.tree_util.tree_map(lambda _: P("data"), tree),
        check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn.lower(tree).compile(
        compiler_options=FAST_COMPILE)(tree))


def _grid(values, n):
    """The int8 payload behind dequantized block values (each block's
    absmax lies on the grid's 127)."""
    blocks = np.concatenate([v.reshape(-1) for v in values])
    blocks = np.pad(blocks, (0, -len(blocks) % n)).reshape(n, -1)
    scale = np.abs(blocks).max(1, keepdims=True) / 127.0 + 1e-12
    return np.round(blocks / scale), scale


@pytest.mark.parametrize("collectives", ["all_to_all", "psum_lanes"])
def test_quantized_pmean_matches_jax(collectives):
    """Eight members, the same leaves in the same order: every element
    within one step of its block's scale of the JAX result, the int8
    payloads equal on at least 99.9% of the elements, and the mean
    quantized (not exact)."""
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(N, 37)).astype(np.float32),
            "w": rng.normal(size=(N, 24, 41)).astype(np.float32)}
    want = _jax_pmean(tree, collectives)
    names = sorted(tree)  # jax's flatten order

    def blocks(r):
        flat = np.concatenate([tree[k][r].reshape(-1) for k in names])
        return np.pad(flat, (0, -len(flat) % N)).reshape(N, -1)

    def member(group):
        leaves = [torch.as_tensor(tree[k][group.rank]) for k in names]
        q, _ = tq._quantize(torch.as_tensor(blocks(group.rank)))
        return q, tq.quantized_pmean(leaves, group, collectives)

    out = run_group(N, member, axis="data")
    jax_q = [np.asarray(jq._quantize(jnp.asarray(blocks(r)))[0])
             for r in range(N)]
    if collectives == "all_to_all":
        same = np.mean([np.mean(q.numpy() == jqr)
                        for (q, _), jqr in zip(out, jax_q)])
        assert same == 1.0
    grid_want, scale = _grid([want[k][0] for k in names], N)
    for _, got in out:
        grid_got, _ = _grid([t.numpy() for t in got], N)
        assert np.mean(grid_got == grid_want) >= 0.999
        flat_got = np.concatenate([t.numpy().reshape(-1) for t in got])
        flat_want = np.concatenate([want[k][0].reshape(-1) for k in names])
        per = -(-len(flat_want) // N)
        step = np.repeat(scale[:, 0], per)[:len(flat_want)]
        assert np.all(np.abs(flat_got - flat_want) <= step * 1.0001)
    exact = np.concatenate([tree[k].mean(0).reshape(-1) for k in names])
    assert not np.allclose(flat_got, exact, rtol=0, atol=1e-7)
    assert out[0][1][1].shape == (24, 41)


def test_quantized_pmean_in_a_group_of_one_still_rounds():
    from elasticdl_tpu_torch.parallel.distributed import AxisGroup

    x = torch.as_tensor(np.random.default_rng(1).normal(size=(300,)),
                        dtype=torch.float32)
    (got,) = tq.quantized_pmean([x], AxisGroup("data", 0, 1))
    assert not torch.equal(got, x)
    q, s = tq._quantize(x[None])
    q2, s2 = tq._quantize((q.float() * s).sum(0)[None])
    assert torch.equal(got, (q2.float() * s2).reshape(-1))


# ---------- the quantized trainer ----------


def _linear_batch16():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, test_module.FEATURE_DIM)).astype(np.float32)
    return x, (x @ test_module.TRUE_W + test_module.TRUE_B).astype(
        np.float32)


# name -> (port model and loss, JAX model and loss, batch, trainer kwargs
# of the port and of JAX, exact-vs-quantized tolerance): the linear model
# of test_trainer_quantized_grads_close_to_exact_and_int8_on_wire over
# data 8; the LM over data 4 x model 2 (test_trainer_quantized_grads_
# compose_with_tp's world: the port's model axis splits the LM's Dense
# layers, not a lone row-parallel one).
QUANTIZED_SETUPS = {
    "dp": (lambda: (_Linear(), _linear_loss),
           lambda: (test_module.custom_model(), test_module.loss),
           _linear_batch16, {}, {}, 0.15),
    "dp_tp": (lambda: (tlm.custom_model(tlm.LMConfig(**LM)), tlm.loss),
              lambda: (jlm.custom_model(jlm.LMConfig(**LM)), jlm.loss),
              lambda: _lm_batch(16),
              dict(model_parallel_size=2, param_specs_fn=tlm.param_specs),
              dict(model_parallel_size=2, param_specs_fn=jlm.param_specs),
              0.15),
}


@pytest.mark.parametrize("name", sorted(QUANTIZED_SETUPS))
def test_quantized_trainer_tracks_exact_and_jax(name):
    """Eight shards of one process, four SGD steps. The quantized losses
    track the exact trainer's within int8 noise (the JAX tests' 15%) and
    go downhill, and track the JAX quantized trainer's (its 8-device mesh)
    within 1e-3; the data axis carried the int8 wire among the shards
    (all_to_all over data 8, psum_lanes per model shard under TP)."""
    make, make_jax, batch, kw, jkw, rel = QUANTIZED_SETUPS[name]
    x, y = batch()

    def port(quantized):
        model, loss = make()
        t = AllReduceTrainer(model, loss, toptim.sgd(0.1),
                             _Control().client(0), device="cpu", seed=7,
                             quantized_grads=quantized, **kw)
        t._local_devices = N
        return t

    with start_master(training_shards={"f": (0, 100)},
                      with_membership=True) as master:
        jt, jmc = _jax_trainer(master, *make_jax(),
                               joptim.sgd(learning_rate=0.1), x,
                               quantized_grads=True, **jkw)
        named = _jax_flat(jt)
        exact, quant = port(False), port(True)
        try:
            losses = {"exact": [], "quant": [], "jax": []}
            for t in (exact, quant):
                t.load_flax_params(named)
            for _ in range(4):
                losses["jax"].append(float(jt.train_minibatch(x, y)[2]))
                losses["exact"].append(float(exact.train_minibatch(x, y)[2]))
                losses["quant"].append(float(quant.train_minibatch(x, y)[2]))
            assert quant.world_fingerprint == (
                "data=4,model=2" if kw else "data=8")
        finally:
            jt.close()
            jmc.close()
            for t in (exact, quant):
                t.close()
    assert losses["quant"][-1] < losses["quant"][0]
    for a, b, c in zip(losses["exact"], losses["quant"], losses["jax"]):
        assert b == pytest.approx(a, rel=rel), losses
        assert b == pytest.approx(c, rel=1e-3), losses
    stats = quant.axis_stats["data"]
    assert stats.calls > 0 and stats.wire > 0


def test_quantized_world_of_two_ranks_puts_a_quarter_on_the_wire():
    """Two ranks as threads on the LM (SGD at learning rate 0, so that the
    exact and the quantized world step from the same weights): the ranks
    bitwise equal to each other; their gradients within two steps of the
    largest block scale of the exact f32 all-reduce's; the gloo wire of a
    step at most 0.27 of the f32 one's."""
    x, y = _lm_batch(8)

    def world(quantized):
        control = _Control()
        ranks = [_lm_trainer(control, i, 1, toptim.sgd(0.0),
                             multi_host=True, quantized_grads=quantized)
                 for i in range(2)]
        for t in ranks:
            t._mc.report_liveness()
        return ranks

    def step(ranks):
        losses = _in_threads(*[(lambda t=t, i=i: t.train_minibatch(
            x[4 * i:4 * i + 4], y[4 * i:4 * i + 4])[2]) for i, t in
            enumerate(ranks)])
        return losses, [torch.cat([p.grad.reshape(-1) for p in
                                   t._model.parameters()]) for t in ranks]

    exact, quant = world(False), world(True)
    try:
        step(exact)  # the worlds form and sync
        step(quant)
        for t in exact + quant:
            t.world.stats.reset()
        (_, eg), (ql, qg) = step(exact), step(quant)
        assert torch.equal(ql[0], ql[1]) and torch.equal(qg[0], qg[1])
        _assert_state_equal(_state(quant[0]), _state(quant[1]))
        assert (quant[0].world.stats.wire
                <= 0.27 * exact[0].world.stats.wire)
        bound = 2 * float(eg[0].abs().max()) / 127.0
        assert float((qg[0] - eg[0]).abs().max()) <= bound
        assert not torch.equal(qg[0], eg[0])
    finally:
        for t in exact + quant:
            t.close()


# ---------- BatchNorm over the data axis ----------


def _mnist_batch(n=8):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 28, 28)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int64))


def _mnist():
    """The MNIST CNN on the meta device (the trainer materializes it)."""
    with torch.device("meta"):
        model = mnist_model.custom_model()
    return model, mnist_model.loss, mnist_model.optimizer()


def test_batchnorm_over_shards_and_ranks_matches_jax_and_local():
    """The MNIST CNN over 2 shards of one process, and over 2 World ranks
    of 2 zero1 shards each (the shards' data-axis group across the ranks),
    at batch 8: after two steps the parameters and running statistics lie
    within 1e-5 of LocalTrainer's on the whole batch and of the JAX
    trainer's 8-device step."""
    x, y = _mnist_batch()
    with start_master(training_shards={"f": (0, 100)},
                      with_membership=True) as master:
        jt, jmc = _jax_trainer(master, jmnist.custom_model(), jmnist.loss,
                               jmnist.optimizer(), x)
        named = _jax_flat(jt)
        state = {f"batch_stats/{k}": v
                 for k, v in _jax_flat(jt, "batch_stats").items()}
        try:
            for _ in range(2):
                jt.train_minibatch(x, y)
            jax_params = _jax_flat(jt)
            jax_stats = {f"batch_stats/{k}": v for k, v in
                         _jax_flat(jt, "batch_stats").items()}
        finally:
            jt.close()
            jmc.close()
    local = LocalTrainer(*_mnist(), device="cpu")
    local.load_flax_params(named, state)
    for _ in range(2):
        local.train_minibatch(x, y)

    def check(t):
        _close_to(params_to_flax(t._model), params_to_flax(local._model),
                  1e-5)
        _close_to(state_to_flax(t._model), state_to_flax(local._model),
                  1e-5)
        _close_to(params_to_flax(t._model), jax_params, 1e-5)
        _close_to(state_to_flax(t._model), jax_stats, 1e-5)

    def ranks(local_devices, **kw):
        control = _Control()
        out = []
        for i in range(2):
            t = AllReduceTrainer(*_mnist(), control.client(i), device="cpu",
                                 multi_host=True, **kw)
            t._local_devices = local_devices
            t.load_flax_params(named, state)
            out.append(t)
        for t in out:
            t._mc.report_liveness()
        return out

    shards = AllReduceTrainer(*_mnist(), _Control().client(0),
                              device="cpu")
    shards._local_devices = 2
    shards.load_flax_params(named, state)
    # (Two ranks of one shard each: tests/test_torch_allreduce.py::
    # test_batchnorm_in_a_multi_process_world_raises.)
    worlds = [[shards], ranks(2, zero1=True)]
    try:
        for _ in range(2):
            for world in worlds:
                n = len(world)
                _in_threads(*[(lambda t=t, i=i: t.train_minibatch(
                    x[8 // n * i:8 // n * (i + 1)],
                    y[8 // n * i:8 // n * (i + 1)])) for i, t in
                    enumerate(world)])
        assert [w[0].world_fingerprint for w in worlds] == [
            "data=2", "data=2,zero=2|pg|p2"]
        for world in worlds:
            check(world[0])
            assert len({t.state_digest() for t in world}) == 1
        # One statistics all-reduce per BatchNorm, forward and backward,
        # per shard and step.
        layers = sum(isinstance(m, BatchNorm) for m in shards._model.modules())
        assert shards.axis_stats["data"].calls == layers * 2 * 2 * 2
    finally:
        for world in worlds:
            for t in world:
                t.close()


def test_quantized_batchnorm_uses_each_shards_statistics():
    """In the quantized step each data shard normalizes with its own batch
    statistics and the new running statistics are their mean: one step
    over 2 shards equals two LocalTrainers on the halves, averaged."""
    x, y = _mnist_batch()
    t = AllReduceTrainer(*_mnist(), _Control().client(0), device="cpu",
                         quantized_grads=True)
    t._local_devices = 2
    halves = [LocalTrainer(*_mnist(), device="cpu") for _ in range(2)]
    try:
        t.init_variables_if_needed(x)
        named, state = params_to_flax(t._model), state_to_flax(t._model)
        losses = []
        for i, h in enumerate(halves):
            h.load_flax_params(named, state)
            losses.append(float(h.train_minibatch(x[4 * i:4 * i + 4],
                                                  y[4 * i:4 * i + 4])[2]))
        loss = float(t.train_minibatch(x, y)[2])
        assert loss == pytest.approx(np.mean(losses), rel=1e-6)
        want = {k: (state_to_flax(halves[0]._model)[k]
                    + state_to_flax(halves[1]._model)[k]) / 2
                for k in state}
        _close_to(state_to_flax(t._model), want, 1e-6)
        assert t.axis_stats["data"].calls > 0
    finally:
        t.close()


def test_quantized_is_suspended_on_the_seq_axis(warnings_of_trainer):
    t = _lm_trainer(_Control(), 0, 2, toptim.sgd(0.1), quantized_grads=True,
                    zero1=True, context_parallel_size=2,
                    context_parallel_model_fn=lambda **kw:
                    tlm.context_parallel_model(config=tlm.LMConfig(**LM),
                                               **kw))
    try:
        t.train_minibatch(*_lm_batch(4))
        assert t.world_fingerprint == "data=1,seq=2"
        assert not t._quantized_active()
        assert not isinstance(t._optimizer, zero1.ShardedOptimizer)
        for flag in ("quantized_grads", "zero1"):
            assert any(f"{flag} is suspended" in w
                       for w in warnings_of_trainer)
    finally:
        t.close()
