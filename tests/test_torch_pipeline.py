"""The port's pipeline parallelism (elasticdl_tpu_torch/parallel/
pipeline.py, pipeline_interleaved.py, pipeline_schedule.py, the stage axis
of parallel/shards.py and the AllReduce trainer's pipeline path) against
the JAX package's, on a tiny float32 LM (vocab 64, d_model 32, 2 heads, 4
layers, S 16):

- the interleaved schedule tables equal JAX's over a grid of (n, v, m);
- GPipe, 1F1B and interleaved 1F1B in one process of stage 2 shards, and
  of data 2 x stage 2 shards, against the JAX schedule on its 8-device CPU
  mesh (data 2 x stage 2) on the same weights: loss within 1e-5, each
  gradient within 1e-4 of its leaf's largest value. The JAX schedule's
  result does not depend on its mesh (its own tests hold 1F1B on data x
  stage equal to stage alone), so one JAX run per schedule is the
  reference of both;
- the schedule-free sequential apply against JAX's make_lm_sequential, the
  staged tree's names and shapes against a JAX-made tree, a JAX staged
  checkpoint restored into the port and the reverse, the staged <->
  monolithic conversion;
- the trainer: each schedule's step equal to the sequential step by hand,
  a checkpoint moved between schedules, an infeasible world trained
  sequentially, a rejected hook falling back to the monolithic model;
- 1F1B's stash at most 2N inputs whatever M is, the validation errors,
  dropout, the generic pipeline_apply, and the named remat policies.

Stages and data positions are threads of this process over gloo; the JAX
sides compile at XLA optimization level 0."""

import functools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh
from elasticdl_tpu.common import save_utils as jsave
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.parallel import pipeline as jpipe
from elasticdl_tpu.parallel.pipeline_schedule import (
    build_interleaved_schedule as jax_schedule,
)
from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.common.params import (
    flax_leaves,
    load_flax,
    monolithic_to_staged,
    params_to_flax,
    staged_to_monolithic,
)
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.layers.init import materialize
from elasticdl_tpu_torch.master.membership import MembershipManager
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models.transformer import moe_lm
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers as toptim
from elasticdl_tpu_torch.parallel import mesh as pmesh
from elasticdl_tpu_torch.parallel import pipeline as pl
from elasticdl_tpu_torch.parallel.pipeline_interleaved import (
    interleaved_row_order,
)
from elasticdl_tpu_torch.parallel.pipeline_schedule import (
    build_interleaved_schedule,
)
from elasticdl_tpu_torch.parallel.shards import ProcessShards, run_group
from elasticdl_tpu_torch.worker import allreduce_trainer as art
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

torch.set_num_threads(1)

FAST_COMPILE = {"xla_backend_optimization_level": 0}
CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=4, max_len=16,
           activation_dtype="float32")
STAGES = 2
MICRO = 4
BATCH = 8
SCHEDULES = ("gpipe", "1f1b", "interleaved")
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
# One process of stage 2 shards; one of data 2 x stage 2.
WORLDS = {"stage2": (2, 2, 1), "data2_stage2": (4, 4, 1)}


def _cfg(**kw):
    return tlm.LMConfig(**{**CFG, **kw})


def _batch(n=BATCH, seed=0):
    tokens = synthetic_lm_tokens(n, CFG["max_len"], vocab=CFG["vocab"],
                                 branching=4, seed=seed)
    return tokens[:, :-1], tokens[:, 1:]


def _build(schedule, cfg=None, stages=STAGES, micro=MICRO):
    return tlm.pipeline_spec(n_stages=stages, num_microbatches=micro,
                             schedule=schedule, config=cfg or _cfg())


def _model(build, seed=0):
    model = materialize(build.init_fn(), "cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _nest(named):
    """{wire name: array} -> the nested dict a flax apply takes."""
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(value)
    return tree


def _flax_grads(model):
    return {x.name: x.to_flax(x.param.grad).detach().numpy()
            for x in flax_leaves(model)}


def _assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_reference(schedule):
    """(port weights, JAX loss, JAX grads by wire name) of the schedule on
    the JAX package's data 2 x stage 2 mesh."""
    model = _model(_build(schedule))
    named = params_to_flax(model)
    x, y = _batch()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "stage"))
    build = jlm.pipeline_spec(mesh, STAGES, MICRO, schedule=schedule,
                              batch_axis="data",
                              config=jlm.LMConfig(**CFG))
    with mesh:
        step = jax.jit(lambda p: build.loss_and_grads_fn(p, x, y)).lower(
            _nest(named)).compile(compiler_options=FAST_COMPILE)
        loss, grads = step(_nest(named))
    grads = {k: np.asarray(v) for k, v in flatten_params(grads)[0].items()}
    return named, float(loss), grads


def _port_step(build, named, world):
    """One scheduled step of the port's shards in one process of `world`
    (n_devices, local, processes): (loss, flax-layout gradients)."""
    model = _model(build)
    load_flax(model, named)
    spec = pmesh.resolve_world_spec(
        pmesh.ParallelConfig(pipeline_stages=STAGES,
                             has_pipeline_spec=True),
        pmesh.WorldTopology(*world))
    shards = ProcessShards(model, spec, 0, torch.device("cpu"), 0,
                           pipeline=build)
    try:
        x, y = _batch()
        loss = shards.pipeline_step(build, x, y, MICRO)
    finally:
        shards.close()
    return float(loss), _flax_grads(model)


# ---------- the schedules against JAX ----------


@pytest.mark.parametrize("n,v,m", [(2, 2, 4), (2, 2, 8), (4, 2, 8),
                                   (2, 4, 8), (4, 3, 12), (3, 2, 5)])
def test_interleaved_tables_equal_jax(n, v, m):
    ours, theirs = build_interleaved_schedule(n, v, m), jax_schedule(n, v, m)
    for field in ("n_stages", "v", "num_micro", "ticks", "fwd_mailbox",
                  "bwd_mailbox", "stash_depth", "dy_store"):
        assert getattr(ours, field) == getattr(theirs, field), field
    for field in ("fwd_chunk", "fwd_micro", "bwd_chunk", "bwd_micro",
                  "head_micro"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(theirs, field), err_msg=field)
    from elasticdl_tpu.parallel.pipeline_interleaved import (
        interleaved_row_order as jax_order,
    )

    np.testing.assert_array_equal(interleaved_row_order(n, v),
                                  jax_order(n, v))


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_matches_jax(schedule, world):
    named, jloss, jgrads = _jax_reference(schedule)
    loss, grads = _port_step(_build(schedule), named, WORLDS[world])
    assert abs(loss - jloss) <= LOSS_ATOL, (loss, jloss)
    _assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("rows", [2, 4])
def test_sequential_apply_matches_jax(rows):
    cfg = _cfg()
    model = _model(_build("interleaved" if rows == 4 else "1f1b"))
    named = params_to_flax(model)
    x, _ = _batch(4)
    apply = jax.jit(jpipe.make_lm_sequential(jlm.LMConfig(**CFG), rows))
    want = np.asarray(apply.lower(_nest(named), x).compile(
        compiler_options=FAST_COMPILE)(_nest(named), x))
    model.eval()
    with torch.no_grad():
        got = pl.make_lm_sequential(cfg, rows)(model, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_staged_tree_names_and_shapes_are_jax():
    """The staged tree's wire names and flax-layout shapes are those of a
    JAX-made tree (pytree_utils.flatten_params of the GPipe init)."""
    x, _ = _batch(4)
    for schedule, rows in (("1f1b", 2), ("interleaved", 4)):
        build = jlm.pipeline_spec(None, STAGES, MICRO, schedule=schedule,
                                  config=jlm.LMConfig(**CFG))
        shapes = jax.eval_shape(build.init_fn, jax.random.PRNGKey(0), x)
        want = {k: tuple(v.shape)
                for k, v in flatten_params(shapes)[0].items()}
        model = _build(schedule).init_fn()
        got = {leaf.name: tuple(leaf.to_flax(leaf.param).shape)
               for leaf in flax_leaves(model)}
        assert got == want
        assert list(got) == list(flatten_params(shapes)[1])
        assert model.total_rows == rows


class _JaxSide:
    """The JAX package's checkpoint functions' view of a trainer: the
    staged params tree and an optax Adam state."""

    def __init__(self, params, opt_state, version):
        self.variables = {"params": params}
        self.opt_state = opt_state
        self.version = version
        self._optimizer_spec = jlm.optimizer()

    def export_variables(self):
        return {"variables": self.variables, "opt_state": self.opt_state,
                "rng": np.zeros(2, np.uint32), "version": self.version}

    def restore_variables(self, exported):
        self.variables = exported["variables"]
        self.opt_state = exported["opt_state"]
        self.version = exported["version"]


def test_jax_staged_checkpoint_restores_into_the_port_and_back(tmp_path):
    """A JAX staged .npz (params and Adam moments after a step) restores
    into a port trainer of the staged tree bitwise, and the port's save
    restores into the JAX side bitwise."""
    named, _, jgrads = _jax_reference("1f1b")
    opt = jlm.optimizer().to_optax()
    params = jax.tree_util.tree_map(np.asarray, _nest(named))
    state = opt.init(params)
    _, state = opt.update(_nest(jgrads), state, params)
    path = str(tmp_path / "jax.npz")
    jsave.save_trainer_checkpoint(_JaxSide(params, state, 5), path)

    build = _build("1f1b")
    trainer = LocalTrainer(build.init_fn(), tlm.loss, tlm.optimizer(),
                           device="cpu")
    trainer.init_variables_if_needed(_batch(2)[0])
    save_utils.restore_trainer_checkpoint(trainer, path)
    assert trainer.get_model_version() == 5
    for name, value in params_to_flax(trainer._model).items():
        np.testing.assert_array_equal(value, named[name], err_msg=name)
    jleaves = jax.tree_util.tree_leaves(state)
    ours = trainer.optimizer_state_leaves()
    assert len(ours) == len(jleaves)
    for a, b in zip(ours, jleaves):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))

    back = str(tmp_path / "port.npz")
    trainer.train_minibatch(*_batch(4))
    save_utils.save_trainer_checkpoint(trainer, back)
    side = _JaxSide(params, state, 0)
    jsave.restore_trainer_checkpoint(side, back)
    assert side.version == 6
    got = {k: np.asarray(v) for k, v in
           flatten_params(side.variables)[0].items()}
    for name, value in params_to_flax(trainer._model).items():
        np.testing.assert_array_equal(got["params/" + name], value)
    for a, b in zip(trainer.optimizer_state_leaves(),
                    jax.tree_util.tree_leaves(side.opt_state)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_staged_and_monolithic_trees_convert():
    """The rows are the layer stack in order: the staged tree converted to
    the plain LM's gives its logits, and converts back bitwise."""
    model = _model(_build("interleaved"))
    named = params_to_flax(model)
    plain = staged_to_monolithic(named)
    assert "Block_3/Dense_0/kernel" in plain
    np.testing.assert_array_equal(plain["Block_3/Dense_0/kernel"],
                                  named["stages/Block_0/Dense_0/kernel"][3])
    back = monolithic_to_staged(plain, 4)
    assert sorted(back) == sorted(named)
    for k, v in named.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    lm = materialize(tlm.custom_model(_cfg()), "cpu")
    load_flax(lm, plain)
    x, _ = _batch(4)
    model.eval()
    lm.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(model(torch.as_tensor(x)).numpy(),
                                      lm(torch.as_tensor(x)).numpy())


# ---------- the trainer ----------


class _Control:
    def __init__(self):
        self.membership = MembershipManager(coordinator_port=0)
        self.servicer = MasterServicer(TaskDispatcher({}), None,
                                       self.membership)

    def client(self, worker_id=0):
        return MasterClient(
            rpc.InProcessStub(self.servicer, rpc.MASTER_SERVICE),
            worker_id, worker_host="127.0.0.1")


def _trainer(schedule="1f1b", local=2, cfg=None, opt=None, **kw):
    cfg = cfg or _cfg()
    kw.setdefault("pipeline_stages", STAGES)
    kw.setdefault("pipeline_microbatches", 2)
    trainer = AllReduceTrainer(
        tlm.custom_model(cfg), tlm.loss, opt or toptim.adam(0.01),
        _Control().client(), device="cpu", seed=7,
        pipeline_schedule=schedule,
        pipeline_spec_fn=functools.partial(tlm.pipeline_spec, config=cfg),
        **kw)
    trainer._local_devices = local
    return trainer


@pytest.fixture
def warnings(monkeypatch):
    said = []
    monkeypatch.setattr(art.logger, "warning",
                        lambda msg, *a, **k: said.append(msg % a))
    return said


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_trainer_step_matches_the_sequential_step(schedule):
    """One trainer step under each schedule equals the plain step by hand
    from the trainer's own initial weights: the sequential apply, its
    gradients, then the optimizer (JAX test_trainer_pipeline_step_matches_
    dp_baseline). SGD: Adam's first step is lr times the gradient's sign
    wherever the gradient is noise (qkv's key bias, whose gradient is zero
    in exact arithmetic), and the moments move between schedules in
    test_checkpoint_moves_between_schedules."""
    x, y = _batch()
    trainer = _trainer(schedule, opt=toptim.sgd(0.1))
    try:
        trainer.init_variables_if_needed(x)
        assert trainer.world_fingerprint == "data=1,stage=2"
        rows = 4 if schedule == "interleaved" else 2
        assert trainer._model.total_rows == rows
        ref = LocalTrainer(trainer._pipeline_build.init_fn(), tlm.loss,
                           toptim.sgd(0.1), device="cpu")
        ref.load_flax_params(params_to_flax(trainer._model))
        _, _, want_loss = ref.train_minibatch(x, y)
        _, _, loss = trainer.train_minibatch(x, y)
        assert abs(float(loss) - float(want_loss)) <= LOSS_ATOL
        _assert_grads_close(_flax_grads(trainer._model),
                            _flax_grads(ref._model))
        want = params_to_flax(ref._model)
        for name, value in params_to_flax(trainer._model).items():
            np.testing.assert_allclose(value, want[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        assert [c["flash_fwd"] for c in trainer.shard_launches] == [0, 0]
    finally:
        trainer.close()


def test_checkpoint_moves_between_schedules(tmp_path):
    """GPipe and 1F1B share one tree: a GPipe trainer's checkpoint resumes
    under 1F1B with the weights and Adam moments bitwise, and trains on
    (JAX test_pipeline_checkpoint_transfers_between_schedules)."""
    x, y = _batch()
    path = str(tmp_path / "pp.npz")
    first = _trainer("gpipe")
    try:
        for _ in range(3):
            first.train_minibatch(x, y)
        saved = params_to_flax(first._model)
        saved_opt = [t.detach().clone() for t in
                     first.optimizer_state_leaves()]
        save_utils.save_trainer_checkpoint(first, path)
    finally:
        first.close()
    second = _trainer("1f1b")
    try:
        second.init_variables_if_needed(x)
        save_utils.restore_trainer_checkpoint(second, path)
        assert second.get_model_version() == 3
        for name, value in params_to_flax(second._model).items():
            np.testing.assert_array_equal(value, saved[name])
        for a, b in zip(second.optimizer_state_leaves(), saved_opt):
            assert torch.equal(a, b)
        losses = [float(second.train_minibatch(x, y)[2]) for _ in range(3)]
        assert losses[-1] < losses[0]
    finally:
        second.close()


def test_infeasible_world_trains_the_staged_tree_sequentially(warnings):
    """3 stages on 2 local devices: the world cannot host the stage axis,
    so the staged tree trains with the sequential apply under pure data
    parallelism, the tree intact."""
    cfg = _cfg(n_layers=6)
    x, y = _batch()
    trainer = _trainer("gpipe", cfg=cfg, pipeline_stages=3)
    try:
        losses = [float(trainer.train_minibatch(x, y)[2]) for _ in range(3)]
        assert trainer.world_fingerprint == "data=2"
        assert not trainer._pp_active()
        assert trainer._model.total_rows == 3
        assert losses[-1] < losses[0]
        assert any("pipeline_stages 3 infeasible" in w for w in warnings)
        out = trainer.evaluate_minibatch(x[:5])
        assert out.shape == (5, CFG["max_len"], CFG["vocab"])
    finally:
        trainer.close()


def test_rejected_or_missing_hook_and_ignored_options(warnings):
    """A hook that rejects the configuration leaves the monolithic model;
    no hook runs unpipelined; zero1 and quantized_grads are ignored under
    the pipeline; the model and seq axes cannot be combined with it."""
    trainer = _trainer(cfg=_cfg(n_layers=3))
    try:
        assert trainer._pipeline_build is None
        assert isinstance(trainer._model, tlm.TransformerLM)
        trainer.train_minibatch(*_batch())
        assert trainer.world_fingerprint == "data=2"
    finally:
        trainer.close()
    assert any("pipeline_spec hook rejected the configuration" in w
               and "not divisible" in w for w in warnings)
    trainer = AllReduceTrainer(
        tlm.custom_model(_cfg()), tlm.loss, toptim.adam(0.01),
        _Control().client(), device="cpu", pipeline_stages=2)
    trainer.close()
    assert any("no pipeline_spec hook" in w for w in warnings)
    trainer = _trainer(zero1=True, quantized_grads=True)
    trainer.close()
    assert any(w.startswith("zero1 is ignored under pipeline")
               for w in warnings)
    assert any(w.startswith("quantized_grads is ignored under pipeline")
               for w in warnings)
    for kw in (dict(model_parallel_size=2),
               dict(context_parallel_size=2,
                    context_parallel_model_fn=tlm.context_parallel_model)):
        with pytest.raises(ValueError, match="cannot be combined"):
            _trainer(**kw)


def test_trainer_pads_and_evaluates():
    """A ragged minibatch pads up to microbatches x data positions; the
    evaluation forward is the schedule-free apply on the staged tree."""
    x, y = _batch()
    trainer = _trainer("1f1b", local=4)
    try:
        _, _, loss = trainer.train_minibatch(x[:5], y[:5])
        assert trainer.world_fingerprint == "data=2,stage=2"
        assert np.isfinite(float(loss))
        out = trainer.evaluate_minibatch(x[:3])
        assert out.shape == (3, CFG["max_len"], CFG["vocab"])
    finally:
        trainer.close()


# ---------- memory, validation, dropout ----------


def test_1f1b_stash_stays_at_2n_as_microbatches_grow():
    """GPipe keeps every microbatch's activations to the backward; 1F1B
    stashes the inputs of its microbatches in flight, at most 2N whatever
    M is (JAX test_1f1b_memory_is_o_stages_not_o_microbatches)."""
    peaks = {}
    for micro in (4, 8, 16):
        build = _build("1f1b", micro=micro)
        model = _model(build)

        def run(group):
            rows = build.stage_rows_fn(group.rank)
            stage = materialize(model.stage_copy(rows), "cpu")
            load_flax(stage, {k: v[rows] if k.startswith("stages/") else v
                              for k, v in params_to_flax(model).items()})
            stats = {}
            build.loss_and_grads_fn(stage, *_batch(2 * micro), group,
                                    stats=stats)
            return stats

        stats = run_group(STAGES, run, axis=pmesh.STAGE_AXIS)
        assert all(s["stash_depth"] == 2 * STAGES for s in stats)
        peaks[micro] = [s["stash_peak"] for s in stats]
    assert peaks[4] == peaks[8] == peaks[16] == [3, 1]


def test_validation_errors_match_jax():
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        pl.microbatch(torch.zeros(5, 3), 2)
    with pytest.raises(ValueError, match="microbatch size"):
        pl.data_shard(np.zeros((6, 3)), 3, 4, 0)
    for schedule in SCHEDULES:
        with pytest.raises(ValueError, match="n_layers 3 not divisible"):
            _build(schedule, cfg=_cfg(n_layers=3))
    for schedule in ("1f1b", "interleaved"):
        with pytest.raises(ValueError, match="vocab 63 not divisible"):
            _build(schedule, cfg=_cfg(vocab=63))
    with pytest.raises(ValueError, match="2 stages x 3 chunks"):
        tlm.pipeline_spec(n_stages=2, num_microbatches=2,
                          schedule="interleaved", virtual_stages=3,
                          config=_cfg())
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        _build("zigzag")
    with pytest.raises(ValueError, match="leading dim 3"):
        pl.pipeline_apply(lambda p, x: x, {"w": torch.zeros(3, 2)},
                          torch.zeros(2, 1, 2), _StageGroup())


class _StageGroup:
    """A stage group's size and rank, for a call that fails before it
    communicates."""

    size, rank = 2, 0


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_dropout_needs_an_rng_and_is_seeded(schedule):
    cfg = _cfg(dropout=0.5)
    build = _build(schedule, cfg=cfg)
    model = _model(build)
    x, y = _batch()

    def step(rng):
        def run(group):
            rows = build.stage_rows_fn(group.rank)
            stage = materialize(model.stage_copy(rows), "cpu")
            load_flax(stage, {k: v[rows] if k.startswith("stages/") else v
                              for k, v in params_to_flax(model).items()})
            return float(build.loss_and_grads_fn(stage, x, y, group,
                                                 rng=rng))

        return run_group(STAGES, run, axis=pmesh.STAGE_AXIS)

    with pytest.raises(ValueError, match="rng"):
        step(None)
    first, again, other = step(1), step(1), step(2)
    assert first == again and first[0] == first[1]
    assert first != other


def test_generic_pipeline_apply_matches_jax():
    """pipeline_apply over any stage function (an MLP of 4 stages, 3
    microbatches): outputs on every stage and the gradients of one loss
    equal JAX make_pipeline's on its stage mesh."""
    n, d, batch, micro = 4, 8, 6, 3
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(n, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.normal(size=(n, d)) * 0.1).astype(np.float32)
    x = rng.normal(size=(batch, d)).astype(np.float32)

    def jstage(p, h):
        return jax.numpy.tanh(h @ p["w"] + p["b"])

    mesh = Mesh(np.array(jax.devices()[:n]), ("stage",))
    pipe = jpipe.make_pipeline(jstage, mesh)

    def jloss(p):
        y = jpipe.unmicrobatch(pipe(p, jpipe.microbatch(x, micro)))
        return (y ** 2).sum()

    with mesh:
        want_y = np.asarray(jax.jit(lambda p: pipe(
            p, jpipe.microbatch(x, micro)))({"w": w, "b": b}))
        want_g = jax.jit(jax.grad(jloss))({"w": w, "b": b})

    def run(group):
        params = {"w": torch.tensor(w, requires_grad=True),
                  "b": torch.tensor(b, requires_grad=True)}
        xm = pl.microbatch(torch.tensor(x, requires_grad=True), micro)
        run_pipe = pl.make_pipeline(
            lambda p, h: torch.tanh(h @ p["w"] + p["b"]))
        y = run_pipe(params, xm, group)
        (y ** 2).sum().backward()
        return y.detach().numpy(), params["w"].grad, params["b"].grad

    outs = run_group(n, run, axis=pmesh.STAGE_AXIS)
    for y, _, _ in outs:
        np.testing.assert_allclose(y, want_y, rtol=1e-5, atol=1e-6)
    gw = sum(o[1] for o in outs).numpy()
    gb = sum(o[2] for o in outs).numpy()
    np.testing.assert_allclose(gw, np.asarray(want_g["w"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gb, np.asarray(want_g["b"]), rtol=1e-4,
                               atol=1e-5)


# ---------- named remat ----------


def _step_grads(module, cfg, x, y):
    model = materialize(module.custom_model(cfg), "cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    model.train()
    module.loss(torch.as_tensor(y), model(torch.as_tensor(x))).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", [p for p in tlm.REMAT_POLICIES if p])
def test_named_remat_policy_gives_the_gradients_of_remat_off(policy):
    """Each of jax.checkpoint_policies' six plain policies (the dense LM
    and the MoE LM, float32): the gradients of remat=False within 1e-5 of
    each leaf's largest (the recompute sums a residual's gradient in
    another order; the JAX package's remat test holds 1e-5 too)."""
    x, y = _batch(2)
    for module, make in ((tlm, tlm.LMConfig), (moe_lm, moe_lm.MoELMConfig)):
        cfg = make(**CFG)
        want = _step_grads(module, cfg, x, y)
        got = _step_grads(module, make(**CFG, remat=True,
                                       remat_policy=policy), x, y)
        for name, g in want.items():
            scale = max(float(g.abs().max()), 1e-30)
            assert float((got[name] - g).abs().max()) <= 1e-5 * scale, name


def test_remat_factory_policies_raise():
    """The names that make a policy from arguments are refused when the
    config is built (JAX accepts them there and fails when it traces the
    step)."""
    for name in ("save_only_these_names", "offload_dot_with_no_batch_dims",
                 "save_from_both_policies"):
        assert hasattr(jax.checkpoint_policies, name)
        with pytest.raises(ValueError, match="factory"):
            tlm.LMConfig(remat=True, remat_policy=name)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        moe_lm.MoELMConfig(remat=True, remat_policy="nothing")
