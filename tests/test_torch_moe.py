"""The port's Switch-MoE layer and MoE LM (elasticdl_tpu_torch/layers/moe.py,
models/transformer/moe_lm.py) against the JAX package's, from the same
weights carried by the weight bridge; the index dispatch against the one-hot
einsums it replaces; a tiny MoE job through the port's master; worker
checkpoints across the two packages.

Tolerances, as a share of the largest value compared: float32 outputs
1e-5, float32 gradients 1e-4 (the same arithmetic summed in another
order), bfloat16 2e-2 (an 8-bit mantissa, rounded at other places: the
GELU's internal precision, fused bias adds); parameters after one Adam step
as tests/test_torch_trainer.py bounds them."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
from elasticdl_tpu.common import save_utils as jax_save_utils
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.layers import moe as jmoe
from elasticdl_tpu.models.transformer import moe_lm as jmoe_lm
from elasticdl_tpu.worker.trainer import LocalTrainer as JaxLocalTrainer
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.common.params import (
    flax_leaves,
    params_from_flax,
    params_to_flax,
)
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.layers.moe import SwitchMoE, route, switch_moe_plain
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models.transformer import moe_lm
from elasticdl_tpu_torch.worker import task_data_service
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

from test_torch_trainer import _adam_step_tolerance

torch.set_num_threads(1)

F32_OUT_RTOL = 1e-5
F32_GRAD_RTOL = 1e-4
BF16_RTOL = 2e-2
# Layers 0-3: Block_0, MoEBlock_0, Block_1, MoEBlock_1.
TINY = dict(vocab=64, d_model=32, n_heads=2, n_layers=4, max_len=16,
            num_experts=4)
# XLA's backend at optimization level 0: the same IEEE arithmetic, compiled
# in a fraction of the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def _short_waits(monkeypatch):
    monkeypatch.setattr(task_data_service, "_WAIT_SLEEP_SECONDS", 0.001)


def _close(got, want, what, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


def _named(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree)[0].items()}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _torch_grads(model):
    """The model's gradients under flax wire names and layouts."""
    grads = copy.deepcopy(model)
    for p, src in zip(grads.parameters(), model.parameters()):
        p.data = src.grad
    return params_to_flax(grads)


# ---------- the layer ----------


def _nest(named):
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _layer_pair(dtype, capacity_factor, d=16, hidden=32, shape=(2, 8)):
    """(flax layer, its params, port layer with the same weights, x): the
    port's initializers, carried to flax by the weight bridge."""
    jl = jmoe.SwitchMoE(num_experts=4, d_hidden=hidden,
                        capacity_factor=capacity_factor, dtype=dtype)
    x = np.random.default_rng(1).normal(size=(*shape, d)).astype(np.float32)
    layer = SwitchMoE(d, 4, hidden, capacity_factor, getattr(torch, dtype))
    generator = torch.Generator().manual_seed(0)
    init_flax_defaults(layer, generator)
    return jl, _nest(params_to_flax(layer)), layer, x


def _layer_loss(out, aux):
    return (out.float() ** 2).mean() + 0.01 * aux


@pytest.mark.parametrize("dtype,capacity_factor", [
    ("float32", 1.25), ("bfloat16", 1.25), ("float32", 0.01)])
def test_switch_moe_matches_flax(dtype, capacity_factor):
    """Output, aux loss, and the input and parameter gradients of
    mean(out^2) + 0.01 aux; at capacity_factor 0.01 (capacity 1) most
    tokens drop and give an output of exactly 0 on both sides."""
    jl, params, layer, x = _layer_pair(dtype, capacity_factor)

    def jloss(p, x):
        out, aux = jl.apply({"params": p}, x)
        return (out.astype(np.float32) ** 2).mean() + 0.01 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = _jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True), params, x)

    xt = torch.tensor(x, requires_grad=True)
    r = route(layer, xt)
    probs = jax.nn.softmax(np.asarray(x).reshape(-1, 16)
                           @ np.asarray(params["router"]["kernel"])
                           + np.asarray(params["router"]["bias"]))
    np.testing.assert_array_equal(r.expert.numpy(),
                                  np.asarray(probs).argmax(-1))
    out, aux = layer(xt)
    _layer_loss(out, aux).backward()
    rtol_out = F32_OUT_RTOL if dtype == "float32" else BF16_RTOL
    rtol_grad = F32_GRAD_RTOL if dtype == "float32" else BF16_RTOL
    _close(out.detach(), jout, "output", rtol_out)
    assert abs(aux.item() - float(jaux)) <= 1e-6 * float(jaux)
    _close(xt.grad, jgx, "input gradient", rtol_grad)
    grads = _torch_grads(layer)
    jgrads = _named(jgp)
    assert sorted(grads) == sorted(jgrads) == [
        "router/bias", "router/kernel", "w_in", "w_out"]
    for name, want in jgrads.items():
        _close(grads[name], want, name, rtol_grad)

    dropped = ~r.keep.numpy()
    flat = out.detach().reshape(-1, 16).numpy()
    assert np.all(flat[dropped] == 0)
    assert np.all(np.asarray(jout).reshape(-1, 16)[dropped] == 0)
    if capacity_factor < 1:
        assert r.capacity == 1 and r.keep.sum() <= 4 and dropped.sum() >= 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_dispatch_equals_one_hot_einsums(dtype):
    """The index dispatch and combine against the one-hot einsums on 64
    tokens with capacity 8 per expert (some experts overflow): bitwise in
    float32, and in bfloat16 too, where the combine's one product is exact
    in float32 and rounded once on both sides."""
    _, _, layer, x = _layer_pair(dtype, 0.5, shape=(4, 16))
    results = []
    for fn in (layer, lambda x: switch_moe_plain(layer, x)):
        xt = torch.tensor(x, requires_grad=True)
        layer.zero_grad()
        out, aux = fn(xt)
        _layer_loss(out, aux).backward()
        results.append((out.detach(), aux.detach(), xt.grad,
                        _torch_grads(layer)))
    (out, aux, gx, grads), (pout, paux, pgx, pgrads) = results
    assert route(layer, torch.tensor(x)).keep.sum() < 64
    assert torch.equal(out, pout) and torch.equal(aux, paux)
    # The gradients pass through the same products, reordered where the
    # einsums' backward sums other terms: float32 rounding apart.
    rtol = F32_GRAD_RTOL if dtype == "float32" else BF16_RTOL
    _close(gx, pgx, "input gradient", rtol)
    for name in pgrads:
        _close(grads[name], pgrads[name], name, rtol)


# ---------- the LM ----------


def _tokens(seed=0, batch=2):
    toks = synthetic_lm_tokens(batch, 16, vocab=64, branching=4, seed=seed)
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _lm(activation_dtype="float32", remat=False, **overrides):
    """The tiny port LM, initialized from seed 0."""
    cfg = moe_lm.MoELMConfig(**dict(TINY, activation_dtype=activation_dtype,
                                    remat=remat, **overrides))
    tm = moe_lm.custom_model(cfg).to_empty(device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    return tm


@functools.lru_cache(maxsize=None)
def _jax_lm_step():
    """The JAX model's float32 training loss, aux term, logits, gradients
    and parameters after one Adam step, from the weights of _lm()."""
    jm = jmoe_lm.custom_model(jmoe_lm.MoELMConfig(
        **TINY, activation_dtype="float32"))
    x, y = _tokens()
    tx = jmoe_lm.optimizer().to_optax()

    def step(p):
        def loss_of(q):
            out = jm.apply({"params": q}, x, training=True)
            return jmoe_lm.loss(y, out), out

        (loss, out), grads = jax.value_and_grad(loss_of, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        # Without dropout the training logits are the eval logits.
        return loss, out["aux_loss"], out["logits"], grads, \
            jax.tree_util.tree_map(lambda a, b: a + b, p, updates)

    loss, aux, logits, grads, after = _jit(
        step, _nest(params_to_flax(_lm())))
    return float(loss), float(aux), np.asarray(logits), _named(grads), \
        _named(after)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_lm_matches_flax_logits_loss_grads_and_adam_step(remat):
    """float32: eval logits, the training loss with its aux term, every
    gradient and one Adam step; remat=True checkpoints every block, and the
    JAX model under remat (nn.remat(Block), nn.remat(MoEBlock)) has the
    same parameters under the names CheckpointBlock_i and
    CheckpointMoEBlock_i."""
    jloss, jaux, jlogits, jgrads, jafter = _jax_lm_step()
    tm = _lm(remat=remat)
    x, y = _tokens()
    if remat:
        shapes = jax.eval_shape(
            jmoe_lm.custom_model(jmoe_lm.MoELMConfig(
                **TINY, activation_dtype="float32", remat=True)).init,
            jax.random.PRNGKey(0), x)["params"]
        names = sorted(flatten_params(shapes)[0])
        assert "CheckpointMoEBlock_1/SwitchMoE_0/w_in" in names
        assert sorted(n.replace("Checkpoint", "") for n in names) == \
            sorted(jgrads)

    calls = []
    tm.MoEBlock_0.register_forward_pre_hook(lambda *_: calls.append(1))
    tm.train()
    out = tm(torch.tensor(x))
    assert sorted(out) == ["aux_loss", "logits"]
    loss = moe_lm.loss(torch.tensor(y), out)
    loss.backward()
    assert len(calls) == (2 if remat else 1)  # recomputed in backward
    assert abs(loss.item() - jloss) <= 1e-5
    assert abs(out["aux_loss"].item() - jaux) <= 1e-6 * jaux
    grads = _torch_grads(tm)
    assert sorted(grads) == sorted(jgrads)
    for name, want in jgrads.items():
        _close(grads[name], want, name, F32_GRAD_RTOL)
    tm.eval()
    with torch.no_grad():
        logits = tm(torch.tensor(x))
    assert isinstance(logits, torch.Tensor)  # plain logits in eval mode
    _close(logits, jlogits, "eval logits", F32_OUT_RTOL)

    # One Adam step through the port's LocalTrainer from the same weights.
    trainer = LocalTrainer(moe_lm.custom_model(tm.config), moe_lm.loss,
                           moe_lm.optimizer(), device="cpu")
    trainer.load_flax_params(params_to_flax(_lm()))
    trainer.train_minibatch(x, y)
    after = trainer.export_variables()["variables"]
    for name, value in jafter.items():
        np.testing.assert_array_less(
            np.abs(after[name] - value), _adam_step_tolerance(jgrads[name]),
            err_msg=name)


def test_moe_lm_bfloat16_and_aux_weight():
    """bfloat16 activations: the training loss within 2e-2 of flax's; the
    aux term follows the instance config's aux_loss_weight."""
    tm = _lm("bfloat16")
    jm = jmoe_lm.custom_model(jmoe_lm.MoELMConfig(**TINY))
    x, y = _tokens()
    jout = _jit(lambda p: jm.apply({"params": p}, x, training=True),
                _nest(params_to_flax(tm)))
    with torch.no_grad():
        out = tm(torch.tensor(x))
    assert out["logits"].dtype == torch.float32
    loss = float(moe_lm.loss(torch.tensor(y), out))
    assert abs(loss - float(jmoe_lm.loss(y, jout))) <= BF16_RTOL
    zero = _lm("bfloat16", aux_loss_weight=0.0)
    with torch.no_grad():
        assert zero(torch.tensor(x))["aux_loss"].item() == 0.0


def test_config_guards_names_and_flagship_count():
    with pytest.raises(ValueError, match="remat=False"):
        moe_lm.MoELMConfig(remat_policy="nothing_saveable")
    with pytest.raises(NotImplementedError):
        moe_lm.MoELMConfig(remat=True, remat_policy="dots_saveable")
    moe_lm.MoELMConfig(remat=True, remat_policy="nothing_saveable")
    with pytest.raises(ValueError, match="moe_every"):
        moe_lm.MoELMConfig(moe_every=0)
    with pytest.raises(ValueError, match="num_experts"):
        moe_lm.MoELMConfig(num_experts=1)
    # DP x EP: the expert weights split over the model axis, the rest
    # replicated.
    assert moe_lm.param_specs({
        "MoEBlock_0/SwitchMoE_0/w_in": np.zeros((4, 2, 3)),
        "MoEBlock_0/SwitchMoE_0/router/kernel": np.zeros((2, 4))}) == {
        "MoEBlock_0/SwitchMoE_0/w_in": ("model", None, None),
        "MoEBlock_0/SwitchMoE_0/router/kernel": ()}
    # The flagship-width config: flax's names and shapes, abstractly.
    cfg = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=12,
               max_len=4096)
    shapes = jax.eval_shape(
        jmoe_lm.custom_model(jmoe_lm.MoELMConfig(**cfg)).init,
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 8), np.int32))
    want = {k: v.shape for k, v in flatten_params(shapes["params"])[0].items()}
    model = moe_lm.custom_model(moe_lm.flagship_config(4096))
    assert model.config == moe_lm.MoELMConfig(**cfg)
    assert {x.name: tuple(x.to_flax(x.param).shape)
            for x in flax_leaves(model)} == want
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == 222_492_672 + 6 * 25_164_804 == 373_481_496


# ---------- the job and its checkpoints ----------


MODEL_DEF = """\
from elasticdl_tpu_torch.models.transformer import moe_lm as _m
from elasticdl_tpu_torch.models.transformer.moe_lm import (  # noqa
    eval_metrics_fn, feed, loss, optimizer,
)


def custom_model():
    return _m.custom_model(_m.MoELMConfig(
        vocab=64, d_model=32, n_heads=2, n_layers=4, max_len=16))
"""


def _write(path, rows):
    with RecordFileWriter(str(path)) as writer:
        for row in rows:
            writer.write(encode_example({"tokens": row}))
    return str(path)


def test_tiny_moe_job_through_the_master(tmp_path):
    """32 training records in tasks of 8, minibatches of 4 (8 steps), 8
    validation records evaluated every 4 versions: records_done exact, the
    evaluation results in."""
    tokens = synthetic_lm_tokens(40, 16, vocab=64, branching=4, seed=3)
    model_def = tmp_path / "tiny_moe.py"
    model_def.write_text(MODEL_DEF)
    common = [
        "--model_def", str(model_def), "--distribution_strategy", "Local",
        "--training_data", _write(tmp_path / "train.edlr", tokens[:32]),
        "--validation_data", _write(tmp_path / "valid.edlr", tokens[32:]),
        "--records_per_task", "8", "--minibatch_size", "4",
        "--num_epochs", "1", "--evaluation_steps", "4", "--seed", "0",
    ]
    master_args = edl_args.master_parser().parse_args(
        common + ["--instance_backend", "none"])
    edl_args.validate_args(master_args)
    master = Master(master_args)
    worker_args = edl_args.worker_parser().parse_args(common + [
        "--worker_id", "0", "--master_addr", "in-process",
        "--job_type", "training_with_evaluation"])
    worker = build_worker(worker_args, MasterClient(master.stub(), 0),
                          device="cpu")
    worker.run()
    assert master.task_d.finished() and not master.task_d.job_failed
    assert master.task_d.stats()["records_done"] == 32
    assert worker.steps == 8
    evals = master.evaluation_service.completed_results
    assert [v for v, _ in evals] == [4, 8]
    assert all(np.isfinite(m["token_ce"]) for _, m in evals)


def test_moe_checkpoints_restore_across_packages(tmp_path):
    """A port worker checkpoint of the MoE LM restores in the JAX package
    (its weights bitwise the port's) and the JAX package's checkpoint of it
    in the port (eval logits bitwise the port's before the trip); Adam's
    moments come along both ways."""
    cfg = moe_lm.MoELMConfig(**TINY, activation_dtype="float32")
    x, y = _tokens()
    ours = LocalTrainer(moe_lm.custom_model(cfg), moe_lm.loss,
                        moe_lm.optimizer(), device="cpu")
    ours.train_minibatch(x, y)
    want = ours.evaluate_minibatch(x)
    exported = ours.export_variables()["variables"]
    save_utils.save_trainer_checkpoint(ours, str(tmp_path / "port"))
    with np.load(tmp_path / "port.npz") as data:
        assert "params/MoEBlock_1/SwitchMoE_0/w_out" in data.files
        assert "params/MoEBlock_0/SwitchMoE_0/router/kernel" in data.files

    # A JAX trainer holding some variables (restore_variables, not its
    # init, which compiles); the checkpoint replaces them.
    jt = JaxLocalTrainer(
        jmoe_lm.custom_model(jmoe_lm.MoELMConfig(
            **TINY, activation_dtype="float32")),
        jmoe_lm.loss, jmoe_lm.optimizer())
    jt.restore_variables({"variables": {"params": _nest(
        params_to_flax(_lm()))}, "version": 0})
    jax_save_utils.restore_trainer_checkpoint(jt, str(tmp_path / "port"))
    assert jt.get_model_version() == 1
    restored = _named(jt.export_variables()["variables"]["params"])
    assert sorted(restored) == sorted(exported)
    for name, value in exported.items():
        np.testing.assert_array_equal(restored[name], value, err_msg=name)

    jax_save_utils.save_trainer_checkpoint(jt, str(tmp_path / "jax"))
    back = LocalTrainer(moe_lm.custom_model(cfg), moe_lm.loss,
                        moe_lm.optimizer(), device="cpu", seed=3)
    back.restore_on_init = str(tmp_path / "jax.npz")
    np.testing.assert_array_equal(back.evaluate_minibatch(x), want)
    assert back.get_model_version() == 1
    # The restored moments train on as the original's do.
    assert back.train_minibatch(x, y)[2].item() == \
        ours.train_minibatch(x, y)[2].item()
    np.testing.assert_array_equal(back.evaluate_minibatch(x),
                                  ours.evaluate_minibatch(x))


# ---------- expert parallelism ----------


EP_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, max_len=16,
              num_experts=4, moe_every=2, activation_dtype="float32")


def test_dp_ep_step_matches_jax_mesh():
    """tests/test_moe_lm.py's DP x EP setup (its config, its seed-7 batch
    of 8 x 16): the JAX step on the 8-device CPU mesh (data 4 x model 2,
    the experts split by moe_lm.param_specs) against the port's
    AllReduceTrainer over two model shards of one process, each holding 2
    of the 4 experts, from the same weights. The routing runs over the
    whole batch on both sides (GSPMD keeps the global computation), so the
    loss, its aux term and every gradient agree within 1e-5 of the
    largest value (float32 in another order)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from elasticdl_tpu_torch.ops import optimizers as toptim
    from elasticdl_tpu_torch.worker.allreduce_trainer import (
        AllReduceTrainer,
    )
    from test_torch_allreduce import _Control

    tokens = synthetic_lm_tokens(8, 16, vocab=64, branching=4, seed=7)
    features, labels = tokens[:, :-1], tokens[:, 1:]
    jmodel = jmoe_lm.custom_model(jmoe_lm.MoELMConfig(**EP_CFG))
    variables = dict(_jit(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(5)}, x, training=False), features))

    def loss_fn(v, x, y):
        out = jmodel.apply(v, x, training=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jmoe_lm.loss(y, out)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    var_sh = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), jmoe_lm.param_specs(variables),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    batch_sh = NamedSharding(mesh, P("data", None))
    args = (jax.device_put(variables, var_sh),
            jax.device_put(features, batch_sh),
            jax.device_put(labels, batch_sh))
    want_loss, want = jax.jit(
        jax.value_and_grad(loss_fn), in_shardings=(var_sh, batch_sh,
                                                   batch_sh),
        out_shardings=(NamedSharding(mesh, P()), var_sh)).lower(
        *args).compile(compiler_options=FAST_COMPILE)(*args)

    t = AllReduceTrainer(moe_lm.custom_model(moe_lm.MoELMConfig(**EP_CFG)),
                         moe_lm.loss, toptim.sgd(0.1), _Control().client(0),
                         device="cpu", model_parallel_size=2,
                         param_specs_fn=moe_lm.param_specs)
    t._local_devices = 2
    try:
        t.load_flax_params(_named(variables["params"]))
        _, _, loss = t.train_minibatch(features, labels)
        assert t.world_fingerprint == "data=1,model=2"
        assert [m.w_in.shape[0] for m in t.shards.models[0].modules()
                if hasattr(m, "first")] == [2]
        _close(float(loss), float(want_loss), "loss", F32_OUT_RTOL)
        grads = {x.name: x.to_flax(x.param.grad).detach().numpy()
                 for x in flax_leaves(t._model)}
        for name, g in _named(jax.device_get(want)["params"]).items():
            _close(grads[name], g, name, F32_OUT_RTOL)
    finally:
        t.close()
