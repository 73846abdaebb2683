"""The port's image and tabular zoo (models/{mnist,cifar10,census,heart,
iris,deepfm}) against the JAX package's flax models from the same weights:
the training-mode forward, the loss, every gradient, the new batch_stats
and one optimizer step; then jobs through the port's Master: the linear
model of tests/test_module.py recovering its true weights, a BatchNorm CNN
with evaluation, and deepfm_distributed on two in-process PS shards; the PS
trainer refuses BatchNorm state.

Tolerances, as a share of the largest value compared: outputs and
gradients 1e-4 (float32 summed in another order), running statistics and
parameters after one step 1e-5 (Adam's first step: see
tests/test_torch_ctr.py)."""

import copy

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.census import dnn as jcensus_dnn
from elasticdl_tpu.models.census import wide_deep as jcensus_wd
from elasticdl_tpu.models.cifar10 import cifar10_cnn as jcifar
from elasticdl_tpu.models.deepfm import deepfm_functional as jdeepfm
from elasticdl_tpu.models.heart import heart_model as jheart
from elasticdl_tpu.models.iris import iris_dnn as jiris
from elasticdl_tpu.models.mnist import mnist_model as jmnist
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common.params import (
    flax_leaves,
    params_to_flax,
    state_to_flax,
)
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.gen.synthetic import (
    synthetic_classification_arrays,
)
from elasticdl_tpu_torch.data.reader import CSVDataReader
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models.census import dnn as census_dnn
from elasticdl_tpu_torch.models.census import wide_deep as census_wd
from elasticdl_tpu_torch.models.cifar10 import cifar10_cnn
from elasticdl_tpu_torch.models.deepfm import deepfm_functional
from elasticdl_tpu_torch.models.heart import heart_model
from elasticdl_tpu_torch.models.iris import iris_dnn
from elasticdl_tpu_torch.models.mnist import mnist_model
from elasticdl_tpu_torch.worker import task_data_service
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

import test_module

torch.set_num_threads(1)

RTOL = 1e-4
STEP_ATOL = 1e-5
# A gradient below this share of the model's largest is 0 but for rounding.
ZERO_GRAD = 1e-5
# XLA's backend at optimization level 0: the same IEEE arithmetic, compiled
# in a third of the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def _short_waits(monkeypatch):
    monkeypatch.setattr(task_data_service, "_WAIT_SLEEP_SECONDS", 0.001)


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


def _nest(named):
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _images(n, shape, seed):
    images, labels = synthetic_classification_arrays(
        n, image_shape=shape, noise=0.1, seed=seed)
    return [encode_example({"image": images[i], "label": labels[i]})
            for i in range(n)]


def _iris_records(tmp_path, n):
    path = iris_dnn.make_csv(str(tmp_path / "iris.csv"), n=n)
    reader = CSVDataReader(path)
    assert reader.create_shards() == {path: (0, n)}

    class _Task:
        shard_name, start, end = path, 0, n

    return list(reader.read_records(_Task))


# port module, port class, JAX module, JAX class, records
MODELS = {
    "mnist": (mnist_model, "MnistCNN", jmnist, "MnistCNN",
              lambda tmp: _images(4, (28, 28), 1)),
    "cifar10": (cifar10_cnn, "Cifar10CNN", jcifar, "Cifar10CNN",
                lambda tmp: _images(4, (32, 32, 3), 2)),
    "census_wide_deep": (census_wd, "WideDeep", jcensus_wd, "WideDeep",
                         lambda tmp: census_wd.make_records(32, seed=4)),
    "census_dnn": (census_dnn, "CensusDNN", jcensus_dnn, "CensusDNN",
                   lambda tmp: census_dnn.make_records(32, seed=4)),
    "heart": (heart_model, "HeartModel", jheart, "HeartModel",
              lambda tmp: heart_model.make_records(32, seed=4)),
    "iris": (iris_dnn, "IrisDNN", jiris, "IrisDNN",
             lambda tmp: _iris_records(tmp, 30)),
    "deepfm": (deepfm_functional, "DeepFM", jdeepfm, "DeepFM",
               lambda tmp: deepfm_functional.make_records(32, seed=4)),
}


def _tensors(features):
    if isinstance(features, dict):
        return {k: torch.as_tensor(v) for k, v in features.items()}
    return torch.as_tensor(features)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax_forward_gradients_and_one_step(name, tmp_path,
                                                          monkeypatch):
    module, cls, jmod, jcls, make_records = MODELS[name]
    if name == "cifar10":
        # Dropout off on both sides (its bits differ between the two
        # frameworks).
        monkeypatch.setattr(cifar10_cnn, "DROPOUT_RATE", 0.0)
        monkeypatch.setattr(jcifar.nn, "Dropout",
                            lambda rate, deterministic: (lambda x: x))
    records = make_records(tmp_path)
    features, labels = module.feed(records, "training", None)
    jfeatures, jlabels = jmod.feed(records, "training", None)
    for got, want in ((features, jfeatures), (labels, jlabels)):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_array_equal(got, want)

    # The weights: the port's initializers, through the weight bridge.
    model = getattr(module, cls)()
    model.init_weights(torch.Generator().manual_seed(0))
    named = params_to_flax(model)
    state = state_to_flax(model)
    jvars = {"params": _nest(named)}
    mutable = False
    if state:
        jvars["batch_stats"] = _nest(
            {k[len("batch_stats/"):]: v for k, v in state.items()})
        mutable = ["batch_stats"]
    jmodel = getattr(jmod, jcls)()
    tx = jmod.optimizer().to_optax()

    def step(p, rest):
        def loss_of(q):
            out = jmodel.apply({"params": q, **rest}, features, training=True,
                               mutable=mutable)
            logits, new = out if mutable else (out, {})
            return jmod.loss(labels, logits), (logits, new)

        (loss, (logits, new)), grads = jax.value_and_grad(
            loss_of, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, logits, new, grads, optax.apply_updates(p, updates)

    rest = {k: v for k, v in jvars.items() if k != "params"}
    jloss, jlogits, jnew, grad_tree, after_tree = jax.jit(step).lower(
        jvars["params"], rest).compile(compiler_options=FAST_COMPILE)(
        jvars["params"], rest)
    jgrads = {k: np.asarray(v)
              for k, v in flatten_params(grad_tree)[0].items()}
    want_after = {k: np.asarray(v)
                  for k, v in flatten_params(after_tree)[0].items()}
    want_state = {k: np.asarray(v) for k, v in flatten_params(jnew)[0].items()}

    ref = copy.deepcopy(model).train()
    logits = ref(_tensors(features))
    loss = module.loss(labels, logits)
    loss.backward()
    _close(logits.detach().numpy(), jlogits, "logits")
    assert abs(loss.item() - float(jloss)) <= RTOL * abs(float(jloss))
    leaves = flax_leaves(ref)
    assert sorted(x.name for x in leaves) == sorted(jgrads)
    largest = max(float(np.abs(g).max()) for g in jgrads.values())
    zero = {name for name, g in jgrads.items()
            if np.abs(g).max() <= ZERO_GRAD * largest}
    for leaf in leaves:
        got = leaf.to_flax(leaf.param.grad).numpy()
        if leaf.name in zero:
            # A conv bias right before a training-mode BatchNorm: its
            # gradient is 0 in exact arithmetic, rounding noise in both.
            assert np.abs(got).max() <= ZERO_GRAD * largest, leaf.name
        else:
            _close(got, jgrads[leaf.name], leaf.name)
    got_state = state_to_flax(ref)
    assert sorted(got_state) == sorted(want_state)
    for key in want_state:
        _close(got_state[key], want_state[key], key, STEP_ATOL)

    # One step through the port's LocalTrainer (the model is materialized
    # already, so the trainer keeps these weights).
    spec = module.optimizer()
    trainer = LocalTrainer(model, module.loss, spec, device="cpu")
    trainer.train_minibatch(features, labels)
    exported = trainer.export_variables()
    for key in want_state:
        _close(exported["state"][key], want_state[key], key, STEP_ATOL)
    lr = spec.hyperparams["learning_rate"]
    for key, value in want_after.items():
        bound = STEP_ATOL
        if spec.name == "adam" and key in zero:
            # Adam's first step normalizes the rounding noise: either sign,
            # up to lr.
            bound = STEP_ATOL + 2 * lr
        elif spec.name == "adam":
            # Adam's first update is lr * g / (|g| + eps): where a gradient
            # is about 0, its rounding moves the update by up to lr.
            g = np.abs(jgrads[key])
            eps = spec.hyperparams["epsilon"]
            bound = STEP_ATOL + np.minimum(
                2 * lr, lr * RTOL * g.max() * eps / (g + eps) ** 2)
        np.testing.assert_array_less(
            np.abs(exported["variables"][key] - value), bound, err_msg=key)


# ---------- jobs through the port's Master ----------


LINEAR_MODEL_DEF = """\
import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.example import batch_examples
from elasticdl_tpu_torch.ops import optimizers


class LinearModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 1)

    def init_weights(self, generator):
        with torch.no_grad():
            self.Dense_0.weight.normal_(0.0, 0.5, generator=generator)
            self.Dense_0.bias.zero_()

    def forward(self, x):
        return self.Dense_0(x)


def custom_model():
    with torch.device("meta"):
        return LinearModel()


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return torch.mean((predictions.reshape(-1) - labels.reshape(-1)) ** 2)


def optimizer(lr=0.1):
    return optimizers.sgd(learning_rate=lr)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    labels = batch["y"] if mode != Modes.PREDICTION else None
    return batch["x"], labels
"""


def _write(path, records):
    with RecordFileWriter(str(path)) as writer:
        for record in records:
            writer.write(record)
    return str(path)


def _job(model_def, train, valid=None, strategy="Local", extra=(),
         master_extra=()):
    common = [
        "--model_def", model_def, "--distribution_strategy", strategy,
        "--training_data", train, "--num_epochs", "1", "--seed", "0",
        *extra,
    ]
    if valid:
        common += ["--validation_data", valid]
    master_args = edl_args.master_parser().parse_args(
        common + ["--instance_backend", "none", *master_extra])
    edl_args.validate_args(master_args)
    master = Master(master_args)
    worker_args = edl_args.worker_parser().parse_args(common + [
        "--worker_id", "0", "--master_addr", "in-process",
        "--job_type", ("training_with_evaluation" if valid
                       else "training_only"),
    ])
    ps_stubs = master.ps_stubs() if strategy == "ParameterServerStrategy" \
        else None
    worker = build_worker(worker_args, MasterClient(master.stub(), 0),
                          ps_stubs=ps_stubs, device="cpu")
    return master, worker


def test_linear_model_job_recovers_true_weights(tmp_path):
    """The counterpart of tests/test_worker_e2e.py's converging job: 256
    records, 8 epochs in tasks of 64, minibatches of 16."""
    model_def = tmp_path / "linear_model.py"
    model_def.write_text(LINEAR_MODEL_DEF)
    train = _write(tmp_path / "train.edlr",
                   test_module.make_linear_records(256))
    master, worker = _job(str(model_def), train, extra=[
        "--records_per_task", "64", "--minibatch_size", "16",
        "--num_epochs", "8"])
    worker.run()
    assert master.task_d.finished() and not master.task_d.job_failed
    assert master.task_d.stats()["records_done"] == 256 * 8
    assert worker.steps == (256 // 16) * 8
    variables = worker.trainer.export_variables()["variables"]
    np.testing.assert_allclose(variables["Dense_0/kernel"].reshape(-1),
                               test_module.TRUE_W, atol=0.05)
    np.testing.assert_allclose(float(variables["Dense_0/bias"][0]),
                               test_module.TRUE_B, atol=0.05)


def test_batchnorm_cnn_job_trains_and_evaluates(tmp_path):
    """CIFAR-10's CNN as a job: 64 training records in tasks of 16,
    evaluation every 2 versions; the batch_stats move and land in the
    worker's checkpoint."""
    train = _write(tmp_path / "train.edlr", _images(64, (32, 32, 3), 3))
    valid = _write(tmp_path / "valid.edlr", _images(16, (32, 32, 3), 4))
    master, worker = _job(
        "elasticdl_tpu_torch.models.cifar10.cifar10_cnn", train, valid,
        extra=["--records_per_task", "16", "--minibatch_size", "16",
               "--evaluation_steps", "2", "--checkpoint_steps", "4",
               "--checkpoint_dir", str(tmp_path / "ckpt")])
    worker.run()
    assert master.task_d.finished() and not master.task_d.job_failed
    assert master.task_d.stats()["records_done"] == 64
    assert worker.steps == 4
    evals = master.evaluation_service.completed_results
    assert [v for v, _ in evals] == [2, 4]
    assert all(np.isfinite(m["accuracy"]) for _, m in evals)
    state = worker.trainer.export_variables()["state"]
    assert len(state) == 12
    assert np.abs(state["batch_stats/BatchNorm_0/mean"]).max() > 0


def test_deepfm_distributed_trains_on_two_ps_shards(tmp_path):
    """DeepFM with both tables in two in-process PS shards
    (ParameterServerStrategy through the master): 12 epochs of 64
    records, the loss falls and each shard holds rows of both tables."""
    train = _write(tmp_path / "train.edlr",
                   deepfm_functional.make_records(64, seed=2))
    master, worker = _job(
        "elasticdl_tpu_torch.models.deepfm.deepfm_distributed", train,
        strategy="ParameterServerStrategy",
        extra=["--records_per_task", "32", "--minibatch_size", "32",
               "--num_epochs", "12"],
        master_extra=["--num_ps", "2"])
    losses = []
    step = worker.trainer.train_minibatch

    def train_minibatch(features, labels):
        result = step(features, labels)
        losses.append(float(result[2]))
        return result

    worker.trainer.train_minibatch = train_minibatch
    worker.run()
    worker.trainer.close()
    assert master.task_d.finished() and not master.task_d.job_failed
    assert master.task_d.stats()["records_done"] == 12 * 64
    assert len(losses) == 24 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < 0.9 * np.mean(losses[:4]), losses
    for server in master.ps_servers:
        assert set(server.parameters.embedding_tables) == {
            "fm_linear", "fm_factors"}
        assert server.parameters.version == 24


def test_ps_trainer_trains_batchnorm_state():
    """BatchNorm state under ParameterServerStrategy: the PS trainer keeps
    a model's running statistics on the worker, updates them in the PS
    step, leaves them out of the pushed gradients, and exports them
    (tests/test_torch_ps_trainer.py holds them against the JAX
    trainer)."""
    from elasticdl_tpu_torch.ps.parameter_server import ParameterServer

    shard = ParameterServer(0, 1, optimizer_spec=cifar10_cnn.optimizer())
    client = PSClient([shard.stub()])
    trainer = ParameterServerTrainer(
        cifar10_cnn.custom_model(), cifar10_cnn.loss,
        cifar10_cnn.optimizer(), client, pipeline_pushes=False,
        device="cpu")
    features, labels = cifar10_cnn.feed(_images(2, (32, 32, 3), 5),
                                        "training", None)
    assert trainer.train_minibatch(features, labels)[0]
    state = trainer.export_variables()["state"]
    assert len(state) == 12
    assert np.abs(state["batch_stats/BatchNorm_0/mean"]).max() > 0
    assert not any(k.startswith("batch_stats") or "mean" in k
                   for k in shard.parameters.dense)
    client.close()
