"""The port's device-resident Criteo CTR family (models/dac_ctr/{deepfm,
wide_deep,dcn,xdeepfm}.py over CTREmbeddings) against the JAX package's
flax models from the same weights: outputs, loss, gradients and one Adam
step at vocab 1000; then one tiny job per head through the port's Master."""

import functools
import os

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.dac_ctr import common as jcommon
from elasticdl_tpu.models.dac_ctr import dcn as jdcn
from elasticdl_tpu.models.dac_ctr import deepfm as jdeepfm
from elasticdl_tpu.models.dac_ctr import wide_deep as jwide_deep
from elasticdl_tpu.models.dac_ctr import xdeepfm as jxdeepfm
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common.params import flax_leaves, params_to_flax
from elasticdl_tpu_torch.data.gen.criteo import iter_criteo_records
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models.dac_ctr import dcn, deepfm, wide_deep, xdeepfm
from elasticdl_tpu_torch.models.dac_ctr.transform import feed
from elasticdl_tpu_torch.worker import task_data_service
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

torch.set_num_threads(1)

VOCAB = 1000
BATCH = 32
# float32 sums in another order in the two frameworks, as a share of the
# largest value compared.
RTOL = 1e-5
# head -> (port module, port class, JAX module, JAX class name)
HEADS = {
    "deepfm": (deepfm, "DeepFMCriteo", jdeepfm, "DeepFMCriteo"),
    "wide_deep": (wide_deep, "WideDeep", jwide_deep, "WideDeep"),
    "dcn": (dcn, "DCN", jdcn, "DCN"),
    "xdeepfm": (xdeepfm, "XDeepFM", jxdeepfm, "XDeepFM"),
}


@pytest.fixture(autouse=True)
def _short_waits(monkeypatch):
    monkeypatch.setattr(task_data_service, "_WAIT_SLEEP_SECONDS", 0.001)


def _batch():
    records = list(iter_criteo_records(BATCH, seed=4))
    features, labels = feed(records, "training", None)
    features["ids"] = features["ids"] % VOCAB
    return features, labels


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= RTOL, f"{what}: {err} of max {scale}"


def _jax_model(head, monkeypatch):
    _, _, jmod, cls = HEADS[head]
    if cls == "DeepFMCriteo":
        return jmod.DeepFMCriteo(vocab=VOCAB)
    # The other JAX heads size their tables by the full id space; the
    # test's vocab goes through CTREmbeddings' default.
    monkeypatch.setattr(jmod, "CTREmbeddings", functools.partial(
        jcommon.CTREmbeddings, vocab=VOCAB))
    return getattr(jmod, cls)()


def _nest(named):
    """{'a/b/c': array} -> the nested params tree flax applies."""
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_matches_jax_outputs_gradients_and_adam_step(head,
                                                          monkeypatch):
    features, labels = _batch()
    module, cls, jmod, _ = HEADS[head]
    # The weights: the port's initializers, through the weight bridge.
    model = getattr(module, cls)(vocab=VOCAB)
    model.init_weights(torch.Generator().manual_seed(0))
    named = params_to_flax(model)
    jmodel = _jax_model(head, monkeypatch)
    tx = jmod.optimizer().to_optax()

    def step(p):
        """Loss, logits, gradients and the params after one Adam step."""
        def loss_of(q):
            logits = jmodel.apply({"params": q}, features)
            return jcommon.ctr_loss(labels, logits), logits

        (loss, logits), grads = jax.value_and_grad(loss_of, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, logits, grads, optax.apply_updates(p, updates)

    jloss, jlogits, grad_tree, after_tree = jax.jit(step)(_nest(named))
    jgrads = {k: np.asarray(v)
              for k, v in flatten_params(grad_tree)[0].items()}
    want = {k: np.asarray(v)
            for k, v in flatten_params(after_tree)[0].items()}

    logits = model({k: torch.as_tensor(v) for k, v in features.items()})
    loss = module.loss(labels, logits)
    loss.backward()
    _close(logits.detach().numpy(), jlogits, "logits")
    assert abs(loss.item() - float(jloss)) <= RTOL * abs(float(jloss))
    leaves = flax_leaves(model)
    assert sorted(x.name for x in leaves) == sorted(jgrads)
    for leaf in leaves:
        _close(leaf.to_flax(leaf.param.grad), jgrads[leaf.name], leaf.name)

    # One Adam step through the port's LocalTrainer.
    spec = module.optimizer()
    trainer = LocalTrainer(getattr(module, cls)(vocab=VOCAB), module.loss,
                           spec, device="cpu")
    trainer.load_flax_params(named)
    trainer.train_minibatch(features, labels)
    after = trainer.export_variables()["variables"]
    lr, eps = spec.hyperparams["learning_rate"], spec.hyperparams["epsilon"]
    for name, value in want.items():
        # Adam's first update is lr * g / (|g| + eps): where a gradient is
        # about 0, its rounding moves the update by up to lr
        # (tests/test_torch_trainer.py); elsewhere 1e-6.
        g = np.abs(jgrads[name])
        noise = RTOL * g.max()
        bound = 1e-6 + np.minimum(2 * lr, lr * noise * eps / (g + eps) ** 2)
        np.testing.assert_array_less(np.abs(after[name] - value), bound,
                                     err_msg=name)


def test_exported_weights_are_copies():
    """Exported weights stay as they were when exported, as the JAX
    package's (jax.device_get) do, also on the CPU, where the parameters'
    own memory is the host's."""
    features, labels = _batch()
    trainer = LocalTrainer(deepfm.DeepFMCriteo(vocab=VOCAB), deepfm.loss,
                           deepfm.optimizer(), device="cpu")
    trainer.train_minibatch(features, labels)
    exported = trainer.export_variables()["variables"]
    kept = {k: v.copy() for k, v in exported.items()}
    # New weights land in the parameters' memory (load_state_dict copies
    # in place, as the PS trainer's pull does).
    trainer.load_flax_params({k: v + 1 for k, v in kept.items()})
    trainer.train_minibatch(features, labels)
    for name, value in kept.items():
        np.testing.assert_array_equal(exported[name], value, err_msg=name)


MODEL_DEF = """\
import torch
from elasticdl_tpu_torch.models.dac_ctr import {head} as _m
from elasticdl_tpu_torch.models.dac_ctr.{head} import (  # noqa: F401
    eval_metrics_fn, loss, optimizer,
)


def custom_model():
    with torch.device("meta"):
        return _m.{cls}(vocab={vocab})


def feed(records, mode, metadata):
    features, labels = _m.feed(records, mode, metadata)
    features["ids"] = features["ids"] % {vocab}
    return features, labels
"""


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_trains_as_a_job_through_the_master(head, tmp_path):
    paths = {}
    for name, n, seed in (("train", 96, 0), ("valid", 32, 1)):
        paths[name] = os.path.join(tmp_path, f"{name}.edlr")
        with RecordFileWriter(paths[name]) as writer:
            for record in iter_criteo_records(n, seed=seed):
                writer.write(record)
    model_def = tmp_path / f"tiny_{head}.py"
    model_def.write_text(MODEL_DEF.format(head=head, cls=HEADS[head][1],
                                          vocab=VOCAB))
    common = [
        "--model_def", str(model_def), "--distribution_strategy", "Local",
        "--training_data", paths["train"],
        "--validation_data", paths["valid"],
        "--records_per_task", "32", "--num_epochs", "1",
        "--minibatch_size", "16", "--evaluation_steps", "3", "--seed", "0",
    ]
    master_args = edl_args.master_parser().parse_args(
        common + ["--instance_backend", "none"])
    edl_args.validate_args(master_args)
    master = Master(master_args)
    worker_args = edl_args.worker_parser().parse_args(common + [
        "--worker_id", "0", "--master_addr", "in-process",
        "--job_type", "training_with_evaluation", "--log_loss_steps", "2",
    ])
    worker = build_worker(worker_args, MasterClient(master.stub(), 0),
                          device="cpu")
    worker.run()
    assert master.task_d.finished() and not master.task_d.job_failed
    assert master.task_d.stats()["records_done"] == 96
    assert worker.steps == 6
    evals = master.evaluation_service.completed_results
    assert evals and all({"auc", "accuracy"} <= set(m) for _, m in evals)
