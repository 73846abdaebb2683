"""AllReduceTrainer across the shards of a process (elasticdl_tpu_torch/
parallel/shards.py): a TP2 world of one process through the master's lease
loop; a regroup TP2 x 2 processes -> TP2 x 1 -> pure DP that carries the
state bitwise; the gradients of model-replicated parameters equal across
the model group; the loss as the mean over the batch's real tokens; and
BatchNorm across shards taking the whole batch's statistics. Processes and
shards are threads of this process (ELASTICDL_LOCAL_DEVICES's role is
played by the trainer's _local_devices)."""

import numpy as np
import torch

from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common.params import flax_leaves, params_to_flax
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models.mnist import mnist_model
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers as toptim
from elasticdl_tpu_torch.parallel import tensor_parallel as tp
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.trainer import LocalTrainer
from test_torch_allreduce import (
    _Control,
    _assert_state_equal,
    _free_port,
    _in_threads,
    _no_waits,  # noqa: F401 - the autouse fixture
    _state,
)

torch.set_num_threads(1)

LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, max_len=16,
          activation_dtype="float32")
MODEL_DEF = f"""\
from elasticdl_tpu_torch.models.transformer import transformer_lm as _lm
from elasticdl_tpu_torch.models.transformer.transformer_lm import (  # noqa
    eval_metrics_fn, feed, loss, optimizer, param_specs,
)


def custom_model():
    return _lm.custom_model(_lm.LMConfig(**{LM!r}))
"""


def _batch(n, seed=0):
    tokens = synthetic_lm_tokens(n, LM["max_len"], vocab=LM["vocab"],
                                 branching=4, seed=seed)
    return tokens[:, :-1], tokens[:, 1:]


def _trainer(control, worker_id, local, opt=None, **kw):
    from elasticdl_tpu_torch.worker.allreduce_trainer import (
        AllReduceTrainer,
    )

    mc = control.client(worker_id)
    trainer = AllReduceTrainer(
        tlm.custom_model(tlm.LMConfig(**LM)), tlm.loss,
        opt or toptim.adam(0.01), mc, device="cpu", seed=1,
        param_specs_fn=tlm.param_specs, **kw)
    trainer._local_devices = local
    return trainer, mc


def test_tp2_world_of_one_process_through_the_lease_loop(tmp_path,
                                                         monkeypatch):
    """--multi_host --model_parallel_size 2 through the port's Master and
    build_worker: the master relays the flag to the workers it spawns,
    and every lease's step runs across two model shards."""
    monkeypatch.setenv("ELASTICDL_METRICS_PORT", "-1")
    monkeypatch.setenv("ELASTICDL_HEARTBEAT_SECONDS", "0")
    monkeypatch.setenv("ELASTICDL_LOCAL_DEVICES", "2")
    monkeypatch.delenv("ELASTICDL_OBS_DIR", raising=False)
    model_def = tmp_path / "lm.py"
    model_def.write_text(MODEL_DEF)
    train = tmp_path / "train.edlr"
    tokens = synthetic_lm_tokens(32, LM["max_len"], vocab=LM["vocab"],
                                 branching=4, seed=3)
    with RecordFileWriter(str(train)) as writer:
        for row in tokens:
            writer.write(encode_example({"tokens": row}))
    common = ["--model_def", str(model_def),
              "--distribution_strategy", "AllreduceStrategy",
              "--multi_host", "--model_parallel_size", "2",
              "--training_data", str(train), "--records_per_task", "16",
              "--minibatch_size", "8", "--num_epochs", "1", "--seed", "0"]
    master = Master(edl_args.master_parser().parse_args(common + [
        "--instance_backend", "none",
        "--coordinator_port", str(_free_port())]))
    # A spawned worker gets the flags (what `edl train` and master.main
    # hand over).
    relayed = edl_args.worker_parser().parse_args(
        master._command_for("worker", 1)[3:])
    assert (relayed.model_parallel_size, relayed.multi_host) == (2, True)
    worker = build_worker(
        edl_args.worker_parser().parse_args(common + [
            "--worker_id", "0", "--master_addr", "in-process"]),
        MasterClient(master.stub(), 0, worker_host="127.0.0.1"),
        device="cpu")
    try:
        worker.run()
        assert master.task_d.finished() and not master.task_d.job_failed
        assert master.task_d.stats()["records_done"] == 32
        assert worker.steps == 4
        trainer = worker.trainer
        assert trainer.world_fingerprint == "data=1,model=2"
        assert trainer.shards.mp == 2
        assert trainer.axis_stats["model"].calls > 0
    finally:
        worker.trainer.close()


def test_regroup_across_axes_carries_state_bitwise():
    """Two processes of two model shards each (data 2 x model 2), then the
    survivor alone (data 1 x model 2), then one shard per process (pure
    DP): each regroup keeps (variables, Adam moments, version) bit for
    bit, and the worlds' fingerprints are the JAX resolver's."""
    control = _Control()
    t0, mc0 = _trainer(control, 0, 2, multi_host=True,
                       model_parallel_size=2)
    t1, mc1 = _trainer(control, 1, 2, multi_host=True,
                       model_parallel_size=2)
    mc0.report_liveness()
    mc1.report_liveness()
    x, y = _batch(8)
    try:
        _in_threads(lambda: t0.train_minibatch(x[:4], y[:4]),
                    lambda: t1.train_minibatch(x[4:], y[4:]))
        assert t0.world_fingerprint == "data=2,model=2|pg|p2"
        _assert_state_equal(_state(t0), _state(t1))
        t1.close()
        control.membership.remove_worker(1)
        before = _state(t0)
        t0.init_world_if_needed()
        assert t0.world_fingerprint == "data=1,model=2"
        _assert_state_equal(_state(t0), before)
        t0.train_minibatch(x, y)
        t0._local_devices = 1
        before = _state(t0)
        t0.init_world_if_needed(force=True)
        assert (t0.world_fingerprint, t0.shards) == ("data=1", None)
        assert any("model_parallel_size 2 infeasible" in n
                   for n in t0.world_spec.notes)
        _assert_state_equal(_state(t0), before)
        t0.train_minibatch(x, y)
        assert t0.get_model_version() == 3
    finally:
        t0.close()


def test_model_replicated_gradients_equal_across_the_model_group():
    control = _Control()
    t, _ = _trainer(control, 0, 2, model_parallel_size=2)
    try:
        t.train_minibatch(*_batch(4))
        specs = tp.transformer_param_specs(
            [x.name for x in flax_leaves(t._model)])
        replicated = [n for n, s in specs.items() if not s]
        assert "Block_0/MultiHeadAttention_0/proj/bias" in replicated
        for name in replicated:
            grads = t.shards.shard_grads(name)
            assert torch.equal(grads[0], grads[1]), name
            assert grads[0].abs().max() > 0, name
    finally:
        t.close()


def test_loss_is_the_mean_over_the_real_tokens():
    """Three rows over two data positions of one process: the batch pads to
    four by cyclic repetition and the loss is taken over the three real
    rows, LocalTrainer's loss on them, and the SGD step is its step (Adam's
    first step is lr * sign(g), which rounding noise flips)."""
    x, y = _batch(3)
    local = LocalTrainer(tlm.custom_model(tlm.LMConfig(**LM)), tlm.loss,
                         toptim.sgd(0.5), seed=1, device="cpu")
    _, _, want = local.train_minibatch(x, y)
    for local_devices, kw in ((2, {}), (2, dict(model_parallel_size=2))):
        t, _ = _trainer(_Control(), 0, local_devices, toptim.sgd(0.5), **kw)
        try:
            _, _, got = t.train_minibatch(x, y)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
            ours, theirs = params_to_flax(t._model), params_to_flax(
                local._model)
            for name, value in theirs.items():
                np.testing.assert_allclose(
                    ours[name], value, rtol=0,
                    atol=1e-5 * np.abs(value).max(), err_msg=name)
        finally:
            t.close()


def test_batchnorm_across_shards_raises():
    """(The name is from before cross-rank BatchNorm.) The MNIST CNN over
    two data shards of one process: the statistics are the whole batch's,
    so a step equals LocalTrainer's on the whole batch within 1e-5
    (parameters and running statistics)."""
    control = _Control()
    from elasticdl_tpu_torch.common.params import state_to_flax
    from elasticdl_tpu_torch.worker.allreduce_trainer import (
        AllReduceTrainer,
    )

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int64)
    local = LocalTrainer(mnist_model.custom_model(), mnist_model.loss,
                         mnist_model.optimizer(), device="cpu")
    local.init_variables_if_needed(x)
    named, state = params_to_flax(local._model), state_to_flax(local._model)
    t = AllReduceTrainer(mnist_model.custom_model(), mnist_model.loss,
                         mnist_model.optimizer(), control.client(0),
                         device="cpu")
    t._local_devices = 2
    try:
        t.load_flax_params(named, state)
        local.train_minibatch(x, y)
        t.train_minibatch(x, y)
        assert t.world_fingerprint == "data=2"
        for ours, theirs in ((params_to_flax(t._model),
                              params_to_flax(local._model)),
                             (state_to_flax(t._model),
                              state_to_flax(local._model))):
            for k, v in theirs.items():
                np.testing.assert_allclose(ours[k], v, rtol=1e-5,
                                           atol=1e-5 * np.abs(v).max(),
                                           err_msg=k)
    finally:
        t.close()
