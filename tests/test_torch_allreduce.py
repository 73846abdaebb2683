"""The port's elastic AllReduce trainer (elasticdl_tpu_torch/worker/
allreduce_trainer.py, parallel/{distributed,broadcast}.py) against the JAX
package's AllReduceTrainer on the same inputs and weights: a one-process
world step by step against JAX and bitwise against the port's LocalTrainer,
a world of two gloo ranks run as threads against the JAX trainer on the
whole batch, a regroup 2 -> 1 -> 2 with the collective state sync, the
COLLECTIVE pull of the MNIST CNN (BatchNorm statistics included), a
--multi_host lease job whose second worker dies mid-lease, and the
documented divergences. No subprocess: ranks are threads of this process,
each with its own process group."""

import socket
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax
import test_module
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.ops import optimizers as joptim
from elasticdl_tpu.worker.allreduce_trainer import (
    AllReduceTrainer as JaxAllReduceTrainer,
)
from elasticdl_tpu.worker.master_client import MasterClient as JaxClient
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.common.params import params_to_flax, state_to_flax
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.membership import MembershipManager
from elasticdl_tpu_torch.master.policy import WorldHintBoard
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models.mnist import mnist_model
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers as toptim
from elasticdl_tpu_torch.parallel import distributed
from elasticdl_tpu_torch.worker import allreduce_trainer as art
from elasticdl_tpu_torch.worker import task_data_service
from elasticdl_tpu_torch.worker import worker as worker_loop
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.trainer import LocalTrainer
from test_utils import start_master

torch.set_num_threads(1)

LM = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, max_len=16,
          activation_dtype="float32")
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _no_waits(monkeypatch):
    """The join gate, the lease loop and the task loop poll without
    sleeping."""
    monkeypatch.setattr(art, "GATE_POLL_SECONDS", 0.0)
    monkeypatch.setattr(worker_loop, "LEASE_WAIT_SECONDS", 0.0)
    monkeypatch.setattr(task_data_service, "_WAIT_SLEEP_SECONDS", 0.0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Linear(nn.Module):
    """tests/test_module.py's LinearModel."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(test_module.FEATURE_DIM, 1)

    def forward(self, x):
        return self.Dense_0(x)


def _linear_loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return torch.mean((predictions.reshape(-1) - labels.reshape(-1)) ** 2)


# name -> (port model, loss, optimizer spec; JAX model, loss, optimizer
# spec; batch(n, seed)). The LM trains with SGD across the frameworks:
# Adam moves a weight whose gradient is rounding noise (the key bias) by up
# to its learning rate either way (ROADMAP Queue 3), which no parameter
# tolerance over five steps can hold.
def _linear_batch(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, test_module.FEATURE_DIM)).astype(np.float32)
    return x, (x @ test_module.TRUE_W + test_module.TRUE_B).astype(
        np.float32)


def _lm_batch(n, seed):
    tokens = synthetic_lm_tokens(n, LM["max_len"], vocab=LM["vocab"],
                                 branching=4, seed=seed)
    return tokens[:, :-1], tokens[:, 1:]


MODELS = {
    "linear": (lambda: (_Linear(), _linear_loss, toptim.sgd(0.1)),
               lambda: (test_module.custom_model(), test_module.loss,
                        joptim.sgd(learning_rate=0.1)),
               _linear_batch),
    "lm": (lambda: (tlm.custom_model(tlm.LMConfig(**LM)), tlm.loss,
                    toptim.sgd(0.5)),
           lambda: (jlm.custom_model(jlm.LMConfig(**LM)), jlm.loss,
                    joptim.sgd(learning_rate=0.5)),
           _lm_batch),
}


class _Control:
    """The port's master service for AllReduce in this process: a
    membership, optionally step leases, behind an in-process stub."""

    def __init__(self):
        self.membership = MembershipManager(coordinator_port=_free_port())
        self.servicer = MasterServicer(TaskDispatcher({}), None,
                                       self.membership)
        self.board = WorldHintBoard()
        self.servicer.bind_job_context(world_hints=self.board)

    def client(self, worker_id):
        return MasterClient(
            rpc.InProcessStub(self.servicer, rpc.MASTER_SERVICE),
            worker_id, worker_host="127.0.0.1")


def _port_trainer(control, worker_id, make, named=None, **kw):
    model, loss, opt = make()
    mc = control.client(worker_id)
    trainer = AllReduceTrainer(model, loss, opt, mc, device="cpu", **kw)
    if named is not None:
        trainer.load_flax_params(named)
    return trainer, mc


def _jax_trainer(master, make_jax, x, seed=7):
    model, loss, opt = make_jax()
    mc = JaxClient(master["addr"], worker_id=0, worker_host="127.0.0.1")
    trainer = JaxAllReduceTrainer(model, loss, opt, mc, seed=seed)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), x)["params"]
    trainer.restore_variables({"variables": {"params": params},
                               "version": 0})
    return trainer, mc


def _jax_named(trainer):
    return {k: np.asarray(v) for k, v in
            flatten_params(trainer._variables["params"])[0].items()}


def _assert_params_close(ours, named):
    assert set(ours) == set(named)
    for k, want in named.items():
        np.testing.assert_allclose(ours[k], want, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * np.abs(want).max(),
                                   err_msg=k)


def _state(trainer):
    exported = trainer.export_variables()
    return (exported["variables"], exported.get("state"),
            [np.asarray(leaf.cpu()) for leaf in exported["opt_state"]],
            exported["version"])


def _assert_state_equal(a, b):
    (va, sa, oa, na), (vb, sb, ob, nb) = a, b
    assert na == nb
    assert set(va) == set(vb) and all(
        np.array_equal(va[k], vb[k]) for k in va)
    assert (sa is None) == (sb is None)
    if sa is not None:
        assert set(sa) == set(sb) and all(
            np.array_equal(sa[k], sb[k]) for k in sa)
    assert len(oa) == len(ob) and all(
        np.array_equal(x, y) for x, y in zip(oa, ob))


def _in_threads(*fns):
    """Runs each fn in its own thread; returns their results, re-raising
    the first error."""
    out, errors = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: B902 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_process_world_matches_jax_and_local_trainer(name):
    """Five steps, one of them a ragged batch of 13: the port's step in a
    one-process world is LocalTrainer's bit for bit, and within 1e-5
    (loss) and 1e-4 (parameters) of the JAX AllReduceTrainer, which pads
    13 to its 8-device mesh and slices the padding off before the loss."""
    make, make_jax, batch = MODELS[name]
    control = _Control()
    with start_master(training_shards={"f": (0, 100)},
                      with_membership=True) as master:
        jt, jmc = _jax_trainer(master, make_jax, batch(16, 0)[0])
        named = _jax_named(jt)
        pt, _ = _port_trainer(control, 0, make, named, seed=7)
        local = LocalTrainer(*make(), device="cpu")
        local.load_flax_params(named)
        try:
            for step in range(5):
                x, y = batch(13 if step == 2 else 16, step)
                _, _, jloss = jt.train_minibatch(x, y)
                _, version, loss = pt.train_minibatch(x, y)
                _, _, lloss = local.train_minibatch(x, y)
                assert float(loss) == pytest.approx(float(jloss),
                                                    rel=LOSS_RTOL)
                assert torch.equal(loss, lloss)
            assert version == jt.get_model_version() == 5
            _assert_params_close(pt.export_variables()["variables"],
                                 _jax_named(jt))
            _assert_state_equal(_state(pt), _state(local))
            assert pt.world_fingerprint == "data=1"
        finally:
            jt.close()
            jmc.close()
            pt.close()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_two_rank_world_matches_jax_on_the_whole_batch(name):
    """Two gloo ranks, each on half of every batch of 16, against the JAX
    trainer on the whole batch: the ranks hold the same bits after every
    step, within 1e-5 of the JAX trainer's parameters and loss."""
    make, make_jax, batch = MODELS[name]
    control = _Control()
    with start_master(training_shards={"f": (0, 100)},
                      with_membership=True) as master:
        jt, jmc = _jax_trainer(master, make_jax, batch(16, 0)[0])
        named = _jax_named(jt)
        ranks = [_port_trainer(control, i, make, named, multi_host=True)
                 for i in range(2)]
        for _, mc in ranks:
            mc.report_liveness()
        try:
            for step in range(3):
                x, y = batch(16, step)
                _, _, jloss = jt.train_minibatch(x, y)
                losses = _in_threads(*[
                    (lambda t=t, i=i: t.train_minibatch(
                        x[8 * i:8 * (i + 1)], y[8 * i:8 * (i + 1)])[2])
                    for i, (t, _) in enumerate(ranks)])
                assert torch.equal(losses[0], losses[1])
                assert float(losses[0]) == pytest.approx(float(jloss),
                                                         rel=LOSS_RTOL)
            states = [_state(t) for t, _ in ranks]
            _assert_state_equal(*states)
            want = _jax_named(jt)
            for k, v in want.items():
                np.testing.assert_allclose(
                    states[0][0][k], v, rtol=LOSS_RTOL,
                    atol=LOSS_RTOL * np.abs(v).max(), err_msg=k)
            assert ranks[0][0].world_fingerprint == "data=2|p2"
            stats = ranks[0][0].world.stats
            assert stats.calls >= 3 and stats.d2h_s == 0.0  # no staging
        finally:
            jt.close()
            jmc.close()
            for t, _ in ranks:
                t.close()


def test_two_rank_bfloat16_gradients_average():
    """The bfloat16 LM (the flagship's activations) as two gloo ranks on
    halves of a batch of 16. Each rank's step is LocalTrainer's on its
    half, so the averaged first-step gradients and the loss are, bit for
    bit, the mean of two LocalTrainers' on the halves (summed, then divided
    by the world size). Against LocalTrainer on the whole batch they lie
    within 1e-2 of each tensor's largest gradient (each rank's gradients
    are rounded to bfloat16 before the all-reduce: up to 4e-3 here); a sum
    not divided by the world size is off by a factor of 2."""
    lm = dict(LM, activation_dtype="bfloat16")

    def make():
        return tlm.custom_model(tlm.LMConfig(**lm)), tlm.loss, toptim.sgd(0.5)

    def local_step(x, y):
        local = LocalTrainer(*make(), device="cpu")
        _, _, loss = local.train_minibatch(x, y)
        return loss, {n: p.grad.clone()
                      for n, p in local._model.named_parameters()}

    x, y = _lm_batch(16, 0)
    (l0, g0), (l1, g1) = local_step(x[:8], y[:8]), local_step(x[8:], y[8:])
    _, whole = local_step(x, y)
    control = _Control()
    ranks = [_port_trainer(control, i, make, multi_host=True)
             for i in range(2)]
    for _, mc in ranks:
        mc.report_liveness()
    try:
        _in_threads(*[(lambda t=t: t.init_variables_if_needed(x[:8]))
                      for t, _ in ranks])
        losses = _in_threads(*[
            (lambda t=t, i=i: t.train_minibatch(x[8 * i:8 * (i + 1)],
                                                y[8 * i:8 * (i + 1)])[2])
            for i, (t, _) in enumerate(ranks)])
        assert torch.equal(losses[0], (l0 + l1) / 2)
        for name, p in ranks[0][0]._model.named_parameters():
            assert torch.equal(p.grad, (g0[name] + g1[name]) / 2), name
            g = whole[name]
            err = float((p.grad - g).abs().max() / g.abs().max())
            assert err <= 1e-2, (name, err)
        _assert_state_equal(_state(ranks[0][0]), _state(ranks[1][0]))
    finally:
        for t, _ in ranks:
            t.close()


def test_regroup_two_one_two_syncs_rank0_state():
    """2 ranks train; rank 1 leaves and rank 0 goes on alone in a world of
    1; a fresh joiner forms a world of 2 with it and takes rank 0's
    variables, Adam moments and version by the collective sync."""
    make = lambda: (_Linear(), _linear_loss, toptim.adam(0.02))  # noqa
    control = _Control()
    t0, mc0 = _port_trainer(control, 0, make, multi_host=True)
    t1, mc1 = _port_trainer(control, 1, make, multi_host=True)
    mc0.report_liveness()
    mc1.report_liveness()
    x, y = _linear_batch(8, 0)
    try:
        for _ in range(2):
            _in_threads(lambda: t0.train_minibatch(x[:4], y[:4]),
                        lambda: t1.train_minibatch(x[4:], y[4:]))
        t1.close()
        control.membership.remove_worker(1)
        t0.init_world_if_needed()
        assert (t0.world_size, t0.world.is_live()) == (1, False)
        t0.train_minibatch(x, y)
        torch.manual_seed(123)  # the joiner's weights differ
        t2, mc2 = _port_trainer(control, 2, lambda: (
            _Linear(), _linear_loss, toptim.adam(0.02)), multi_host=True)
        mc2.report_liveness()
        _in_threads(t0.init_world_if_needed,
                    lambda: t2.init_variables_if_needed(x))
        assert t2.rank == 1 and t2.world.is_live()
        _assert_state_equal(_state(t2), _state(t0))
        assert t2.get_model_version() == 3
        _in_threads(lambda: t0.train_minibatch(x[:4], y[:4]),
                    lambda: t2.train_minibatch(x[4:], y[4:]))
        _assert_state_equal(_state(t2), _state(t0))
        assert t0.state_digest() == t2.state_digest()
        assert not torch.distributed.is_initialized()
    finally:
        t0.close()
        t2.close()


def test_collective_pull_carries_batchnorm_state():
    """Two one-process worlds (no --multi_host) of the MNIST CNN at batch
    4: a joiner pulls rank 0's variables, BatchNorm statistics, optimizer
    leaves and version over the COLLECTIVE service, bitwise."""
    rng = np.random.default_rng(0)
    x = rng.random((4, 28, 28), np.float32)
    y = rng.integers(0, 10, 4).astype(np.int64)
    make = lambda: (mnist_model.custom_model(), mnist_model.loss,  # noqa
                    mnist_model.optimizer())
    control = _Control()
    t0, _ = _port_trainer(control, 0, make)
    try:
        for _ in range(2):
            t0.train_minibatch(x, y)
        t1, _ = _port_trainer(control, 1, make, seed=5)
        try:
            t1.init_variables_if_needed(x)
            assert (t1.rank, t1.world_size) == (1, 2)
            ours = _state(t1)
            assert ours[1] and ours[3] == 2
            _assert_state_equal(ours, _state(t0))
            # A later epoch bump resolves to the same spec: a fast regroup.
            control.membership.register(7, "10.0.0.7:1")
            before = art._C_REGROUPS.labels(mode="fast").value
            t0.init_world_if_needed()
            assert art._C_REGROUPS.labels(mode="fast").value == before + 1
        finally:
            t1.close()
    finally:
        t0.close()


def test_batchnorm_in_a_multi_process_world_raises(monkeypatch):
    """(The name is from before cross-rank BatchNorm.) The MNIST CNN in a
    world of two ranks as threads, each on half of a batch of 8: its
    BatchNorm statistics are the whole batch's, so two steps land within
    1e-5 of LocalTrainer's on the whole batch (parameters and running
    statistics), and the ranks stay bitwise equal."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int64)
    make = lambda: (mnist_model.custom_model(), mnist_model.loss,  # noqa
                    mnist_model.optimizer())
    local = LocalTrainer(*make(), device="cpu")
    local.init_variables_if_needed(x)
    named, state = params_to_flax(local._model), state_to_flax(local._model)
    control = _Control()
    ranks = []
    for i in range(2):
        t, mc = _port_trainer(control, i, make, multi_host=True)
        t.load_flax_params(named, state)
        ranks.append(t)
    for t in ranks:
        t._mc.report_liveness()
    try:
        for _ in range(2):
            local.train_minibatch(x, y)
            _in_threads(lambda: ranks[0].train_minibatch(x[:4], y[:4]),
                        lambda: ranks[1].train_minibatch(x[4:], y[4:]))
        assert ranks[0].world_fingerprint == "data=2|p2"
        _assert_state_equal(_state(ranks[0]), _state(ranks[1]))
        for ours, theirs in ((params_to_flax(ranks[0]._model),
                              params_to_flax(local._model)),
                             (state_to_flax(ranks[0]._model),
                              state_to_flax(local._model))):
            for k, v in theirs.items():
                np.testing.assert_allclose(ours[k], v, rtol=1e-5,
                                           atol=1e-5 * np.abs(v).max(),
                                           err_msg=k)
    finally:
        for t in ranks:
            t.close()


@pytest.mark.parametrize("kw", [dict(pipeline_stages=2)],
                         ids=lambda kw: next(iter(kw)))
def test_unported_parallelism_raises(kw, monkeypatch):
    """The pipeline is ported (tests/test_torch_pipeline.py): a model spec
    without the pipeline_spec hook runs unpipelined, with the JAX warning,
    and the stage axis combined with the model axis raises, as in JAX. The
    model and seq axes are tests/test_torch_model_axes.py's, the data axis
    tests/test_torch_data_axis.py's."""
    said = []
    monkeypatch.setattr(art.logger, "warning",
                        lambda msg, *a, **k: said.append(msg % a))
    trainer = AllReduceTrainer(_Linear(), _linear_loss, toptim.sgd(0.1),
                               _Control().client(0), device="cpu", **kw)
    trainer.close()
    assert trainer._pipeline_stages == 1
    assert any("no pipeline_spec hook; running unpipelined" in w
               for w in said)
    with pytest.raises(ValueError, match="cannot be combined"):
        AllReduceTrainer(_Linear(), _linear_loss, toptim.sgd(0.1),
                         _Control().client(0), device="cpu",
                         pipeline_spec_fn=tlm.pipeline_spec,
                         model_parallel_size=2, **kw)


def test_divergences_backend_gate_budget_and_world_hint(monkeypatch):
    """gloo for every device; the join gate's budget from its knob, else
    90 s (no compile tracker); the world hint polled and recorded."""
    assert distributed.collective_backend() == "gloo"
    monkeypatch.delenv("ELASTICDL_JOIN_GATE_SECONDS", raising=False)
    assert art.join_gate_budget() == 90.0
    monkeypatch.setenv("ELASTICDL_JOIN_GATE_SECONDS", "7")
    assert art.join_gate_budget() == 7.0
    control = _Control()
    control.board.announce(3, "scale up")
    trainer, _ = _port_trainer(control, 0, lambda: (
        _Linear(), _linear_loss, toptim.sgd(0.1)))
    try:
        trainer.train_minibatch(*_linear_batch(4, 0))
        assert (trainer.hint_seq_seen, trainer.hinted_world) == (1, 3)
    finally:
        trainer.close()
    assert art.step_seed(0, 5) == art.step_seed(0, 5) != art.step_seed(0, 6)


LINEAR_DEF = '''\
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
'''


class _Killed(BaseException):
    """The death of a worker's process: no handler of the worker catches
    it."""


def test_lease_job_survives_a_worker_dying_mid_lease(tmp_path, monkeypatch):
    """--multi_host through the port's in-process Master: two worker threads
    train on step leases; worker 1 dies at its 11th step (mid-lease). Its
    group is dropped and the membership loses it, as the instance manager
    does on a process's exit; worker 0's collective fails, it regroups to
    a world of 1, the lease is requeued, and records_done is exact."""
    monkeypatch.setenv("ELASTICDL_METRICS_PORT", "-1")
    monkeypatch.setenv("ELASTICDL_HEARTBEAT_SECONDS", "0")
    monkeypatch.delenv("ELASTICDL_OBS_DIR", raising=False)
    model_def = tmp_path / "linear.py"
    model_def.write_text(LINEAR_DEF)
    train = tmp_path / "train.edlr"
    with RecordFileWriter(str(train)) as writer:
        for record in test_module.make_linear_records(192):
            writer.write(record)
    common = ["--model_def", str(model_def),
              "--distribution_strategy", "AllreduceStrategy",
              "--multi_host", "--training_data", str(train),
              "--records_per_task", "16", "--minibatch_size", "4",
              "--num_epochs", "1", "--seed", "0"]
    margs = edl_args.master_parser().parse_args(common + [
        "--instance_backend", "none",
        "--coordinator_port", str(_free_port())])
    master = Master(margs)
    workers = [build_worker(
        edl_args.worker_parser().parse_args(common + [
            "--worker_id", str(i), "--master_addr", "in-process"]),
        MasterClient(master.stub(), i, worker_host="127.0.0.1"),
        device="cpu") for i in range(2)]
    dying = workers[1].trainer
    run_step = dying.train_lease_minibatch
    calls = [0]

    def dies_at_11(features, labels):
        calls[0] += 1
        if calls[0] == 11:
            raise _Killed()
        return run_step(features, labels)

    dying.train_lease_minibatch = dies_at_11

    def worker_1():
        try:
            workers[1].run()
        except _Killed:
            dying.close()
            master.task_d.recover_tasks(1)
            master.membership.remove_worker(1)

    try:
        _in_threads(workers[0].run, worker_1)
        assert master.task_d.finished() and not master.task_d.job_failed
        assert master.task_d.stats()["records_done"] == 192
        assert workers[0].trainer.world_size == 1
        assert workers[1].steps == 10 and workers[0].steps > 24
        # Worker 0's 11th step ran its forward and backward, then its
        # all-reduce raised.
        assert workers[0].failed_steps == 1
    finally:
        for w in workers:
            w.trainer.close()
        master.stop()
