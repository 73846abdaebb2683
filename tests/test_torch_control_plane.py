"""The port's control plane (elasticdl_tpu_torch/master, worker/worker.py,
task_data_service.py, master_client.py, common/rpc.py, save_utils.py)
against the JAX package's: the task dispatcher's decisions, the servicer's
answers, a tiny-LM job through both workers, a recovery drill, and worker
checkpoints restored across the two packages."""

import numpy as np
import pytest
import torch

import jax
from elasticdl_tpu.common import save_utils as jax_save_utils
from elasticdl_tpu.common.constants import JobType as JaxJobType
from elasticdl_tpu.common.model_utils import get_model_spec as jax_spec
from elasticdl_tpu.data import reader as jax_reader
from elasticdl_tpu.master.evaluation_service import (
    EvaluationService as JaxEvaluationService,
)
from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxDispatcher,
)
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu.worker.master_client import (
    MasterClient as JaxMasterClient,
)
from elasticdl_tpu.worker.trainer import LocalTrainer as JaxLocalTrainer
from elasticdl_tpu.worker.worker import Worker as JaxWorker
from elasticdl_tpu_torch.common import rpc, save_utils
from elasticdl_tpu_torch.common.constants import MAX_TASK_RETRIES, JobType
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.common.tensor_utils import ndarray_to_tensor_pb
from elasticdl_tpu_torch.data import reader
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker import task_data_service
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.trainer import LocalTrainer
from elasticdl_tpu_torch.worker.worker import Worker

from test_torch_trainer import LOSS_ATOL, TINY
from test_utils import start_master

torch.set_num_threads(1)

# Eval outputs and metrics of the same weights in the two frameworks
# (test_torch_trainer.py holds logits to the same bound).
EVAL_ATOL = 1e-4
LM_SPEC = "elasticdl_tpu_torch.models.transformer.transformer_lm"


@pytest.fixture(autouse=True)
def _short_waits(monkeypatch):
    monkeypatch.setattr(task_data_service, "_WAIT_SLEEP_SECONDS", 0.001)


# ---------- (a) the dispatcher's decisions ----------


def _dispatch_scenario(dispatcher_cls):
    """One scripted scenario: shuffled shards over 2 epochs, a failing
    task requeued up to MAX_TASK_RETRIES, a dead worker's tasks recovered,
    evaluation tasks, batched leases; then a second dispatcher whose task
    exhausts its retries. Returns the dispatch log and both stats."""
    d = dispatcher_cls({"a": (0, 50), "b": (10, 35)}, {"v": (0, 20)},
                       records_per_task=8, num_epochs=2, shuffle=True,
                       seed=7)
    log = []

    def record(task_id, task):
        log.append((task_id,) if task is None else (
            task_id, task.shard_name, task.start, task.end, int(task.type)))
        return task_id

    def get(worker, eval_only=False):
        return record(*(d.get_eval_task(worker) if eval_only
                        else d.get(worker)))

    d.report(get(0), True)
    for _ in range(MAX_TASK_RETRIES):  # fails, requeued at the front
        d.report(get(1), False, "boom")
    d.report(get(1), True)  # its last allowed retry succeeds
    get(2)
    get(2)
    d.recover_tasks(2)  # a dead worker: both tasks back in the queue
    d.create_evaluation_tasks(5)
    d.report(get(0, eval_only=True), True)
    for task_id, task in d.get_batch(3, 4):
        d.report(record(task_id, task), True)
    worker = 0
    while (task_id := get(worker)) >= 0:
        d.report(task_id, True)
        worker = (worker + 1) % 3
    result = {"stats": d.stats(), "done": (d.finished(), d.job_failed)}

    doomed = dispatcher_cls({"a": (0, 8)}, records_per_task=8, seed=1)
    for _ in range(MAX_TASK_RETRIES + 1):
        doomed.report(record(*doomed.get(0)), False, "boom")
    return dict(result, log=log, doomed_stats=doomed.stats(),
                doomed_done=(doomed.finished(), doomed.job_failed))


def test_dispatcher_scenario_matches_jax_package():
    ours = _dispatch_scenario(TaskDispatcher)
    theirs = _dispatch_scenario(JaxDispatcher)
    assert ours == theirs
    assert ours["stats"]["records_done"] == 2 * (50 + 35)
    assert ours["stats"]["tasks_recovered"] == 2
    assert ours["done"] == (True, False)
    assert ours["doomed_stats"]["tasks_abandoned"] == 1
    assert ours["doomed_done"] == (True, True)


# ---------- (b) the servicer through the in-process stub ----------


def _servicer_pair():
    def build(dispatcher_cls, service_cls, servicer_cls):
        d = dispatcher_cls({"t": (0, 24)}, {"v": (0, 8)},
                           records_per_task=8, shuffle=False)
        evaluation = service_cls(d, tlm.eval_metrics_fn, eval_steps=2)
        return servicer_cls(d, evaluation)

    return (build(TaskDispatcher, EvaluationService, MasterServicer),
            build(JaxDispatcher, JaxEvaluationService, JaxServicer))


def test_servicer_through_stub_answers_as_jax_servicer():
    ours, theirs = _servicer_pair()
    _answers_as_jax_servicer(
        rpc.InProcessStub(ours, rpc.MASTER_SERVICE), theirs)


def test_servicer_over_the_socket_answers_as_jax_servicer():
    """The same calls through the port's socket transport (common/rpc.py
    serve and a channel) answer as the JAX servicer does."""
    ours, theirs = _servicer_pair()
    server, port = rpc.serve(ours, rpc.MASTER_SERVICE)
    channel = rpc.build_channel(f"127.0.0.1:{port}", ready_timeout=0)
    try:
        _answers_as_jax_servicer(rpc.Stub(channel, rpc.MASTER_SERVICE),
                                 theirs)
    finally:
        channel.close()
        server.stop(0)


def _answers_as_jax_servicer(stub, theirs):
    logits = np.random.default_rng(0).standard_normal(
        (2, 3, 5)).astype(np.float32)
    labels = np.array([[1, 2, 3], [4, 0, 1]], np.int32)
    calls = [
        ("get_task", "GetTaskRequest", dict(worker_id=0)),
        ("get_task_batch", "GetTaskRequest", dict(worker_id=1, max_tasks=2)),
        ("report_task_result", "ReportTaskResultRequest",
         dict(task_id=0, lease_token=1)),
        ("report_task_results", "ReportTaskResultsRequest",
         dict(results=[dict(task_id=1, lease_token=2),
                       dict(task_id=2, err_message="boom", lease_token=3)])),
        ("report_version", "ReportVersionRequest", dict(model_version=2)),
        ("get_task", "GetTaskRequest", dict(worker_id=0,
                                            task_type=pb.EVALUATION)),
        ("report_evaluation_metrics", "ReportEvaluationMetricsRequest",
         dict(worker_id=0)),
        ("report_task_result", "ReportTaskResultRequest", dict(task_id=3)),
        ("get_task", "GetTaskRequest", dict(worker_id=2)),
        ("get_task", "GetTaskRequest", dict(worker_id=2,
                                            task_type=pb.EVALUATION)),
        ("get_job_status", "GetJobStatusRequest", {}),
    ]
    for method, req_name, fields in calls:
        ours_req = getattr(pb, req_name)()
        theirs_req = getattr(pb2, req_name)()
        for name, value in fields.items():
            if name == "results":
                for entry in value:
                    ours_req.results.add(**entry)
                    theirs_req.results.add(**entry)
            else:
                setattr(ours_req, name, value)
                setattr(theirs_req, name, value)
        if method == "report_evaluation_metrics":
            for req in (ours_req, theirs_req):
                out = ndarray_to_tensor_pb(logits).SerializeToString()
                lab = ndarray_to_tensor_pb(labels).SerializeToString()
                if req is ours_req:
                    req.model_outputs.append(pb.Tensor.FromString(out))
                    req.labels = pb.Tensor.FromString(lab)
                else:
                    req.model_outputs.add().ParseFromString(out)
                    req.labels.ParseFromString(lab)
        got = getattr(stub, method)(ours_req)
        want = getattr(theirs, method)(theirs_req, None)
        if method == "get_job_status":
            # seconds since each worker's last call differ between runs
            assert sorted(got.worker_last_seen_ago) == sorted(
                want.worker_last_seen_ago)
            got.worker_last_seen_ago.clear()
            want.worker_last_seen_ago.clear()
            assert got.last_eval_metrics.keys() == {"token_ce"}
        assert type(got).__name__ == type(want).__name__
        parsed = type(want).FromString(got.SerializeToString())
        assert parsed == want, method


def test_master_client_over_the_socket_and_its_reconnect(monkeypatch):
    """MasterClient on an address: the worker's calls cross the socket and
    answer as through the in-process stub of an identical servicer;
    reconnect() waits for a master that rebinds the same port, then swaps
    the channel."""
    monkeypatch.setenv("ELASTICDL_RPC_MAX_ATTEMPTS", "1")
    rpc.reload_config()
    ours, _ = _servicer_pair()
    twin, _ = _servicer_pair()
    server, port = rpc.serve(ours, rpc.MASTER_SERVICE)
    client = MasterClient(f"127.0.0.1:{port}", 0)
    local = MasterClient(rpc.InProcessStub(twin, rpc.MASTER_SERVICE), 0)
    try:
        for mc in (client, local):
            assert mc.reconnect() is (mc is client)
        for call in (lambda mc: mc.get_task(),
                     lambda mc: mc.get_task_batch(2),
                     lambda mc: mc.report_task_results(
                         [(0, "", {"records": 8}, 1)]),
                     lambda mc: mc.report_task_result(1, lease_token=2),
                     lambda mc: mc.report_version(2),
                     lambda mc: mc.report_telemetry(
                         [dict(role="worker-0", seq=1, full=True)],
                         origin="worker-0")):
            assert call(client) == call(local)
        got, want = client.get_job_status(), local.get_job_status()
        assert got.records_done == want.records_done == 16
        server.stop(0)
        with pytest.raises(rpc.RpcError) as err:
            client.get_task()
        assert err.value.code() == rpc.StatusCode.UNAVAILABLE
        assert client.reconnect(probe_timeout=0.2) is False
        server, _ = rpc.serve(ours, rpc.MASTER_SERVICE, port=port)
        assert client.reconnect()
        rpc.reload_config()  # the breaker tripped on the dead peer
        assert client.get_job_status().records_done == 16
    finally:
        client.close()
        server.stop(0)
        monkeypatch.undo()
        rpc.reload_config()


def test_stub_surfaces_handler_errors_as_rpc_errors():
    class Broken:
        def get_task(self, request, context):
            raise RuntimeError("dispatcher down")

    stub = rpc.InProcessStub(Broken(), rpc.MASTER_SERVICE)
    with pytest.raises(rpc.RpcError) as err:
        stub.get_task(pb.GetTaskRequest(worker_id=1))
    assert err.value.code() == rpc.StatusCode.UNKNOWN
    assert "dispatcher down" in err.value.details()
    with pytest.raises(rpc.RpcError) as err:
        stub.report_version(pb.ReportVersionRequest(model_version=1))
    assert err.value.code() == rpc.StatusCode.UNIMPLEMENTED


# ---------- (c) a tiny-LM job through both workers ----------


def _lm_records():
    tokens = synthetic_lm_tokens(32, TINY["max_len"], vocab=TINY["vocab"],
                                 branching=4, seed=0)
    records = [encode_example({"tokens": t}) for t in tokens]
    return records[:24], records[24:]


def _jax_trainer(named):
    """A JAX LocalTrainer holding the flax-named weights `named` (its own
    jitted init would cost seconds of compiling on the CPU)."""
    params = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jax.numpy.asarray(value)
    trainer = JaxLocalTrainer(jlm.custom_model(jlm.LMConfig(**TINY)),
                              jlm.loss, jlm.optimizer())
    trainer.restore_variables({"variables": {"params": params},
                               "version": 0})
    return trainer


def _port_trainer(named=None, **kwargs):
    trainer = LocalTrainer(tlm.custom_model(tlm.LMConfig(**TINY)), tlm.loss,
                           tlm.optimizer(), device="cpu", **kwargs)
    if named is not None:
        trainer.load_flax_params(named)
    return trainer


def _recording(trainer, losses):
    """Records each step's loss (the worker itself materializes it only at
    log steps)."""
    step = trainer.train_minibatch

    def train_minibatch(features, labels):
        result = step(features, labels)
        losses.append(float(result[2]))
        return result

    trainer.train_minibatch = train_minibatch
    return trainer


def _task_log(reader_obj, log):
    read = reader_obj.read_records

    def read_records(task):
        log.append((task.task_id, task.shard_name, task.start, task.end,
                    int(task.type)))
        yield from read(task)

    reader_obj.read_records = read_records
    return reader_obj


_SHARDS = dict(training_shards={"train": (0, 24)},
               evaluation_shards={"valid": (0, 8)})


@pytest.fixture(scope="module")
def jax_job():
    """The tiny-LM job through the JAX package's Worker behind its gRPC
    master, once per module: its results, and its trained trainer (whose
    jitted step and forward later tests reuse instead of compiling
    again)."""
    train, valid = _lm_records()
    initial = _port_trainer(seed=0)
    initial.init_variables_if_needed(None)
    start = initial.export_variables()["variables"]
    jt = _jax_trainer(start)
    losses, tasks = [], []
    jreader = _task_log(jax_reader.CompositeReader([
        jax_reader.InMemoryReader(train, "train"),
        jax_reader.InMemoryReader(valid, "valid")]), tasks)
    with start_master(records_per_task=8, num_epochs=1, shuffle=False,
                      eval_metrics_factory=jlm.eval_metrics_fn,
                      eval_steps=2, **_SHARDS) as m:
        JaxWorker(
            0, JaxMasterClient(m["addr"], 0), jreader, jax_spec(
                "elasticdl_tpu.models.transformer.transformer_lm"),
            _recording(jt, losses), minibatch_size=4,
            job_type=JaxJobType.TRAINING_WITH_EVALUATION,
        ).run()
        done = (m["task_d"].finished(), m["task_d"].job_failed)
        records_done = m["task_d"].stats()["records_done"]
        evals = list(m["evaluation_service"].completed_results)
    del jt.train_minibatch  # the recording wrapper
    return dict(start=start, trainer=jt, losses=losses, tasks=tasks,
                done=done, records_done=records_done, evals=evals)


def test_tiny_lm_job_matches_jax_worker(jax_job):
    train, valid = _lm_records()
    assert jax_job["done"] == (True, False)
    losses, tasks = [], []
    task_d = TaskDispatcher(_SHARDS["training_shards"],
                            _SHARDS["evaluation_shards"], records_per_task=8,
                            num_epochs=1, shuffle=False)
    evaluation = EvaluationService(task_d, tlm.eval_metrics_fn, eval_steps=2)
    servicer = MasterServicer(task_d, evaluation)
    preader = _task_log(reader.CompositeReader([
        reader.InMemoryReader(train, "train"),
        reader.InMemoryReader(valid, "valid")]), tasks)
    client = MasterClient(rpc.InProcessStub(servicer, rpc.MASTER_SERVICE), 0)
    worker = Worker(0, client, preader, get_model_spec(LM_SPEC),
                    _recording(_port_trainer(jax_job["start"]), losses),
                    minibatch_size=4,
                    job_type=JobType.TRAINING_WITH_EVALUATION)
    worker.run()
    assert task_d.finished() and not task_d.job_failed

    assert tasks == jax_job["tasks"]
    assert len(losses) == worker.steps == 6
    np.testing.assert_allclose(losses, jax_job["losses"], atol=LOSS_ATOL)
    assert task_d.stats()["records_done"] == jax_job["records_done"] == 24
    assert [v for v, _ in evaluation.completed_results] == [
        v for v, _ in jax_job["evals"]] == [2, 4, 6]
    for (_, ours), (_, theirs) in zip(evaluation.completed_results,
                                      jax_job["evals"]):
        assert abs(ours["token_ce"] - theirs["token_ce"]) < EVAL_ATOL


# ---------- (d) a recovery drill ----------


class _Killed(BaseException):
    """A worker process dying: nothing in the worker loop catches it."""


class _DyingClient(MasterClient):
    """Worker 0's client: after its first task completes, the next task it
    leases is its last — the worker dies holding it."""

    def __init__(self, stub, worker_id):
        super().__init__(stub, worker_id)
        self.leased = 0

    def get_task(self, task_type=pb.TRAINING):
        task = super().get_task(task_type)
        if task.task_id >= 0:
            self.leased += 1
            if self.leased == 2:
                raise _Killed(task.task_id)
        return task


def test_recovery_drill_keeps_records_done_exact():
    train, _ = _lm_records()
    task_d = TaskDispatcher({"train": (0, 24)}, records_per_task=8,
                            num_epochs=1, shuffle=True, seed=3)
    servicer = MasterServicer(task_d)
    spec = get_model_spec(LM_SPEC)

    def worker(worker_id, client_cls):
        client = client_cls(rpc.InProcessStub(servicer, rpc.MASTER_SERVICE),
                            worker_id)
        return Worker(worker_id, client,
                      reader.InMemoryReader(train, "train"), spec,
                      _port_trainer(seed=worker_id), minibatch_size=4)

    first = worker(0, _DyingClient)
    with pytest.raises(_Killed):
        first.run()
    assert first.steps == 2  # one task of 8 records
    assert task_d.stats()["doing_by_worker"] == {0: 1}
    task_d.recover_tasks(0)  # the instance manager saw worker 0 die

    second = worker(1, MasterClient)
    second.run()
    stats = task_d.stats()
    assert task_d.finished() and not task_d.job_failed
    assert stats["records_done"] == 24  # every record once, none twice
    assert stats["tasks_recovered"] == 1
    assert second.steps == 4


# ---------- (e) worker checkpoints across the two packages ----------


def test_checkpoints_restore_across_packages(tmp_path, jax_job):
    train, _ = _lm_records()
    x, y = tlm.feed(train[:4], "training", None)
    x2, y2 = tlm.feed(train[4:8], "training", None)

    # JAX -> port, through restore_on_init: the JAX job's trained trainer
    # (6 Adam steps) saved by the JAX package.
    jt = jax_job["trainer"]
    jax_save_utils.save_trainer_checkpoint(jt, str(tmp_path / "jax"))
    ours = _port_trainer(seed=5)
    ours.restore_on_init = str(tmp_path / "jax.npz")
    np.testing.assert_allclose(ours.evaluate_minibatch(x),
                               jt.evaluate_minibatch(x), atol=EVAL_ATOL)
    assert ours.get_model_version() == jt.get_model_version() == 6
    # One further Adam step from the restored moments matches.
    _, version, loss = ours.train_minibatch(x2, y2)
    _, jversion, jloss = jt.train_minibatch(x2, y2)
    assert version == jversion == 7
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    np.testing.assert_allclose(ours.evaluate_minibatch(x),
                               jt.evaluate_minibatch(x), atol=EVAL_ATOL)

    # port -> JAX: the port's file restores into the JAX trainer.
    _, _, loss = ours.train_minibatch(x, y)
    save_utils.save_trainer_checkpoint(ours, str(tmp_path / "port"))
    jax_save_utils.restore_trainer_checkpoint(jt, str(tmp_path / "port"))
    assert jt.get_model_version() == 8
    np.testing.assert_allclose(jt.evaluate_minibatch(x),
                               ours.evaluate_minibatch(x), atol=EVAL_ATOL)
    _, _, loss = ours.train_minibatch(x2, y2)
    _, _, jloss = jt.train_minibatch(x2, y2)
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    np.testing.assert_allclose(jt.evaluate_minibatch(x),
                               ours.evaluate_minibatch(x), atol=EVAL_ATOL)

    # port -> port is exact, and a weights-only export restores weights.
    save_utils.save_trainer_checkpoint(ours, str(tmp_path / "again"))
    again = _port_trainer(seed=6)
    again.restore_on_init = str(tmp_path / "again")
    np.testing.assert_array_equal(again.evaluate_minibatch(x),
                                  ours.evaluate_minibatch(x))
    assert again.train_minibatch(x2, y2)[2].item() == \
        ours.train_minibatch(x2, y2)[2].item()
    save_utils.ExportModelCallback(str(tmp_path / "export")).on_train_end(
        ours)
    with np.load(tmp_path / "export.npz") as data:
        assert not any(k.startswith("__opt__") for k in data.files)
        assert "params/lm_head/kernel" in data.files


# ---------- (f) the master relaunched from its journal ----------


_TINY_DEF = """\
from elasticdl_tpu_torch.models.transformer import transformer_lm as _lm
from elasticdl_tpu_torch.models.transformer.transformer_lm import (  # noqa
    eval_metrics_fn, feed, loss, optimizer,
)


def custom_model():
    return _lm.custom_model(_lm.LMConfig(**{tiny!r}))
"""


class _MasterPlace:
    """The servicer at the master's place, in one process: hands each call
    to whichever Master holds the place now (a relaunched master comes
    back on the same address), and records the traffic."""

    def __init__(self, master):
        self.master = master
        self.traffic = []  # (method, request bytes, response bytes)

    def __getattr__(self, method):
        handler = getattr(self.master.servicer, method)

        def call(request, context):
            response = handler(request, context)
            self.traffic.append((method, request.SerializeToString(),
                                 response.SerializeToString()))
            return response

        return call


def _crash(master):
    """What a SIGKILL leaves of a master: its threads and its
    observability plane gone, its journal closed without a final
    compaction, nothing else flushed."""
    for part in (master._heartbeat, master.policy, master.aggregator):
        if part is not None:
            part.close()
    master.journal.close()
    if getattr(master, "_owns_obs", False):  # the JAX master's is global
        master.obs.close()


def _relaunch_env(monkeypatch):
    """No endpoint, flight recorder, heartbeat or memory sampler (none
    is under test here), an aggregator that polls once, and no
    TensorBoard writer (the JSONL stream is the metrics service's record
    of truth in both packages)."""
    from elasticdl_tpu.master import metrics_service as jax_metrics_service
    from elasticdl_tpu_torch.master import metrics_service

    for name, value in (("ELASTICDL_METRICS_PORT", "-1"),
                        ("ELASTICDL_FLIGHTREC", "0"),
                        ("ELASTICDL_HEARTBEAT_SECONDS", "0"),
                        ("ELASTICDL_MEM_SAMPLE_SECONDS", "0"),
                        ("ELASTICDL_AGGREGATOR_INTERVAL", "3600"),
                        ("ELASTICDL_OBS_DIR", ""),
                        ("ELASTICDL_JOB_NAME", "relaunch")):
        monkeypatch.setenv(name, value)
    for mod in (metrics_service, jax_metrics_service):
        monkeypatch.setattr(mod, "_make_summary_writer", lambda d: None)


def _relaunch_argv(tmp_path, model_def):
    from elasticdl_tpu_torch.data.recordfile import RecordFileWriter

    train, valid = _lm_records()
    paths = {}
    for name, records in (("train", train), ("valid", valid)):
        paths[name] = str(tmp_path / f"{name}.edlr")
        with RecordFileWriter(paths[name]) as writer:
            for record in records:
                writer.write(record)
    return ["--model_def", model_def, "--distribution_strategy", "Local",
            "--training_data", paths["train"],
            "--validation_data", paths["valid"],
            "--records_per_task", "8", "--num_epochs", "1",
            "--minibatch_size", "2", "--evaluation_steps", "4",
            "--seed", "0", "--job_name", "relaunch"]


def _events(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


def test_master_relaunched_from_its_journal_mid_task(tmp_path, monkeypatch):
    """The tiny LM as a job through the port's master, with its journal:
    the master is dropped while the worker holds a lease (after minibatch 2
    of 4 of training task 2) and a successor is built over the same
    journal directory. It replays to incarnation 2, restores the lease and
    the owner's liveness, accepts the straddling report once by its lease
    token (a retried copy is discarded), and finishes with records_done
    exact, every evaluation in metrics.jsonl. The same stub traffic, fed
    to the JAX package's master relaunched at the same call, gets the same
    answers byte for byte."""
    import json

    import elasticdl_tpu.observability as jax_observability
    from elasticdl_tpu.common import args as jax_args
    from elasticdl_tpu.common import rpc as jax_rpc
    from elasticdl_tpu.master import master as jax_master_mod
    from elasticdl_tpu_torch.common import args as edl_args
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.worker.main import build_worker

    _relaunch_env(monkeypatch)
    # The JAX package's plane is process-global and kept by the first
    # master that sets it up: one left by an earlier JAX master of this
    # process would keep this job's events elsewhere.
    stale = jax_observability.current_handle()
    if stale is not None:
        stale.close()
    model_def = tmp_path / "tiny_lm_def.py"
    model_def.write_text(_TINY_DEF.format(tiny=TINY))
    common = _relaunch_argv(tmp_path, str(model_def))

    def master_args(parser_mod, name):
        args = parser_mod.master_parser().parse_args(common + [
            "--instance_backend", "none", "--master_port", "0",
            "--metrics_dir", str(tmp_path / name / "metrics")])
        parser_mod.validate_args(args)
        return args

    monkeypatch.setenv("ELASTICDL_MASTER_JOURNAL_DIR",
                       str(tmp_path / "port" / "journal"))
    place = _MasterPlace(Master(master_args(edl_args, "port")))
    first = place.master
    assert first.master_incarnation == 1
    worker_args = edl_args.worker_parser().parse_args(common + [
        "--worker_id", "0", "--master_addr", "in-process",
        "--job_type", "training_with_evaluation"])
    worker = build_worker(
        worker_args,
        MasterClient(rpc.InProcessStub(place, rpc.MASTER_SERVICE), 0),
        device="cpu")
    step = worker.trainer.train_minibatch
    relaunch_at, held = [], []

    def train_minibatch(features, labels):
        result = step(features, labels)
        if result[1] == 6:  # minibatch 2 of 4 of training task 2
            held.extend((wid, task.start, task.end) for _, wid, task in
                        first.task_d.inflight_leases())
            _crash(first)
            relaunch_at.append(len(place.traffic))
            place.master = Master(master_args(edl_args, "port"))
            # The lease's owner has its liveness seeded (its grace window).
            assert list(place.master.servicer.snapshot_liveness()) == [0]
            (tid, wid, _), = place.master.task_d.inflight_leases()
            assert wid == 0
            # A report for the held task under another lease's token (the
            # worker's previous one) is acknowledged and discarded: the
            # restored lease keeps the task and its accounting.
            token = place.master.task_d.lease_token(tid)
            stub = rpc.InProcessStub(place, rpc.MASTER_SERVICE)
            assert stub.report_task_result(pb.ReportTaskResultRequest(
                task_id=tid, lease_token=token - 1)) == pb.Empty()
            assert place.master.task_d.lease_token(tid) == token
            assert place.master.task_d.stats()["records_done"] == 8
        return result

    worker.trainer.train_minibatch = train_minibatch
    worker.run()
    successor = place.master
    assert relaunch_at and successor is not first
    assert successor.master_incarnation == 2
    # The straddling report: task 2's, leased from the first master and
    # reported by the worker to the successor (after the stale-token one
    # above). A retried copy of it reaches the successor and is discarded.
    reports = [i for i, (method, _, _) in enumerate(place.traffic)
               if method == "report_task_result" and i > relaunch_at[0]]
    straddling = place.traffic[reports[1]]
    stub = rpc.InProcessStub(place, rpc.MASTER_SERVICE)
    assert stub.report_task_result(pb.ReportTaskResultRequest.FromString(
        straddling[1])) == pb.Empty()
    status = stub.get_job_status(pb.GetJobStatusRequest())
    stats = successor.task_d.stats()
    assert stats["records_done"] == status.records_done == 24
    assert status.master_incarnation == 2 and status.finished
    assert successor.task_d.finished() and not successor.task_d.job_failed
    assert worker.steps == 12
    # Versions reach the master after each training task (4, 8, 12): the
    # first master evaluates at 4, the successor at 8 and 12.
    assert [v for v, _ in first.evaluation_service.completed_results] == [4]
    evals = successor.evaluation_service.completed_results
    assert [v for v, _ in evals] == [8, 12]
    successor.stop()

    events = _events(str(tmp_path / "port" / "metrics" / "events.jsonl"))
    recovered = [e for e in events if e["kind"] == "master_recovered"]
    reissued = [e for e in events if e["kind"] == "lease_reissued"]
    assert [(e["incarnation"], e["records_done"], e["leases"])
            for e in recovered] == [(2, 8, 1)]
    assert len(held) == 1 and held[0][0] == 0  # the worker's one lease
    assert [(e["worker"], e["start"], e["end"]) for e in reissued] == held
    stale = [e for e in events if e["kind"] == "task_stale_lease"]
    assert [(e["task_id"], e["expected"] - e["token"]) for e in stale] == [
        (reissued[0]["task_id"], 1)]
    lines = [json.loads(line) for line in open(
        tmp_path / "port" / "metrics" / "metrics.jsonl")]
    assert [(x["group"], x["step"]) for x in lines] == [
        ("eval", 4), ("eval", 8), ("eval", 12), ("train", 12)]

    # The JAX package's master on the same traffic, relaunched at the same
    # call (its gRPC port never binds: the calls come from the record).
    monkeypatch.setattr(jax_rpc, "serve", lambda *a, **kw: (None, 0))
    monkeypatch.setenv("ELASTICDL_MASTER_JOURNAL_DIR",
                       str(tmp_path / "jax" / "journal"))
    jargs = master_args(jax_args, "jax")
    jargs.model_def = "elasticdl_tpu.models.transformer.transformer_lm"
    jmaster = jax_master_mod.Master(jargs)
    jmaster.prepare()
    for i, (method, request, response) in enumerate(place.traffic):
        if i == relaunch_at[0]:
            _crash(jmaster)
            jmaster = jax_master_mod.Master(jargs)
            jmaster.prepare()
            assert jmaster.master_incarnation == 2
        req_cls = jax_rpc.MASTER_SERVICE.methods[method][0]
        got = getattr(jmaster.servicer, method)(
            req_cls.FromString(request), None)
        if method == "get_job_status":
            assert got.master_incarnation == 2
            assert got.records_done == 24 and got.finished
        else:
            assert got.SerializeToString() == response, (i, method)
    jevals = jmaster.evaluation_service.completed_results
    assert [v for v, _ in jevals] == [8, 12]
    for (_, ours), (_, theirs) in zip(evals, jevals):
        assert abs(ours["token_ce"] - theirs["token_ce"]) < EVAL_ATOL
    jmaster.stop()
    jevents = _events(str(tmp_path / "jax" / "metrics" / "events.jsonl"))
    for kind in ("master_recovered", "lease_reissued", "task_stale_lease"):
        strip = ("ts", "seq", "pid", "job", "role", "host")
        assert [{k: v for k, v in e.items() if k not in strip}
                for e in jevents if e["kind"] == kind] == [
            {k: v for k, v in e.items() if k not in strip}
            for e in events if e["kind"] == kind]


def test_journaled_master_serves_before_prepare_and_relaunches(
        tmp_path, monkeypatch):
    """A journaled master serves from construction on: its constructor
    snapshots the initial tasks, so a master that never ran prepare() and
    is dropped with a lease out leaves a journal its successor finishes
    the job from, every record counted once."""
    from elasticdl_tpu_torch.common import args as edl_args
    from elasticdl_tpu_torch.master.journal import SNAPSHOT_NAME
    from elasticdl_tpu_torch.master.master import Master

    _relaunch_env(monkeypatch)
    journal_dir = tmp_path / "journal"
    monkeypatch.setenv("ELASTICDL_MASTER_JOURNAL_DIR", str(journal_dir))
    model_def = tmp_path / "tiny_lm_def.py"
    model_def.write_text(_TINY_DEF.format(tiny=TINY))
    args = edl_args.master_parser().parse_args(
        _relaunch_argv(tmp_path, str(model_def))
        + ["--instance_backend", "none", "--master_port", "0"])
    edl_args.validate_args(args)

    def lease(stub):
        task = stub.get_task(pb.GetTaskRequest(worker_id=0))
        assert task.type == pb.TRAINING
        return task

    def report(stub, task):
        stub.report_task_result(pb.ReportTaskResultRequest(
            task_id=task.task_id, lease_token=task.lease_token))

    first = Master(args)
    assert (journal_dir / SNAPSHOT_NAME).exists()
    stub = first.stub()
    report(stub, lease(stub))
    held = lease(stub)
    _crash(first)

    successor = Master(args)
    assert successor.master_incarnation == 2
    assert [(tid, wid) for tid, wid, _ in
            successor.task_d.inflight_leases()] == [(held.task_id, 0)]
    stub = successor.stub()
    report(stub, held)
    report(stub, lease(stub))
    done = stub.get_task(pb.GetTaskRequest(worker_id=0))
    assert done.task_id == -1 and done.type != pb.WAIT
    assert successor.task_d.stats()["records_done"] == 24
    assert successor.task_d.finished()
    successor.stop()


def test_master_owns_its_observability_plane(tmp_path, monkeypatch):
    """A master with an obs dir sets up its own plane (the exporter on
    127.0.0.1, the flight recorder without signal handlers), replaces a
    plane an earlier master of the process left over another obs dir, and
    closes its plane in stop(). A master with neither an obs dir nor a
    metrics port sets nothing up."""
    import json
    import signal

    from elasticdl_tpu_torch import observability
    from elasticdl_tpu_torch.common import args as edl_args
    from elasticdl_tpu_torch.master.master import Master

    _relaunch_env(monkeypatch)
    monkeypatch.setenv("ELASTICDL_METRICS_PORT", "0")
    monkeypatch.setenv("ELASTICDL_FLIGHTREC", "1")
    model_def = tmp_path / "tiny_lm_def.py"
    model_def.write_text(_TINY_DEF.format(tiny=TINY))
    common = _relaunch_argv(tmp_path, str(model_def)) + [
        "--instance_backend", "none", "--master_port", "0"]

    def build(*extra):
        args = edl_args.master_parser().parse_args(common + list(extra))
        edl_args.validate_args(args)
        return Master(args)

    sigterm = signal.getsignal(signal.SIGTERM)
    left = build("--metrics_dir", str(tmp_path / "a"))
    assert observability.current_handle() is left.obs
    assert left.obs.exporter._server.server_address[0] == "127.0.0.1"
    assert left.obs.flight is not None
    assert signal.getsignal(signal.SIGTERM) is sigterm
    with open(tmp_path / "a" / "endpoints" / "master.json") as f:
        assert json.load(f)["host"] == "127.0.0.1"

    master = build("--metrics_dir", str(tmp_path / "b"))
    assert observability.current_handle() is master.obs is not left.obs
    assert left.obs.exporter._server.fileno() == -1  # closed
    assert master.obs.obs_dir == str(tmp_path / "b")
    master.stop()
    assert observability.current_handle() is None
    assert not (tmp_path / "b" / "endpoints" / "master.json").exists()

    monkeypatch.delenv("ELASTICDL_METRICS_PORT")
    bare = build()
    assert bare.obs is None and observability.current_handle() is None
    bare.stop()
