"""The port's `edl` client (`python -m elasticdl_tpu_torch.client.main`)
against the JAX package's: `zoo init` (a PyTorch template the port's spec
loader takes and trains), `zoo list` (every model directory of the JAX
zoo), `zoo build` and `zoo push` (the same files and commands), `top` and
`dash` on a port master over the port's transport, `tensorboard`, and
`profile` (raises until the device profiler is ported). One `edl train` ->
`edl predict` round on the zoo template through the real CLI, the master
in this process and one worker process per job: the predictions the worker
writes equal the JAX template model's forward on the exported weights."""

import json
import os
import sys

import numpy as np
import pytest

from elasticdl_tpu.client import main as jax_client
from elasticdl_tpu.common.model_utils import get_model_spec as jax_spec
from elasticdl_tpu.observability import dashboard as jax_dashboard
from elasticdl_tpu_torch.client import main as port_client
from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.common.args import master_parser
from elasticdl_tpu_torch.common.model_utils import (
    get_model_spec as port_spec,
    load_module,
)
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUE_W = np.array([1.0, -2.0, 0.5, 0.0], np.float32)


def _zoo_init(client, path, *extra):
    return client.main(["zoo", "init", "--path", str(path), "--name",
                        "tmpl", *extra])


def test_zoo_init_template_loads_and_trains(tmp_path):
    assert _zoo_init(port_client, tmp_path) == 0
    module = load_module(str(tmp_path / "tmpl.py"))
    spec = port_spec(str(tmp_path / "tmpl.py"))
    trainer = LocalTrainer(spec.build_model(), spec.loss,
                           spec.build_optimizer_spec(), device="cpu")
    x = np.ones((3, module.IN_FEATURES), np.float32)
    accepted, version, loss = trainer.train_minibatch(x, np.ones(3))
    assert accepted and version == 1 and np.isfinite(float(loss))
    # Refuses to overwrite without --force, as the JAX client does.
    assert _zoo_init(port_client, tmp_path) == 1
    assert _zoo_init(jax_client, tmp_path) == 1
    assert _zoo_init(port_client, tmp_path, "--force") == 0


def test_zoo_list_names_every_jax_model_directory(capsys):
    assert port_client.main(["zoo", "list"]) == 0
    listed = capsys.readouterr().out.split()
    jax_zoo = os.path.join(REPO, "elasticdl_tpu", "models")
    want = sorted(e for e in os.listdir(jax_zoo)
                  if os.path.isdir(os.path.join(jax_zoo, e))
                  and not e.startswith("__"))
    assert listed == want


@pytest.mark.parametrize("command", [
    ["zoo", "build", "--image", "reg.example/zoo:1"],
    ["zoo", "push", "--image", "reg.example/zoo:1", "--dry_run"],
])
def test_zoo_build_and_push_match_jax(tmp_path, capsys, command):
    zoo_dir = tmp_path / "myzoo"
    zoo_dir.mkdir()
    (zoo_dir / "m.py").write_text("# model def\n")
    results = {}
    for name, client in (("jax", jax_client), ("port", port_client)):
        build = tmp_path / f"build_{name}"
        argv = list(command)
        if command[1] == "build":
            argv += ["--path", str(zoo_dir), "--build_dir", str(build)]
        rc = client.main(argv)
        out = capsys.readouterr().out.replace(str(build), "<build>")
        files = {}
        if build.exists():
            for root, _, names in os.walk(build):
                for n in names:
                    p = os.path.join(root, n)
                    files[os.path.relpath(p, build)] = open(p).read()
        results[name] = (rc, out, files)
    assert results["port"] == results["jax"]
    assert results["port"][0] == 0


@pytest.mark.parametrize("which", [None, "/usr/bin/tensorboard"])
def test_tensorboard_matches_jax(monkeypatch, which):
    import shutil
    import subprocess

    calls = []

    class _Done:
        returncode = 0

    monkeypatch.setattr(shutil, "which", lambda name: which)
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or _Done())
    argv = ["tensorboard", "--metrics_dir", "/m", "--port", "7007"]
    rcs = [client.main(argv) for client in (jax_client, port_client)]
    assert rcs[0] == rcs[1] == (1 if which is None else 0)
    if which is not None:
        assert calls[0] == calls[1]


def test_profile_raises_naming_the_queue_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        port_client.main(["profile", "--master_addr", "127.0.0.1:1"])


def _records(path, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = x @ TRUE_W
    with RecordFileWriter(str(path)) as w:
        for i in range(n):
            w.write(encode_example({"x": x[i], "y": y[i:i + 1]}))
    return str(path), x


@pytest.fixture
def quiet_master(monkeypatch):
    """No heartbeat file, no exporter, no journal; the instance manager's
    environment edits are undone after the test."""
    for var, value in (("ELASTICDL_HEARTBEAT_SECONDS", "0"),
                       ("ELASTICDL_TORCH_DEVICE", "cpu"),
                       ("OMP_NUM_THREADS", "1"),
                       ("ELASTICDL_TELEMETRY_PUSH_INTERVAL", "0"),
                       ("ELASTICDL_JOB_NAME", "")):
        monkeypatch.setenv(var, value)
    for var in ("ELASTICDL_METRICS_PORT", "ELASTICDL_OBS_DIR",
                "ELASTICDL_MASTER_JOURNAL_DIR", "ELASTICDL_POLICY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTHONPATH", REPO)


def test_top_and_dash_read_a_port_master(tmp_path, quiet_master, capsys,
                                         monkeypatch):
    from elasticdl_tpu_torch.master.master import Master

    data, _ = _records(tmp_path / "d.edlr", 16)
    _zoo_init(port_client, tmp_path)
    capsys.readouterr()
    master = Master(master_parser().parse_args([
        "--model_def", str(tmp_path / "tmpl.py"), "--training_data", data,
        "--records_per_task", "8", "--instance_backend", "none",
        "--distribution_strategy", "Local", "--master_port", "0"]))
    try:
        master.serve()
        addr = f"127.0.0.1:{master.port}"
        assert port_client.main(["top", "--master_addr", addr,
                                 "--iterations", "1", "--interval",
                                 "0"]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line == ("epoch 1/1 v0 tasks todo=2 doing=0 workers=0 "
                        "records=0")
        assert port_client.main(["dash", "--master_addr", addr,
                                 "--once"]) == 0
        frame = capsys.readouterr().out
        # The JAX package's renderer on the same status and summary (the
        # master has no exporter here, so the summary is empty).
        status = master.stub().get_job_status(pb.GetJobStatusRequest())
        assert frame == jax_dashboard.render({}, status) + "\n"
        assert "epoch 1/1" in frame
    finally:
        master.stop()
    # A master that is gone: exit 2, as the JAX client's (no readiness
    # probe, short retry backoffs).
    for var, value in (("ELASTICDL_RPC_READY_TIMEOUT", "0"),
                       ("ELASTICDL_RPC_BACKOFF_BASE", "0.01"),
                       ("ELASTICDL_RPC_BACKOFF_MAX", "0.02")):
        monkeypatch.setenv(var, value)
    rpc.reload_config()
    try:
        assert port_client.main(
            ["dash", "--master_addr", addr, "--once"]) == 2
    finally:
        monkeypatch.undo()
        rpc.reload_config()


_PREDICT_DEF = """\
import numpy as np

from tmpl import *  # noqa: F401,F403 (the zoo template)


class _Save:
    def __init__(self):
        self.rows = []

    def process(self, predictions, worker_id):
        self.rows.append(np.asarray(predictions))

    def close(self):
        np.save({out!r}, np.concatenate(self.rows))


prediction_outputs_processor = _Save()
"""


def test_edl_train_then_predict_round(tmp_path, quiet_master):
    """`edl train` exports the zoo template's weights, `edl predict` of
    them writes one prediction per record; both equal the JAX template's
    forward on the exported weights (and the port's in this process)."""
    train, _ = _records(tmp_path / "train.edlr", 64)
    predict, x = _records(tmp_path / "predict.edlr", 32, seed=1)
    _zoo_init(port_client, tmp_path)
    out = tmp_path / "preds.npy"
    (tmp_path / "tmpl_predict.py").write_text(
        _PREDICT_DEF.format(out=str(out)))
    os.environ["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{REPO}"
    export = str(tmp_path / "model.npz")
    path_before = list(sys.path)
    common = ["--model_zoo", str(tmp_path), "--num_workers", "1",
              "--distribution_strategy", "Local", "--master_port", "0",
              "--task_timeout_check_seconds", "0.2", "--minibatch_size",
              "16"]
    try:
        assert port_client.main([
            "train", "--model_def", "tmpl", "--training_data", train,
            "--num_epochs", "2", "--records_per_task", "32",
            "--output", export, *common]) == 0
        assert port_client.main([
            "predict", "--model_def", "tmpl_predict", "--prediction_data",
            predict, "--records_per_task", "16",
            "--checkpoint_dir_for_init", export, *common]) == 0
    finally:
        # The master in this process put the zoo on sys.path and imported
        # the port's template as `tmpl`.
        sys.path[:] = path_before
        for name in ("tmpl", "tmpl_predict"):
            sys.modules.pop(name, None)
    got = np.load(out).reshape(-1)
    assert got.shape == (32,)
    with np.load(export) as data:
        params = {k[len("params/"):]: data[k] for k in data.files
                  if k.startswith("params/")}
    # The JAX template (flax Dense 64 -> relu -> Dense 1) on the weights.
    jax_dir = tmp_path / "jax"
    _zoo_init(jax_client, jax_dir)
    sys.path.insert(0, str(jax_dir))
    try:
        model = jax_spec("tmpl").build_model()
    finally:
        sys.path.remove(str(jax_dir))
        sys.modules.pop("tmpl", None)
    tree = {}
    for name, value in params.items():
        layer, leaf = name.split("/")
        tree.setdefault(layer, {})[leaf] = value
    want = np.asarray(model.apply({"params": tree}, x)).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # Trained: the predictions follow the linear target.
    assert float(np.mean((got - x @ TRUE_W) ** 2)) < float(
        np.mean((x @ TRUE_W) ** 2))


@pytest.mark.parametrize("with_prediction_data", [False, True],
                         ids=["validation", "validation_and_prediction"])
def test_evaluation_only_job_reports_its_metrics(tmp_path, quiet_master,
                                                 monkeypatch,
                                                 with_prediction_data):
    """What `edl evaluate` runs: a master with validation data and no
    training data (prediction data too, in the second case: the job is
    still evaluation-only). The port opens the evaluation job over the
    evaluation tasks created at the start, so the metrics reach the
    metrics service (the JAX master opens none and drops them:
    "Evaluation metrics reported with no job open"). The accuracy equals
    the JAX package's metric on the worker's outputs."""
    from elasticdl_tpu.common.evaluation_utils import (
        accuracy_metric as jax_accuracy,
    )
    from elasticdl_tpu_torch.common.args import worker_parser
    from elasticdl_tpu_torch.master import metrics_service
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.models.iris import iris_dnn
    from elasticdl_tpu_torch.worker.main import build_worker
    from elasticdl_tpu_torch.worker.master_client import MasterClient

    data = iris_dnn.make_csv(str(tmp_path / "iris.csv"), n=48)
    obs = tmp_path / "obs"
    common = ["--model_def", "elasticdl_tpu_torch.models.iris.iris_dnn",
              "--validation_data", data, "--records_per_task", "16",
              "--minibatch_size", "8", "--distribution_strategy", "Local"]
    if with_prediction_data:
        common += ["--prediction_data", data]
    monkeypatch.setattr(metrics_service, "_make_summary_writer",
                        lambda path: None)
    master = Master(master_parser().parse_args(
        common + ["--instance_backend", "none", "--metrics_dir", str(obs)]))
    outputs = []
    try:
        worker = build_worker(
            worker_parser().parse_args(common + [
                "--worker_id", "0", "--master_addr", "in-process",
                "--job_type", "evaluation_only"]),
            MasterClient(master.stub(), 0), device="cpu")
        evaluate = worker.trainer.evaluate_minibatch
        worker.trainer.evaluate_minibatch = (
            lambda f, v=-1: outputs.append(evaluate(f, v)) or outputs[-1])
        worker.run()
        assert master.task_d.finished()
        results = master.evaluation_service.completed_results
    finally:
        master.stop()
    labels = np.loadtxt(data, delimiter=",")[:, 4]
    metric = jax_accuracy()
    metric.update(np.concatenate(outputs), labels)
    assert results == [(-1, {"accuracy": pytest.approx(
        float(metric.result()), abs=1e-7)})]
    evals = [json.loads(line) for line in open(obs / "metrics.jsonl")
             if '"eval"' in line]
    assert len(evals) == 1 and evals[0]["step"] == -1


def test_evaluation_only_job_after_a_master_relaunch(tmp_path, quiet_master,
                                                     monkeypatch):
    """A journaled evaluation-only master dies with one of its three
    evaluation tasks done and one in flight. Its successor replays the
    journal and opens the evaluation job over the two tasks it still
    holds, warning that the first task's metrics are lost: the in-flight
    task's owner reports it to the successor, a worker takes the last one,
    and the results (the JAX package's accuracy over those two tasks'
    outputs) are published once."""
    from elasticdl_tpu.common.evaluation_utils import (
        accuracy_metric as jax_accuracy,
    )
    from elasticdl_tpu_torch.master import master as master_module
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.models.iris import iris_dnn

    monkeypatch.setenv("ELASTICDL_MASTER_JOURNAL_DIR",
                       str(tmp_path / "journal"))
    data = iris_dnn.make_csv(str(tmp_path / "iris.csv"), n=48)
    labels = np.loadtxt(data, delimiter=",")[:, 4]
    args = master_parser().parse_args([
        "--model_def", "elasticdl_tpu_torch.models.iris.iris_dnn",
        "--validation_data", data, "--records_per_task", "16",
        "--distribution_strategy", "Local", "--instance_backend", "none"])
    rng = np.random.default_rng(0)

    def evaluate(master, task_id, task):
        outputs = rng.normal(size=(task.end - task.start, 3)).astype(
            np.float32)
        master.evaluation_service.report_evaluation_metrics(
            outputs, labels[task.start:task.end])
        master.task_d.report(task_id, True)
        return outputs

    first = Master(args)
    try:
        evaluate(first, *first.task_d.get(0))
        in_flight = first.task_d.get(1)
    finally:
        first.stop()

    warnings = []
    monkeypatch.setattr(master_module.logger, "warning",
                        lambda msg, *a, **k: warnings.append(msg % a))
    second = Master(args)
    try:
        assert second.master_incarnation == 2
        outputs = [evaluate(second, *in_flight)]
        outputs.append(evaluate(second, *second.task_d.get(0)))
        assert second.task_d.finished()
        assert second.task_d.get(0) == (-1, None)
        results = second.evaluation_service.completed_results
    finally:
        second.stop()
    assert any("2 of its 3 evaluation tasks left" in w for w in warnings)
    metric = jax_accuracy()
    metric.update(np.concatenate(outputs), np.concatenate(
        [labels[in_flight[1].start:in_flight[1].end], labels[32:48]]))
    assert results == [(-1, {"accuracy": pytest.approx(
        float(metric.result()), abs=1e-7)})]
