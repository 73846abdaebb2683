"""A job across processes on the CPU: `elasticdl_tpu_torch.master.main` in
a process group of its own with `--instance_backend local_process`, its
workers and PS shards spawned by the port's LocalProcessInstanceManager,
everything talking over the port's socket transport (common/rpc.py).

- Local, two workers on a tiny LM: after the first reported task worker 0
  is stopped (SIGSTOP) and worker 1 SIGKILLed and relaunched by the
  manager, so the tasks left wait for the relaunched worker; once it has
  done half the records worker 0 is continued and the master process
  alone SIGKILLed, and `master.main` relaunched with
  `--instance_backend none` over the same journal and port. The orphaned
  workers ride out the outage and finish the job.
- ParameterServerStrategy, two shards and one worker on DeepFM-PS: shard 0
  is SIGKILLed mid-job and relaunched on the same port.

Each case checks records_done exactly (the master's final train record in
metrics.jsonl), the lifecycle events, that no process of the job is left,
and that the processes' telemetry pushes (every 0.5 s here) reached the
master: from each worker's exit line, and from the master's own tally.
Every child runs with ELASTICDL_TORCH_DEVICE=cpu and one thread; a chaos
latency on the workers' get_task (ELASTICDL_CHAOS) stretches the job so
the kills land mid-job. A `tensorboard` package that fails to import is
put first on the children's path: importing the real one pulls in
TensorFlow, and the metrics service then writes JSONL only."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from elasticdl_tpu_torch.chaos import process as chaos_process
from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.gen.criteo import iter_criteo_records
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.proto import messages as pb

from test_torch_trainer import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Hard limit for any one wait on a process of the job.
STEP_TIMEOUT = 60
LM_RECORDS = 128
LM_TASK = 8
PS_TRAIN = 512
PS_VALID = 64
PS_TASK = 64

_TINY_DEF = """\
from elasticdl_tpu_torch.models.transformer import transformer_lm as _lm
from elasticdl_tpu_torch.models.transformer.transformer_lm import (  # noqa
    eval_metrics_fn, feed, loss, optimizer,
)


def custom_model():
    return _lm.custom_model(_lm.LMConfig(**{tiny!r}))
"""


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    """The test's own status polls: short backoffs and breaker cooldown."""
    monkeypatch.setenv("ELASTICDL_RPC_BACKOFF_BASE", "0.05")
    monkeypatch.setenv("ELASTICDL_RPC_BACKOFF_MAX", "0.2")
    monkeypatch.setenv("ELASTICDL_RPC_BREAKER_COOLDOWN", "0.5")
    rpc.reload_config()
    yield
    monkeypatch.undo()
    rpc.reload_config()


def _env(tmp_path, **extra):
    stubs = tmp_path / "stubs" / "tensorboard"
    stubs.mkdir(parents=True, exist_ok=True)
    (stubs / "__init__.py").write_text(
        'raise ImportError("TensorBoard is not used by these tests")\n')
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": f"{tmp_path / 'stubs'}{os.pathsep}{REPO}",
        "ELASTICDL_TORCH_DEVICE": "cpu",
        "OMP_NUM_THREADS": "1",
        "ELASTICDL_HEARTBEAT_SECONDS": "0",
        "ELASTICDL_FLIGHTREC": "0",
        "ELASTICDL_METRICS_PORT": "-1",
        "ELASTICDL_RPC_BACKOFF_BASE": "0.05",
        "ELASTICDL_RPC_BACKOFF_MAX": "0.2",
        "ELASTICDL_RPC_BREAKER_COOLDOWN": "0.5",
        "ELASTICDL_RPC_READY_TIMEOUT": "20",
        "ELASTICDL_MASTER_PATIENCE_SECONDS": "60",
        "ELASTICDL_TELEMETRY_PUSH_INTERVAL": "0.5",
        "ELASTICDL_CHAOS": json.dumps({"seed": 0, "rules": [{
            "method": "get_task", "kind": "latency", "latency_s": 0.25,
            "side": "client", "role": "worker-*"}]}),
    })
    env.update(extra)
    return env


def _spawn(argv, env, log_path):
    with open(log_path, "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.master.main", *argv],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            process_group=0)


def _wait(predicate, what, proc=None, timeout=STEP_TIMEOUT):
    end = time.time() + timeout
    while time.time() < end:
        value = predicate()
        if value:
            return value
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"master exited ({proc.returncode}) "
                                 f"while waiting for {what}")
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _bound_port(log_path, proc):
    def port():
        text = log_path.read_text(errors="replace")
        found = re.search(r"Master serving on port (\d+)", text)
        return int(found.group(1)) if found else None

    return _wait(port, "the master's port", proc)


class _Status:
    def __init__(self, port):
        self._stub = rpc.Stub(
            rpc.build_channel(f"127.0.0.1:{port}", ready_timeout=0),
            rpc.MASTER_SERVICE)

    def __call__(self):
        try:
            return self._stub.get_job_status(pb.GetJobStatusRequest(),
                                             timeout=5)
        except rpc.RpcError:
            return None


def _records(path, records):
    with RecordFileWriter(str(path)) as writer:
        for record in records:
            writer.write(record)
    return str(path)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _exits(text, role):
    """{"<role>-<id>": exit record} of the processes that logged one."""
    return {f"{role.lower()}-{rid}": json.loads(body) for rid, body in
            re.findall(rf"{role} (\d+) exiting: (\{{.*\}})", text)}


def _teardown(procs, port):
    for proc in procs:
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=10)
    if port is not None:
        for pid, _ in chaos_process.find_job_pids(port):
            chaos_process.deliver(pid, signal.SIGKILL)


def test_local_job_survives_a_worker_kill_and_a_master_kill(tmp_path):
    tokens = synthetic_lm_tokens(LM_RECORDS, TINY["max_len"],
                                 vocab=TINY["vocab"], branching=4, seed=0)
    train = _records(tmp_path / "train.edlr",
                     [encode_example({"tokens": t}) for t in tokens])
    model_def = tmp_path / "tiny_lm_def.py"
    model_def.write_text(_TINY_DEF.format(tiny=TINY))
    obs = tmp_path / "metrics"
    env = _env(tmp_path,
               ELASTICDL_MASTER_JOURNAL_DIR=str(tmp_path / "journal"))
    argv = ["--model_def", str(model_def), "--distribution_strategy",
            "Local", "--training_data", train, "--records_per_task",
            str(LM_TASK), "--num_epochs", "1", "--minibatch_size", "4",
            "--metrics_dir", str(obs), "--job_name", "proc-lm",
            "--task_timeout_check_seconds", "1", "--seed", "0"]
    first = _spawn(argv + ["--instance_backend", "local_process",
                           "--num_workers", "2", "--master_port", "0"],
                   env, tmp_path / "master1.log")
    second = port = None
    try:
        port = _bound_port(tmp_path / "master1.log", first)
        status = _Status(port)
        _wait(lambda: (status() or pb.JobStatusResponse()).records_done
              >= LM_TASK, "the first reported task", first)
        stopped = chaos_process.find_role_pid("worker", 0, port,
                                              timeout=STEP_TIMEOUT)
        chaos_process.deliver(stopped, signal.SIGSTOP)
        worker_kill = time.time()
        chaos_process.kill_role("worker", 1, port, timeout=STEP_TIMEOUT)
        _wait(lambda: (status() or pb.JobStatusResponse()).relaunches >= 1,
              "worker 1's relaunch", first)
        _wait(lambda: (status() or pb.JobStatusResponse()).records_done
              >= LM_RECORDS // 2, "half the records", first)
        # Continued before the master dies: a group whose parent dies is
        # orphaned, and one holding a stopped process then gets SIGHUP.
        chaos_process.deliver(stopped, signal.SIGCONT)
        master_kill = time.time()
        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=10)
        workers = chaos_process.find_job_pids(port)
        assert len(workers) == 2, workers  # the orphans ride it out
        second = _spawn(argv + ["--instance_backend", "none",
                                "--master_port", str(port)],
                        env, tmp_path / "master2.log")
        assert second.wait(timeout=STEP_TIMEOUT) == 0, (
            tmp_path / "master2.log").read_text()[-3000:]
        _wait(lambda: not chaos_process.find_job_pids(port),
              "the workers' exit")
    finally:
        _teardown((first, second), port)
    trains = [m for m in _lines(obs / "metrics.jsonl")
              if m["group"] == "train"]
    assert trains[-1]["records_done"] == LM_RECORDS
    events = _lines(obs / "events.jsonl")
    relaunched = [e for e in events if e.get("kind") == "pod_relaunch"]
    assert [e["instance"] for e in relaunched] == ["worker-1"], relaunched
    recovered = [e for e in events if e.get("kind") == "master_recovered"]
    assert len(recovered) == 1 and recovered[0]["incarnation"] == 2
    # The relaunched worker 1 took work from the first master: with worker
    # 0 stopped, it reported the tasks done between the two kills.
    reports = [
        s for s in _lines(obs / "trace_worker-1.jsonl")
        if s.get("ph") == "X" and s["name"].endswith("/report_task_result")
        and s.get("args", {}).get("code") == "OK"
        and worker_kill < s["ts"] / 1e6
        and (s["ts"] + s["dur"]) / 1e6 < master_kill]
    assert reports
    exits = _exits((tmp_path / "master1.log").read_text(errors="replace"),
                   "Worker")
    assert sorted(exits) == ["worker-0", "worker-1"], exits
    assert all(e["steps"] > 0 and e["telemetry"]["accepted"] >= 1
               for e in exits.values()), exits


def test_ps_job_survives_a_shard_kill(tmp_path):
    train = _records(tmp_path / "train.edlr",
                     iter_criteo_records(PS_TRAIN, seed=0))
    valid = _records(tmp_path / "valid.edlr",
                     iter_criteo_records(PS_VALID, seed=1))
    obs = tmp_path / "metrics"
    argv = ["--model_def", "elasticdl_tpu_torch.models.dac_ctr.deepfm_ps",
            "--distribution_strategy", "ParameterServerStrategy",
            "--num_ps", "2", "--num_workers", "1",
            "--instance_backend", "local_process", "--master_port", "0",
            "--training_data", train, "--validation_data", valid,
            "--records_per_task", str(PS_TASK), "--minibatch_size",
            str(PS_TASK), "--evaluation_steps", "4", "--num_epochs", "1",
            "--metrics_dir", str(obs), "--job_name", "proc-ps",
            "--task_timeout_check_seconds", "1", "--seed", "0"]
    master = _spawn(argv, _env(tmp_path), tmp_path / "master.log")
    port = None
    try:
        port = _bound_port(tmp_path / "master.log", master)
        status = _Status(port)
        _wait(lambda: (status() or pb.JobStatusResponse()).records_done
              >= 2 * PS_TASK, "two reported tasks", master)
        chaos_process.kill_role("ps", 0, port, timeout=STEP_TIMEOUT)
        assert master.wait(timeout=STEP_TIMEOUT) == 0, (
            tmp_path / "master.log").read_text()[-3000:]
        _wait(lambda: not chaos_process.find_job_pids(port),
              "the job's processes' exit")
    finally:
        _teardown((master,), port)
    metrics = _lines(obs / "metrics.jsonl")
    trains = [m for m in metrics if m["group"] == "train"]
    assert trains[-1]["records_done"] == PS_TRAIN
    evals = [m for m in metrics if m["group"] == "eval"]
    # Every evaluation the master completed (its evaluation service logs
    # each) is in metrics.jsonl.
    completed = re.findall(r"Evaluation @ version",
                           (tmp_path / "master.log").read_text())
    assert evals and len(evals) == len(completed), (evals, completed)
    assert all({"auc", "accuracy"} <= set(m) for m in evals), evals
    events = _lines(obs / "events.jsonl")
    relaunched = [e for e in events if e.get("kind") == "pod_relaunch"]
    assert [e["instance"] for e in relaunched] == ["ps-0"], relaunched
    # The master's aggregator took pushed snapshots from every process.
    tally = json.loads(re.findall(
        r"Telemetry pushes accepted: (\{.*\})",
        (tmp_path / "master.log").read_text(errors="replace"))[-1])
    assert sorted(tally) == ["ps-0", "ps-1", "worker-0"], tally
    assert all(t["snapshots"] >= 1 and t["payload_bytes"] > 0
               for t in tally.values()), tally


def test_a_worker_without_a_card_exits_with_the_device_error(tmp_path):
    """ELASTICDL_TORCH_DEVICE unset means the CUDA device: on a host without
    one the worker process ends non-zero with the device rule's error (the
    instance manager counts that as a failure), never on the CPU. The
    child sees no card (CUDA_VISIBLE_DEVICES empty), also on a host that
    has one."""
    model_def = tmp_path / "tiny_lm_def.py"
    model_def.write_text(_TINY_DEF.format(tiny=TINY))
    env = _env(tmp_path, ELASTICDL_RPC_READY_TIMEOUT="0",
               CUDA_VISIBLE_DEVICES="")
    env.pop("ELASTICDL_TORCH_DEVICE")
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
         "--worker_id", "0", "--master_addr", "127.0.0.1:1",
         "--model_def", str(model_def), "--distribution_strategy", "Local",
         "--training_data", str(tmp_path / "none.edlr")],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=STEP_TIMEOUT)
    assert proc.returncode != 0
    assert "runs on a CUDA device by default" in proc.stderr, (
        proc.stderr[-2000:])
