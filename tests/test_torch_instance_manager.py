"""The port's LocalProcessInstanceManager (elasticdl_tpu_torch/master/
instance_manager.py) against the JAX package's: both run the same short
`python -c` children (exit 0, exit 1, SIGKILL) and must make the same
decisions — per-instance exit handling and statuses, relaunch counts, the
dispatcher's recover_tasks calls, all_workers_failed/done and
edl_pod_events_total — also under the policy actuators (restart_worker,
scale_workers). Then the master's process wiring: `_command_for` gives the
JAX master's argv with the port's entry points, and the watchdog recovers
a silent worker's tasks."""

import sys
import time

import pytest

from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.master import instance_manager as jax_im
from elasticdl_tpu.master.master import Master as JaxMaster
from elasticdl_tpu.observability.metrics import (
    default_registry as jax_registry,
)
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.master import instance_manager as im
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.observability.metrics import default_registry

WAIT_S = 30
EVENTS = ("launch", "exit", "relaunch", "failed", "restart", "scale_up",
          "scale_down")


class _Dispatcher:
    def __init__(self):
        self.recovered = []

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)


def _exits(tmp_path):
    """command_for: worker 0 exits 0, worker 1 always exits 1, worker 2 is
    SIGKILLed once and then exits 0, ps 0 exits 0."""

    def command_for(kind, instance_id):
        if kind == "worker" and instance_id == 1:
            code = "raise SystemExit(1)"
        elif kind == "worker" and instance_id == 2:
            marker = tmp_path / f"{command_for.side}-killed-once"
            code = (f"import os, pathlib; p = pathlib.Path({str(marker)!r})\n"
                    "if not p.exists():\n"
                    "    p.touch(); os.kill(os.getpid(), 9)\n")
        else:
            code = "pass"
        return [sys.executable, "-c", code]

    return command_for


def _sleepers(kind, instance_id):
    return [sys.executable, "-c", "import time; time.sleep(60)"]


def _pod_events(registry):
    counter = registry.get("edl_pod_events_total")
    out = {}
    for kind in ("worker", "ps"):
        for event in EVENTS:
            out[(kind, event)] = (
                counter.labels(kind=kind, event=event).value
                if counter is not None else 0.0)
    return out


def _run(module, registry, command_for, drive):
    """Runs one manager through `drive(manager)`; returns what it decided."""
    dispatcher = _Dispatcher()
    manager = module.LocalProcessInstanceManager(
        command_for, num_workers=3, num_ps=1, task_dispatcher=dispatcher,
        max_relaunches=2, poll_seconds=0.02)
    trail = {}
    on_exit = manager._on_exit

    def record(inst, code):
        if manager._stop.is_set():  # stop()'s own terminations
            return on_exit(inst, code)
        on_exit(inst, code)
        trail.setdefault(f"{inst.kind}-{inst.id}", []).append(
            (code, inst.status, inst.relaunch_count))

    manager._on_exit = record
    before = _pod_events(registry)
    try:
        drive(manager)
    finally:
        manager.stop()
    after = _pod_events(registry)
    return {
        "trail": trail,
        "statuses": manager.worker_statuses(),
        "relaunches": manager.total_relaunches(),
        "recovered": sorted(dispatcher.recovered),
        "failed": manager.all_workers_failed(),
        "done": manager.all_workers_done(),
        "worker_count": manager.worker_count(),
        "pod_events": {k: after[k] - before[k] for k in after},
    }


def _until(predicate):
    end = time.time() + WAIT_S
    while time.time() < end:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out")


def _exit_policy(manager):
    manager.start_parameter_servers()
    manager.start_workers()
    _until(manager.all_workers_done)


def _actuators(manager):
    manager.start_parameter_servers()
    manager.start_workers()
    _until(lambda: manager.worker_count() == 3)
    old_pid = manager._instances[("worker", 1)].popen.pid
    assert manager.restart_worker(1, reason="straggler")
    _until(lambda: manager._instances[("worker", 1)].popen.pid != old_pid)
    assert manager.scale_workers(1, reason="behind") == [3]
    assert manager.scale_workers(-2, reason="ahead") == [3, 2]
    _until(lambda: manager.worker_statuses()[2] == PodStatus.SUCCEEDED
           and manager.worker_statuses()[3] == PodStatus.SUCCEEDED)


@pytest.mark.parametrize("drive", [_exit_policy, _actuators],
                         ids=["exit_policy", "actuators"])
def test_decisions_equal_the_jax_manager(tmp_path, drive):
    command_for = _exits(tmp_path) if drive is _exit_policy else _sleepers
    results = {}
    for side, module, registry in (("port", im, default_registry()),
                                   ("jax", jax_im, jax_registry())):
        command_for.side = side
        results[side] = _run(module, registry, command_for, drive)
    assert results["port"] == results["jax"]
    if drive is _exit_policy:
        port = results["port"]
        assert port["statuses"] == {0: PodStatus.SUCCEEDED,
                                    1: PodStatus.FAILED,
                                    2: PodStatus.SUCCEEDED}
        assert port["relaunches"] == 3 and port["recovered"] == [1, 1, 1, 2]
        assert port["pod_events"][("worker", "failed")] == 1


def _parse(parser_module, argv, kind):
    parser = (parser_module.master_parser() if kind == "master"
              else parser_module.worker_parser())
    return parser.parse_args(argv)


@pytest.mark.parametrize("strategy", ["Local", "ParameterServerStrategy"])
def test_command_for_is_the_jax_masters_with_the_ports_entry_points(
        strategy):
    argv = ["--model_def", "pkg.model", "--distribution_strategy", strategy,
            "--training_data", "/d/train.edlr",
            "--validation_data", "/d/valid.edlr",
            "--records_per_task", "16", "--minibatch_size", "4",
            "--num_workers", "2", "--num_ps", "2", "--master_port", "0",
            "--checkpoint_dir", "/ckpt", "--checkpoint_steps", "5",
            "--output", "/out", "--job_name", "cmd", "--use_async",
            "--sync_window_timeout", "0"]
    ours = Master.__new__(Master)
    ours.args = _parse(edl_args, argv, "master")
    theirs = JaxMaster.__new__(JaxMaster)
    theirs.args = _parse(jax_args, argv, "master")
    ours.port = theirs.port = 41234
    for kind, instance_id in (("worker", 0), ("worker", 1), ("ps", 0),
                              ("ps", 1)):
        want = [a.replace("elasticdl_tpu.", "elasticdl_tpu_torch.")
                for a in theirs._command_for(kind, instance_id)]
        assert ours._command_for(kind, instance_id) == want
    assert ours.ps_addrs() == theirs.ps_addrs() == (
        "127.0.0.1:41235,127.0.0.1:41236")
    # The worker's argv parses with the port's worker parser.
    worker = ours._command_for("worker", 1)
    parsed = _parse(edl_args, worker[3:], "worker")
    assert parsed.worker_id == 1 and parsed.master_addr == "127.0.0.1:41234"
    assert parsed.job_type == "training_with_evaluation"


def test_watchdog_recovers_a_silent_workers_tasks(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.data.recordfile import write_records
    from elasticdl_tpu_torch.proto import messages as pb

    monkeypatch.setenv("ELASTICDL_METRICS_PORT", "-1")
    monkeypatch.setenv("ELASTICDL_HEARTBEAT_SECONDS", "0")
    monkeypatch.setenv("ELASTICDL_OBS_DIR", "")
    train = str(tmp_path / "train.edlr")
    write_records(train, [b"x"] * 32)
    args = _parse(edl_args, [
        "--model_def", "elasticdl_tpu_torch.models.dac_ctr.deepfm_ps",
        "--distribution_strategy", "Local", "--training_data", train,
        "--records_per_task", "8", "--instance_backend", "none",
        "--worker_liveness_timeout_seconds", "0.2"], "master")
    master = Master(args)
    try:
        stub = master.stub()
        task = stub.get_task(pb.GetTaskRequest(worker_id=5))
        assert task.task_id >= 0
        assert master.task_d.stats()["doing"] == 1
        master._run_watchdog()  # within the timeout: nothing happens
        assert master.task_d.stats()["doing"] == 1
        time.sleep(0.3)
        master._run_watchdog()
        stats = master.task_d.stats()
        assert stats["doing"] == 0 and stats["todo"] == 4
        assert 5 not in master.servicer.snapshot_liveness()
    finally:
        master.stop()
