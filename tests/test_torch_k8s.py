"""The port's k8s backend against the JAX package's: the spec parsers, the
pod manifests, the `--yaml` master manifest, the master's k8s wiring, and
the two K8sInstanceManagers driven over real HTTP against
tests/fake_k8s_server.py through the same scripted pod phases (a
preempted worker, an OOM kill, a succeeded worker, a pod deleted while the
watch stream was down). No subprocess and no cluster: the fake API server
plays kubelet through set_pod_phase."""

import json
import time

import pytest

from elasticdl_tpu.client import main as jax_client
from elasticdl_tpu.common import k8s_client as jax_k8s_client
from elasticdl_tpu.common import k8s_resource as jax_resource
from elasticdl_tpu.master.k8s_instance_manager import (
    K8sInstanceManager as JaxK8sInstanceManager,
)
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxTaskDispatcher,
)
from elasticdl_tpu_torch.client import main as port_client
from elasticdl_tpu_torch.common import k8s_client as port_k8s_client
from elasticdl_tpu_torch.common import k8s_resource as port_resource
from elasticdl_tpu_torch.common.k8s_rest import RestApi
from elasticdl_tpu_torch.master.k8s_instance_manager import (
    K8sInstanceManager as PortK8sInstanceManager,
)
from elasticdl_tpu_torch.master.task_dispatcher import (
    TaskDispatcher as PortTaskDispatcher,
)

from fake_k8s_server import FakeK8sApiServer

NS = "default"

# The spec strings of tests/test_k8s_backend.py and test_k8s_stub_e2e.py,
# good and bad.
PARSER_CASES = [
    ("resource", ("cpu=250m,memory=32Mi,gpu=1,tpu=4",)),
    ("resource", ("cpu=2.5,ephemeral-storage=1Gi",)),
    ("resource", ("amd.com/gpu=2",)),
    ("resource", ("",)),
    ("resource", ("disk=2Gi",)),
    ("resource", ("cpu=1,memory=1Gi",)),
    ("resource", ("memory=abc",)),
    ("resource", ("cpu=x",)),
    ("resource", ("gpu=1.5",)),
    ("resource", ("flux_capacitors=1",)),
    ("resource", ("cpu",)),
    ("volume", ("host_path=/data,mount_path=/data;"
                "claim_name=c1,mount_path=/m1,sub_path=s0",)),
    ("volume", ("host_path=/data",)),
    ("volume", ("mount_path=/only",)),
    ("volume", ("",)),
    ("priority", ("high=0.5", 4)),
    ("priority", ("critical", 2)),
    ("priority", ("", 2)),
    ("priority", ("high=abc", 2)),
    ("priority", ("low=0.3", 2)),
]
_PARSERS = {"resource": "parse_resource_spec", "volume": "parse_volume_spec",
            "priority": "parse_worker_priority"}


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # the error's type and text are the result
        return "error", type(e).__name__, str(e)


@pytest.mark.parametrize("parser,args", PARSER_CASES)
def test_spec_parsers_match_jax(parser, args):
    name = _PARSERS[parser]
    want = _outcome(getattr(jax_resource, name), *args)
    assert _outcome(getattr(port_resource, name), *args) == want


def test_group_volume_manifests_match_jax():
    vols = port_resource.parse_volume_spec(
        "host_path=/data,mount_path=/data;host_path=/data,mount_path=/d2;"
        "claim_name=c1,mount_path=/m1,sub_path=s0")
    assert (port_resource.group_volume_manifests(vols)
            == jax_resource.group_volume_manifests(vols))


@pytest.mark.parametrize("kwargs", [
    {},
    {"resource_requests": {"cpu": "1", "nvidia.com/gpu": "1"},
     "resource_limits": {"nvidia.com/gpu": "1"}, "priority_class": "high",
     "envs": {"ELASTICDL_JOB_NAME": "j", "ELASTICDL_OBS_DIR": "/obs"},
     "volumes": [{"kind": "pvc", "source": "c1", "mount_path": "/m1",
                  "sub_path": "s0"},
                 {"kind": "host_path", "source": "/d", "mount_path": "/d"}],
     "restart_policy": "OnFailure"},
])
def test_pod_manifest_matches_jax(kwargs):
    labels = {port_k8s_client.ELASTICDL_JOB_KEY: "j",
              port_k8s_client.ELASTICDL_REPLICA_TYPE_KEY: "worker",
              port_k8s_client.ELASTICDL_REPLICA_INDEX_KEY: "0"}
    command = ["python", "-m", "elasticdl_tpu_torch.worker.main"]
    got = port_k8s_client.build_pod_manifest(
        "elasticdl-j-worker-0", labels, "img", command, **kwargs)
    want = jax_k8s_client.build_pod_manifest(
        "elasticdl-j-worker-0", labels, "img", command, **kwargs)
    assert got == want


def test_yaml_master_manifest_matches_jax(tmp_path):
    argv = ["--model_def", "test_module", "--training_data",
            str(tmp_path / "d.edlr"), "--num_workers", "2",
            "--instance_backend", "k8s", "--image_name", "example/image:1",
            "--job_name", "yamljob", "--volume",
            "host_path=/data,mount_path=/data;claim_name=c,mount_path=/c"]
    paths = {}
    for name, client in (("jax", jax_client), ("port", port_client)):
        paths[name] = tmp_path / f"{name}.json"
        assert client.main(
            ["train", *argv, "--yaml", str(paths[name])]) == 0
    want = paths["jax"].read_text().replace(
        "elasticdl_tpu.master.main", "elasticdl_tpu_torch.master.main")
    got = json.loads(paths["port"].read_text())
    assert got == json.loads(want)
    assert got["spec"]["containers"][0]["command"][:3] == [
        "python", "-m", "elasticdl_tpu_torch.master.main"]


@pytest.fixture(scope="module")
def shared_server():
    server = FakeK8sApiServer()
    yield server
    server.stop()


@pytest.fixture
def api_server(shared_server, monkeypatch):
    """The module's fake API server; each test keeps to namespaces and
    job names of its own."""
    monkeypatch.setenv("EDL_K8S_API_SERVER", shared_server.endpoint)
    return shared_server


def test_edl_train_submits_the_master_pod(api_server, tmp_path):
    rc = port_client.main([
        "train", "--model_def", "test_module", "--training_data",
        str(tmp_path / "d.edlr"), "--num_workers", "1",
        "--instance_backend", "k8s", "--image_name", "img",
        "--job_name", "submitjob"])
    assert rc == 0
    pod = api_server.pods()["elasticdl-submitjob-master"]
    assert pod["spec"]["serviceAccountName"] == "elasticdl-master"
    assert pod["spec"]["containers"][0]["command"][:3] == [
        "python", "-m", "elasticdl_tpu_torch.master.main"]


def _wait_for(predicate, what, timeout=10.0):
    end = time.time() + timeout
    while time.time() < end:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _failed(exit_code, reason):
    return [{"state": {"terminated": {"exitCode": exit_code,
                                      "reason": reason}}}]


def _drive(server, ns, manager_cls, dispatcher_cls, scenario):
    """Runs one scripted pod scenario against a manager of one package in
    namespace `ns`; returns what the scenario leaves: pod names on the
    server, relaunch counts, the tasks recovered and the manager's
    verdicts."""
    task_d = dispatcher_cls({"f": (0, 40)}, records_per_task=10,
                            shuffle=False)
    mgr = manager_cls(ns, "stubjob", "img",
                      lambda kind, i: ["python", "-m", "x", kind, str(i)],
                      num_workers=2, num_ps=1, task_dispatcher=task_d,
                      max_relaunches=1)
    try:
        mgr.start_parameter_servers()
        mgr.start_workers()
        for name in list(server.pods(ns)):
            server.set_pod_phase(ns, name, "Running")
        # The manager's watch is live once it has seen the pods run.
        _wait_for(lambda: all(
            mgr._statuses.get(key) == "Running"
            for key in (("ps", 0), ("worker", 0), ("worker", 1))),
            "the pods running")
        w0, w1 = (f"elasticdl-stubjob-worker-{i}" for i in (0, 1))
        task_d.get(0)
        task_d.get(0)
        if scenario == "preempted":
            server.set_pod_phase(ns, w0, "Failed",
                                 _failed(137, "Preempted"))
            _wait_for(lambda: mgr.total_relaunches() == 1, "the relaunch")
            # The manager deletes the failed pod; the DELETED event of
            # that predecessor must not relaunch it again.
            _wait_for(lambda: f"{w0}-r1" in server.pods(ns)
                      and w0 not in server.pods(ns), "the -r1 pod")
        elif scenario == "oom":
            server.set_pod_phase(ns, w0, "Failed",
                                 _failed(137, "OOMKilled"))
            _wait_for(lambda: task_d.stats()["doing"] == 0, "recovery")
            server.set_pod_phase(ns, w1, "Failed", _failed(1, "Error"))
            _wait_for(mgr.all_workers_failed, "both workers failed")
        elif scenario == "succeeded":
            server.set_pod_phase(ns, w1, "Succeeded")
            server.set_pod_phase(ns, w0, "Succeeded")
            _wait_for(mgr.all_workers_done, "both workers done")
        elif scenario == "watch_reset":
            # A blind window: the open streams stop getting events, the
            # pod is deleted, then the streams end (reset_streams in two
            # steps, so that the deletion falls between them); the
            # reconnect's re-list synthesizes the DELETED.
            with server._lock:
                blind, server._watchers = server._watchers, []
            RestApi(server.endpoint).delete_pod(ns, w0)
            for _, _, q in blind:
                q.put(None)
            _wait_for(lambda: f"{w0}-r1" in server.pods(ns),
                      "the -r1 pod")
        time.sleep(0.1)  # late events, if any, land now
        stats = task_d.stats()
        return {
            "pods": sorted(server.pods(ns)),
            "services": sorted(server.services(ns)),
            "relaunches": dict(mgr._relaunches),
            "incarnations": dict(mgr._incarnations),
            "total_relaunches": mgr.total_relaunches(),
            "todo": stats["todo"], "doing": stats["doing"],
            "failed": mgr.all_workers_failed(),
            "done": mgr.all_workers_done(),
        }
    finally:
        mgr.stop()


@pytest.mark.parametrize(
    "scenario", ["preempted", "oom", "succeeded", "watch_reset"])
def test_instance_manager_over_http_matches_jax(api_server, scenario):
    outcomes = {}
    for name, manager_cls, dispatcher_cls in (
            ("jax", JaxK8sInstanceManager, JaxTaskDispatcher),
            ("port", PortK8sInstanceManager, PortTaskDispatcher)):
        outcomes[name] = _drive(api_server, name, manager_cls,
                                dispatcher_cls, scenario)
    assert outcomes["port"] == outcomes["jax"]
    relaunched = scenario in ("preempted", "watch_reset")
    assert outcomes["port"]["total_relaunches"] == int(relaunched)
    # Worker 0's two tasks went back to the queue whenever it failed.
    assert outcomes["port"]["doing"] == (0 if scenario != "succeeded"
                                         else 2)


def test_master_k8s_wiring(api_server, tmp_path, monkeypatch):
    """The port's Master under --instance_backend k8s: the PS address is
    the service name on port 50002 (the PS pod's command serves there),
    the pods get the JAX master's forwarded environment but no compile
    cache directory and no log format (the port logs in one format), and with the metrics service on serve() creates the
    TensorBoard LoadBalancer service."""
    from elasticdl_tpu_torch.common.args import master_parser
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
    from elasticdl_tpu_torch.master import metrics_service
    from elasticdl_tpu_torch.master.master import Master

    monkeypatch.setattr(metrics_service, "_make_summary_writer",
                        lambda path: None)
    for var, value in (("ELASTICDL_METRICS_PORT", "-1"),
                       ("ELASTICDL_HEARTBEAT_SECONDS", "0"),
                       ("ELASTICDL_AGGREGATOR_INTERVAL", "3600"),
                       ("ELASTICDL_LOG_LEVEL", "INFO"),
                       ("ELASTICDL_LOG_FORMAT", "json"),
                       ("ELASTICDL_COMPILE_CACHE_DIR", str(tmp_path))):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("ELASTICDL_MASTER_JOURNAL_DIR", raising=False)
    data = str(tmp_path / "d.edlr")
    with RecordFileWriter(data) as w:
        w.write(encode_example({"x": [1.0]}))
    obs = tmp_path / "obs"
    monkeypatch.setenv("ELASTICDL_OBS_DIR", str(obs))
    args = master_parser().parse_args([
        "--model_def", "elasticdl_tpu_torch.models.iris.iris_dnn",
        "--training_data", data, "--num_workers", "1", "--num_ps", "1",
        "--distribution_strategy", "ParameterServerStrategy",
        "--instance_backend", "k8s", "--image_name", "img",
        "--job_name", "wirejob", "--master_port", "0",
        "--metrics_dir", str(obs), "--worker_resources", "cpu=1,gpu=1"])
    master = Master(args)
    try:
        master.serve()
        assert master.ps_addrs() == "wirejob-ps-0:50002"
        pods = api_server.pods()
        ps_cmd = pods["elasticdl-wirejob-ps-0"]["spec"]["containers"][0][
            "command"]
        assert ps_cmd[ps_cmd.index("--port") + 1] == "50002"
        worker = pods["elasticdl-wirejob-worker-0"]["spec"]["containers"][0]
        cmd = worker["command"]
        assert cmd[1:3] == ["-m", "elasticdl_tpu_torch.worker.main"]
        assert cmd[cmd.index("--ps_addrs") + 1] == "wirejob-ps-0:50002"
        assert worker["resources"] == {
            "requests": {"cpu": "1", "nvidia.com/gpu": "1"},
            "limits": {"nvidia.com/gpu": "1"}}
        env = {e["name"]: e.get("value") for e in worker["env"]}
        assert env == {"ELASTICDL_JOB_NAME": "wirejob",
                       "ELASTICDL_OBS_DIR": str(obs),
                       "ELASTICDL_LOG_LEVEL": "INFO", "MY_POD_IP": None}
        services = {name: svc for name, svc in api_server.services().items()
                    if "wirejob" in name}
        assert sorted(services) == ["tensorboard-wirejob", "wirejob-ps-0"]
        assert services["tensorboard-wirejob"]["spec"]["type"] == (
            "LoadBalancer")
        assert services["wirejob-ps-0"]["spec"]["ports"] == [
            {"port": 50002}]
    finally:
        master.stop()
