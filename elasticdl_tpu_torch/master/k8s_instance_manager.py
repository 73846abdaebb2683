"""Kubernetes-backed elastic instance manager (counterpart of
elasticdl_tpu/master/k8s_instance_manager.py: the same lifecycle, pod
names, incarnations and relaunch accounting).

Pods are created over the API and followed through the watch stream. A
worker or PS pod that is deleted, or fails with exit 137 that is not an
OOM kill (a preemption), is relaunched under a new incarnation name
(-r<N>) up to the relaunch cap; any other failure is final. A failed
worker's tasks go back to the dispatcher's queue. Pod transitions land on
the observability plane as `edl_pod_events_total` and the `pod_launch`,
`pod_exit`, `pod_relaunch` and `pod_failed` events. `membership` is None
outside AllReduce, as in the JAX master; the manager drops a worker from
it when one is given.
"""

import threading

from elasticdl_tpu_torch.common import k8s_client
from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.common.k8s_resource import (
    parse_resource_spec,
    parse_volume_spec,
    parse_worker_priority,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.master.instance_manager import DEFAULT_MAX_RELAUNCHES
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("master.k8s_instance_manager")

# The family the local-process manager registers; the registry returns the
# one shared metric for the name.
_POD_EVENTS = default_registry().counter(
    "edl_pod_events_total",
    "Instance lifecycle transitions seen by the master",
    labelnames=("kind", "event"),
)


class K8sInstanceManager:
    def __init__(
        self,
        namespace,
        job_name,
        image_name,
        command_for,
        num_workers=0,
        num_ps=0,
        task_dispatcher=None,
        membership=None,
        worker_resources=None,
        ps_resources=None,
        worker_priority=None,
        volumes=None,
        max_relaunches=DEFAULT_MAX_RELAUNCHES,
        envs=None,
        ps_service_port=50002,
    ):
        k8s_client.require_k8s()
        self._command_for = command_for
        self._num_workers = num_workers
        self._num_ps = num_ps
        self._task_d = task_dispatcher
        self._membership = membership
        # Spec strings parse here, so a bad spec fails the job at
        # submission, not at the first relaunch.
        self._worker_resources = parse_resource_spec(worker_resources)
        self._ps_resources = parse_resource_spec(ps_resources)
        self._worker_priority = parse_worker_priority(
            worker_priority, num_workers)
        self._volumes = parse_volume_spec(volumes)
        self._max_relaunches = max_relaunches
        self._envs = envs or {}
        self._ps_service_port = ps_service_port
        self._lock = threading.Lock()
        self._stopping = False
        self._statuses = {}  # (kind, id) -> PodStatus
        self._relaunches = {}  # (kind, id) -> count
        # (kind, id) -> current incarnation: a relaunch creates a NEW pod
        # name (-rN), so the dead predecessor's late events (its DELETED,
        # late MODIFIEDs) are told apart from the replacement's and
        # ignored.
        self._incarnations = {}
        self._client = k8s_client.Client(
            namespace, job_name, image_name, event_callback=self._event_cb)

    # ---------- lifecycle ----------

    def start_parameter_servers(self):
        for ps_id in range(self._num_ps):
            self._start("ps", ps_id)

    def start_workers(self):
        for worker_id in range(self._num_workers):
            self._start("worker", worker_id)

    def _start(self, kind, instance_id):
        resources = (
            self._ps_resources if kind == "ps" else self._worker_resources)
        # cpu and memory stay requests only (a limit would turn a
        # scheduling hint into a throttle or OOM boundary); extended device
        # resources (nvidia.com/gpu) must appear in limits, as the device
        # plugin API requires.
        device_limits = {k: v for k, v in (resources or {}).items()
                         if "/" in k}
        with self._lock:
            incarnation = self._incarnations.get((kind, instance_id), 0)
        self._client.create_pod(
            kind,
            instance_id,
            self._command_for(kind, instance_id),
            resource_requests=resources or None,
            resource_limits=device_limits or None,
            priority_class=(
                self._worker_priority.get(instance_id)
                if kind == "worker" else None),
            envs=self._envs,
            volumes=self._volumes,
            incarnation=incarnation,
        )
        if kind == "ps":
            # A stable service name, so a relaunched PS keeps its address
            # and the workers re-seed it.
            with self._lock:
                first = (kind, instance_id) not in self._statuses
            if first:
                try:
                    self._client.create_service(
                        f"{self._client.job_name}-ps-{instance_id}",
                        self._ps_service_port,
                        kind,
                        instance_id,
                    )
                except Exception:
                    logger.warning(
                        "PS service creation failed (may already exist)",
                        exc_info=True,
                    )
        with self._lock:
            self._statuses[(kind, instance_id)] = PodStatus.PENDING
        _POD_EVENTS.labels(kind=kind, event="launch").inc()
        emit_event("pod_launch", instance=f"{kind}-{instance_id}",
                   incarnation=incarnation)

    def create_tensorboard_service(self):
        """A LoadBalancer service `tensorboard-<job>` in front of the
        master pod; `edl tensorboard --metrics_dir <dir>` serves behind
        it."""
        self._client.create_tensorboard_service()

    def stop(self):
        with self._lock:
            self._stopping = True
            keys = {key: self._incarnations.get(key, 0)
                    for key in self._statuses}
        self._client.stop()
        for (kind, instance_id), incarnation in keys.items():
            # The current incarnation and any failed predecessors still
            # holding their names.
            for inc in range(incarnation + 1):
                try:
                    self._client.delete_pod(kind, instance_id, inc)
                except Exception:
                    pass

    # ---------- watch-event state machine ----------

    def _event_cb(self, event):
        with self._lock:
            if self._stopping:
                # Teardown deletes are ours; treating them as preemptions
                # would bring back the pods just removed.
                return
        pod = event["object"]
        labels = pod.metadata.labels or {}
        kind = labels.get(k8s_client.ELASTICDL_REPLICA_TYPE_KEY)
        if kind not in ("worker", "ps"):
            return
        instance_id = int(
            labels.get(k8s_client.ELASTICDL_REPLICA_INDEX_KEY, -1))
        with self._lock:
            incarnation = self._incarnations.get((kind, instance_id), 0)
        expected_name = self._client.pod_name(kind, instance_id, incarnation)
        pod_name = pod.metadata.name
        if pod_name is not None and pod_name != expected_name:
            # A dead predecessor's late event: not this replica's current
            # pod, so it does not drive the state machine.
            return
        phase = pod.status.phase
        deleted = event["type"] == "DELETED"
        with self._lock:
            prev = self._statuses.get((kind, instance_id))
        if phase == "Running" and prev != PodStatus.RUNNING:
            with self._lock:
                self._statuses[(kind, instance_id)] = PodStatus.RUNNING
            return
        if phase == "Succeeded":
            with self._lock:
                self._statuses[(kind, instance_id)] = PodStatus.SUCCEEDED
            _POD_EVENTS.labels(kind=kind, event="exit").inc()
            emit_event("pod_exit", instance=f"{kind}-{instance_id}",
                       exit_code=0)
            if kind == "worker" and self._membership is not None:
                self._membership.remove_worker(instance_id)
            return
        if deleted or phase == "Failed":
            relaunch = deleted or self._is_preempted(pod)
            self._on_failure(kind, instance_id, relaunch)

    @staticmethod
    def _is_preempted(pod):
        """Exit 137 that is NOT an OOM kill: a preemption or eviction, so
        the pod is relaunched."""
        for cs in pod.status.container_statuses or []:
            term = cs.state and cs.state.terminated
            if term and term.exit_code == 137 and term.reason != "OOMKilled":
                return True
        return False

    def _on_failure(self, kind, instance_id, relaunch):
        logger.warning("%s %d failed (relaunch=%s)", kind, instance_id,
                       relaunch)
        _POD_EVENTS.labels(kind=kind, event="exit").inc()
        emit_event("pod_exit", instance=f"{kind}-{instance_id}",
                   relaunchable=relaunch)
        if kind == "worker":
            if self._task_d is not None:
                self._task_d.recover_tasks(instance_id)
            if self._membership is not None:
                self._membership.remove_worker(instance_id)
        key = (kind, instance_id)
        with self._lock:
            count = self._relaunches.get(key, 0)
            can_relaunch = relaunch and count < self._max_relaunches
            if can_relaunch:
                self._relaunches[key] = count + 1
                # A new incarnation is a new pod name; the failed pod keeps
                # its name on the API server (creating it again is a 409).
                old_incarnation = self._incarnations.get(key, 0)
                self._incarnations[key] = old_incarnation + 1
            else:
                self._statuses[key] = PodStatus.FAILED
        if not can_relaunch:
            _POD_EVENTS.labels(kind=kind, event="failed").inc()
            emit_event("pod_failed", instance=f"{kind}-{instance_id}")
            return
        _POD_EVENTS.labels(kind=kind, event="relaunch").inc()
        emit_event("pod_relaunch", instance=f"{kind}-{instance_id}",
                   attempt=count + 1)
        # Reap the failed predecessor (it may be gone already when a
        # deletion was the trigger).
        try:
            self._client.delete_pod(kind, instance_id, old_incarnation)
        except Exception:
            pass
        # A PS keeps its id and service address; the workers re-seed it.
        self._start(kind, instance_id)

    # ---------- status ----------

    def total_relaunches(self):
        """Relaunches across all instances (the job-status RPC)."""
        with self._lock:
            return sum(self._relaunches.values())

    def _worker_statuses(self):
        with self._lock:
            return [s for (k, _), s in self._statuses.items()
                    if k == "worker"]

    def all_workers_failed(self):
        workers = self._worker_statuses()
        return bool(workers) and all(s == PodStatus.FAILED for s in workers)

    def all_workers_done(self):
        workers = self._worker_statuses()
        return bool(workers) and all(
            s in (PodStatus.SUCCEEDED, PodStatus.FAILED) for s in workers)
