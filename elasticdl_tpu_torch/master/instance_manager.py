"""Elastic instance management: start, watch and relaunch worker and PS
processes (counterpart of elasticdl_tpu/master/instance_manager.py).

LocalProcessInstanceManager: instances are OS subprocesses on this host.
The exit-code policy mirrors the pod policy of the reference's k8s
instance manager: clean exit = done; non-zero (a SIGKILL included) =
failure -> task recovery + relaunch up to the cap. The policy engine's
actuators (`restart_worker`, `scale_workers`) and the status queries of the
master's poll loop are the JAX manager's. Children get the master's
environment plus their ELASTICDL_ROLE stamp; ELASTICDL_TORCH_DEVICE rides
along in it. The pods of the k8s backend: master/k8s_instance_manager.py.
"""

import os
import subprocess
import sys
import threading
import time

from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("master.instance_manager")

DEFAULT_MAX_RELAUNCHES = 3

_POD_EVENTS = default_registry().counter(
    "edl_pod_events_total",
    "Instance lifecycle transitions seen by the master",
    labelnames=("kind", "event"),
)


class _Instance:
    def __init__(self, kind, instance_id, popen):
        self.kind = kind  # "worker" | "ps"
        self.id = instance_id
        self.popen = popen
        self.status = PodStatus.RUNNING
        self.relaunch_count = 0
        # Policy-driven deliberate kill: the next exit relaunches without
        # charging the max_relaunches failure budget.
        self.forgive_next_exit = False
        # Policy-driven scale-down: the next exit is a clean retirement
        # (tasks recover, membership drops, no relaunch).
        self.retired = False


class LocalProcessInstanceManager:
    """Spawns worker/PS processes, watches them, relaunches failures.

    command_for(kind, instance_id) -> argv list; the master wires in the
    command builders so this class knows nothing about flags.
    """

    def __init__(
        self,
        command_for,
        num_workers=0,
        num_ps=0,
        task_dispatcher=None,
        membership=None,
        max_relaunches=DEFAULT_MAX_RELAUNCHES,
        poll_seconds=1.0,
        restart_workers=True,
    ):
        self._command_for = command_for
        self._num_workers = num_workers
        self._num_ps = num_ps
        self._task_d = task_dispatcher
        self._membership = membership
        self._max_relaunches = max_relaunches
        self._poll_seconds = poll_seconds
        self._restart_workers = restart_workers
        self._lock = threading.Lock()
        self._instances = {}  # (kind, id) -> _Instance
        self._stop = threading.Event()
        self._monitor = None

    # ---------- lifecycle ----------

    def start_parameter_servers(self):
        for ps_id in range(self._num_ps):
            self._launch("ps", ps_id)

    def start_workers(self):
        for worker_id in range(self._num_workers):
            self._launch("worker", worker_id)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True
        )
        self._monitor.start()

    def _launch(self, kind, instance_id):
        argv = self._command_for(kind, instance_id)
        # Children get the master's environment (log level/format,
        # observability dir/job, chaos schedule, ELASTICDL_TORCH_DEVICE all
        # ride along) plus a per-instance ELASTICDL_ROLE stamp, so every
        # process of one chaos run logs with a correlatable identity.
        env = dict(os.environ)
        env["ELASTICDL_ROLE"] = f"{kind}-{instance_id}"
        popen = subprocess.Popen(
            argv, stdout=sys.stdout, stderr=sys.stderr, env=env
        )
        with self._lock:
            prev = self._instances.get((kind, instance_id))
            inst = _Instance(kind, instance_id, popen)
            if prev is not None:
                inst.relaunch_count = prev.relaunch_count
            self._instances[(kind, instance_id)] = inst
        _POD_EVENTS.labels(kind=kind, event="launch").inc()
        emit_event(
            "pod_launch", instance=f"{kind}-{instance_id}", pid=popen.pid
        )
        logger.info("Launched %s %d (pid %d)", kind, instance_id, popen.pid)

    def stop(self):
        self._stop.set()
        with self._lock:
            instances = list(self._instances.values())
        for inst in instances:
            if inst.popen.poll() is None:
                inst.popen.terminate()
        deadline = time.time() + 10
        for inst in instances:
            try:
                inst.popen.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                inst.popen.kill()

    # ---------- watch / relaunch (the elastic engine) ----------

    def _monitor_loop(self):
        while not self._stop.is_set():
            with self._lock:
                instances = list(self._instances.values())
            for inst in instances:
                code = inst.popen.poll()
                if code is None or inst.status in (
                    PodStatus.SUCCEEDED,
                    PodStatus.FAILED,
                ):
                    continue
                self._on_exit(inst, code)
            self._stop.wait(self._poll_seconds)

    def _on_exit(self, inst, code):
        if self._stop.is_set():
            # Teardown in progress: exits are stop()'s own SIGTERMs, not
            # failures — relaunching here would leak processes.
            return
        _POD_EVENTS.labels(kind=inst.kind, event="exit").inc()
        emit_event(
            "pod_exit",
            instance=f"{inst.kind}-{inst.id}",
            exit_code=code,
        )
        if inst.retired:
            # Deliberate scale-down: the exit is the retirement completing,
            # whatever the exit code. Tasks recover, membership drops, and
            # the instance counts as done — never as a failure.
            inst.status = PodStatus.SUCCEEDED
            logger.info("%s %d retired (scale-down)", inst.kind, inst.id)
            if inst.kind == "worker":
                if self._task_d is not None:
                    self._task_d.recover_tasks(inst.id)
                if self._membership is not None:
                    self._membership.remove_worker(inst.id)
            return
        if code == 0:
            inst.status = PodStatus.SUCCEEDED
            logger.info("%s %d finished", inst.kind, inst.id)
            if inst.kind == "worker" and self._membership is not None:
                self._membership.remove_worker(inst.id)
            return
        logger.warning(
            "%s %d exited with code %d", inst.kind, inst.id, code
        )
        if inst.kind == "worker":
            # Recover its in-flight tasks FIRST so they re-dispatch
            # (reference k8s_instance_manager.py:320-325), then drop it
            # from the comm group so survivors re-mesh.
            if self._task_d is not None:
                self._task_d.recover_tasks(inst.id)
            if self._membership is not None:
                self._membership.remove_worker(inst.id)
        forgiven = inst.forgive_next_exit
        inst.forgive_next_exit = False
        relaunch = (
            forgiven or inst.relaunch_count < self._max_relaunches
        ) and (inst.kind == "ps" or self._restart_workers)
        if relaunch:
            if not forgiven:
                inst.relaunch_count += 1
            logger.info(
                "Relaunching %s %d (attempt %d)",
                inst.kind,
                inst.id,
                inst.relaunch_count,
            )
            _POD_EVENTS.labels(kind=inst.kind, event="relaunch").inc()
            emit_event(
                "pod_relaunch",
                instance=f"{inst.kind}-{inst.id}",
                attempt=inst.relaunch_count,
            )
            self._launch(inst.kind, inst.id)
            with self._lock:
                self._instances[(inst.kind, inst.id)].relaunch_count = (
                    inst.relaunch_count
                )
        else:
            inst.status = PodStatus.FAILED
            _POD_EVENTS.labels(kind=inst.kind, event="failed").inc()
            emit_event(
                "pod_failed",
                instance=f"{inst.kind}-{inst.id}",
                exit_code=code,
            )

    # ---------- policy actuators ----------

    def restart_worker(self, worker_id, reason=""):
        """Deliberate kill+relaunch of one worker (straggler mitigation).
        The monitor loop performs the relaunch on its next poll; the exit
        is forgiven, so mitigation never consumes the max_relaunches
        failure budget. Returns False when the worker isn't running."""
        with self._lock:
            inst = self._instances.get(("worker", worker_id))
            if (
                inst is None
                or inst.retired
                or inst.popen.poll() is not None
            ):
                return False
            inst.forgive_next_exit = True
        _POD_EVENTS.labels(kind="worker", event="restart").inc()
        emit_event(
            "pod_restart",
            instance=f"worker-{worker_id}",
            reason=reason[:200],
        )
        logger.info("Restarting worker %d (%s)", worker_id, reason)
        inst.popen.terminate()
        return True

    def scale_workers(self, delta, reason=""):
        """Policy-driven ±k worker scaling. Positive delta launches new
        worker ids past the current highest; negative retires the
        highest-id running workers (tasks recover, membership drops, no
        relaunch). Returns the affected worker ids."""
        if delta == 0:
            return []
        affected = []
        if delta > 0:
            with self._lock:
                worker_ids = [
                    i.id
                    for i in self._instances.values()
                    if i.kind == "worker"
                ]
                next_id = (max(worker_ids) + 1) if worker_ids else 0
                self._num_workers = max(
                    self._num_workers, next_id + delta
                )
            for wid in range(next_id, next_id + delta):
                self._launch("worker", wid)
                affected.append(wid)
        else:
            with self._lock:
                victims = sorted(
                    (
                        i
                        for i in self._instances.values()
                        if i.kind == "worker"
                        and not i.retired
                        and i.status == PodStatus.RUNNING
                    ),
                    key=lambda i: -i.id,
                )[:-delta]
                for inst in victims:
                    inst.retired = True
                self._num_workers = max(
                    0, self._num_workers - len(victims)
                )
            for inst in victims:
                affected.append(inst.id)
                if inst.popen.poll() is None:
                    inst.popen.terminate()
        if affected:
            event = "scale_up" if delta > 0 else "scale_down"
            _POD_EVENTS.labels(kind="worker", event=event).inc(
                len(affected)
            )
            emit_event(
                "pod_scale",
                delta=delta,
                workers=affected,
                reason=reason[:200],
            )
            logger.info(
                "Scaled workers %+d (%s): %s", delta, reason, affected
            )
        return affected

    def worker_count(self):
        """Workers currently part of the job (running or pending relaunch;
        retired and terminally failed ones excluded)."""
        with self._lock:
            return sum(
                1
                for i in self._instances.values()
                if i.kind == "worker"
                and not i.retired
                and i.status != PodStatus.FAILED
            )

    # ---------- status ----------

    def all_workers_failed(self):
        with self._lock:
            workers = [
                i for i in self._instances.values() if i.kind == "worker"
            ]
        return bool(workers) and all(
            w.status == PodStatus.FAILED for w in workers
        )

    def all_workers_done(self):
        with self._lock:
            workers = [
                i for i in self._instances.values() if i.kind == "worker"
            ]
        return bool(workers) and all(
            w.status in (PodStatus.SUCCEEDED, PodStatus.FAILED)
            for w in workers
        )

    def worker_statuses(self):
        with self._lock:
            return {
                i.id: i.status
                for i in self._instances.values()
                if i.kind == "worker"
            }

    def total_relaunches(self):
        """Cumulative relaunches across all instances (job-status RPC)."""
        with self._lock:
            return sum(
                i.relaunch_count for i in self._instances.values()
            )
