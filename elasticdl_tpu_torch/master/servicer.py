"""The master service (counterpart of elasticdl_tpu/master/servicer.py).

Serves the worker-facing task protocol: task pulls (with WAIT when the
queue is momentarily empty but the job is unfinished), batched pulls, task
results, evaluation metric reports, model version reports (the evaluation
trigger), pushed telemetry and the job status, with the job context the
master binds once it is prepared (bind_job_context: the instance manager's
relaunches, the aggregator's stragglers and alerts, the policy's actions,
the world-hint board, the metrics port, the incarnation of a master
replayed from its journal) and the liveness grace of a recovery
(seed_liveness). Under AllReduce it also serves the membership (comm
ranks with the join gate, liveness registration), and under --multi_host
the step leases; the world hint is answered from the board. Method names
match rpc.MASTER_SERVICE; each takes (request, context) as a gRPC handler
does. On-demand profiling (start_profile) is not ported yet.
"""

import threading
import time

from elasticdl_tpu_torch.chaos import injection
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("master.servicer")


class MasterServicer:
    def __init__(
        self,
        task_dispatcher,
        evaluation_service=None,
        membership=None,
        worker_liveness_timeout=60.0,
        step_lease_manager=None,
    ):
        self._task_d = task_dispatcher
        self._evaluation_service = evaluation_service
        self._membership = membership
        self._step_leases = step_lease_manager
        # Same threshold the master watchdog uses, so alive_workers in the
        # job status can't contradict actual liveness decisions.
        self._worker_liveness_timeout = worker_liveness_timeout
        self._lock = threading.Lock()
        # worker_id -> last-RPC wall time, for the liveness watchdog.
        self.worker_liveness = {}
        self.max_model_version = 0
        # Bound after construction (master.prepare): the instance manager,
        # the metrics endpoint, the aggregator and the policy engine exist
        # only then.
        self._instance_manager = None
        self._metrics_port = 0
        self._aggregator = None
        self._policy = None
        self._world_hints = None
        # Monotonic master incarnation (journal-recovered masters bump it)
        # stamped into JobStatusResponse so clients and workers can tell a
        # restart from a stall. 1 = first (or journal-less) life.
        self.master_incarnation = 1

    def bind_job_context(
        self,
        instance_manager=None,
        metrics_port=0,
        aggregator=None,
        policy=None,
        world_hints=None,
        master_incarnation=None,
    ):
        """Late-bind job-status sources created after this servicer."""
        self._instance_manager = instance_manager
        self._metrics_port = metrics_port
        self._aggregator = aggregator
        self._policy = policy
        self._world_hints = world_hints
        if master_incarnation is not None:
            self.master_incarnation = master_incarnation

    def _touch(self, worker_id):
        with self._lock:
            self.worker_liveness[worker_id] = time.time()

    def snapshot_liveness(self):
        """Copy of the liveness table (a watchdog iterates it while
        handlers insert)."""
        with self._lock:
            return dict(self.worker_liveness)

    def forget_worker(self, worker_id):
        with self._lock:
            self.worker_liveness.pop(worker_id, None)

    def seed_liveness(self, worker_ids):
        """Grant recovery-time grace to workers that held journaled leases:
        a reappearing owner's next call refreshes this stamp and keeps its
        re-issued lease; one that never reappears ages out and the normal
        watchdog sweeps its tasks back to the queue."""
        now = time.time()
        with self._lock:
            for wid in worker_ids:
                self.worker_liveness.setdefault(wid, now)

    # ---------- rpc methods (names match rpc.MASTER_SERVICE) ----------

    def get_task(self, request, context):
        self._touch(request.worker_id)
        # Deterministic crash seam for the master-kill drill: a chaos
        # "kill" rule on this point SIGKILLs the master at the Nth
        # dispatch, BEFORE any lease is issued for this call.
        injection.inject_local("master.dispatch")
        if request.task_type == pb.EVALUATION:
            task_id, task = self._task_d.get_eval_task(request.worker_id)
        else:
            task_id, task = self._task_d.get(request.worker_id)
        if task is None:
            # Queue momentarily empty: tell the worker to WAIT unless the
            # whole job is done (then task_id stays -1 with default type).
            res = pb.Task(task_id=-1)
            if not self._task_d.finished():
                res.type = pb.WAIT
            return res
        # The dispatch is the root of the task's trace: an instant event
        # here plus the task_id in every downstream span (the worker
        # re-keys its context to this id) ties the chain together.
        tracing.instant(
            "dispatch_task", task_id=task_id, worker=request.worker_id
        )
        return self._stamp_lease(task.to_proto(task_id))

    def _stamp_lease(self, task_pb):
        """Stamp the dispatcher's lease token into an outgoing Task so the
        worker can echo it with the result (exactly-once reporting across
        master restarts)."""
        task_pb.lease_token = self._task_d.lease_token(task_pb.task_id)
        return task_pb

    def get_task_batch(self, request, context):
        """Lease batching: up to max_tasks tasks in one call. An empty
        batch with finished=False is the WAIT analog."""
        self._touch(request.worker_id)
        injection.inject_local("master.dispatch")
        leased = self._task_d.get_batch(
            request.worker_id, max(1, request.max_tasks)
        )
        res = pb.TaskBatch()
        for task_id, task in leased:
            res.tasks.append(self._stamp_lease(task.to_proto(task_id)))
            tracing.instant(
                "dispatch_task", task_id=task_id, worker=request.worker_id
            )
        if not leased:
            res.finished = self._task_d.finished()
        return res

    def report_task_result(self, request, context):
        success = not request.err_message
        self._task_d.report(
            request.task_id, success, request.err_message,
            lease_token=request.lease_token,
        )
        return pb.Empty()

    def report_task_results(self, request, context):
        """Batched analog of report_task_result."""
        for entry in request.results:
            self._task_d.report(
                entry.task_id, not entry.err_message, entry.err_message,
                lease_token=entry.lease_token,
            )
        return pb.Empty()

    def get_world_hint(self, request, context):
        """The announced next worker world (policy scale events); workers
        poll it between steps."""
        self._touch(request.worker_id)
        if self._world_hints is None:
            return pb.WorldHintResponse()
        hint = self._world_hints.current()
        return pb.WorldHintResponse(
            hint_seq=hint["hint_seq"],
            target_world_size=hint["target_world_size"],
            reason=hint["reason"],
            age_seconds=hint["age_seconds"],
        )

    def report_evaluation_metrics(self, request, context):
        self._touch(request.worker_id)
        if self._evaluation_service is not None and request.model_outputs:
            decoded = [
                tensor_utils.tensor_pb_to_ndarray(t)
                for t in request.model_outputs
            ]
            # Single-output models report one tensor; multi-output models
            # report a list and their metrics receive the list.
            outputs = decoded[0] if len(decoded) == 1 else decoded
            labels = tensor_utils.tensor_pb_to_ndarray(request.labels)
            self._evaluation_service.report_evaluation_metrics(
                outputs, labels
            )
        return pb.Empty()

    def report_version(self, request, context):
        with self._lock:
            self.max_model_version = max(
                self.max_model_version, request.model_version
            )
        if self._evaluation_service is not None:
            self._evaluation_service.add_evaluation_task_if_needed(
                request.model_version
            )
        return pb.Empty()

    def get_comm_rank(self, request, context):
        if self._membership is None:
            return pb.GetCommRankResponse(rank_id=-1)
        (
            rank,
            world,
            group_id,
            coordinator,
            coordinator_port,
        ) = self._membership.get_comm_rank(request.worker_host)
        world_ready = False
        if request.ready_epoch_plus_one > 0:
            world_ready = self._membership.arrive(
                request.worker_host, request.ready_epoch_plus_one - 1
            )
        return pb.GetCommRankResponse(
            rank_id=rank,
            world_size=world,
            rendezvous_id=group_id,
            coordinator_addr=coordinator,
            rendezvous_port=coordinator_port,
            world_ready=world_ready,
        )

    def lease_steps(self, request, context):
        self._touch(request.worker_id)
        if self._step_leases is None:
            raise ValueError(
                "step leases are only served for the multi-host AllReduce "
                "strategy"
            )
        return self._step_leases.lease_steps(
            request.worker_id, request.worker_host, request.batch_size
        )

    def report_lease(self, request, context):
        self._touch(request.worker_id)
        if self._step_leases is not None:
            self._step_leases.report_lease(
                request.lease_id,
                request.rank,
                request.success,
                request.err_message,
            )
        return pb.Empty()

    def report_worker_liveness(self, request, context):
        self._touch(request.worker_id)
        if self._membership is not None and request.host:
            self._membership.register(request.worker_id, request.host)
        return pb.Empty()

    def report_telemetry(self, request, context):
        """Push-based telemetry: merge a batch of (delta-encoded) metric
        snapshots into the aggregator. Roles the aggregator cannot extend
        (sequence gap) come back in need_full, telling the reporter to
        resend a full snapshot. Without a bound aggregator every snapshot
        lands on need_full."""
        if self._aggregator is None:
            return pb.ReportTelemetryResponse(
                accepted=0,
                need_full=sorted(
                    {s.role for s in request.snapshots if s.role}
                ),
            )
        accepted, need_full = self._aggregator.ingest_push(
            request.snapshots, origin=request.origin
        )
        return pb.ReportTelemetryResponse(
            accepted=accepted, need_full=need_full
        )

    def get_job_status(self, request, context):
        """Telemetry for monitors. Workers with a call inside the liveness
        timeout count as alive."""
        stats = self._task_d.stats()
        now = time.time()
        with self._lock:
            alive = sum(
                1
                for ts in self.worker_liveness.values()
                if now - ts < self._worker_liveness_timeout
            )
            last_seen_ago = {
                wid: now - ts
                for wid, ts in self.worker_liveness.items()
            }
            version = self.max_model_version
        res = pb.JobStatusResponse(
            todo_tasks=stats["todo"],
            doing_tasks=stats["doing"],
            epoch=stats["epoch"],
            num_epochs=stats["num_epochs"],
            model_version=version,
            alive_workers=alive,
            finished=self._task_d.finished(),
            job_failed=stats["job_failed"],
            records_done=stats["records_done"],
            tasks_recovered=stats.get("tasks_recovered", 0),
            tasks_abandoned=stats.get("tasks_abandoned", 0),
            metrics_port=self._metrics_port,
            master_incarnation=self.master_incarnation,
        )
        if self._instance_manager is not None:
            res.relaunches = self._instance_manager.total_relaunches()
        if self._membership is not None:
            res.membership_epoch = self._membership.group_id
        if self._aggregator is not None:
            # Straggler flags + alert count from the telemetry
            # aggregator, so monitors see anomalies without scraping.
            res.stragglers.extend(self._aggregator.stragglers())
            res.alerts_fired = self._aggregator.alerts_fired()
        # Policy plane: applied actions, active blacklists, backup races.
        res.policy_blacklisted.extend(
            f"worker-{wid}" for wid in stats.get("blacklisted", [])
        )
        res.backup_tasks_inflight = stats.get("backups_inflight", 0)
        res.backup_wins = stats.get("backup_wins", 0)
        if self._policy is not None:
            res.policy_actions = self._policy.actions_total()
        for wid, age in last_seen_ago.items():
            res.worker_last_seen_ago[wid] = age
        for wid, n in stats["doing_by_worker"].items():
            res.worker_doing_tasks[wid] = n
        if (
            self._evaluation_service is not None
            and self._evaluation_service.completed_results
        ):
            eval_version, metrics = (
                self._evaluation_service.completed_results[-1]
            )
            res.last_eval_version = eval_version
            for name, value in metrics.items():
                res.last_eval_metrics[name] = float(value)
        return res
