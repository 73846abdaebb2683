"""The master: control plane of one elastic training job (counterpart of
elasticdl_tpu/master/master.py). From master args, the observability plane
(observability.setup as role "master"), the model spec, the dataset shards,
the task dispatcher, the metrics service (`--metrics_dir`), the evaluation
service and the servicer; the resume from a PS checkpoint
(`--checkpoint_dir_for_init`: records the checkpoint already trained on are
not dispatched again).

Under AllreduceStrategy the master keeps the membership of the workers'
comm group (master/membership.py: epochs, ranks, the rotated rendezvous
port from --coordinator_port, the join gate), and under --multi_host it
leases training work to the whole world at once (master/step_lease.py).
The instance managers and the watchdog drop a dead or silent worker from
the membership, so the survivors regroup.

The survivable control plane: with ELASTICDL_MASTER_JOURNAL_DIR set, the
master replays the journal's snapshot and write-ahead log
(master/journal.py) before it serves, restores the dispatcher's state,
in-flight leases and membership epoch, bumps its incarnation and mirrors
every mutation from then on. A master built over the journal of a dead one
is its successor.

The constructor brings the master to serving, as the JAX master's
__init__ and prepare() do before it binds its port: the heartbeat, the
telemetry aggregator (with an obs dir), the world-hint board, the policy
engine (ELASTICDL_POLICY), the job context of the servicer, the snapshot on
start, and after a replay the liveness grace of the leases' owners with the
`master_recovered` and `lease_reissued` events. `prepare()` starts the
threads (heartbeat, aggregator poll, policy loop); `stop()` takes it all
down again, the observability plane the master set up included.

Two ways to run a job:
- across processes (master/main.py): `serve()` binds the master's port
  LAST, so the first call a client lands already sees the recovered
  world, then `--instance_backend local_process` starts `--num_ps` PS
  processes (ps/main.py) and `--num_workers` worker processes
  (worker/main.py) with the argv of `_command_for`, and `run()` polls
  until the job is done or failed, with the task-timeout and liveness
  watchdog (journal compaction rides its tick). A master relaunched with
  `--instance_backend none` over the journal and port of a dead one
  serves the workers that outlived it. The master then exports
  ELASTICDL_OBS_DIR and ELASTICDL_JOB_NAME for its children, as the JAX
  master does.
- in one process: a worker reaches the master through `stub()` and the
  shards through `ps_stubs()`, in-process stubs that cross the wire format
  on every call; under ParameterServerStrategy the master builds the
  `--num_ps` shards itself, with the arguments the JAX master hands its PS
  processes, and `relaunch_ps(i)` replaces shard i with a fresh one behind
  the same stubs. The master leaves the process environment alone.

With `--instance_backend k8s` the instance manager
(master/k8s_instance_manager.py) creates the worker and PS pods over the
Kubernetes API, with the environment the JAX master forwards to them:
ELASTICDL_OBS_DIR, the job name and ELASTICDL_LOG_LEVEL (not
ELASTICDL_COMPILE_CACHE_DIR, as the port has no compile cache, nor
ELASTICDL_LOG_FORMAT, as the port has no JSON log format). Each PS is reached through its service
`<job>-ps-<i>:50002`, and with the metrics service on, `serve()` also
creates the TensorBoard LoadBalancer service in front of the master pod.
"""

import json
import os
import sys
import time

from elasticdl_tpu_torch import observability
from elasticdl_tpu_torch.common import knobs, rpc
from elasticdl_tpu_torch.common.args import build_arguments_from_parsed_result
from elasticdl_tpu_torch.common.constants import DistributionStrategy
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.instance_manager import (
    LocalProcessInstanceManager,
)
from elasticdl_tpu_torch.master.journal import open_master_journal
from elasticdl_tpu_torch.master.membership import MembershipManager
from elasticdl_tpu_torch.master.metrics_service import MetricsService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.step_lease import (
    StepLeaseManager,
    is_lease_owner,
)
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.ps import checkpoint as ps_checkpoint
from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
from elasticdl_tpu_torch.worker.master_client import MasterClient

logger = get_logger("master.master")

# Flag subsets relayed into spawned processes (the JAX master's) — each
# must stay within what the receiving parser (worker_parser / ps_parser)
# accepts.
_WORKER_RELAY_ARGS = [
    "job_name",
    "model_zoo",
    "model_def",
    "distribution_strategy",
    "minibatch_size",
    "get_model_steps",
    "ps_wire_dtype",
    "log_loss_steps",
    "seed",
    "model_parallel_size",
    "pipeline_stages",
    "pipeline_schedule",
    "pipeline_microbatches",
    "pipeline_virtual_stages",
    "context_parallel_size",
    "context_parallel_impl",
    "multi_host",
    "zero1",
    "quantized_grads",
    "training_data",
    "validation_data",
    "prediction_data",
    "records_per_task",
    "num_epochs",
    "prefetch_records",
    "profile_dir",
    "profile_start_step",
    "profile_steps",
]
_PS_RELAY_ARGS = [
    "job_name",
    "model_zoo",
    "model_def",
    "seed",
]
# The port each PS serves on in its pod, behind its service (k8s).
PS_SERVICE_PORT = 50002


def _reject_unported(args):
    if args.distribution_strategy not in (
            DistributionStrategy.LOCAL,
            DistributionStrategy.PARAMETER_SERVER,
            DistributionStrategy.ALLREDUCE):
        raise ValueError(
            f"unknown --distribution_strategy {args.distribution_strategy}"
        )


class Master:
    def __init__(self, args):
        _reject_unported(args)
        self.args = args
        # The observability plane comes up FIRST so task creation and
        # every later lifecycle transition land in the event log and the
        # registry.
        self.obs, self._owns_obs = _master_plane(args)
        if args.model_zoo:
            sys.path.insert(0, args.model_zoo)
        self.spec = get_model_spec(args.model_def)

        # --- data shards -> task dispatcher ---
        reader_factory = self.spec.create_data_reader or create_data_reader
        training_shards = (
            reader_factory(args.training_data).create_shards()
            if args.training_data
            else {}
        )
        evaluation_shards = (
            reader_factory(args.validation_data).create_shards()
            if args.validation_data
            else {}
        )
        prediction_shards = (
            reader_factory(args.prediction_data).create_shards()
            if args.prediction_data
            else {}
        )
        self.task_d = TaskDispatcher(
            training_shards,
            evaluation_shards,
            prediction_shards,
            records_per_task=args.records_per_task,
            num_epochs=args.num_epochs,
            shuffle=args.shuffle_shards,
            seed=args.seed,
        )

        if args.checkpoint_dir_for_init and training_shards:
            self._resume_from_ps_checkpoint(args)

        self.metrics_service = (
            MetricsService(args.metrics_dir) if args.metrics_dir else None)
        self.evaluation_service = None
        if evaluation_shards:
            self.evaluation_service = EvaluationService(
                self.task_d,
                self.spec.build_metrics
                if self.spec.eval_metrics_fn
                else dict,
                eval_steps=args.evaluation_steps,
                on_results=(
                    self.metrics_service.on_evaluation_results
                    if self.metrics_service
                    else None
                ),
            )
        if args.output and training_shards:
            # Arm the final export task (a train-end callback task).
            self.task_d.enable_train_end_task()
        created = self.task_d.pending_tasks(pb.EVALUATION)
        self.membership = (
            MembershipManager(coordinator_port=args.coordinator_port)
            if args.distribution_strategy == DistributionStrategy.ALLREDUCE
            else None
        )
        self._open_journal()
        if self.evaluation_service is not None and not training_shards:
            self._open_evaluation_only_job(created)
        self.step_leases = (
            StepLeaseManager(self.task_d, self.membership)
            if self.membership is not None and args.multi_host
            else None
        )
        self.servicer = MasterServicer(
            self.task_d,
            self.evaluation_service,
            self.membership,
            worker_liveness_timeout=args.worker_liveness_timeout_seconds,
            step_lease_manager=self.step_leases,
        )
        self._server = None
        self.port = None
        self.instance_manager = self._build_instance_manager(args)
        self._build_job_context()
        if self.journal is not None:
            # Snapshot-on-start, once every state provider is attached:
            # fold the replayed (or fresh) state, the initial tasks
            # included, into snapshot.json and truncate the WAL, so replay
            # time is bounded by post-start activity only.
            self.journal.compact()
        if self._recovered_state is not None:
            self._reissue_leases()

        self.ps_servers = []
        if args.distribution_strategy == DistributionStrategy.PARAMETER_SERVER:
            if args.num_ps < 1:
                raise ValueError(
                    "ParameterServerStrategy requires --num_ps >= 1")
            if self.instance_manager is None:
                self.ps_servers = [
                    self._build_ps(i) for i in range(args.num_ps)]

    def _open_evaluation_only_job(self, created):
        """An evaluation-only job (`edl evaluate`) creates its evaluation
        tasks at the start, for the model the workers restore (version -1);
        the evaluation job opens over those the dispatcher still holds
        after a journal replay. The metric state is not journaled, so after
        a relaunch the results cover the tasks evaluated since."""
        left = self.task_d.pending_tasks(pb.EVALUATION)
        if left < created:
            logger.warning(
                "Evaluation-only job resumed with %d of its %d evaluation "
                "tasks left: the metrics of the %d done before the relaunch "
                "are lost, the results cover the %d left",
                left, created, created - left, left)
        if left:
            self.evaluation_service.open_job(-1, left)

    def _open_journal(self):
        """Replay snapshot+WAL (ELASTICDL_MASTER_JOURNAL_DIR), restore the
        dispatcher's state, bump the incarnation, and mirror every mutation
        from here on. All init-time dispatcher setup (task creation,
        checkpoint fast-forward, train-end arming) happens BEFORE the
        attach, so the WAL only ever holds post-start ops (the constructor
        snapshots the merged state)."""
        self.journal = open_master_journal()
        self.master_incarnation = 1
        self._recovered_state = None
        self._recovered_leases = []
        if self.journal is None:
            return
        state = self.journal.load()
        # Every journaled master records its incarnation at startup, so a
        # nonzero replayed incarnation means a previous life.
        if state["incarnation"] > 0:
            self._recovered_state = state
            self.master_incarnation = state["incarnation"] + 1
            self.task_d.restore_state(state)
            self._recovered_leases = self.task_d.inflight_leases()
            if self.membership is not None:
                self.membership.restore_state(state)
            logger.warning(
                "Master journal replayed: incarnation %d, records_done=%d, "
                "%d in-flight leases restored, hint_seq=%d",
                self.master_incarnation, state["records_done"],
                len(self._recovered_leases), state["hint_seq"],
            )
        self.task_d.attach_journal(self.journal)
        self.journal.add_state_provider(self.task_d.export_state)
        if self.membership is not None:
            self.membership.attach_journal(self.journal)
            self.journal.add_state_provider(self.membership.export_state)
        self.journal.add_state_provider(
            lambda: {"incarnation": self.master_incarnation})
        self.journal.record({
            "op": "incarnation", "value": self.master_incarnation,
        })

    def _build_job_context(self):
        """What the JAX master's prepare() builds before it binds its
        port, short of starting threads: the heartbeat, the telemetry
        aggregator (with an obs dir), the world-hint board, the policy
        engine (ELASTICDL_POLICY), their journaled state, and the
        servicer's job context."""
        from elasticdl_tpu_torch.common.heartbeat import HeartbeatWriter
        from elasticdl_tpu_torch.master.policy import (
            PolicyEngine,
            WorldHintBoard,
            policy_enabled,
        )

        self._heartbeat = HeartbeatWriter(job=self.args.job_name)
        self.aggregator = None
        self.policy = None
        exporter = self.obs.exporter if self.obs is not None else None
        if self.obs is not None and self.obs.obs_dir:
            # Job-level telemetry: scrape every advertised per-role
            # endpoint (in one process, the master's own registry, read in
            # process), derive throughput/straggler/imbalance signals,
            # re-export them as edl_job_* gauges + /api/summary, and run
            # the alert rules.
            from elasticdl_tpu_torch.observability.aggregator import (
                TelemetryAggregator,
            )

            self.aggregator = TelemetryAggregator(
                self.obs.obs_dir, job=self.args.job_name)
            if exporter is not None:
                exporter.summary_provider = self.aggregator.summary
        recovered = self._recovered_state
        self.world_hints = WorldHintBoard()
        if self.journal is not None:
            # hint_seq survives the restart: a board resuming from 0 would
            # make trainers silently ignore every post-restart hint.
            if recovered is not None:
                self.world_hints.restore_state(recovered)
            self.world_hints.attach_journal(self.journal)
            self.journal.add_state_provider(self.world_hints.export_state)
        if policy_enabled() and self.aggregator is not None:
            # The closed loop: aggregator signals -> rules -> actuators
            # (the dispatcher's blacklist and backup tasks; the instance
            # manager's restarts and scaling when workers are processes).
            self.policy = PolicyEngine(
                self.aggregator.summary, self.task_d,
                instance_manager=self.instance_manager,
                world_hints=self.world_hints)
            if self.journal is not None:
                # Resume without re-firing already-applied decisions:
                # restored cooldowns keep them suppressed.
                if recovered is not None:
                    self.policy.restore_state(recovered)
                self.policy.attach_journal(self.journal)
                self.journal.add_state_provider(self.policy.export_state)
            if exporter is not None:
                exporter.summary_provider = self._summary
        self.servicer.bind_job_context(
            instance_manager=self.instance_manager,
            metrics_port=self.obs.metrics_port if self.obs else 0,
            aggregator=self.aggregator,
            policy=self.policy,
            world_hints=self.world_hints,
            master_incarnation=self.master_incarnation,
        )

    def _reissue_leases(self):
        """Re-lease trail: owners that reappear within the liveness window
        keep their restored leases (seed_liveness grants the grace)."""
        state = self._recovered_state
        owners = sorted({wid for _, wid, _ in self._recovered_leases})
        self.servicer.seed_liveness(owners)
        observability.emit_event(
            "master_recovered",
            incarnation=self.master_incarnation,
            records_done=state["records_done"],
            leases=len(self._recovered_leases),
            hint_seq=state["hint_seq"],
            membership_epoch=state["membership_epoch"],
        )
        for tid, wid, task in self._recovered_leases:
            observability.emit_event(
                "lease_reissued", task_id=tid, worker=wid,
                shard=task.shard_name, start=task.start, end=task.end,
            )

    def _build_instance_manager(self, args):
        if args.instance_backend == "none" or (
                args.num_workers == 0 and args.num_ps == 0):
            return None
        if args.instance_backend == "k8s":
            return self._build_k8s_instance_manager(args)
        # Spawned workers and PS processes find the obs dir and the job
        # identity through the environment; a fixed metrics port is the
        # master's alone (local children bind ephemeral ports).
        if self.obs is not None and self.obs.obs_dir:
            os.environ[observability.OBS_DIR_ENV] = self.obs.obs_dir
        os.environ[observability.JOB_NAME_ENV] = args.job_name
        os.environ.pop(observability.METRICS_PORT_ENV, None)
        return LocalProcessInstanceManager(
            self._command_for,
            num_workers=args.num_workers,
            num_ps=args.num_ps,
            task_dispatcher=self.task_d,
            membership=self.membership,
            max_relaunches=args.max_relaunches,
        )

    def _build_k8s_instance_manager(self, args):
        from elasticdl_tpu_torch.master.k8s_instance_manager import (
            K8sInstanceManager,
        )

        envs = {observability.JOB_NAME_ENV: args.job_name}
        # The obs dir and the log level follow the master into the pods,
        # so that every role's traces, events and logs land together. The
        # JAX master also forwards its compile cache directory and its log
        # format; the port compiles nothing ahead of time and logs in the
        # plain format only.
        for var in (observability.OBS_DIR_ENV, "ELASTICDL_LOG_LEVEL"):
            if knobs.is_set(var):
                envs[var] = knobs.raw(var)
        return K8sInstanceManager(
            args.namespace,
            args.job_name,
            args.image_name,
            self._command_for,
            num_workers=args.num_workers,
            num_ps=args.num_ps,
            task_dispatcher=self.task_d,
            membership=self.membership,
            worker_resources=args.worker_resources,
            ps_resources=args.ps_resources,
            worker_priority=args.worker_pod_priority,
            volumes=args.volume,
            max_relaunches=args.max_relaunches,
            envs=envs,
            ps_service_port=PS_SERVICE_PORT,
        )

    def _master_addr(self):
        host = os.environ.get("MY_POD_IP", "127.0.0.1")
        return f"{host}:{self.port}"

    def _ps_addr(self, ps_id):
        # Under k8s, PS i is its service's stable name. Else PS i listens
        # on base+1+i on this host. With --master_port 0 the base is the
        # ACTUALLY BOUND master port (serve() binds before any instance
        # spawns), so two concurrent jobs on one host don't collide on a
        # fixed base.
        if self.args.instance_backend == "k8s":
            return f"{self.args.job_name}-ps-{ps_id}:{PS_SERVICE_PORT}"
        base = self.args.master_port or self.port or 50001
        return f"127.0.0.1:{base + 1 + ps_id}"

    def ps_addrs(self):
        return ",".join(self._ps_addr(i) for i in range(self.args.num_ps))

    def _command_for(self, kind, instance_id):
        """argv for a spawned instance: the JAX master's, with the port's
        entry points."""
        relay = build_arguments_from_parsed_result(
            self.args,
            filter_args=(
                _WORKER_RELAY_ARGS if kind == "worker" else _PS_RELAY_ARGS
            ),
        )
        if kind == "worker":
            argv = [
                sys.executable,
                "-m",
                "elasticdl_tpu_torch.worker.main",
                "--worker_id",
                str(instance_id),
                "--master_addr",
                self._master_addr(),
            ]
            if self.args.num_ps:
                argv += ["--ps_addrs", self.ps_addrs()]
            if self.args.training_data:
                if self.args.validation_data:
                    argv += ["--job_type", "training_with_evaluation"]
            elif self.args.validation_data:
                argv += ["--job_type", "evaluation_only"]
            elif self.args.prediction_data:
                argv += ["--job_type", "prediction_only"]
            for flag in ("output", "checkpoint_dir_for_init"):
                value = getattr(self.args, flag, "")
                if value:
                    argv += [f"--{flag}", str(value)]
            return argv + relay
        if kind == "ps":
            ps_port = int(self._ps_addr(instance_id).rsplit(":", 1)[1])
            argv = [
                sys.executable,
                "-m",
                "elasticdl_tpu_torch.ps.main",
                "--ps_id",
                str(instance_id),
                "--num_ps",
                str(self.args.num_ps),
                "--port",
                str(ps_port),
                "--master_addr",
                self._master_addr(),
            ]
            for flag in (
                "checkpoint_dir",
                "checkpoint_steps",
                "keep_checkpoint_max",
                "checkpoint_dir_for_init",
                "grads_to_wait",
                "sync_version_tolerance",
                "sync_window_timeout",
            ):
                value = getattr(self.args, flag, None)
                # `is not None` so explicit numeric zeros still relay;
                # empty-string defaults for the path flags stay dropped.
                if value is not None and value != "":
                    argv += [f"--{flag}", str(value)]
            if not self.args.use_async:
                argv += ["--use_sync"]
            if self.args.lr_staleness_modulation:
                argv += ["--lr_staleness_modulation"]
            return argv + relay
        raise ValueError(kind)

    def prepare(self):
        """Starts the master's threads: the heartbeat, the telemetry
        aggregator's poll and the policy engine's loop. The constructor
        already did the rest of what the JAX master's prepare() does
        before it binds its port, so stub() serves from construction on."""
        self._heartbeat.start()
        if self.aggregator is not None:
            self.aggregator.start()
        if self.policy is not None:
            self.policy.start()
        return self

    def serve(self):
        """Binds the master's port (`--master_port`, 0 binds any; the
        bound one is `self.port`), then starts the PS and worker processes
        of the instance manager, as the end of the JAX master's prepare()
        does."""
        self._server, self.port = rpc.serve(
            self.servicer, rpc.MASTER_SERVICE, port=self.args.master_port)
        logger.info("Master serving on port %d", self.port)
        if self.instance_manager is not None:
            if self.args.num_ps:
                self.instance_manager.start_parameter_servers()
            self.instance_manager.start_workers()
        if self.metrics_service is not None and hasattr(
                self.instance_manager, "create_tensorboard_service"):
            # The k8s manager's LoadBalancer service in front of this
            # master pod.
            try:
                self.instance_manager.create_tensorboard_service()
                logger.info("Created TensorBoard LoadBalancer service "
                            "tensorboard-%s", self.args.job_name)
            except Exception:
                logger.warning("TensorBoard service creation failed",
                               exc_info=True)
        return self

    def run(self, poll_seconds=None):
        """Poll until done or failed; returns the process exit code. Stops
        the master on the way out."""
        poll = poll_seconds or min(5.0, self.args.task_timeout_check_seconds)
        last_watchdog = time.time()
        last_metrics = time.time()
        last_records = self.task_d.stats()["records_done"]

        # Brief linger before the server stops on ANY terminal path, so
        # monitors polling get_job_status can observe the terminal state
        # (finished OR failed) instead of an ambiguous UNAVAILABLE.
        def linger():
            time.sleep(getattr(self.args, "shutdown_linger_seconds", 2.0))

        try:
            while True:
                if self.task_d.finished():
                    logger.info("All tasks complete; job done")
                    linger()
                    return 1 if self.task_d.job_failed else 0
                if self.task_d.job_failed:
                    logger.error("Job failed (task retries exhausted)")
                    linger()
                    return 1
                if self.instance_manager is not None:
                    if self.instance_manager.all_workers_failed():
                        logger.error("All workers failed; aborting job")
                        return 1
                    if self.instance_manager.all_workers_done():
                        logger.error(
                            "All workers exited but tasks remain; "
                            "aborting job")
                        return 1
                now = time.time()
                if now - last_watchdog >= self.args.task_timeout_check_seconds:
                    last_watchdog = now
                    self._run_watchdog()
                    # Journal maintenance rides the watchdog tick: this
                    # thread holds no dispatcher or policy lock here, which
                    # compaction requires (it calls back into the state
                    # providers).
                    if self.journal is not None:
                        self.journal.maybe_compact()
                if self.metrics_service and now - last_metrics >= 30.0:
                    stats = self.task_d.stats()
                    elapsed = now - last_metrics
                    self.metrics_service.log_scalars(
                        "train",
                        self.servicer.max_model_version,
                        {
                            "records_per_sec": (
                                stats["records_done"] - last_records
                            ) / elapsed,
                            "records_done": stats["records_done"],
                            "epoch": stats["epoch"],
                            "todo_tasks": stats["todo"],
                            "doing_tasks": stats["doing"],
                        },
                    )
                    last_metrics = now
                    last_records = stats["records_done"]
                time.sleep(poll)
        finally:
            self.stop()

    def _run_watchdog(self):
        """Task-timeout + liveness watchdog: the tasks of a worker whose
        task runs over its timeout, or that has not called within the
        liveness timeout, go back to the queue, and it leaves the comm
        group. Step leases' synthetic owners are not watched: a lease
        lives as long as its membership epoch (step_lease.py aborts stale
        ones), and recovering its tasks here would pull them out from
        under a live world."""
        slow = {wid for wid in self.task_d.doing_tasks_over_timeout()
                if not is_lease_owner(wid)}
        deadline = time.time() - self.args.worker_liveness_timeout_seconds
        silent = {
            wid
            for wid, ts in self.servicer.snapshot_liveness().items()
            if ts < deadline
        }
        for worker_id in slow | silent:
            why = "slow" if worker_id in slow else "silent"
            logger.warning(
                "Watchdog: recovering tasks of %s worker %d", why, worker_id)
            observability.emit_event(
                "task_timeout", worker=worker_id, reason=why)
            self.task_d.recover_tasks(worker_id)
            self.servicer.forget_worker(worker_id)
            if self.membership is not None:
                # Survivors regroup instead of blocking on the dead rank's
                # next collective.
                self.membership.remove_worker(worker_id)

    def _summary(self):
        """Aggregator summary with the policy plane merged in, so
        /api/summary shows decisions next to signals."""
        summary = self.aggregator.summary()
        if self.policy is not None:
            summary["policy"] = self.policy.summary()
        return summary

    def stop(self):
        """Takes down what the constructor, prepare() and serve() started:
        the heartbeat, the policy engine, the aggregator, the instance
        manager's processes, the metrics service (after a final train
        snapshot, so short jobs leave a record), the server, the journal
        (closed, not compacted) and the observability plane this master set
        up."""
        self._heartbeat.close()
        if self.policy is not None:
            self.policy.close()
            self.policy = None
        if self.aggregator is not None:
            logger.info("Telemetry pushes accepted: %s",
                        json.dumps(self.aggregator.push_tally()))
            self.aggregator.close()
            self.aggregator = None
        if self.instance_manager is not None:
            self.instance_manager.stop()
        if self.metrics_service is not None:
            stats = self.task_d.stats()
            self.metrics_service.log_scalars(
                "train",
                self.servicer.max_model_version,
                {
                    "records_done": stats["records_done"],
                    "epoch": stats["epoch"],
                    "todo_tasks": stats["todo"],
                    "doing_tasks": stats["doing"],
                },
            )
            self.metrics_service.close()
            self.metrics_service = None
        if self._server is not None:
            self._server.stop(2)
            self._server = None
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        if self._owns_obs:
            self.obs.close()
            self._owns_obs = False

    def _resume_from_ps_checkpoint(self, args):
        """Skip the records a PS checkpoint already trained on: the
        checkpoint carries their exact count (a version alone is ambiguous:
        a sync window merges a variable number of pushes, tasks end in
        partial batches); checkpoints without it fall back to an estimate
        from the version."""
        version = ps_checkpoint.latest_complete_version(
            args.checkpoint_dir_for_init)
        if not version:
            return
        records = ps_checkpoint.read_total_records(
            args.checkpoint_dir_for_init, version)
        if not records:
            records = (version
                       * (1 if args.use_async else max(args.grads_to_wait, 1))
                       * args.minibatch_size)
        self.task_d.set_completed_records(records)

    def _build_ps(self, ps_id):
        args = self.args
        return ParameterServer(
            ps_id,
            args.num_ps,
            optimizer_spec=self.spec.build_optimizer_spec(),
            use_async=args.use_async,
            grads_to_wait=args.grads_to_wait,
            sync_version_tolerance=args.sync_version_tolerance,
            sync_window_timeout=args.sync_window_timeout,
            lr_staleness_modulation=args.lr_staleness_modulation,
            checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_steps=args.checkpoint_steps,
            keep_checkpoint_max=args.keep_checkpoint_max,
            checkpoint_dir_for_init=args.checkpoint_dir_for_init or None,
            master_client=MasterClient(self.stub(), -1),
        )

    def stub(self):
        """A client stub of this master's service, for a worker in this
        process."""
        return rpc.InProcessStub(self.servicer, rpc.MASTER_SERVICE)

    def ps_stubs(self):
        """One client stub per PS shard, index = shard id. A stub keeps
        reaching its shard's place across relaunch_ps."""
        return [rpc.InProcessStub(_ShardPlace(self.ps_servers, i),
                                  rpc.PSERVER_SERVICE)
                for i in range(len(self.ps_servers))]

    def relaunch_ps(self, ps_id):
        """Replaces shard `ps_id` with a fresh ParameterServer built from the
        same arguments (empty unless --checkpoint_dir_for_init restores it);
        workers re-seed it on their next pull."""
        self.ps_servers[ps_id] = self._build_ps(ps_id)
        logger.info("Relaunched PS shard %d", ps_id)
        return self.ps_servers[ps_id]


def _master_plane(args):
    """The master's observability plane -> (handle or None, owned).

    `--metrics_dir` doubles as the obs dir, as in the JAX master, and
    ELASTICDL_OBS_DIR stands in for it. A master with neither an obs dir
    nor ELASTICDL_METRICS_PORT sets nothing up. A live plane over the
    same obs dir (set up by the process hosting the job) is used as it is
    and left to its owner. Any other live plane (one an earlier master of
    this process left behind) is closed, and the master sets up its own:
    role "master", its exporter on 127.0.0.1 unless ELASTICDL_METRICS_HOST
    names another address (its scrapers live in this process), and the
    flight recorder without signal handlers (the process's, not the
    master's). stop() closes the plane the master set up."""
    obs_dir = args.metrics_dir or knobs.get_str(observability.OBS_DIR_ENV)
    if not obs_dir and not knobs.is_set(observability.METRICS_PORT_ENV):
        return None, False
    live = observability.current_handle()
    if live is not None:
        if live.obs_dir == obs_dir:
            return live, False
        live.close()
    handle = observability.setup(
        role="master", job=args.job_name, obs_dir=obs_dir,
        arm_signals=False,
        host=knobs.get_str("ELASTICDL_METRICS_HOST") or "127.0.0.1")
    return handle, True


class _ShardPlace:
    """The servicer at one shard's place: hands each call to whichever
    ParameterServer currently holds it."""

    def __init__(self, servers, ps_id):
        self._servers = servers
        self._ps_id = ps_id

    def __getattr__(self, method):
        return getattr(self._servers[self._ps_id].servicer, method)
