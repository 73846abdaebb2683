"""The worker loop: pull tasks, train/evaluate/predict minibatches, report
(counterpart of elasticdl_tpu/worker/worker.py).

Job-type dispatch, per-minibatch retry (<= 64), evaluation tasks interleaved
into training, prediction output processing, train-end callback task
handling, and the step-synchronized lease loop of multi-host AllReduce
(`lease_mode`): training is leased to the whole world at once, every rank
runs the lease's n_steps minibatches, and a comm failure or a membership
change abandons the lease, which the master requeues. The device trace
window (profile_dir) comes with the observability slice; asking for it
raises NotImplementedError.
"""

import time
import traceback

from elasticdl_tpu_torch.common.constants import (
    DEFAULT_MAX_MINIBATCH_RETRY_NUM,
    JobType,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.common.rpc import RpcError
from elasticdl_tpu_torch.common.timing import Timing
from elasticdl_tpu_torch.observability import datapath, tracing
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

logger = get_logger("worker.worker")

# Lease-loop poll interval while the master answers WAIT (tests set it
# to 0).
LEASE_WAIT_SECONDS = 0.5

_REG = default_registry()
_STEPS = _REG.counter(
    "edl_worker_steps_total", "Minibatch steps this worker completed"
)
_TASKS = _REG.counter(
    "edl_worker_tasks_total",
    "Tasks this worker processed, by result",
    labelnames=("result",),
)
_PHASE_SECONDS = _REG.histogram(
    "edl_phase_seconds",
    "Worker phase latency (task_process/batch_process + trainer phases)",
    labelnames=("phase",),
)


class Worker:
    def __init__(
        self,
        worker_id,
        master_client,
        data_reader,
        model_spec,
        trainer,
        minibatch_size=64,
        job_type=JobType.TRAINING_ONLY,
        log_loss_steps=100,
        max_minibatch_retries=DEFAULT_MAX_MINIBATCH_RETRY_NUM,
        extra_callbacks=(),
        profile_dir="",
        lease_mode=False,
    ):
        if profile_dir:
            raise NotImplementedError(
                "the worker's device trace window (profile_dir) is not "
                "ported to elasticdl_tpu_torch yet"
            )
        self._worker_id = worker_id
        self._mc = master_client
        self._tds = TaskDataService(master_client, data_reader)
        self._spec = model_spec
        self._trainer = trainer
        self._minibatch_size = minibatch_size
        self._job_type = job_type
        self._log_loss_steps = log_loss_steps
        self._max_minibatch_retries = max_minibatch_retries
        self._metadata = data_reader.metadata
        # Step-synchronized lease mode (multi-host AllReduce): training is
        # driven by whole-world leases instead of independent task pulls.
        self._lease_mode = lease_mode
        self._steps = 0
        # Lease steps that raised (a peer's death surfaces in the step's
        # all-reduce, after its forward and backward ran).
        self._failed_steps = 0
        self._timing = Timing().bind_histogram(_PHASE_SECONDS)
        # Data-plane stages recorded off the worker loop (task acquire,
        # read/starve, decode) mirror into this Timing as input_<stage>
        # phases; the trainer's h2d stage binds its own Timing at the
        # call site so bench attribution sees it in the trainer summary.
        datapath.get().bind_timing(self._timing)
        trainer_timing = getattr(trainer, "timing", None)
        if trainer_timing is not None:
            # Trainer phases (pull/step/push) reach /metrics through the
            # same labeled histogram.
            trainer_timing.bind_histogram(_PHASE_SECONDS)
        self._callbacks = (
            model_spec.callbacks() if model_spec.callbacks else []
        ) + list(extra_callbacks)

    # ---------- public ----------

    def run(self):
        if self._job_type in (
            JobType.TRAINING_ONLY,
            JobType.TRAINING_WITH_EVALUATION,
        ):
            if self._lease_mode:
                # Leases cover TRAINING work only; the regular loop
                # afterwards drains evaluation and train-end tasks.
                self._train_leases()
            self._train_and_evaluate()
        elif self._job_type == JobType.EVALUATION_ONLY:
            self._evaluate_only()
        elif self._job_type == JobType.PREDICTION_ONLY:
            self._predict_only()
        else:
            raise ValueError(f"unknown job type {self._job_type}")

    # ---------- job loops ----------

    def _train_and_evaluate(self):
        while True:
            task = self._tds.get_task()
            if task is None:
                # Batched leases: results buffered past the last fetch
                # must land before the loop exits.
                self._tds.flush_reports()
                logger.info("Worker %d: no more tasks", self._worker_id)
                break
            if task.type == pb.TRAINING:
                self._run_task(task, self._process_train_batch)
                # In local/AllReduce modes the worker is the version source
                # (the PS plays that role in PS mode): reporting after each
                # training task drives version-triggered evaluation. A lost
                # report only delays the next eval trigger — never worth a
                # worker's life during a master blip.
                try:
                    self._mc.report_version(
                        self._trainer.get_model_version()
                    )
                except RpcError:
                    logger.warning(
                        "report_version failed (master unreachable?); "
                        "continuing",
                    )
                # Interleave pending evaluation tasks between training
                # tasks.
                if self._job_type == JobType.TRAINING_WITH_EVALUATION:
                    self._drain_eval_tasks()
            elif task.type == pb.EVALUATION:
                self._run_task(task, self._process_eval_batch)
            elif task.type == pb.TRAIN_END_CALLBACK:
                self._run_train_end_callbacks(task)
            else:
                logger.warning("Skipping unexpected task %s", task)
                self._tds.report_task(task.task_id)

    def _train_leases(self):
        """Step-synchronized lease loop (multi-host AllReduce): every rank
        of the current membership epoch runs exactly lease.n_steps
        minibatches, then the lease's tasks complete; a comm failure or a
        membership change abandons the lease (the master requeues it). The
        loop returns when training work is exhausted; evaluation and
        train-end tasks drain through the regular task loop after."""
        while True:
            lease = self._mc.lease_steps(self._minibatch_size)
            if lease.status == pb.LeaseStepsResponse.FINISHED:
                logger.info(
                    "Worker %d: training leases exhausted", self._worker_id
                )
                return
            if lease.status == pb.LeaseStepsResponse.WAIT:
                # Not in the group yet, peers still finishing the active
                # lease, or no mintable work: announce ourselves, drain any
                # pending evaluation work, and poll again.
                self._mc.report_liveness()
                if self._job_type == JobType.TRAINING_WITH_EVALUATION:
                    self._drain_eval_tasks()
                time.sleep(LEASE_WAIT_SECONDS)
                continue
            try:
                records = self._read_lease_records(lease.ranges)
            except Exception as e:
                logger.error("Lease %d data read failed: %s",
                             lease.lease_id, e)
                self._mc.report_lease(
                    lease.lease_id, lease.rank, False, str(e)
                )
                continue
            if not records:
                self._mc.report_lease(
                    lease.lease_id, lease.rank, False, "empty lease ranges"
                )
                continue
            B = self._minibatch_size
            first = self._spec.feed(
                records[:B], Modes.TRAINING, self._metadata
            )
            self._trainer.init_variables_if_needed(first[0])
            self._trainer.init_world_if_needed()
            if (
                self._trainer.group_id != lease.epoch
                or self._trainer.rank != lease.rank
                or self._trainer.world_size != lease.world_size
            ):
                # The world moved between minting and joining; the master
                # aborts this lease on its next epoch observation.
                logger.info(
                    "Worker %d: lease %d is for epoch %d but this worker "
                    "is at epoch %d (rank %d/%d); refetching",
                    self._worker_id,
                    lease.lease_id,
                    lease.epoch,
                    self._trainer.group_id,
                    self._trainer.rank,
                    self._trainer.world_size,
                )
                continue
            tracing.set_context(lease_epoch=lease.epoch)
            running = False
            try:
                loss = None
                dp = datapath.get()
                for i in range(lease.n_steps):
                    # Cycle this rank's records to fill every batch: all
                    # ranks must run identically-shaped steps.
                    with dp.stage("collate"):
                        rows = [
                            records[(i * B + j) % len(records)]
                            for j in range(B)
                        ]
                    with dp.stage("decode"):
                        features, labels = self._spec.feed(
                            rows, Modes.TRAINING, self._metadata
                        )
                    running = True
                    loss = self._trainer.train_lease_minibatch(
                        features, labels
                    )
                    running = False
                    self._steps += 1
                    _STEPS.inc()
                    if self._steps % self._log_loss_steps == 0:
                        logger.info(
                            "Step %d (lease %d) loss %.6f",
                            self._steps,
                            lease.lease_id,
                            float(loss),
                        )
                # "Success" means the steps ran: wait for the device
                # before reporting.
                if loss is not None:
                    float(loss)
            except Exception as e:
                self._failed_steps += running
                logger.warning(
                    "Lease %d failed mid-steps; re-checking world",
                    lease.lease_id,
                    exc_info=True,
                )
                old_epoch = self._trainer.group_id
                try:
                    self._trainer.init_world_if_needed(force=True)
                except Exception:
                    logger.warning(
                        "World re-init failed; will retry on next lease",
                        exc_info=True,
                    )
                if self._trainer.group_id == old_epoch:
                    # Same membership epoch: a deterministic failure (bad
                    # feed, ...), not an elastic event. Report it so the
                    # master's retry ladder bounds it instead of re-minting
                    # the same doomed lease forever.
                    self._mc.report_lease(
                        lease.lease_id, lease.rank, False, str(e)
                    )
                    time.sleep(LEASE_WAIT_SECONDS)
                continue
            self._mc.report_lease(lease.lease_id, lease.rank, True)
            self._mc.report_version(self._trainer.get_model_version())

    def _read_lease_records(self, ranges):
        records = []
        for r in ranges:
            records.extend(self._tds.read_range(r))
        return records

    def _evaluate_only(self):
        while True:
            task = self._tds.get_task(pb.EVALUATION)
            if task is None:
                break
            self._run_task(task, self._process_eval_batch)

    def _predict_only(self):
        processor = self._spec.prediction_outputs_processor
        while True:
            task = self._tds.get_task(pb.PREDICTION)
            if task is None:
                break
            self._run_task(
                task,
                lambda records, task=task: self._process_predict_batch(
                    records, processor
                ),
            )
        # Optional end-of-stream hook: buffering processors (e.g. the
        # ODPS writer's) flush their tail here.
        close = getattr(processor, "close", None)
        if close is not None:
            close()

    def _drain_eval_tasks(self):
        while True:
            task = self._tds.try_get_eval_task()
            if task is None:
                return
            self._run_task(task, self._process_eval_batch)

    # ---------- task/batch processing ----------

    def _run_task(self, task, process_batch):
        # Re-key this thread's trace context to the task: every span and
        # RPC from here to report_task_result (PS pulls/pushes included)
        # carries the task id and one fresh trace id, which is what lets
        # trace_report.py stitch the task's cross-process chain together.
        tracing.set_context(task_id=task.task_id)
        try:
            with self._timing.record("task_process"), tracing.span(
                "task_process",
                task_type=pb.TaskType.Name(task.type),
            ):
                for records in self._tds.read_batches(
                    task, self._minibatch_size
                ):
                    with self._timing.record("batch_process"), tracing.span(
                        "batch_process"
                    ):
                        self._process_with_retries(process_batch, records)
            if task.type == pb.TRAINING:
                # A training task is done once its gradients are applied:
                # the pipelined PS trainer's last push lands, and the PS's
                # version report (which may open an evaluation round) with
                # it, before the task's report can finish the job.
                flush = getattr(self._trainer, "flush_pushes", None)
                if flush is not None:
                    flush()
            self._tds.report_task(task.task_id)
            _TASKS.labels(result="success").inc()
        except Exception as e:
            logger.error(
                "Task %d failed: %s\n%s",
                task.task_id,
                e,
                traceback.format_exc(),
            )
            self._tds.report_task(task.task_id, err_message=str(e))
            _TASKS.labels(result="failure").inc()
        finally:
            # Per-task phase breakdown at DEBUG; in the finally so a failed
            # task's time can't leak into the next task's report.
            self._timing.report(logger, reset=True)
            trainer_timing = getattr(self._trainer, "timing", None)
            if trainer_timing is not None:
                trainer_timing.report(logger, reset=True)
            # One `datapath` event per task: the per-stage seconds this
            # task spent in the feed path, keyed by task id.
            datapath.get().flush_event(task_id=task.task_id)

    def _process_with_retries(self, process_batch, records):
        """Per-minibatch retry: transient failures (PS restart, comm
        regroup) retry up to the cap; then the whole task is failed back to
        the master for re-dispatch."""
        for attempt in range(self._max_minibatch_retries):
            try:
                process_batch(records)
                return
            except Exception:
                if attempt == self._max_minibatch_retries - 1:
                    raise
                logger.warning(
                    "Minibatch failed (attempt %d):\n%s",
                    attempt + 1,
                    traceback.format_exc(),
                )

    def _process_train_batch(self, records):
        with datapath.get().stage("decode"):
            features, labels = self._spec.feed(
                records, Modes.TRAINING, self._metadata
            )
        accepted, version, loss = self._trainer.train_minibatch(
            features, labels
        )
        if accepted:
            self._steps += 1
            _STEPS.inc()
            if self._steps % self._log_loss_steps == 0:
                # Only materialize the on-device loss when logging; every
                # other step stays dispatch-ahead (no wait for the card).
                logger.info(
                    "Step %d (version %d) loss %.6f",
                    self._steps,
                    version,
                    float(loss),
                )

    def _process_eval_batch(self, records):
        with datapath.get().stage("decode"):
            features, labels = self._spec.feed(
                records, Modes.EVALUATION, self._metadata
            )
        outputs = self._trainer.evaluate_minibatch(features)
        self._mc.report_evaluation_metrics(outputs, labels)

    def _process_predict_batch(self, records, processor):
        with datapath.get().stage("decode"):
            features, _ = self._spec.feed(
                records, Modes.PREDICTION, self._metadata
            )
        outputs = self._trainer.predict_minibatch(features)
        if processor is not None:
            processor.process(outputs, self._worker_id)

    def _run_train_end_callbacks(self, task):
        try:
            for cb in self._callbacks:
                on_train_end = getattr(cb, "on_train_end", None)
                if on_train_end:
                    on_train_end(self._trainer)
            self._tds.report_task(task.task_id)
        except Exception as e:
            self._tds.report_task(task.task_id, err_message=str(e))

    @property
    def steps(self):
        return self._steps

    @property
    def failed_steps(self):
        return self._failed_steps

    @property
    def trainer(self):
        return self._trainer
