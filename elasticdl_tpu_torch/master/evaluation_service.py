"""Version-triggered distributed evaluation (counterpart of
elasticdl_tpu/master/evaluation_service.py).

Every time the model version advances past `eval_steps`, the master creates
evaluation tasks; training workers interleave them, reporting raw model
outputs + labels; the master folds those into streaming metrics and
publishes the results when all eval tasks of the job complete.
"""

import threading

from elasticdl_tpu_torch.common.evaluation_utils import (
    as_metric,
    update_metrics_chunked,
)
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("master.evaluation_service")


class EvaluationJob:
    def __init__(self, metrics, model_version, total_tasks):
        self.model_version = model_version
        self.total_tasks = total_tasks
        self.completed_tasks = 0
        self._metrics = {k: as_metric(v) for k, v in metrics.items()}

    def report_evaluation_metrics(self, outputs, labels):
        update_metrics_chunked(self._metrics, outputs, labels)

    def complete_task(self):
        self.completed_tasks += 1
        return self.completed_tasks >= self.total_tasks

    def results(self):
        return {k: m.result() for k, m in self._metrics.items()}


class EvaluationService:
    def __init__(
        self,
        task_dispatcher,
        eval_metrics_factory,
        eval_steps=0,
        eval_initially=False,
        on_results=None,
    ):
        """eval_metrics_factory: () -> {name: metric}; on_results: callback
        (model_version, {name: value}) when a job finishes (TensorBoard /
        logging hook)."""
        self._task_d = task_dispatcher
        self._metrics_factory = eval_metrics_factory
        self._eval_steps = eval_steps
        # eval_initially: backdate the last-eval marker so the very first
        # report_version already crosses the eval_steps threshold.
        self._last_eval_version = -eval_steps if eval_initially else 0
        self._on_results = on_results
        self._lock = threading.Lock()
        self._job = None
        self.completed_results = []  # [(model_version, {name: value})]
        task_dispatcher.add_evaluation_complete_callback(self._task_completed)

    def add_evaluation_task_if_needed(self, model_version):
        """Called on every report_version (PS version bump or AllReduce step
        report)."""
        with self._lock:
            if self._eval_steps <= 0 or self._job is not None:
                return False
            if model_version < self._last_eval_version + self._eval_steps:
                return False
            n = self._task_d.create_evaluation_tasks(model_version)
            if n == 0:
                return False
            self._job = EvaluationJob(
                self._metrics_factory(), model_version, n
            )
            self._last_eval_version = model_version
            return True

    def start_final_evaluation(self, model_version):
        """One evaluation pass at end of training regardless of eval_steps."""
        with self._lock:
            if self._job is not None:
                return False
            n = self._task_d.create_evaluation_tasks(model_version)
            if n == 0:
                return False
            self._job = EvaluationJob(self._metrics_factory(), model_version, n)
            return True

    def open_job(self, model_version, total_tasks):
        """Opens an evaluation job over `total_tasks` evaluation tasks the
        dispatcher already holds: an evaluation-only job's, created at the
        start. (The JAX master opens none for them, so their metrics are
        dropped.)"""
        with self._lock:
            self._job = EvaluationJob(
                self._metrics_factory(), model_version, total_tasks)

    def report_evaluation_metrics(self, outputs, labels):
        with self._lock:
            if self._job is None:
                logger.warning("Evaluation metrics reported with no job open")
                return
            self._job.report_evaluation_metrics(outputs, labels)

    def _task_completed(self, task_id, task):
        finished_job = None
        with self._lock:
            if self._job is None:
                return
            if self._job.complete_task():
                finished_job = self._job
                self._job = None
        if finished_job is not None:
            results = finished_job.results()
            self.completed_results.append(
                (finished_job.model_version, results)
            )
            logger.info(
                "Evaluation @ version %d: %s",
                finished_job.model_version,
                results,
            )
            if self._on_results:
                self._on_results(finished_job.model_version, results)

    @property
    def in_progress(self):
        with self._lock:
            return self._job is not None
