"""Worker-side wrapper over the Master service stub (counterpart of
elasticdl_tpu/worker/master_client.py:12-130, for the methods the port's
servicer has).

It takes the stub instead of an address: rpc.InProcessStub(servicer,
rpc.MASTER_SERVICE) for a master in this process. The gRPC channel, and
with it `reconnect`, comes with the transport.
"""

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.proto import messages as pb


class MasterClient:
    def __init__(self, stub, worker_id):
        self._stub = stub
        self._worker_id = worker_id

    def get_task(self, task_type=pb.TRAINING):
        return self._stub.get_task(
            pb.GetTaskRequest(
                worker_id=self._worker_id, task_type=task_type
            )
        )

    def get_task_batch(self, max_tasks, task_type=pb.TRAINING):
        """Lease up to max_tasks tasks in one call (TaskBatch response;
        empty tasks + finished=False means wait and poll again)."""
        return self._stub.get_task_batch(
            pb.GetTaskRequest(
                worker_id=self._worker_id,
                task_type=task_type,
                max_tasks=max_tasks,
            )
        )

    def report_task_results(self, results):
        """Batch-report task results. results: iterable of
        (task_id, err_message, exec_counters) or
        (task_id, err_message, exec_counters, lease_token) tuples; the
        token (when the dispatched Task carried one) makes the report
        exactly-once across a master restart."""
        req = pb.ReportTaskResultsRequest()
        for result in results:
            task_id, err_message, exec_counters = result[:3]
            lease_token = result[3] if len(result) > 3 else 0
            entry = req.results.add(
                task_id=task_id,
                err_message=err_message or "",
                lease_token=lease_token,
            )
            if exec_counters:
                for k, v in exec_counters.items():
                    entry.exec_counters[k] = int(v)
        return self._stub.report_task_results(req)

    def report_task_result(self, task_id, err_message="", exec_counters=None,
                           lease_token=0):
        req = pb.ReportTaskResultRequest(
            task_id=task_id, err_message=err_message,
            lease_token=lease_token,
        )
        if exec_counters:
            for k, v in exec_counters.items():
                req.exec_counters[k] = int(v)
        return self._stub.report_task_result(req)

    def report_evaluation_metrics(self, model_outputs, labels):
        # Multi-output models pass a list/tuple; each output goes on the wire
        # as its own tensor so the master can hand metrics the same list.
        if not isinstance(model_outputs, (list, tuple)):
            model_outputs = [model_outputs]
        req = pb.ReportEvaluationMetricsRequest(
            model_outputs=[
                tensor_utils.ndarray_to_tensor_pb(np.asarray(o))
                for o in model_outputs
            ],
            labels=tensor_utils.ndarray_to_tensor_pb(np.asarray(labels)),
            worker_id=self._worker_id,
        )
        return self._stub.report_evaluation_metrics(req)

    def report_version(self, model_version):
        return self._stub.report_version(
            pb.ReportVersionRequest(model_version=model_version)
        )

    def get_job_status(self):
        return self._stub.get_job_status(pb.GetJobStatusRequest())
