"""Worker-side wrapper over the Master service stub (counterpart of
elasticdl_tpu/worker/master_client.py).

`master` is the master's address ("host:port"), over which the client
builds a hardened channel (common/rpc.py), or a stub: an
rpc.InProcessStub(servicer, rpc.MASTER_SERVICE) for a master in this
process. Only the address form can `reconnect`. `worker_host` is the
"ip:port" this worker is reached on, its key in the AllReduce membership;
the AllReduce trainer rewrites its port to its broadcast server's.
"""

import threading
import time

import numpy as np

from elasticdl_tpu_torch.common import rpc, tensor_utils
from elasticdl_tpu_torch.proto import messages as pb


class _Answered:
    """A stub whose calls note the time the master first answered one."""

    def __init__(self, stub, client):
        self._stub = stub
        self._client = client

    def __getattr__(self, name):
        fn = getattr(self._stub, name)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self._client.first_answer_at is None:
                self._client.first_answer_at = time.time()
            return out

        return call


class MasterClient:
    def __init__(self, master, worker_id, worker_host=""):
        self._addr = None
        self._channel = None
        self._reconnect_lock = threading.Lock()
        # time.time() of the master's first answer (a worker process's
        # start split, worker/main.py).
        self.first_answer_at = None
        if isinstance(master, str):
            self._addr = master
            self._channel = rpc.build_channel(master)
            self._stub = _Answered(
                rpc.Stub(self._channel, rpc.MASTER_SERVICE), self)
        else:
            self._stub = _Answered(master, self)
        self._worker_id = worker_id
        self.worker_host = worker_host

    def reconnect(self, probe_timeout=1.0):
        """Rebuild the channel once the master accepts TCP again (a master
        relaunched on the same address). Returns True when the swap
        happened; False (channel untouched) while the master is still
        unreachable or the client holds a stub. Safe from any thread:
        every call reads self._stub at call time, so in-flight users
        migrate on their next call."""
        if self._addr is None:
            return False
        with self._reconnect_lock:
            if not rpc.wait_channel_ready(self._addr, probe_timeout):
                return False
            old = self._channel
            self._channel = rpc.build_channel(self._addr, ready_timeout=0)
            self._stub = _Answered(
                rpc.Stub(self._channel, rpc.MASTER_SERVICE), self)
            old.close()
            return True

    def close(self):
        if self._channel is not None:
            self._channel.close()

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

    def get_comm_rank(self, ready_epoch=None):
        """ready_epoch: declare this worker at the join gate for that
        membership epoch (see the proto's GetCommRankRequest); the
        response's world_ready says whether the whole world has
        arrived."""
        return self._stub.get_comm_rank(
            pb.GetCommRankRequest(
                worker_host=self.worker_host,
                ready_epoch_plus_one=(
                    0 if ready_epoch is None else ready_epoch + 1
                ),
            )
        )

    def report_liveness(self):
        """Registers this worker's host in the membership (a no-op for a
        host already registered under this id)."""
        return self._stub.report_worker_liveness(
            pb.ReportWorkerLivenessRequest(
                worker_id=self._worker_id, host=self.worker_host
            )
        )

    def lease_steps(self, batch_size):
        return self._stub.lease_steps(
            pb.LeaseStepsRequest(
                worker_id=self._worker_id,
                worker_host=self.worker_host,
                batch_size=batch_size,
            )
        )

    def report_lease(self, lease_id, rank, success, err_message=""):
        return self._stub.report_lease(
            pb.ReportLeaseRequest(
                lease_id=lease_id,
                worker_id=self._worker_id,
                rank=rank,
                success=success,
                err_message=err_message,
            )
        )

    def get_world_hint(self):
        """The master's announced next world (policy scale events);
        hint_seq 0 means none was ever announced."""
        return self._stub.get_world_hint(
            pb.GetWorldHintRequest(worker_id=self._worker_id)
        )

    def get_job_status(self):
        return self._stub.get_job_status(pb.GetJobStatusRequest())

    def report_telemetry(self, snapshots, origin=""):
        """Push a batch of (possibly delta-encoded) metric snapshots.
        snapshots: iterable of pb.TelemetrySnapshot (or kwargs dicts)."""
        req = pb.ReportTelemetryRequest(origin=origin)
        for snap in snapshots:
            if isinstance(snap, dict):
                req.snapshots.add(**snap)
            else:
                req.snapshots.append(snap)
        return self._stub.report_telemetry(req)
