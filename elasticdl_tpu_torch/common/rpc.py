"""Service tables and the in-process stub (counterpart of
elasticdl_tpu/common/rpc.py:94-156 and :749-783).

Each service is declared once as a ServiceSpec table: method name ->
(request class, response class). `InProcessStub(servicer, spec)` gives the
client one callable per method, as `rpc.Stub` does over a gRPC channel, but
calls the servicer in this process. It still crosses the wire format where a
channel would: the request is serialized and parsed back before the handler
sees it, and the response is serialized and parsed back before the caller
does, so both sides only ever share bytes. A handler's exception reaches the
caller as an RpcError with code UNKNOWN, as gRPC surfaces it. Each method
also has `.future(request)`, as a gRPC multi-callable does: the call runs on
the stub's small thread pool and `.result()` returns the response or raises
the RpcError, so a client fans out to several servicers at once (the
parameter-server shards apply concurrently; their native kernels release the
interpreter lock). The handler is looked up at each call, so a servicer
object can hand calls on to whichever server currently holds its place (a
relaunched parameter-server shard behind the same stub).

The gRPC transport (channels, `serve`, retries, deadlines and the circuit
breaker) waits until grpcio and protobuf are installed where the port runs.
"""

import concurrent.futures
import dataclasses
import enum

from elasticdl_tpu_torch.proto import messages as pb


class StatusCode(enum.Enum):
    """The gRPC status codes the port raises or branches on, with gRPC's
    numbers."""

    UNKNOWN = 2
    DEADLINE_EXCEEDED = 4
    UNIMPLEMENTED = 12
    UNAVAILABLE = 14


class RpcError(Exception):
    """A failed call, with `code()` and `details()` as grpc.RpcError has."""

    def __init__(self, code, details=""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self):
        return self._code

    def details(self):
        return self._details


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    name: str
    # method name -> (request class, response class)
    methods: dict


MASTER_SERVICE = ServiceSpec(
    name="elasticdl_tpu.Master",
    methods={
        "get_task": (pb.GetTaskRequest, pb.Task),
        # Lease batching: up to max_tasks tasks per RPC, batched reports.
        "get_task_batch": (pb.GetTaskRequest, pb.TaskBatch),
        "report_task_result": (pb.ReportTaskResultRequest, pb.Empty),
        "report_task_results": (pb.ReportTaskResultsRequest, pb.Empty),
        "report_evaluation_metrics": (
            pb.ReportEvaluationMetricsRequest, pb.Empty,
        ),
        "report_version": (pb.ReportVersionRequest, pb.Empty),
        "get_job_status": (pb.GetJobStatusRequest, pb.JobStatusResponse),
    },
)


PSERVER_SERVICE = ServiceSpec(
    name="elasticdl_tpu.Pserver",
    methods={
        "push_model": (pb.Model, pb.Empty),
        "push_embedding_table_infos": (pb.Model, pb.Empty),
        "pull_dense_parameters": (
            pb.PullDenseParametersRequest,
            pb.PullDenseParametersResponse,
        ),
        "pull_embedding_vectors": (pb.PullEmbeddingVectorsRequest, pb.Tensor),
        "pull_embedding_table": (
            pb.PullEmbeddingTableRequest,
            pb.IndexedSlices,
        ),
        "push_gradients": (pb.PushGradientsRequest, pb.PushGradientsResponse),
        # Out-of-band transport: slim span header + one contiguous payload
        # (the client sends a tensor_utils.PackedPushRequest, which joins
        # the header with views of the payload when it serializes).
        "push_gradients_packed": (
            pb.PushGradientsPackedRequest,
            pb.PushGradientsResponse,
        ),
    },
)

# Threads per stub for `.future` calls: enough for a client's fan-out of
# pulls and a chunked push to one servicer to run side by side.
FUTURE_THREADS = 4


class InProcessStub:
    """Client stub over a servicer in this process: one callable attribute
    per spec method, each taking a request message and returning the
    response message, with `.future(request)` beside it."""

    def __init__(self, servicer, spec: ServiceSpec):
        # Starts no thread until the first `.future` call.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=FUTURE_THREADS, thread_name_prefix="edl-stub")
        for method, (req_cls, resp_cls) in spec.methods.items():
            call = self._method(
                f"/{spec.name}/{method}", servicer, method, req_cls,
                resp_cls,
            )
            call.future = lambda request, call=call: self._pool.submit(
                call, request)
            setattr(self, method, call)

    def close(self):
        """Waits for the calls in flight and stops the stub's threads."""
        self._pool.shutdown(wait=True)

    @staticmethod
    def _method(path, servicer, method, req_cls, resp_cls):
        def call(request):
            handler = getattr(servicer, method, None)
            if handler is None:
                raise RpcError(StatusCode.UNIMPLEMENTED,
                               f"Method not found: {path}")
            wire_request = req_cls.FromString(request.SerializeToString())
            try:
                response = handler(wire_request, None)
            except Exception as e:  # the servicer's failure, as gRPC reports it
                raise RpcError(
                    StatusCode.UNKNOWN,
                    f"Exception calling application: {e}",
                ) from e
            return resp_cls.FromString(response.SerializeToString())

        return call
