"""The port's socket transport and its resilient call plane
(elasticdl_tpu_torch/common/rpc.py) against the JAX package's gRPC plane:
message bytes equal to elasticdl_tpu_pb2's across a real socket for every
method of both services, the status codes the transport raises, the retry
policies, backoff sequences and breaker transitions of the JAX module, the
cases of tests/test_rpc_resilience.py that need no grpc, trace context
across the socket (observability/tracing.py) and the chaos faults on it
(chaos/injection.py)."""

import dataclasses
import mmap
import random
import socket
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.chaos import injection as jax_injection
from elasticdl_tpu.common import rpc as jax_rpc
from elasticdl_tpu.observability import tracing as jax_tracing
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu_torch.chaos import injection
from elasticdl_tpu_torch.chaos.injection import FaultSchedule
from elasticdl_tpu_torch.common import rpc, tensor_utils
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.proto import messages as pb

from test_torch_wire import CASES, _build

# method -> (request case, response case) of test_torch_wire.CASES.
METHOD_CASES = {
    "get_task": ("GetTaskRequest", "Task"),
    "get_task_batch": ("GetTaskRequest", "TaskBatch"),
    "report_task_result": ("ReportTaskResultRequest", "Empty"),
    "report_task_results": ("ReportTaskResultsRequest", "Empty"),
    "report_evaluation_metrics": ("ReportEvaluationMetricsRequest", "Empty"),
    "report_version": ("ReportVersionRequest", "Empty"),
    "get_job_status": ("GetJobStatusRequest", "JobStatusResponse"),
    "report_telemetry": ("ReportTelemetryRequest", "ReportTelemetryResponse"),
    "get_comm_rank": ("GetCommRankRequest", "GetCommRankResponse"),
    "report_worker_liveness": ("ReportWorkerLivenessRequest", "Empty"),
    "lease_steps": ("LeaseStepsRequest", "LeaseStepsResponse"),
    "report_lease": ("ReportLeaseRequest", "Empty"),
    "get_world_hint": ("GetWorldHintRequest", "WorldHintResponse"),
    "pull_model": ("PullDenseParametersRequest", "Model"),
    "push_model": ("Model", "Empty"),
    "push_embedding_table_infos": ("Model", "Empty"),
    "pull_dense_parameters": ("PullDenseParametersRequest",
                              "PullDenseParametersResponse"),
    "pull_embedding_vectors": ("PullEmbeddingVectorsRequest", "Tensor"),
    "pull_embedding_table": ("PullEmbeddingTableRequest", "IndexedSlices"),
    "push_gradients": ("PushGradientsRequest", "PushGradientsResponse"),
    "push_gradients_packed": ("PushGradientsPackedRequest",
                              "PushGradientsResponse"),
}


@pytest.fixture(autouse=True)
def _fast_rpc_config(monkeypatch):
    """Small backoffs so the retry cases run in milliseconds; restore the
    process-wide policy cache afterwards."""
    monkeypatch.setenv("ELASTICDL_RPC_BACKOFF_BASE", "0.01")
    monkeypatch.setenv("ELASTICDL_RPC_BACKOFF_MAX", "0.05")
    rpc.reload_config()
    yield
    monkeypatch.undo()
    rpc.reload_config()


def _pb2_bytes(case):
    cls_name, values = CASES[case]
    return _build(pb2, cls_name, values).SerializeToString()


class _Recorder:
    """Answers every method with its case's response; records what each
    handler received, as bytes."""

    def __init__(self):
        self.received = {}

    def __getattr__(self, method):
        spec = {**rpc.MASTER_SERVICE.methods, **rpc.PSERVER_SERVICE.methods,
                **rpc.COLLECTIVE_SERVICE.methods}
        _, resp_cls = spec[method]

        def handler(request, context):
            self.received[method] = request.SerializeToString()
            return resp_cls.FromString(_pb2_bytes(METHOD_CASES[method][1]))

        return handler


class FlakyPserver:
    """Counts calls; fails the first `fail_n` of each method with `code`
    (tests/test_rpc_resilience.py's, on the port's status codes)."""

    def __init__(self, fail_n=0, code=rpc.StatusCode.UNAVAILABLE,
                 sleep_s=0.0):
        self.calls = {}
        self.fail_n = fail_n
        self.code = code
        self.sleep_s = sleep_s

    def _maybe_fail(self, method, context):
        n = self.calls.get(method, 0)
        self.calls[method] = n + 1
        if self.sleep_s:
            time.sleep(self.sleep_s)
        if n < self.fail_n:
            context.abort(self.code, f"flaky {method} #{n}")

    def __getattr__(self, method):
        def handler(request, context):
            self._maybe_fail(method, context)
            if method == "pull_dense_parameters":
                return pb.PullDenseParametersResponse(
                    initialized=True, version=7,
                    dense_parameters=[tensor_utils.ndarray_to_tensor_pb(
                        np.arange(64, dtype=np.float32), "w")])
            if method == "pull_embedding_vectors":
                return tensor_utils.ndarray_to_tensor_pb(
                    np.ones((2, 4), dtype=np.float32))
            return rpc.PSERVER_SERVICE.methods[method][1]()

        if method.startswith("_"):
            raise AttributeError(method)
        return handler


def _counter_value(name, **labels):
    metric = default_registry().get(name)
    if metric is None:
        return 0.0
    child = metric.labels(**labels) if labels else metric
    return child.value


def _stub_to(port, spec=rpc.PSERVER_SERVICE, **kw):
    return rpc.Stub(rpc.build_channel(f"127.0.0.1:{port}", **kw), spec)


@pytest.fixture
def served():
    """serve(servicer, spec, **kw) -> port; every server stops after the
    test."""
    servers = []

    def start(servicer, spec=rpc.PSERVER_SERVICE, **kw):
        server, port = rpc.serve(servicer, spec, **kw)
        servers.append(server)
        return port

    yield start
    for server in servers:
        server.stop(0)


# ---------- the wire: bytes and status codes ----------


@pytest.mark.parametrize("spec", [rpc.MASTER_SERVICE, rpc.PSERVER_SERVICE,
                                  rpc.COLLECTIVE_SERVICE],
                         ids=["master", "pserver", "collective"])
def test_every_method_carries_pb2_bytes_across_the_socket(spec, served):
    recorder = _Recorder()
    stub = _stub_to(served(recorder, spec), spec)
    for method, (req_cls, _) in spec.methods.items():
        req_case, resp_case = METHOD_CASES[method]
        request = req_cls.FromString(_pb2_bytes(req_case))
        response = getattr(stub, method)(request)
        assert recorder.received[method] == _pb2_bytes(req_case), method
        assert response.SerializeToString() == _pb2_bytes(resp_case), method
        future = getattr(stub, method).future(request)
        assert future.result().SerializeToString() == _pb2_bytes(resp_case)
    jax_spec = {"elasticdl_tpu.Master": jax_rpc.MASTER_SERVICE,
                "elasticdl_tpu.Pserver": jax_rpc.PSERVER_SERVICE,
                "elasticdl_tpu.Collective": jax_rpc.COLLECTIVE_SERVICE}[
                    spec.name]
    assert set(spec.methods) <= set(jax_spec.methods)


def test_packed_push_round_trip(served):
    """A tensor_utils.PackedPushRequest goes out as its header and payload
    views and arrives as the PushGradientsPackedRequest they encode."""
    got = {}

    class Shard(FlakyPserver):
        def push_gradients_packed(self, request, context):
            got["request"] = request
            return pb.PushGradientsResponse(accepted=True, version=1)

    rng = np.random.default_rng(0)
    dense = rng.normal(size=(300, 257)).astype(np.float32)
    payload = tensor_utils.PackedPayload()
    header = pb.PushGradientsPackedRequest(version=3, batch_size=8)
    header.dense.append(tensor_utils.pack_tensor_span("w", dense, payload))
    request = tensor_utils.PackedPushRequest(
        header, payload.parts, payload.nbytes)
    stub = _stub_to(served(Shard()))
    assert stub.push_gradients_packed(request).accepted
    received = got["request"]
    assert received.SerializeToString() == request.SerializeToString()
    np.testing.assert_array_equal(
        tensor_utils.unpack_tensor_span(received.dense[0], received.payload),
        dense)


def test_handler_exception_is_unknown_and_missing_method_unimplemented(
        served):
    class Broken(FlakyPserver):
        def push_model(self, request, context):
            raise ValueError("boom")

    port = served(Broken())
    with pytest.raises(rpc.RpcError) as err:
        _stub_to(port).push_model(pb.Model())
    assert err.value.code() == rpc.StatusCode.UNKNOWN
    assert "Exception calling application: boom" in err.value.details()
    with pytest.raises(rpc.RpcError) as err:
        _stub_to(port, rpc.MASTER_SERVICE).get_task(pb.GetTaskRequest())
    assert err.value.code() == rpc.StatusCode.UNIMPLEMENTED


def test_messages_over_the_cap_are_resource_exhausted(served, monkeypatch):
    servicer = FlakyPserver()
    stub = _stub_to(served(servicer))
    monkeypatch.setattr(rpc, "MAX_MESSAGE_LENGTH", 1024)
    big = pb.Model(dense_parameters=[tensor_utils.ndarray_to_tensor_pb(
        np.zeros(512, np.float32), "w")])
    with pytest.raises(rpc.RpcError) as err:  # the request, client side
        stub.push_model(big)
    assert err.value.code() == rpc.StatusCode.RESOURCE_EXHAUSTED
    assert "push_model" not in servicer.calls  # refused before the wire
    servicer_big = FlakyPserver()
    servicer_big.pull_embedding_vectors = (
        lambda request, context: tensor_utils.ndarray_to_tensor_pb(
            np.zeros((64, 8), np.float32)))
    with pytest.raises(rpc.RpcError) as err:  # the response, server side
        _stub_to(served(servicer_big)).pull_embedding_vectors(
            pb.PullEmbeddingVectorsRequest())
    assert err.value.code() == rpc.StatusCode.RESOURCE_EXHAUSTED
    assert "Sent message larger than max" in err.value.details()


def test_flagship_evaluation_report_is_refused_at_the_256mb_cap(served):
    """The flagship's evaluation minibatch reports [4, 4096, 32768] float32
    logits, 2 GiB: over the JAX package's 256 MB cap, so the transport
    refuses it with RESOURCE_EXHAUSTED, as gRPC does. The logits are an
    untouched anonymous mapping: nothing is allocated or copied."""
    assert rpc.MAX_MESSAGE_LENGTH == jax_rpc.MAX_MESSAGE_LENGTH
    servicer = FlakyPserver()

    class Master:
        def __getattr__(self, method):
            return getattr(servicer, method)

    stub = _stub_to(served(Master(), rpc.MASTER_SERVICE), rpc.MASTER_SERVICE)
    logits = mmap.mmap(-1, 4 * 4096 * 32768 * 4)
    report = pb.ReportEvaluationMetricsRequest(
        model_outputs=[pb.Tensor(dims=[4, 4096, 32768], dtype=pb.DT_FLOAT32,
                                 content=memoryview(logits))],
        labels=tensor_utils.ndarray_to_tensor_pb(
            np.zeros((4, 4096), np.int32)),
        worker_id=0)
    with pytest.raises(rpc.RpcError) as err:
        stub.report_evaluation_metrics(report)
    assert err.value.code() == rpc.StatusCode.RESOURCE_EXHAUSTED
    assert servicer.calls == {}


def test_slow_handler_is_deadline_exceeded_and_stopped_server_unavailable(
        monkeypatch):
    monkeypatch.setenv("ELASTICDL_RPC_MAX_ATTEMPTS", "1")
    rpc.reload_config()
    server, port = rpc.serve(FlakyPserver(sleep_s=0.3), rpc.PSERVER_SERVICE)
    stub = _stub_to(port)
    with pytest.raises(rpc.RpcError) as err:
        stub.pull_dense_parameters(pb.PullDenseParametersRequest(),
                                   timeout=0.05)
    assert err.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
    assert stub.pull_dense_parameters(
        pb.PullDenseParametersRequest()).version == 7
    server.stop(0)
    with pytest.raises(rpc.RpcError) as err:
        stub.pull_dense_parameters(pb.PullDenseParametersRequest())
    assert err.value.code() == rpc.StatusCode.UNAVAILABLE


def test_wait_channel_ready_spans_a_late_bind():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    servicer = FlakyPserver()
    started = {}

    def bind_later():
        time.sleep(0.5)
        started["server"], _ = rpc.serve(servicer, rpc.PSERVER_SERVICE,
                                         port=port)

    t = threading.Thread(target=bind_later)
    t.start()
    try:
        start = time.time()
        assert rpc.wait_channel_ready(f"127.0.0.1:{port}", timeout=10)
        assert time.time() - start >= 0.4  # really waited for the bind
        _stub_to(port, ready_timeout=0).push_model(pb.Model())
    finally:
        t.join(timeout=10)
        started["server"].stop(0)
    assert rpc.wait_channel_ready(
        "127.0.0.1:1", timeout=30, abort_check=lambda: True) is False


# ---------- policies, backoff, breaker: equal to the JAX module's ----------


def _policy_fields(policy):
    fields = dataclasses.asdict(policy)
    fields["retryable_codes"] = sorted(c.name for c in policy.retryable_codes)
    return fields


@pytest.mark.parametrize("env", [
    {},
    {"ELASTICDL_RPC_DEADLINES": '{"get_task": 3.5, "push_model": 7}',
     "ELASTICDL_RPC_MAX_ATTEMPTS": "3",
     "ELASTICDL_RPC_BACKOFF_BASE": "0.5",
     "ELASTICDL_RPC_BACKOFF_MAX": "2.5"},
], ids=["defaults", "overrides"])
def test_policies_equal_jax_for_every_spec_method(env, monkeypatch):
    for name in ("ELASTICDL_RPC_BACKOFF_BASE", "ELASTICDL_RPC_BACKOFF_MAX"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rpc.reload_config()
    jax_rpc.reload_config()
    try:
        methods = [f"/{spec.name}/{m}"
                   for spec in (rpc.MASTER_SERVICE, rpc.PSERVER_SERVICE,
                                rpc.COLLECTIVE_SERVICE)
                   for m in spec.methods]
        assert set(rpc.METHOD_POLICIES) == {
            m.rsplit("/", 1)[-1] for m in methods}
        for method in methods:
            assert _policy_fields(rpc.policy_for(method)) == _policy_fields(
                jax_rpc.policy_for(method)), method
    finally:
        monkeypatch.undo()
        jax_rpc.reload_config()


def test_backoff_sequences_equal_jax():
    for policy_name in ("get_task", "push_gradients", "report_telemetry"):
        ours = rpc.METHOD_POLICIES[policy_name]
        theirs = jax_rpc.METHOD_POLICIES[policy_name]
        a = [ours.backoff(i, random.Random(42)) for i in range(8)]
        b = [theirs.backoff(i, random.Random(42)) for i in range(8)]
        assert a == b
        rng_a, rng_b = random.Random(7), random.Random(7)
        assert [ours.backoff(i, rng_a) for i in range(8)] == [
            theirs.backoff(i, rng_b) for i in range(8)]
    policy = rpc.RetryPolicy(backoff_base=0.1, backoff_multiplier=2.0,
                             backoff_max=0.5, jitter=0.5)
    for i, delay in enumerate(policy.backoff(i, random.Random(3))
                              for i in range(6)):
        full = min(0.5, 0.1 * 2.0**i)
        assert 0.5 * full <= delay <= full  # jitter only shrinks


def test_breaker_transitions_equal_jax_under_a_patched_clock(monkeypatch):
    clock = {"now": 1000.0}
    monkeypatch.setattr(time, "time", lambda: clock["now"])
    ours = rpc.CircuitBreaker("peer", threshold=3, cooldown=5.0)
    theirs = jax_rpc.CircuitBreaker("peer", threshold=3, cooldown=5.0)
    ops = ["fail", "fail", "ok", "fail", "fail", "fail", "allow", "tick:2",
           "allow", "tick:3.5", "allow", "allow", "fail", "allow",
           "tick:6", "allow", "tick:6", "allow", "ok", "allow", "fail"]
    trail = {"ours": [], "theirs": []}
    for op in ops:
        if op.startswith("tick:"):
            clock["now"] += float(op[5:])
            continue
        for name, breaker in (("ours", ours), ("theirs", theirs)):
            if op == "fail":
                out = breaker.record_failure()
            elif op == "ok":
                out = breaker.record_success()
            else:
                out = breaker.allow()
            trail[name].append((op, out, breaker.state))
    assert trail["ours"] == trail["theirs"]
    assert ("allow", False, "open") in trail["ours"]
    assert ("allow", True, "half_open") in trail["ours"]


def test_push_gradients_does_not_retry_deadline():
    policy = rpc.policy_for("/elasticdl_tpu.Pserver/push_gradients")
    assert policy.retryable(rpc.StatusCode.UNAVAILABLE)
    assert not policy.retryable(rpc.StatusCode.DEADLINE_EXCEEDED)


def test_retry_on_unavailable_then_success(served):
    servicer = FlakyPserver(fail_n=2)
    stub = _stub_to(served(servicer))
    before = _counter_value("edl_rpc_retries_total", method="push_model")
    stub.push_model(pb.Model(version=1))
    assert servicer.calls["push_model"] == 3  # 2 failures + success
    after = _counter_value("edl_rpc_retries_total", method="push_model")
    assert after - before == 2


def test_future_path_retries_lazily(served):
    servicer = FlakyPserver(fail_n=1)
    stub = _stub_to(served(servicer))
    future = stub.pull_dense_parameters.future(
        pb.PullDenseParametersRequest())
    res = future.result()
    assert res.initialized and res.version == 7
    assert servicer.calls["pull_dense_parameters"] == 2


def test_invalid_argument_fails_fast(served):
    servicer = FlakyPserver(fail_n=10**9,
                            code=rpc.StatusCode.INVALID_ARGUMENT)
    stub = _stub_to(served(servicer))
    with pytest.raises(rpc.RpcError) as err:
        stub.push_model(pb.Model())
    assert err.value.code() == rpc.StatusCode.INVALID_ARGUMENT
    assert servicer.calls["push_model"] == 1  # no retries burned


def test_deadline_exceeded_retries_then_raises(monkeypatch, served):
    monkeypatch.setenv("ELASTICDL_RPC_DEADLINES",
                       '{"pull_dense_parameters": 0.15}')
    monkeypatch.setenv("ELASTICDL_RPC_MAX_ATTEMPTS", "3")
    rpc.reload_config()
    stub = _stub_to(served(FlakyPserver(sleep_s=0.5)))
    before = _counter_value("edl_rpc_retries_total",
                            method="pull_dense_parameters")
    with pytest.raises(rpc.RpcError) as err:
        stub.pull_dense_parameters(pb.PullDenseParametersRequest())
    assert err.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
    after = _counter_value("edl_rpc_retries_total",
                           method="pull_dense_parameters")
    assert after - before == 2  # 3 attempts = 2 retries


def test_explicit_timeout_wins_over_policy_default(served):
    stub = _stub_to(served(FlakyPserver(sleep_s=0.4)))
    start = time.time()
    with pytest.raises(rpc.RpcError) as err:
        # push_gradients: deadline not retryable, so one attempt.
        stub.push_gradients(pb.PushGradientsRequest(), timeout=0.1)
    assert err.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
    assert time.time() - start < 2.0


def test_breaker_trips_fast_fails_and_half_opens(monkeypatch, served):
    monkeypatch.setenv("ELASTICDL_RPC_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("ELASTICDL_RPC_BREAKER_COOLDOWN", "0.3")
    monkeypatch.setenv("ELASTICDL_RPC_MAX_ATTEMPTS", "1")
    rpc.reload_config()
    servicer = FlakyPserver(fail_n=10**9)
    port = served(servicer)
    stub = _stub_to(port)
    for _ in range(3):
        with pytest.raises(rpc.RpcError):
            stub.push_model(pb.Model())
    breaker = rpc.breaker_for(f"127.0.0.1:{port}")
    assert breaker.state == rpc.CircuitBreaker.OPEN
    seen = servicer.calls["push_model"]
    with pytest.raises(rpc.CircuitOpenError):
        stub.push_model(pb.Model())
    assert servicer.calls["push_model"] == seen
    # The future path fails its future instead of raising at creation.
    future = stub.push_model.future(pb.Model())
    with pytest.raises(rpc.CircuitOpenError):
        future.result()
    assert servicer.calls["push_model"] == seen
    servicer.fail_n = 0
    time.sleep(0.35)
    stub.push_model(pb.Model())
    assert breaker.state == rpc.CircuitBreaker.CLOSED


def test_half_open_probe_with_answered_error_closes(monkeypatch, served):
    monkeypatch.setenv("ELASTICDL_RPC_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("ELASTICDL_RPC_BREAKER_COOLDOWN", "0.2")
    monkeypatch.setenv("ELASTICDL_RPC_MAX_ATTEMPTS", "1")
    rpc.reload_config()
    servicer = FlakyPserver(fail_n=2)
    port = served(servicer)
    breaker = rpc.breaker_for(f"127.0.0.1:{port}")
    stub = _stub_to(port)
    for _ in range(2):
        with pytest.raises(rpc.RpcError):
            stub.push_model(pb.Model())
    assert breaker.state == rpc.CircuitBreaker.OPEN
    time.sleep(0.25)
    servicer.code = rpc.StatusCode.INVALID_ARGUMENT
    servicer.fail_n = 10**9
    with pytest.raises(rpc.RpcError):
        stub.push_model(pb.Model())  # the half-open probe: answered
    assert breaker.state == rpc.CircuitBreaker.CLOSED
    seen = servicer.calls["push_model"]
    with pytest.raises(rpc.RpcError) as err:
        stub.push_model(pb.Model())
    assert err.value.code() == rpc.StatusCode.INVALID_ARGUMENT
    assert servicer.calls["push_model"] == seen + 1


# ---------- tracing across the socket ----------


def test_server_span_is_the_child_of_the_client_context(tmp_path, served):
    recorder = tracing.SpanRecorder(str(tmp_path / "trace.jsonl"), "test")
    tracing.set_recorder(recorder)
    try:
        stub = _stub_to(served(FlakyPserver()))
        ctx = tracing.set_context(task_id=41, job="job-a")
        ctx.span_id = "span-7"
        stub.push_model(pb.Model())
        stub.pull_dense_parameters.future(
            pb.PullDenseParametersRequest()).result()
    finally:
        tracing.set_recorder(None)
        recorder.close()
        tracing._context.set(None)
    import json

    spans = [json.loads(line) for line in open(tmp_path / "trace.jsonl")]
    spans = [s for s in spans if s.get("ph") == "X"]
    by_name = {s["name"]: s["args"] for s in spans}
    for method in ("push_model", "pull_dense_parameters"):
        server = by_name[f"rpc_server/elasticdl_tpu.Pserver/{method}"]
        client = by_name[f"rpc_client/elasticdl_tpu.Pserver/{method}"]
        assert server["trace_id"] == client["trace_id"] == ctx.trace_id
        assert server["task_id"] == client["task_id"] == 41
        assert server["job"] == "job-a"
        assert client["code"] == "OK" and client["sent"] >= 0
    ours = tracing.TraceContext(trace_id="abc", span_id="s", job="j",
                                task_id=3, lease_epoch=2)
    theirs = jax_tracing.TraceContext(trace_id="abc", span_id="s", job="j",
                                      task_id=3, lease_epoch=2)
    token = tracing._context.set(ours)
    jax_token = jax_tracing._context.set(theirs)
    try:
        md = tracing.inject([("x", "1")])
        assert md == jax_tracing._inject([("x", "1")])
    finally:
        tracing._context.reset(token)
        jax_tracing._context.reset(jax_token)
    back = tracing.context_from_metadata(md)
    jax_back = jax_tracing.context_from_metadata(md)
    assert back.args() == jax_back.args()
    assert back.span_id == jax_back.span_id == "s"


# ---------- chaos on the socket ----------


def test_chaos_decisions_equal_jax_in_the_same_call_order():
    rules = [
        {"method": "pull", "kind": "unavailable", "start": 1, "count": 2},
        {"method": "", "kind": "latency", "latency_s": 0.2, "start": 3,
         "count": 2, "side": "client"},
        {"method": "push", "kind": "truncate", "start": 0, "count": 1},
        {"method": "get_task", "kind": "deadline", "side": "client"},
    ]
    calls = ["pull_a", "push_b", "pull_a", "pull_c", "push_b", "pull_a",
             "get_task", "get_task"]

    def run(schedule):
        decisions, jitters = [], []
        for method in calls:
            for side in ("server", "client"):
                for rule in schedule.decide(method, side):
                    decisions.append((method, side, rule.kind))
                    if rule.kind == "latency":
                        jitters.append(schedule.jitter(rule))
        return decisions, jitters

    ours = run(FaultSchedule(rules, seed=99))
    theirs = run(jax_injection.FaultSchedule(rules, seed=99))
    assert ours == theirs
    assert ("pull_a", "server", "unavailable") in ours[0]


def test_chaos_server_unavailable_is_retried_through(served):
    schedule = FaultSchedule([{"method": "pull_dense_parameters",
                               "kind": "unavailable", "start": 0,
                               "count": 2}])
    stub = _stub_to(served(FlakyPserver(), chaos=schedule))
    before = _counter_value("edl_chaos_injected_total", kind="unavailable",
                            side="server")
    res = stub.pull_dense_parameters(pb.PullDenseParametersRequest())
    assert res.version == 7  # the retry plane rode out the window
    assert _counter_value("edl_chaos_injected_total", kind="unavailable",
                          side="server") - before == 2


def test_chaos_client_unavailable_injection(served):
    schedule = FaultSchedule([{"method": "push_model", "kind": "unavailable",
                               "start": 0, "count": 1, "side": "client"}])
    servicer = FlakyPserver()
    stub = _stub_to(served(servicer), chaos=schedule)
    stub.push_model(pb.Model())  # the retry absorbs the injected fault
    assert servicer.calls["push_model"] == 1  # the wire saw only the retry


def test_chaos_truncation_surfaces_as_failure_then_recovers(served):
    schedule = FaultSchedule([{"method": "pull_dense_parameters",
                               "kind": "truncate", "start": 0, "count": 1}])
    stub = _stub_to(served(FlakyPserver(), chaos=schedule))
    with pytest.raises(rpc.RpcError) as err:
        stub.pull_dense_parameters(pb.PullDenseParametersRequest())
    assert err.value.code() == rpc.StatusCode.INTERNAL  # fail-fast
    res = stub.pull_dense_parameters(pb.PullDenseParametersRequest())
    assert res.version == 7


def test_chaos_deadline_kinds(monkeypatch, served):
    monkeypatch.setenv("ELASTICDL_RPC_MAX_ATTEMPTS", "2")
    rpc.reload_config()
    client = FaultSchedule([{"method": "pull_dense_parameters",
                             "kind": "deadline", "start": 0, "count": 10,
                             "side": "client"}])
    stub = _stub_to(served(FlakyPserver(sleep_s=0.2)), chaos=client)
    with pytest.raises(rpc.RpcError) as err:
        stub.pull_dense_parameters(pb.PullDenseParametersRequest())
    assert err.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
    # Server side: the handler sleeps past the caller's deadline (one
    # attempt: push_gradients does not retry a deadline).
    server = FaultSchedule([{"method": "push_gradients", "kind": "deadline",
                             "start": 0, "count": 1}])
    stub = _stub_to(served(FlakyPserver(), chaos=server))
    start = time.time()
    with pytest.raises(rpc.RpcError) as err:
        stub.push_gradients(pb.PushGradientsRequest(), timeout=0.1)
    assert err.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
    assert time.time() - start < 1.0
    assert injection.KINDS == jax_injection.KINDS
