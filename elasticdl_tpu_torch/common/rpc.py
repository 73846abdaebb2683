"""Service tables, the socket transport, the resilient call plane and the
in-process stub (counterpart of elasticdl_tpu/common/rpc.py).

Each service is declared once as a ServiceSpec table: method name ->
(request class, response class). Two transports serve the same tables.

`InProcessStub(servicer, spec)` calls a servicer in this process. It still
crosses the wire format where a channel would: the request is serialized and
parsed back before the handler sees it, and the response is serialized and
parsed back before the caller does, so both sides only ever share bytes. Its
handler is looked up at each call, so a servicer object can hand calls on to
whichever server currently holds its place (a relaunched shard behind the
same stub).

Across processes, `serve(servicer, spec, port)` and
`Stub(build_channel(addr), spec)` speak length-prefixed frames over TCP,
built from the standard library (the card's machine has neither grpcio nor
protobuf). The message bytes are those of `proto/messages.py`, which are
the bytes `elasticdl_tpu_pb2` writes; only the framing around them is the
port's own:

    frame    = [u32 head_len][u64 body_len][head][body]
    request  head = [f64 timeout, <0: none][str method path]
                    [str key, str value] per metadata pair
    response head = [u32 status code][str details]
    str      = [u32 len][utf-8]

One connection carries one call at a time; a channel keeps a small pool of
idle connections and opens another for each concurrent call, so `.future`
fan-outs (FUTURE_THREADS per channel) run side by side. There is no HTTP/2,
no TLS and no compression. A server runs one thread per connection and at
most `max_workers` handlers at once, and hands each handler a context with
`abort`, `time_remaining` and `invocation_metadata`. A request or response
larger than MAX_MESSAGE_LENGTH is refused with RESOURCE_EXHAUSTED, as gRPC
refuses it.

Every channel built here is hardened as the JAX package's is:

- per-method deadlines: a call with no explicit timeout gets the method's
  default from METHOD_POLICIES;
- retries: jittered exponential backoff on retryable statuses (UNAVAILABLE
  always; DEADLINE_EXCEEDED only for idempotent methods: a timed-out
  gradient push may have applied server-side and must not double-apply);
  INVALID_ARGUMENT and friends fail fast;
- circuit breaker: per peer, trips after consecutive connectivity failures,
  fails fast while open, half-opens on a timer with a single probe;
- channel-readiness wait: build_channel TCP-probes the peer first;
- tracing: each attempt carries the caller's trace context in its metadata
  and records a client span; the server runs the handler under it and
  records a server span (observability/tracing.py);
- fault injection: with a chaos schedule (argument or ELASTICDL_CHAOS),
  serve() and build_channel() apply the seeded faults of chaos/injection.py.

Retry and trip counts export through the process metrics registry:
edl_rpc_retries_total, edl_rpc_client_failures_total,
edl_rpc_breaker_trips_total, edl_rpc_breaker_fast_fail_total.
"""

import concurrent.futures
import contextlib
import contextvars
import dataclasses
import enum
import json
import random
import socket
import struct
import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("common.rpc")

# The JAX package's (and the reference's) 256 MB message cap.
MAX_MESSAGE_LENGTH = 256 * 1024 * 1024


class StatusCode(enum.Enum):
    """The gRPC status codes the port raises or branches on, with gRPC's
    numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    RESOURCE_EXHAUSTED = 8
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14


_CODES = {c.value: c for c in StatusCode}


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


class CircuitOpenError(RpcError):
    def __init__(self, peer, method):
        super().__init__(
            StatusCode.UNAVAILABLE,
            f"circuit breaker open for peer {peer} (method {method})",
        )
        self.peer = peer


_REG = default_registry()
_RETRIES = _REG.counter(
    "edl_rpc_retries_total",
    "RPC attempts retried after a retryable failure",
    labelnames=("method",),
)
_FAILURES = _REG.counter(
    "edl_rpc_client_failures_total",
    "Terminal client-side RPC failures (retries exhausted or fail-fast)",
    labelnames=("method", "code"),
)
_TRIPS = _REG.counter(
    "edl_rpc_breaker_trips_total",
    "Circuit-breaker trips (closed/half-open -> open)",
    labelnames=("peer",),
)
_FAST_FAILS = _REG.counter(
    "edl_rpc_breaker_fast_fail_total",
    "Calls rejected locally because the peer's circuit was open",
    labelnames=("peer",),
)


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
        "report_telemetry": (
            pb.ReportTelemetryRequest, pb.ReportTelemetryResponse,
        ),
        # Elastic AllReduce: membership (with the join gate), liveness,
        # step leases and the world hint.
        "get_comm_rank": (pb.GetCommRankRequest, pb.GetCommRankResponse),
        "report_worker_liveness": (
            pb.ReportWorkerLivenessRequest, pb.Empty,
        ),
        "lease_steps": (pb.LeaseStepsRequest, pb.LeaseStepsResponse),
        "report_lease": (pb.ReportLeaseRequest, pb.Empty),
        "get_world_hint": (pb.GetWorldHintRequest, pb.WorldHintResponse),
    },
)

# Every AllReduce worker serves its (variables, opt_state, version) here;
# a regrouping rank pulls rank 0's (parallel/broadcast.py).
COLLECTIVE_SERVICE = ServiceSpec(
    name="elasticdl_tpu.Collective",
    methods={"pull_model": (pb.PullDenseParametersRequest, pb.Model)},
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

# Threads per stub (in process) or channel for `.future` calls: enough for a
# client's fan-out of pulls and a chunked push to one servicer to run side
# by side.
FUTURE_THREADS = 4


# ---------- retry policy ----------

_RETRYABLE = (StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED)
# Connectivity-only: non-idempotent methods must not replay a call that may
# have applied server-side before its deadline fired.
_RETRYABLE_CONNECTIVITY = (StatusCode.UNAVAILABLE,)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deadline + retry classification for one RPC method."""

    deadline: float = 30.0
    max_attempts: int = 5
    backoff_base: float = 0.2
    backoff_multiplier: float = 2.0
    backoff_max: float = 5.0
    jitter: float = 0.5  # fraction of each backoff randomized away
    retryable_codes: tuple = _RETRYABLE

    def retryable(self, code):
        return code in self.retryable_codes

    def backoff(self, attempt, rng):
        """Sleep before retry number `attempt` (0-based). Full backoff minus
        a jittered fraction, so a fleet of workers hitting one restarted
        peer doesn't re-dogpile it in lockstep."""
        base = min(
            self.backoff_max,
            self.backoff_base * self.backoff_multiplier**attempt,
        )
        return base * (1.0 - self.jitter * rng.random())


# The JAX package's per-method matrix, for the methods the port's services
# declare.
METHOD_POLICIES = {
    # Master service: small control messages; get_task answers WAIT rather
    # than blocking, so short deadlines are safe.
    "get_task": RetryPolicy(deadline=30.0),
    # Batched leases share get_task's semantics.
    "get_task_batch": RetryPolicy(deadline=30.0),
    "report_task_result": RetryPolicy(deadline=30.0),
    # Duplicate reports are absorbed server-side, so the batch report
    # retries like the single-task one.
    "report_task_results": RetryPolicy(deadline=30.0),
    "report_evaluation_metrics": RetryPolicy(deadline=60.0),
    "report_version": RetryPolicy(deadline=30.0),
    "get_comm_rank": RetryPolicy(deadline=30.0),
    "lease_steps": RetryPolicy(deadline=30.0),
    "report_lease": RetryPolicy(deadline=30.0),
    "report_worker_liveness": RetryPolicy(deadline=30.0),
    "get_job_status": RetryPolicy(deadline=15.0),
    # Hint polls are periodic and read-only; a missed poll self-heals on
    # the next interval, so don't burn retry budget.
    "get_world_hint": RetryPolicy(deadline=10.0, max_attempts=2),
    # Telemetry pushes are periodic and self-healing: one connectivity
    # retry, and a timed-out push (which may have applied and bumped the
    # seq server side) must NOT replay.
    "report_telemetry": RetryPolicy(
        deadline=15.0,
        max_attempts=2,
        retryable_codes=_RETRYABLE_CONNECTIVITY,
    ),
    # Pserver service: payload-bearing; pushes that time out may have
    # applied, so only UNAVAILABLE replays them.
    "push_model": RetryPolicy(deadline=120.0),
    "push_embedding_table_infos": RetryPolicy(deadline=60.0),
    "pull_dense_parameters": RetryPolicy(deadline=60.0),
    "pull_embedding_vectors": RetryPolicy(deadline=60.0),
    "pull_embedding_table": RetryPolicy(deadline=120.0),
    "push_gradients": RetryPolicy(
        deadline=60.0, retryable_codes=_RETRYABLE_CONNECTIVITY
    ),
    # Same non-idempotence as push_gradients (a timed-out chunk may have
    # landed and counted toward the reassembly), with the same deadline.
    "push_gradients_packed": RetryPolicy(
        deadline=60.0, retryable_codes=_RETRYABLE_CONNECTIVITY
    ),
    # Collective service: a full model state pull during an elastic
    # regroup. A deadline is NOT retried: a wedged rank 0 must surface
    # after one budget, not five (broadcast.pull_state shares one budget
    # between the readiness probe and the call).
    "pull_model": RetryPolicy(
        deadline=120.0, retryable_codes=_RETRYABLE_CONNECTIVITY
    ),
}

# Environment overrides (read once; reload_config() re-reads — used by tests
# and by drills that shrink deadlines to force retries):
#   ELASTICDL_RPC_DEADLINES        JSON {method: seconds}
#   ELASTICDL_RPC_MAX_ATTEMPTS     int, all methods
#   ELASTICDL_RPC_BACKOFF_BASE     float, all methods
#   ELASTICDL_RPC_BACKOFF_MAX      float, all methods
#   ELASTICDL_RPC_BREAKER_THRESHOLD  int (<=0 disables the breaker)
#   ELASTICDL_RPC_BREAKER_COOLDOWN   float seconds
#   ELASTICDL_RPC_READY_TIMEOUT      float seconds (0 disables ready-wait)
_config_lock = threading.Lock()
_policy_cache = None


def _load_policies():
    policies = dict(METHOD_POLICIES)
    overrides = {}
    raw = knobs.raw("ELASTICDL_RPC_DEADLINES")
    if raw:
        try:
            overrides = {
                str(k): float(v) for k, v in json.loads(raw).items()
            }
        except (ValueError, AttributeError):
            logger.warning("Bad ELASTICDL_RPC_DEADLINES %r; ignored", raw)
    changes = {}
    for env, field, cast in (
        ("ELASTICDL_RPC_MAX_ATTEMPTS", "max_attempts", int),
        ("ELASTICDL_RPC_BACKOFF_BASE", "backoff_base", float),
        ("ELASTICDL_RPC_BACKOFF_MAX", "backoff_max", float),
    ):
        raw = knobs.raw(env)
        if raw:
            try:
                changes[field] = cast(raw)
            except ValueError:
                logger.warning("Bad %s %r; ignored", env, raw)
    for method, policy in list(policies.items()):
        per = dict(changes)
        if method in overrides:
            per["deadline"] = overrides[method]
        if per:
            policies[method] = dataclasses.replace(policy, **per)
    return policies


def policy_for(method):
    """RetryPolicy for a full ("/pkg.Service/name") or short method name."""
    global _policy_cache
    with _config_lock:
        if _policy_cache is None:
            _policy_cache = _load_policies()
        return _policy_cache.get(method.rsplit("/", 1)[-1], RetryPolicy())


def reload_config():
    """Re-read env overrides (tests / in-process drills). Live channels
    hold references to their peer's breaker, so breakers are re-tuned and
    reset IN PLACE — clearing the registry would split per-peer state
    between old channels and new ones."""
    global _policy_cache
    with _config_lock:
        _policy_cache = None
    threshold = knobs.get_int("ELASTICDL_RPC_BREAKER_THRESHOLD")
    cooldown = knobs.get_float("ELASTICDL_RPC_BREAKER_COOLDOWN")
    with _breakers_lock:
        for breaker in _breakers.values():
            with breaker._lock:
                breaker.threshold = threshold
                breaker.cooldown = cooldown
                breaker._state = CircuitBreaker.CLOSED
                breaker._failures = 0
                breaker._probing = False


def ready_timeout():
    """The channel-readiness probe budget (seconds) this process uses —
    the single accessor for ELASTICDL_RPC_READY_TIMEOUT, shared by
    build_channel and clients that probe on their own (PSClient)."""
    return knobs.get_float("ELASTICDL_RPC_READY_TIMEOUT")


# build_channel's `ready_timeout` PARAMETER shadows the accessor above;
# this alias keeps the accessor the single reader of the knob there.
_default_ready_timeout = ready_timeout


# ---------- circuit breaker ----------


class CircuitBreaker:
    """Per-peer consecutive-failure breaker.

    closed --(threshold consecutive connectivity failures)--> open
    open   --(cooldown elapsed)--> half-open (one probe admitted)
    half-open --probe success--> closed; --probe failure--> open again
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, peer, threshold=None, cooldown=None):
        self.peer = peer
        self.threshold = (
            threshold
            if threshold is not None
            else knobs.get_int("ELASTICDL_RPC_BREAKER_THRESHOLD")
        )
        self.cooldown = (
            cooldown
            if cooldown is not None
            else knobs.get_float("ELASTICDL_RPC_BREAKER_COOLDOWN")
        )
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0

    @property
    def state(self):
        with self._lock:
            return self._state

    def allow(self):
        """May a call proceed right now? Transitions open -> half-open when
        the cooldown has elapsed; half-open admits exactly one probe."""
        if self.threshold <= 0:  # breaker disabled
            return True
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if time.time() - self._opened_at < self.cooldown:
                    return False
                self._state = self.HALF_OPEN
                self._probing = True
                self._probe_started = time.time()
                logger.info("Circuit for %s half-open; probing", self.peer)
                return True
            # HALF_OPEN: one probe in flight at a time — but a probe whose
            # outcome never reached record_* must not wedge the breaker;
            # re-admit after a cooldown's worth of silence.
            if self._probing and (
                time.time() - self._probe_started < self.cooldown
            ):
                return False
            self._probing = True
            self._probe_started = time.time()
            return True

    def record_success(self):
        with self._lock:
            if self._state != self.CLOSED:
                logger.info("Circuit for %s closed again", self.peer)
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self):
        """One failed connectivity ATTEMPT (each retry counts, so
        `threshold` is consecutive failed attempts, not failed calls)."""
        if self.threshold <= 0:
            return
        with self._lock:
            self._failures += 1
            tripped = self._state == self.HALF_OPEN or (
                self._state == self.CLOSED
                and self._failures >= self.threshold
            )
            if tripped:
                self._state = self.OPEN
                self._opened_at = time.time()
                self._probing = False
                _TRIPS.labels(peer=self.peer).inc()
                logger.warning(
                    "Circuit for %s OPEN after %d consecutive failures "
                    "(cooldown %.1fs)",
                    self.peer,
                    self._failures,
                    self.cooldown,
                )


_breakers = {}
_breakers_lock = threading.Lock()


def breaker_for(peer):
    """The process-wide breaker for a peer address (shared by every channel
    to that peer)."""
    with _breakers_lock:
        breaker = _breakers.get(peer)
        if breaker is None:
            breaker = CircuitBreaker(peer)
            _breakers[peer] = breaker
        return breaker


# ---------- frames ----------

_PREFIX = struct.Struct("<IQ")  # head_len, body_len
_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")
# Small parts are joined before a send; larger ones go out as they are
# (payload views are never copied). Batches stay under the kernel's iovec
# limit.
_JOIN_BELOW = 64 * 1024
_IOV_BATCH = 512
# Idle connections a channel keeps for its next calls.
_MAX_IDLE = 8


def _pack_strs(strs):
    out = bytearray()
    for s in strs:
        raw = s.encode("utf-8")
        out += _U32.pack(len(raw))
        out += raw
    return out


def _unpack_strs(head, pos):
    out = []
    while pos < len(head):
        (n,) = _U32.unpack_from(head, pos)
        pos += 4
        out.append(bytes(head[pos:pos + n]).decode("utf-8"))
        pos += n
    return out


def _message_parts(message):
    """The message's encoding as a list of buffers, joined nowhere: a
    Message's field chunks, or a packed push's header and payload views."""
    parts = getattr(message, "serialize_parts", None)
    if parts is not None:
        return parts()
    return [message.SerializeToString()]


def _send_frame(sock, head, parts):
    body_len = sum(memoryview(p).nbytes for p in parts)
    views, small = [], []

    def flush_small():
        if small:
            views.append(memoryview(b"".join(small)))
            small.clear()

    small.append(_PREFIX.pack(len(head), body_len))
    small.append(bytes(head))
    for p in parts:
        view = memoryview(p).cast("B")
        if view.nbytes < _JOIN_BELOW:
            small.append(view)
        else:
            flush_small()
            views.append(view)
    flush_small()
    i = 0
    while i < len(views):
        sent = sock.sendmsg(views[i:i + _IOV_BATCH])
        while sent:
            n = views[i].nbytes
            if sent >= n:
                sent -= n
                i += 1
            else:
                views[i] = views[i][sent:]
                sent = 0


def _recv_into(sock, view):
    pos = 0
    while pos < len(view):
        n = sock.recv_into(view[pos:])
        if n == 0:
            raise ConnectionResetError("connection closed by peer")
        pos += n


def _recv_exact(sock, n):
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return buf


def _recv_head(sock):
    """-> (head bytes, body length), or None on a clean EOF before a
    frame."""
    prefix = bytearray(_PREFIX.size)
    view = memoryview(prefix)
    first = sock.recv_into(view)
    if first == 0:
        return None
    if first < _PREFIX.size:
        _recv_into(sock, view[first:])
    head_len, body_len = _PREFIX.unpack(prefix)
    return _recv_exact(sock, head_len), body_len


# ---------- server ----------


class _Abort(Exception):
    def __init__(self, code, details):
        super().__init__(details)
        self.code = code
        self.details = details


class ServicerContext:
    """What a handler gets beside its request, as a gRPC servicer context
    has it: `abort`, `time_remaining`, `invocation_metadata`."""

    def __init__(self, deadline, metadata):
        self._deadline = deadline
        self._metadata = metadata

    def abort(self, code, details=""):
        raise _Abort(code, details)

    def time_remaining(self):
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.time())

    def invocation_metadata(self):
        return self._metadata


class Server:
    """Serves the methods registered with `add_servicer_to_server` on the
    ports `add_insecure_port` binds: an accept thread, one thread per
    connection, at most `max_workers` handlers at once."""

    def __init__(self, max_workers=64, chaos=None):
        self._handlers = {}  # path -> (servicer method, req cls, resp cls)
        self._max_workers = max_workers
        self._inflight = 0  # handlers running
        self._inflight_cv = threading.Condition()
        self._chaos = chaos
        self._listeners = []
        self._threads = []
        self._conns = set()
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._local = threading.local()

    def add_handler(self, path, handler, req_cls, resp_cls):
        self._handlers[path] = (handler, req_cls, resp_cls)

    def add_insecure_port(self, address):
        """Binds "host:port" ("[::]:port" listens on every address, IPv6
        and IPv4 where the host has both); returns the bound port, 0 on
        failure."""
        host, _, port = address.rpartition(":")
        host = host.strip("[]")
        port = int(port)
        try:
            if host in ("::", ""):
                try:
                    sock = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
                    sock.setsockopt(
                        socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
                    sock.setsockopt(
                        socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    sock.bind(("::", port))
                except OSError:
                    sock.close()
                    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    sock.setsockopt(
                        socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    sock.bind(("0.0.0.0", port))
            else:
                family = socket.AF_INET6 if ":" in host else socket.AF_INET
                sock = socket.socket(family, socket.SOCK_STREAM)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sock.bind((host, port))
        except OSError as e:
            logger.warning("Cannot bind %s: %s", address, e)
            return 0
        sock.listen(128)
        self._listeners.append(sock)
        return sock.getsockname()[1]

    def start(self):
        for sock in self._listeners:
            thread = threading.Thread(
                target=self._accept_loop, args=(sock,), daemon=True,
                name="edl-rpc-accept")
            thread.start()
            self._threads.append(thread)

    def _accept_loop(self, listener):
        while not self._stopped.is_set():
            try:
                conn, _ = listener.accept()
            except OSError:
                return  # the listener was closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stopped.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="edl-rpc-conn").start()

    def _serve_conn(self, conn):
        try:
            while not self._stopped.is_set():
                got = _recv_head(conn)
                if got is None:
                    return
                head, body_len = got
                if body_len > MAX_MESSAGE_LENGTH:
                    # The body is not read: answer and drop the connection.
                    self._reply(conn, StatusCode.RESOURCE_EXHAUSTED,
                                f"Received message larger than max "
                                f"({body_len} vs. {MAX_MESSAGE_LENGTH})")
                    return
                body = _recv_exact(conn, body_len)
                (timeout,) = _F64.unpack_from(head, 0)
                strs = _unpack_strs(head, _F64.size)
                deadline = time.time() + timeout if timeout >= 0 else None
                metadata = tuple(zip(strs[1::2], strs[2::2]))
                code, details, parts = self._handle(
                    strs[0], body, ServicerContext(deadline, metadata))
                self._reply(conn, code, details, parts)
        except OSError:
            return  # the client went away or stop() closed the connection
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    @staticmethod
    def _reply(conn, code, details, parts=()):
        head = _U32.pack(code.value) + _pack_strs([details])
        _send_frame(conn, head, list(parts))

    def _handle(self, path, body, context):
        """-> (status code, details, response parts)."""
        entry = self._handlers.get(path)
        if entry is None:
            return StatusCode.UNIMPLEMENTED, f"Method not found: {path}", ()
        handler, req_cls, resp_cls = entry
        try:
            request = req_cls.FromString(body)
        except pb.DecodeError as e:
            return StatusCode.INTERNAL, f"Exception deserializing request: {e}", ()
        self._local.truncate = False
        with self._running():
            try:
                response = tracing.serve_traced(
                    path, context.invocation_metadata(),
                    lambda: self._chaotic(path, handler, request, context))
            except _Abort as e:
                return e.code, e.details, ()
            except Exception as e:  # the servicer's failure, as gRPC reports it
                logger.exception("Exception calling application %s", path)
                return (StatusCode.UNKNOWN,
                        f"Exception calling application: {e}", ())
        parts = _message_parts(response)
        size = sum(memoryview(p).nbytes for p in parts)
        if self._local.truncate:
            data = b"".join(parts)
            parts = [data[: len(data) // 2]]
        elif size > MAX_MESSAGE_LENGTH:
            return (StatusCode.RESOURCE_EXHAUSTED,
                    f"Sent message larger than max ({size} vs. "
                    f"{MAX_MESSAGE_LENGTH})", ())
        return StatusCode.OK, "", parts

    @contextlib.contextmanager
    def _running(self):
        """One handler slot of max_workers, held while the body runs."""
        with self._inflight_cv:
            self._inflight_cv.wait_for(
                lambda: self._inflight < self._max_workers)
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _chaotic(self, path, handler, request, context):
        """The handler under the server's chaos schedule (none: as is)."""
        schedule = self._chaos
        if schedule is not None:
            from elasticdl_tpu_torch.chaos import injection

            kinds = injection.server_faults(schedule, path, context)
            if "truncate" in kinds:
                self._local.truncate = True
        return handler(request, context)

    def stop(self, grace=None):
        """Closes the listeners and every connection (after `grace` seconds
        for handlers in flight)."""
        self._stopped.set()
        for sock in self._listeners:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        if grace:
            with self._inflight_cv:
                self._inflight_cv.wait_for(
                    lambda: self._inflight == 0, timeout=grace)
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for thread in self._threads:
            thread.join(timeout=5.0)


def add_servicer_to_server(servicer, spec: ServiceSpec, server: Server):
    """Register servicer methods (matched by name) for the spec's service."""
    for method, (req_cls, resp_cls) in spec.methods.items():
        server.add_handler(f"/{spec.name}/{method}",
                           getattr(servicer, method), req_cls, resp_cls)


def _chaos_schedule(chaos):
    if chaos is not None:
        return chaos
    from elasticdl_tpu_torch.chaos import injection

    return injection.schedule_from_env()


def build_server(max_workers: int = 64, chaos=None) -> Server:
    return Server(max_workers, chaos=_chaos_schedule(chaos))


def serve(servicer, spec: ServiceSpec, port: int = 0, max_workers: int = 64,
          chaos=None):
    """Start a server for one servicer; returns (server, bound_port)."""
    server = build_server(max_workers, chaos=chaos)
    add_servicer_to_server(servicer, spec, server)
    bound = server.add_insecure_port(f"[::]:{port}")
    if bound == 0:
        raise RuntimeError(f"failed to bind the RPC server to port {port}")
    server.start()
    return server, bound


# ---------- client ----------


def _split_addr(addr):
    host, _, port = addr.rpartition(":")
    return (host.strip("[]") or "127.0.0.1"), int(port)


class Channel:
    """Connections to one peer: a pool of idle ones, another opened for
    each concurrent call; the peer's breaker, the retry plane and the
    client hooks (tracing, chaos) sit in its calls."""

    def __init__(self, addr, chaos=None, rng=None):
        self.addr = addr
        self._host, self._port = _split_addr(addr)
        self._idle = []
        self._lock = threading.Lock()
        self._closed = False
        # Starts no thread until the first `.future` call.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=FUTURE_THREADS, thread_name_prefix="edl-rpc")
        self.breaker = breaker_for(addr)
        self._rng = rng if rng is not None else random.Random()
        self._rng_lock = threading.Lock()
        self._chaos = chaos

    def unary_unary(self, path, response_deserializer):
        return _MultiCallable(self, path, response_deserializer)

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            sock.close()
        self._pool.shutdown(wait=False)

    # -- connections --

    def _checkout(self, timeout):
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "Channel closed")
            while self._idle:
                sock = self._idle.pop()
                # An idle connection with anything to read holds an EOF
                # (the peer restarted or closed it): drop it.
                try:
                    sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
                except BlockingIOError:
                    return sock
                except OSError:
                    pass
                sock.close()
        try:
            sock = socket.create_connection(
                (self._host, self._port),
                timeout=None if timeout is None else max(timeout, 1e-3))
        except socket.timeout:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded") from None
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"failed to connect to {self.addr}: {e}") from None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkin(self, sock):
        with self._lock:
            if not self._closed and len(self._idle) < _MAX_IDLE:
                self._idle.append(sock)
                return
        sock.close()

    def wire_call(self, path, parts, timeout, metadata):
        """One attempt on the wire -> the response body; raises RpcError
        with the status of a failed call."""
        size = sum(memoryview(p).nbytes for p in parts)
        if size > MAX_MESSAGE_LENGTH:
            raise RpcError(
                StatusCode.RESOURCE_EXHAUSTED,
                f"Sent message larger than max ({size} vs. "
                f"{MAX_MESSAGE_LENGTH})")
        end = None if timeout is None else time.time() + timeout
        sock = self._checkout(timeout)
        try:
            sock.settimeout(timeout)
            head = _F64.pack(-1.0 if timeout is None else timeout)
            flat = [path]
            for key, value in metadata or ():
                flat += [key, value]
            _send_frame(sock, head + _pack_strs(flat), parts)
            if end is not None:
                sock.settimeout(max(end - time.time(), 1e-3))
            got = _recv_head(sock)
            if got is None:
                raise ConnectionResetError("connection closed by peer")
            head, body_len = got
            (code,) = _U32.unpack_from(head, 0)
            details = _unpack_strs(head, 4)[0]
            if body_len > MAX_MESSAGE_LENGTH:
                sock.close()
                sock = None
                raise RpcError(
                    StatusCode.RESOURCE_EXHAUSTED,
                    f"Received message larger than max ({body_len} vs. "
                    f"{MAX_MESSAGE_LENGTH})")
            body = _recv_exact(sock, body_len)
        except socket.timeout:
            sock.close()
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded") from None
        except OSError as e:
            sock.close()
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connection to {self.addr} lost: {e}") from None
        except RpcError:
            if sock is not None:
                sock.close()
            raise
        sock.settimeout(None)
        self._checkin(sock)
        status = _CODES.get(code, StatusCode.UNKNOWN)
        if status != StatusCode.OK:
            raise RpcError(status, details)
        return body

    # -- the retry plane --

    def on_failure(self, method, policy, code, attempt):
        """Bookkeep one failed attempt; True when the caller should retry
        (after this method has slept the backoff)."""
        if code in _RETRYABLE:
            self.breaker.record_failure()
        elif code is not None:
            # A non-connectivity status means the peer ANSWERED: that is a
            # success connectivity-wise, and it releases a half-open probe.
            self.breaker.record_success()
        if (
            code is None
            or not policy.retryable(code)
            or attempt >= policy.max_attempts - 1
        ):
            _FAILURES.labels(
                method=method, code=getattr(code, "name", str(code))
            ).inc()
            return False
        if not self.breaker.allow():
            # Peer declared down mid-retry: stop burning the budget.
            _FAILURES.labels(method=method, code="BREAKER_OPEN").inc()
            return False
        _RETRIES.labels(method=method).inc()
        with self._rng_lock:
            delay = policy.backoff(attempt, self._rng)
        logger.debug(
            "Retrying %s to %s in %.2fs (attempt %d, %s)",
            method, self.addr, delay, attempt + 2, code,
        )
        time.sleep(delay)
        return True


class _MultiCallable:
    """One method on a channel: `call(request, timeout=None,
    metadata=None)` blocks; `call.future(...)` returns a future whose
    `result()` retries lazily, on the caller's thread."""

    def __init__(self, channel, path, resp_cls):
        self._channel = channel
        self._path = path
        self._method = path.rsplit("/", 1)[-1]
        self._resp_cls = resp_cls

    def _prepare(self, request, timeout):
        policy = policy_for(self._path)
        if timeout is None and policy.deadline > 0:
            timeout = policy.deadline
        return policy, timeout, _message_parts(request)

    def attempt(self, parts, timeout, metadata):
        """One attempt with the client hooks: the caller's trace context
        into the metadata and a client span, then the chaos schedule's
        client faults, then the wire."""
        channel = self._channel
        metadata = tracing.inject(metadata)
        start = time.time()
        code = StatusCode.OK
        body = b""
        try:
            if channel._chaos is not None:
                from elasticdl_tpu_torch.chaos import injection

                timeout = injection.client_faults(
                    channel._chaos, self._path, timeout)
            body = channel.wire_call(self._path, parts, timeout, metadata)
            try:
                return self._resp_cls.FromString(body)
            except pb.DecodeError as e:
                raise RpcError(StatusCode.INTERNAL,
                               f"Exception deserializing response! {e}"
                               ) from None
        except RpcError as e:
            code = e.code()
            raise
        finally:
            tracing.record_client_call(
                self._path, start, code.name,
                sent=sum(memoryview(p).nbytes for p in parts),
                received=len(body))

    def __call__(self, request, timeout=None, metadata=None):
        policy, timeout, parts = self._prepare(request, timeout)
        channel = self._channel
        if not channel.breaker.allow():
            _FAST_FAILS.labels(peer=channel.addr).inc()
            raise CircuitOpenError(channel.addr, self._method)
        attempt = 0
        while True:
            try:
                response = self.attempt(parts, timeout, metadata)
            except RpcError as e:
                if not channel.on_failure(
                        self._method, policy, e.code(), attempt):
                    raise
                attempt += 1
                continue
            channel.breaker.record_success()
            return response

    def future(self, request, timeout=None, metadata=None):
        policy, timeout, parts = self._prepare(request, timeout)
        channel = self._channel
        if not channel.breaker.allow():
            # A failed future, not a raise: a fan-out's per-future handling
            # must see it.
            _FAST_FAILS.labels(peer=channel.addr).inc()
            return _FailedFuture(CircuitOpenError(channel.addr, self._method))
        try:
            # The attempt runs on a pool thread under the caller's context
            # (its trace context among it).
            first = channel._pool.submit(
                contextvars.copy_context().run, self.attempt, parts, timeout,
                metadata)
        except RuntimeError:  # the channel was closed
            return _FailedFuture(
                RpcError(StatusCode.CANCELLED, "Channel closed"))
        return _RetryingFuture(self, first, policy, parts, timeout, metadata)


class _FailedFuture:
    def __init__(self, error):
        self._error = error

    def result(self, timeout=None):
        raise self._error


class _RetryingFuture:
    """Future of a `.future()` call: retries happen lazily inside
    result()/exception(), on the caller's thread, so a fan-out of N futures
    still overlaps its healthy peers while one retries."""

    def __init__(self, call, first, policy, parts, timeout, metadata):
        self._call = call
        self._current = first
        self._policy = policy
        self._parts = parts
        self._timeout = timeout
        self._metadata = metadata
        self._attempt = 0
        self._lock = threading.Lock()
        self._outcome = None  # ("ok", response) | ("err", RpcError)

    def result(self, timeout=None):
        with self._lock:
            if self._outcome is None:
                self._outcome = self._resolve(timeout)
        kind, value = self._outcome
        if kind == "err":
            raise value
        return value

    def _resolve(self, timeout):
        channel = self._call._channel
        while True:
            try:
                if self._current is not None:
                    value = self._current.result(timeout)
                    self._current = None
                else:
                    value = self._call.attempt(
                        self._parts, self._timeout, self._metadata)
            except RpcError as e:
                self._current = None
                if not channel.on_failure(
                        self._call._method, self._policy, e.code(),
                        self._attempt):
                    return "err", e
                self._attempt += 1
                continue
            channel.breaker.record_success()
            return "ok", value


class Stub:
    """Client stub: one callable attribute per spec method."""

    def __init__(self, channel: Channel, spec: ServiceSpec):
        for method, (_, resp_cls) in spec.methods.items():
            setattr(self, method,
                    channel.unary_unary(f"/{spec.name}/{method}", resp_cls))


def wait_channel_ready(addr, timeout, abort_check=None):
    """TCP-probe `addr` until it accepts a connection or `timeout` elapses.
    Returns True when the peer accepted. abort_check() returning True ends
    the wait early (e.g. "the subprocess that should bind this port died")."""
    host, _, port = addr.rpartition(":")
    host = host.strip("[]") or "127.0.0.1"
    try:
        port = int(port)
    except ValueError:
        return False
    deadline = time.time() + timeout
    while time.time() < deadline:
        if abort_check is not None and abort_check():
            return False
        try:
            probe = socket.create_connection((host, port), timeout=1)
            probe.close()
            return True
        except OSError:
            time.sleep(0.2)
    return False


def build_channel(addr: str, ready_timeout=None, chaos=None) -> Channel:
    """A hardened channel to `addr`: readiness-waited, then the retry,
    deadline and breaker plane over the tracing and chaos hooks.

    ready_timeout: seconds to TCP-probe before opening (None reads
    ELASTICDL_RPC_READY_TIMEOUT via rpc.ready_timeout(), default 30; 0
    skips the probe). On probe timeout the channel is still built — the
    retry plane owns the failure from there."""
    if ready_timeout is None:
        ready_timeout = _default_ready_timeout()
    if ready_timeout > 0 and not wait_channel_ready(addr, ready_timeout):
        logger.warning(
            "Peer %s not accepting connections after %.1fs; opening "
            "the channel anyway (retries/breaker take over)",
            addr,
            ready_timeout,
        )
    return Channel(addr, chaos=_chaos_schedule(chaos))


# ---------- in process ----------


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
