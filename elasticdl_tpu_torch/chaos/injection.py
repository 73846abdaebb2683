"""Seeded, counter-based fault injection (counterpart of
elasticdl_tpu/chaos/injection.py).

A FaultSchedule owns a list of FaultRules plus one seeded RNG. Each rule
matches calls by method-name substring and side ("server" or "client") and
fires on a deterministic call-index window: the rule's counter increments on
every matching call, and calls with start <= index < start + count get the
fault. Latency jitter draws from the schedule's seeded RNG, so two runs
with the same schedule and the same call order inject byte-identical fault
sequences. The schedule reaches the transport's calls (`server_faults` and
`client_faults`, which common/rpc.py applies where the JAX package installs
its server and client interceptors) and the local injection points
(`inject_local`): the master's dispatch, the worker's record read, the
prefetch thread, the policy engine's scale actuation.

Fault kinds:
  unavailable  server: context.abort(UNAVAILABLE); client: synthetic
               UNAVAILABLE raised before the wire — both retryable.
  latency      sleep latency_s (+/- seeded jitter) before serving.
  deadline     server: sleep past the caller's remaining deadline; client:
               shrink the call's timeout to ~1ms. Deterministic
               DEADLINE_EXCEEDED either way.
  truncate     server only: the response payload is cut in half at the
               serializer, simulating a torn payload; the client sees a
               deserialization failure (INTERNAL — fail-fast, the worker's
               minibatch retry ladder owns recovery).
  kill         local injection points only: SIGKILL the OWN process at the
               matching call index — the deterministic process-crash fault
               behind the master-kill drills ("master.dispatch" fires at
               the Nth task dispatch, "master.scale" between the world
               hint and the scale actuation). Ignored on wire
               interceptors: killing a process from inside an RPC handler
               would model nothing a network can do.
"""

import dataclasses
import json
import os
import random
import signal
import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("chaos.injection")

CHAOS_ENV = "ELASTICDL_CHAOS"

KINDS = ("unavailable", "latency", "deadline", "truncate", "kill")

_INJECTED = default_registry().counter(
    "edl_chaos_injected_total",
    "Faults injected by the chaos interceptors",
    labelnames=("kind", "side"),
)


@dataclasses.dataclass
class FaultRule:
    method: str  # substring of the full method name ("" matches all)
    kind: str  # one of KINDS
    start: int = 0  # first matching call index (0-based) affected
    count: int = -1  # number of calls affected; -1 = unbounded
    latency_s: float = 0.25
    side: str = "server"  # "server" | "client"
    # Target one process by its ELASTICDL_ROLE stamp: "" matches every
    # process, "worker-0" exactly that instance, a trailing "*" matches
    # the prefix ("worker-*" = all workers). Exact by default — a
    # substring match would make "worker-1" also hit worker-10..19 and
    # silently widen a single-straggler drill into a cohort.
    role: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.side not in ("server", "client"):
            raise ValueError(f"unknown fault side {self.side!r}")

    def matches_role(self):
        if not self.role:
            return True
        stamp = knobs.get_str("ELASTICDL_ROLE")
        if self.role.endswith("*"):
            return stamp.startswith(self.role[:-1])
        return stamp == self.role


class FaultSchedule:
    """Thread-safe, deterministic fault decisions for a rule list."""

    def __init__(self, rules, seed=0):
        self.rules = [
            r if isinstance(r, FaultRule) else FaultRule(**r)
            for r in rules
        ]
        self.seed = seed
        self._rng = random.Random(seed)
        self._counts = [0] * len(self.rules)
        self._lock = threading.Lock()

    def decide(self, method, side):
        """Faults to apply to this call (consumes one count per matching
        rule). Deterministic given the per-method call order."""
        active = []
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.side != side or rule.method not in method:
                    continue
                if not rule.matches_role():
                    continue
                index = self._counts[i]
                self._counts[i] += 1
                if index >= rule.start and (
                    rule.count < 0 or index < rule.start + rule.count
                ):
                    active.append(rule)
        return active

    def jitter(self, rule):
        """Jittered latency for a latency-kind fault; the draw comes from
        the schedule's seeded RNG so sequences replay."""
        with self._lock:
            return rule.latency_s * (0.5 + self._rng.random())

    # -- (de)serialization: drills ship schedules to subprocesses via env --

    def to_json(self):
        return json.dumps(
            {
                "seed": self.seed,
                "rules": [dataclasses.asdict(r) for r in self.rules],
            }
        )

    @classmethod
    def from_json(cls, raw):
        spec = json.loads(raw)
        return cls(spec.get("rules", ()), seed=spec.get("seed", 0))


_env_schedule = None
_env_lock = threading.Lock()


def schedule_from_env():
    """The process-wide schedule from ELASTICDL_CHAOS, or None. Cached: all
    servers/channels of one process share one schedule (and therefore one
    set of rule counters), mirroring how one process experiences one
    network."""
    global _env_schedule
    raw = knobs.raw(CHAOS_ENV)
    if not raw:
        return None
    with _env_lock:
        if _env_schedule is None:
            try:
                _env_schedule = FaultSchedule.from_json(raw)
                logger.warning(
                    "CHAOS ACTIVE: %d fault rules (seed %d) from $%s",
                    len(_env_schedule.rules),
                    _env_schedule.seed,
                    CHAOS_ENV,
                )
            except (ValueError, TypeError) as e:
                logger.error("Bad %s (%s); chaos disabled", CHAOS_ENV, e)
                os.environ.pop(CHAOS_ENV, None)
                return None
        return _env_schedule


def inject_local(point):
    """Apply env-scheduled latency faults at a non-RPC injection point.

    The JAX package's interceptors only reach calls that cross a channel,
    but some drills need to perturb purely in-process code paths — e.g. the
    input-starve scenario slows one worker's record reader by matching
    rules against the synthetic method name "datapath.read", and the
    master-kill drills SIGKILL the master at "master.dispatch" /
    "master.scale". Same rule grammar (method substring, start/count
    window, role targeting, seeded jitter); only latency and kill faults
    make sense here — the other kinds model wire behavior — so anything
    else on a local point is ignored."""
    schedule = schedule_from_env()
    if schedule is None:
        return
    for rule in schedule.decide(point, "client"):
        if rule.kind == "latency":
            _INJECTED.labels(kind="latency", side="client").inc()
            time.sleep(schedule.jitter(rule))
        elif rule.kind == "kill":
            # The deterministic crash fault: no cleanup, no atexit, no
            # flushing — exactly what a preemption looks like. The metric
            # bump below is best-effort (the exporter may never scrape it).
            _INJECTED.labels(kind="kill", side="client").inc()
            logger.warning("CHAOS: SIGKILL self at local point %r", point)
            os.kill(os.getpid(), signal.SIGKILL)


def server_faults(schedule, method, context):
    """Applies the schedule's server faults to one call before its handler
    runs (the JAX ChaosServerInterceptor): latency sleeps, deadline sleeps
    past the caller's deadline, unavailable aborts with UNAVAILABLE.
    Returns the kinds that fired; the server cuts the response of a call
    whose kinds hold "truncate" in half."""
    kinds = []
    for rule in schedule.decide(method, "server"):
        _INJECTED.labels(kind=rule.kind, side="server").inc()
        kinds.append(rule.kind)
        if rule.kind == "latency":
            time.sleep(schedule.jitter(rule))
        elif rule.kind == "deadline":
            remaining = context.time_remaining()
            # Sleep just past the caller's deadline; with no deadline to
            # overrun, a plain latency fault.
            time.sleep(remaining + 0.5 if remaining is not None
                       else rule.latency_s)
        elif rule.kind == "unavailable":
            from elasticdl_tpu_torch.common.rpc import StatusCode

            context.abort(
                StatusCode.UNAVAILABLE,
                f"chaos: injected UNAVAILABLE on {method}",
            )
    return kinds


def client_faults(schedule, method, timeout):
    """Applies the schedule's client faults to one call attempt before the
    wire (the JAX ChaosClientInterceptor); returns the attempt's timeout
    (shrunk to 1 ms by a deadline fault). An unavailable fault raises
    UNAVAILABLE; "truncate" is server-side only."""
    for rule in schedule.decide(method, "client"):
        _INJECTED.labels(kind=rule.kind, side="client").inc()
        if rule.kind == "latency":
            time.sleep(schedule.jitter(rule))
        elif rule.kind == "deadline":
            timeout = 0.001
        elif rule.kind == "unavailable":
            from elasticdl_tpu_torch.common.rpc import RpcError, StatusCode

            raise RpcError(
                StatusCode.UNAVAILABLE,
                f"chaos: injected UNAVAILABLE on {method}",
            )
    return timeout
