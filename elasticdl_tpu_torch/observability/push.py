"""Push-based telemetry: delta-encoded metric snapshots from workers and PS
processes to the master's ReportTelemetry RPC (counterpart of
elasticdl_tpu/observability/push.py).

Each reporting process keeps the families it last sent (`TelemetryPusher`)
and ships only the samples whose values changed since (`snapshot_delta`),
on a jittered interval (`TelemetryReporter`) so the fleet doesn't dogpile
the master in lockstep. The master merges deltas back into per-origin
state with `apply_delta` (aggregator.ingest_push). In one process the
master's aggregator reads the registry directly.

Loss recovery is sequence-numbered: every snapshot carries a per-process
`seq`; the master accepts a delta only when it extends the state it holds
(seq == last+1) and otherwise answers `need_full`, which makes the
reporter resend a full snapshot next push. Every Nth push is full anyway
(ELASTICDL_TELEMETRY_FULL_EVERY) to bound the resync horizon.

Deltas never need tombstones: a MetricsRegistry only ever grows samples
(counters/gauges persist once created), so "changed or new" covers the
whole state evolution.
"""

import collections
import os
import random
import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import promtext

logger = get_logger(__name__)

PUSH_INTERVAL_ENV = "ELASTICDL_TELEMETRY_PUSH_INTERVAL"
PUSH_JITTER_ENV = "ELASTICDL_TELEMETRY_PUSH_JITTER"
FULL_EVERY_ENV = "ELASTICDL_TELEMETRY_FULL_EVERY"


def snapshot_delta(prev_families, cur_families):
    """Families holding only the samples that changed (or are new) in
    `cur_families` relative to `prev_families`; families with no changed
    samples are omitted entirely. Both sides are promtext-style ordered
    {name: MetricFamily} dicts; the inputs are not mutated."""
    prev_values = {}
    for family in prev_families.values():
        for s in family.samples:
            prev_values[(s.name, s.labels)] = s.value
    delta = collections.OrderedDict()
    for name, family in cur_families.items():
        changed = [
            s for s in family.samples
            if prev_values.get((s.name, s.labels)) != s.value
        ]
        if changed:
            out = promtext.MetricFamily(family.name, family.type, family.help)
            out.samples = changed
            delta[name] = out
    return delta


def apply_delta(state_families, delta_families):
    """Merge a delta into `state_families` in place (and return it).
    Changed samples replace their (name, labels) slot; new samples and
    families append, preserving the order both sides emitted them in."""
    for name, family in delta_families.items():
        cur = state_families.get(name)
        if cur is None:
            cur = promtext.MetricFamily(family.name, family.type, family.help)
            state_families[name] = cur
        index = {
            (s.name, s.labels): i for i, s in enumerate(cur.samples)
        }
        for s in family.samples:
            i = index.get((s.name, s.labels))
            if i is None:
                cur.samples.append(s)
            else:
                cur.samples[i] = s
    return state_families


class TelemetryPusher:
    """Delta-encoding state machine for one process's registry.

    `snapshot()` returns the kwargs for one pb.TelemetrySnapshot. `reset()`
    forces the next snapshot to be full — call it when the master answers
    need_full.
    """

    def __init__(self, registry, role, full_every=None):
        self._registry = registry
        self.role = role
        self.pid = os.getpid()
        self._seq = 0
        self._last = None  # families as of the last snapshot sent
        if full_every is None:
            full_every = knobs.get_int(FULL_EVERY_ENV)
        self._full_every = max(0, int(full_every))
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            self._last = None

    def snapshot(self):
        """-> {role, pid, seq, full, payload} for one TelemetrySnapshot.
        An unchanged registry still yields a (payload-empty) delta: the
        push doubles as the role's freshness heartbeat."""
        families = promtext.parse(self._registry.expose())
        with self._lock:
            self._seq += 1
            full = self._last is None or (
                self._full_every and self._seq % self._full_every == 0
            )
            payload_families = (
                families if full else snapshot_delta(self._last, families)
            )
            self._last = families
            seq = self._seq
        payload = promtext.to_text(payload_families) if payload_families else ""
        return {
            "role": self.role,
            "pid": self.pid,
            "seq": seq,
            "full": bool(full),
            "payload": payload,
        }


class TelemetryReporter:
    """Background push loop for one process: snapshot the registry on a
    jittered interval and report it through `report_fn` (typically
    MasterClient.report_telemetry). Failures are counted and retried on
    the next tick — telemetry must never take a trainer down. Beside the
    JAX reporter's `pushes` and `errors` it counts the snapshots the
    master accepted, the payload bytes sent and the seconds spent in the
    pushes it answered (`stats()`), which the worker logs at its exit."""

    def __init__(self, report_fn, registry, role,
                 interval=None, jitter=None, full_every=None, seed=None):
        self._report = report_fn
        self._pusher = TelemetryPusher(registry, role, full_every=full_every)
        self.role = role
        if interval is None:
            interval = knobs.get_float(PUSH_INTERVAL_ENV)
        if jitter is None:
            jitter = knobs.get_float(PUSH_JITTER_ENV)
        self.interval = float(interval)
        self._jitter = max(0.0, float(jitter))
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread = None
        self.pushes = 0
        self.errors = 0
        self.accepted = 0
        self.payload_bytes = 0
        self.seconds = 0.0

    @property
    def enabled(self):
        return self.interval > 0

    def start(self):
        if not self.enabled or self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name=f"telemetry-push-{self.role}", daemon=True
        )
        self._thread.start()
        return self

    def push_once(self):
        """One synchronous push; True when the master answered it."""
        start = time.perf_counter()
        snap = self._pusher.snapshot()
        self.payload_bytes += len(snap["payload"])
        try:
            resp = self._report([snap], origin=self.role)
        except Exception as e:  # a failed push must not reach the trainer
            self.errors += 1
            logger.debug("telemetry push failed: %s", e)
            return False
        self.seconds += time.perf_counter() - start
        self.pushes += 1
        self.accepted += int(getattr(resp, "accepted", 0) or 0)
        if resp is not None and self.role in tuple(
            getattr(resp, "need_full", ())
        ):
            self._pusher.reset()
        return True

    def _run(self):
        while not self._stop.is_set():
            wait = self.interval
            if self._jitter:
                wait *= 1.0 + self._jitter * (2.0 * self._rng.random() - 1.0)
            if self._stop.wait(max(0.01, wait)):
                break
            self.push_once()

    def stats(self):
        return {"pushes": self.pushes, "accepted": self.accepted,
                "errors": self.errors, "payload_bytes": self.payload_bytes,
                "seconds": round(self.seconds, 6)}

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
