"""Structured elasticity event log: events.jsonl alongside metrics.jsonl
(counterpart of elasticdl_tpu/observability/events.py).

One JSON object per line:

    {"ts": 1722700000.1, "seq": 7, "kind": "pod_relaunch", "job": "j",
     "role": "master", "kind_id": "worker-1", "attempt": 2, ...}

`seq` is a per-process monotonic counter so the job's elasticity timeline
(launch -> exit -> relaunch, lease grant -> abort, task create -> timeout ->
reassign) can be reconstructed in exact order even when two events land
within one clock tick. Emission is a no-op until observability.setup()
installs a log, so library code can emit unconditionally.

Event kinds (the JAX package's docs/OBSERVABILITY.md#event-schema):
  pod_launch / pod_exit / pod_relaunch / pod_failed
  lease_mint / lease_grant / lease_report / lease_abort / lease_complete
  task_create / task_timeout / task_reassign / task_failed / job_failed
  worker_removed / membership_epoch
  compile / mem_high_watermark / profile_start / profile_done / rotated
"""

import json
import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.observability.rotation import SizeCappedFile

COALESCE_SECONDS_ENV = "ELASTICDL_EVENT_COALESCE_SECONDS"
COALESCE_KINDS_ENV = "ELASTICDL_EVENT_COALESCE_KINDS"


class EventLog:
    def __init__(self, path, job="", role="", max_bytes=None,
                 coalesce_seconds=None, coalesce_kinds=None):
        self.path = path
        self._job = job
        self._role = role
        self._lock = threading.Lock()
        self._seq = 0
        # Coalescing window for high-frequency kinds (500-pod churn makes
        # membership_epoch a write-amplification hazard): the first event
        # of a windowed kind writes immediately; later ones inside the
        # window fold into the NEXT write, which carries coalesced=N and
        # the latest fields. Trailing loss — a suppressed event with no
        # successor before close — is accepted and bounded to one window.
        if coalesce_seconds is None:
            coalesce_seconds = knobs.get_float(COALESCE_SECONDS_ENV)
        if coalesce_kinds is None:
            coalesce_kinds = knobs.get_str(COALESCE_KINDS_ENV)
        if isinstance(coalesce_kinds, str):
            coalesce_kinds = {
                k.strip() for k in coalesce_kinds.split(",") if k.strip()
            }
        self._coalesce_seconds = max(0.0, float(coalesce_seconds))
        self._coalesce_kinds = frozenset(coalesce_kinds)
        self._coalesce_state = {}  # kind -> {"last_write", "suppressed"}
        reg = default_registry()
        self._c_written = reg.counter(
            "edl_events_written_total",
            "Event-log records actually written (rotation markers "
            "included)",
        )
        self._c_bytes = reg.counter(
            "edl_events_bytes_total",
            "Bytes appended to events.jsonl",
        )
        self._c_suppressed = reg.counter(
            "edl_events_suppressed_total",
            "Events folded into a later record by the coalescing window",
            labelnames=("kind",),
        )
        # Size-capped: the previous generation survives as <path>.1 and
        # every fresh generation opens with a `rotated` marker event so
        # readers see a deliberate cut, not a gap.
        self._file = SizeCappedFile(
            path, max_bytes=max_bytes, on_rotate=self._write_rotated_marker_locked
        )

    def _write_rotated_marker_locked(self, generation):
        # Called under self._lock, mid-write, right after the rename:
        # this marker is the new file's first record.
        self._seq += 1
        line = json.dumps(
            {
                "ts": time.time(),
                "kind": "rotated",
                "role": self._role,
                "generation": generation,
                "seq": self._seq,
            },
            separators=(",", ":"),
        )
        self._file.append_line(line)
        self._c_written.inc()
        self._c_bytes.inc(len(line) + 1)

    def emit(self, kind, **fields):
        now = time.time()
        record = {"ts": now, "kind": kind}
        if self._job:
            record["job"] = self._job
        if self._role:
            record["role"] = self._role
        record.update(fields)
        with self._lock:
            if self._file.closed:
                return
            if self._coalesce_seconds and kind in self._coalesce_kinds:
                state = self._coalesce_state.setdefault(
                    kind, {"last_write": 0.0, "suppressed": 0}
                )
                if now - state["last_write"] < self._coalesce_seconds:
                    state["suppressed"] += 1
                    self._c_suppressed.labels(kind=kind).inc()
                    return
                if state["suppressed"]:
                    record["coalesced"] = state["suppressed"]
                    state["suppressed"] = 0
                state["last_write"] = now
            # Rotation check BEFORE assigning seq: a rotation writes the
            # marker (which takes the next seq) as the new generation's
            # first record, so seq stays monotonic in file order. The
            # +24 covers the seq field this record is about to gain.
            probe = json.dumps(record, separators=(",", ":"))
            self._file.maybe_rotate(len(probe) + 24)
            self._seq += 1
            record["seq"] = self._seq
            line = json.dumps(record, separators=(",", ":"))
            self._file.append_line(line)
            self._c_written.inc()
            self._c_bytes.inc(len(line) + 1)

    def close(self):
        with self._lock:
            if not self._file.closed:
                self._file.close()


_event_log = None


def set_event_log(log):
    global _event_log
    _event_log = log


def get_event_log():
    return _event_log


def emit(kind, **fields):
    """Append one event; silently dropped until a log is configured."""
    log = _event_log
    if log is not None:
        log.emit(kind, **fields)


def read_events(path):
    """Parse an events.jsonl (merge helper for tools/tests). A torn final
    line — the writer was SIGKILLed mid-record, the very scenario this log
    diagnoses — yields the valid prefix instead of raising."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events
