"""Stage-level data-plane instrumentation for the input pipeline
(counterpart of elasticdl_tpu/observability/datapath.py).

The feed path is split into named stages, and every stage lands three ways
at once:

- a `Timing` phase (``input_<stage>``) on whatever Timing object the call
  site binds (the worker loop's);
- a tracing span (``datapath.<stage>``);
- metrics: `edl_datapath_seconds_total{stage}` and
  `edl_datapath_records_total`, plus a per-stage duration histogram
  `edl_datapath_stage_seconds{stage}`.

Stage model:

    task     waiting on the master for a task lease (get_task RPC wait)
    read     pulling raw records out of the reader/storage
    decode   parsing records into arrays (InputSpec.feed)
    collate  assembling rows/batches from already-read records
    h2d      host-to-device transfer of the built batch
    starve   trainer blocked on an EMPTY prefetch queue (the step could
             not start because no batch was ready)

`read` vs `starve`: with the prefetch pipeline on (the default), the
producer thread owns `read` and the consumer's wait on the hand-off
queue is `starve` — the signal a perf PR acts on. Without prefetch the
consumer's pull IS the read, and starve stays zero.

Hand-off queues additionally report occupancy through `QueueTelemetry`:
an `edl_datapath_queue_depth{queue}` gauge plus edge-triggered
high-watermark events (`datapath_backpressure`) and an
`edl_datapath_backpressure_total{queue}` counter when a bounded queue
crosses ELASTICDL_DATAPATH_QUEUE_WATERMARK of its capacity.

Overhead is bounded by design: one wall-clock timestamp pair and a
counter bump per stage; ELASTICDL_DATAPATH=0 turns every stage() into a
no-op yield.
"""

import contextlib
import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.observability import emit_event, tracing
from elasticdl_tpu_torch.observability.metrics import default_registry

DATAPATH_ENV = "ELASTICDL_DATAPATH"
QUEUE_CAPACITY_ENV = "ELASTICDL_DATAPATH_QUEUE_CAPACITY"
QUEUE_WATERMARK_ENV = "ELASTICDL_DATAPATH_QUEUE_WATERMARK"

# Canonical stage names; the Timing phase is "input_<stage>".
STAGES = ("task", "read", "decode", "collate", "h2d", "starve")

# Stage-duration buckets: feed stages live in the 50us..1s range, well
# below the latency-shaped registry default (1ms..100s).
_STAGE_BUCKETS = (
    5e-5, 2e-4, 1e-3, 4e-3, 0.016, 0.064, 0.25, 1.0, 4.0,
)

_registry = default_registry()
_SECONDS = _registry.counter(
    "edl_datapath_seconds_total",
    "Wall seconds spent per input-pipeline stage",
    labelnames=("stage",),
)
_RECORDS = _registry.counter(
    "edl_datapath_records_total",
    "Records delivered by the input pipeline",
)
_STAGE_HIST = _registry.histogram(
    "edl_datapath_stage_seconds",
    "Per-call duration of each input-pipeline stage",
    labelnames=("stage",),
    buckets=_STAGE_BUCKETS,
)
_QUEUE_DEPTH = _registry.gauge(
    "edl_datapath_queue_depth",
    "Current occupancy of an input-pipeline hand-off queue",
    labelnames=("queue",),
)
_BACKPRESSURE = _registry.counter(
    "edl_datapath_backpressure_total",
    "High-watermark crossings of an input-pipeline hand-off queue",
    labelnames=("queue",),
)


class _Stage:
    """Mutable holder yielded by stage(); the body sets .records to the
    number of records the stage delivered (counted ONCE per record, at
    the delivery boundary — producers and transforms leave it 0)."""

    __slots__ = ("records",)

    def __init__(self, records=0):
        self.records = records


class Datapath:
    """Per-process data-plane instrumentation hub.

    One instance per process (module singleton via get()); Timing
    mirroring is per-call-site — pass `timing=` so the phase lands on
    the Timing object whose summary the caller reports (the worker loop
    Timing for read/decode, the trainer's own Timing for h2d)."""

    def __init__(self, enabled=None):
        if enabled is None:
            enabled = knobs.get_int(DATAPATH_ENV) != 0
        self._enabled = bool(enabled)
        self._timing = None
        self._lock = threading.Lock()
        # Per-flush accumulation for the `datapath` event trail:
        # {stage: seconds} plus a record count, swapped out whole by
        # flush_event() at task boundaries.
        self._acc = {}
        self._acc_records = 0

    @property
    def enabled(self):
        return self._enabled

    def bind_timing(self, timing):
        """Default Timing object for stages that do not pass their own."""
        self._timing = timing

    @contextlib.contextmanager
    def stage(self, name, records=0, timing=None):
        """Time one stage execution. Yields a holder whose .records the
        body may set once the delivered record count is known."""
        holder = _Stage(records)
        if not self._enabled:
            yield holder
            return
        start = time.time()
        try:
            yield holder
        finally:
            dur = time.time() - start
            tracing.record_span(
                "datapath." + name, start, dur, cat="datapath"
            )
            self.add(name, dur, records=holder.records, timing=timing)

    def add(self, name, seconds, records=0, timing=None):
        """Account an already-measured stage interval (for producer
        threads that time with their own clock pair)."""
        if not self._enabled or seconds < 0:
            return
        _SECONDS.labels(stage=name).inc(seconds)
        _STAGE_HIST.labels(stage=name).observe(seconds)
        if records:
            _RECORDS.inc(records)
        t = timing if timing is not None else self._timing
        if t is not None:
            t.add("input_" + name, seconds)
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._acc_records += records

    def flush_event(self, **extra):
        """Emit one `datapath` event carrying the per-stage seconds
        accumulated since the last flush (called at task boundaries so
        the event trail stays one line per task, not per batch)."""
        if not self._enabled:
            return
        with self._lock:
            acc, self._acc = self._acc, {}
            records, self._acc_records = self._acc_records, 0
        if not acc and not records:
            return
        fields = {f"{k}_s": round(v, 6) for k, v in sorted(acc.items())}
        emit_event("datapath", records=records, **fields, **extra)


class QueueTelemetry:
    """Occupancy/backpressure telemetry for one bounded hand-off queue.

    depth() sets the `edl_datapath_queue_depth{queue}` gauge and fires
    an edge-triggered `datapath_backpressure` event (plus counter) when
    occupancy first crosses the high watermark; it re-arms once depth
    falls back below the mark, so a saturated queue costs one event per
    excursion, not one per put."""

    def __init__(self, name, capacity=None, datapath=None):
        self.name = name
        if capacity is None:
            capacity = knobs.get_int(QUEUE_CAPACITY_ENV)
        self.capacity = int(capacity) if capacity else 0
        ratio = knobs.get_float(QUEUE_WATERMARK_ENV)
        self._mark = (
            self.capacity * ratio if self.capacity and ratio > 0 else 0
        )
        self._armed = True
        self._dp = datapath
        self._gauge = _QUEUE_DEPTH.labels(queue=name)
        self._counter = _BACKPRESSURE.labels(queue=name)

    def depth(self, d):
        dp = self._dp if self._dp is not None else get()
        if not dp.enabled:
            return
        self._gauge.set(d)
        if not self._mark:
            return
        if d >= self._mark:
            if self._armed:
                self._armed = False
                self._counter.inc()
                emit_event(
                    "datapath_backpressure",
                    queue=self.name,
                    depth=int(d),
                    capacity=self.capacity,
                )
        else:
            self._armed = True


_singleton = None
_singleton_lock = threading.Lock()


def get():
    """The process-global Datapath instance (created on first use, so
    the ELASTICDL_DATAPATH gate is read after the process environment is
    fully set up)."""
    global _singleton
    if _singleton is None:
        with _singleton_lock:
            if _singleton is None:
                _singleton = Datapath()
    return _singleton
