"""Background-thread record prefetch: overlap reader IO with training
(counterpart of elasticdl_tpu/data/prefetch.py, without its chaos seam).

For ANY reader, `read_records(task)` runs the wrapped
reader's generator on a producer thread that fills a bounded queue, so
disk reads + CRC checks + proto decode overlap the accelerator's work on
the previous minibatches instead of serializing with it. Record order is
preserved (single producer per task); producer exceptions re-raise in the
consumer at the position they occurred; closing/abandoning the consumer
generator stops the producer instead of leaking a thread blocked on a
full queue.
"""

import queue
import sys
import threading
import time

from elasticdl_tpu_torch.chaos import injection
from elasticdl_tpu_torch.observability import datapath

_END = object()


DEFAULT_BUFFER_BYTES = 64 << 20


class PrefetchReader:
    """Wrap a data reader so its per-task record stream is produced ahead
    of consumption on a background thread. The buffer is bounded BOTH by
    record count (`buffer_records`) and by total buffered payload bytes
    (`buffer_bytes`) — the byte bound is what keeps host RAM flat when
    records are large (a 1024-record bound alone would hold ~150 MB of
    224x224 image Examples)."""

    # Data-plane attribution marker: the producer thread below accounts
    # record reads as the `read` stage, so downstream consumers
    # (TaskDataService.read_batches) must book their queue waits as
    # `starve`, not `read` — otherwise read time would count twice.
    datapath_starve_waits = True

    def __init__(self, reader, buffer_records=1024,
                 buffer_bytes=DEFAULT_BUFFER_BYTES):
        if buffer_records < 1:
            raise ValueError("buffer_records must be >= 1")
        if buffer_bytes < 1:
            raise ValueError("buffer_bytes must be >= 1")
        self._reader = reader
        self._buffer_records = buffer_records
        self._buffer_bytes = buffer_bytes

    def read_records(self, task):
        q = queue.Queue(maxsize=self._buffer_records)
        stop = threading.Event()
        dp = datapath.get()
        # Hand-off queue occupancy/backpressure telemetry; per-task is
        # fine (one producer per task), and re-arming the watermark edge
        # per task keeps excursions attributable to a task id.
        q_telemetry = datapath.QueueTelemetry(
            "prefetch", capacity=self._buffer_records, datapath=dp
        )
        # Outstanding payload bytes, guarded by its own lock; the producer
        # parks while over budget (at least one record is always allowed
        # through so a single huge record can't deadlock).
        state = {"bytes": 0}
        cond = threading.Condition()

        def _sizeof(item):
            if isinstance(item, (bytes, bytearray, memoryview)):
                return len(item)
            # Parsed rows/objects (e.g. CSV tuples) have no byte length
            # (len() would count fields, not bytes); approximate with the
            # interpreter's shallow size so the byte budget still bounds
            # host RAM rather than silently degrading to the record-count
            # bound alone.
            return sys.getsizeof(item)

        def _put(item, nbytes=0):
            """put() that gives up when the consumer is gone."""
            with cond:
                while (
                    not stop.is_set()
                    and state["bytes"] > 0
                    and state["bytes"] + nbytes > self._buffer_bytes
                ):
                    cond.wait(timeout=0.1)
                if stop.is_set():
                    return False
                state["bytes"] += nbytes
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # The producer owns the `read` stage: each pull from the
            # wrapped reader is timed off the training thread (overlap
            # means this cost only surfaces downstream as `starve` when
            # the queue runs dry). Records are NOT counted here — the
            # consumer's delivery boundary counts them exactly once.
            it = iter(self._reader.read_records(task))
            try:
                while True:
                    if dp.enabled:
                        # The chaos hook sits INSIDE the timed window so
                        # an injected slow reader shows up as `read`
                        # seconds, exactly like a genuinely slow one.
                        start = time.time()
                        injection.inject_local("datapath.read")
                        record = next(it, _END)
                        dp.add("read", time.time() - start)
                    else:
                        record = next(it, _END)
                    if record is _END:
                        break
                    if not _put(record, _sizeof(record)):
                        return
                    q_telemetry.depth(q.qsize())
            except BaseException as e:  # re-raised on the consumer side
                _put((_END, e))
                return
            _put((_END, None))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                # Records pass through untouched; only the producer's own
                # (_END, err) pair terminates (readers can yield tuples —
                # _END is module-private, so no user tuple can match).
                if (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and item[0] is _END
                ):
                    err = item[1]
                    if err is not None:
                        raise err
                    return
                with cond:
                    state["bytes"] -= _sizeof(item)
                    cond.notify()
                yield item
        finally:
            # Runs on exhaustion AND on generator close/GC (task failure
            # mid-batch): release the producer and wait for it, so no
            # stale thread is still reading the (possibly shared) file
            # handle when the next task's producer starts.
            stop.set()
            t.join(timeout=5.0)
            if t.is_alive():  # pragma: no cover - stuck in a blocked read
                import logging

                logging.getLogger("data.prefetch").warning(
                    "prefetch producer for task %s did not exit within 5s",
                    getattr(task, "task_id", "?"),
                )

    def __getattr__(self, name):
        # Everything else (create_shards, metadata, ...) delegates to the
        # wrapped reader.
        return getattr(self._reader, name)
