"""Tracing: Chrome-trace JSONL spans and trace context across processes
(counterpart of elasticdl_tpu/observability/tracing.py).

Each process appends complete ("ph": "X") events to its own
`trace_<role>.jsonl`, loadable in Perfetto / chrome://tracing. The trace
"pid" is a stable hash of the process's role string — NOT the OS pid — so
the master and each worker get distinct, deterministic process rows even
when one interpreter hosts several roles.

Trace context is a contextvar carrying (trace_id, span_id, job, task_id,
lease_epoch); the worker re-keys it to each task, so every span of a task
shares a trace id. The transport (common/rpc.py) carries it across
processes as the JAX package's interceptors do: `inject` adds it to a call's
metadata (`edl-trace-*` keys) and `record_client_call` records the client
span; on the server `serve_traced` runs the handler under the propagated
context and records the server span, so one task's dispatch -> pull ->
train -> push -> report chain shares a trace id across every process it
touches. Recording costs nothing until a recorder is installed
(set_recorder) or a span sink is added (add_sink, the flight recorder's
feed).
"""

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
import zlib

# Metadata keys (lowercase, as gRPC's must be).
_MD_TRACE = "edl-trace-id"
_MD_PARENT = "edl-parent-span"
_MD_TASK = "edl-task-id"
_MD_EPOCH = "edl-lease-epoch"
_MD_JOB = "edl-job"

_context = contextvars.ContextVar("edl_trace_context", default=None)

_recorder = None

# Secondary span consumers (the flight recorder). Sinks receive every
# span the plane observes — (name, start_s, dur_s, cat, args) — even
# when no file recorder is installed, and must be cheap + non-raising.
_sinks = []


def add_sink(sink):
    if sink not in _sinks:
        _sinks.append(sink)


def remove_sink(sink):
    if sink in _sinks:
        _sinks.remove(sink)


def _feed_sinks(name, start_s, dur_s, cat, args):
    for sink in list(_sinks):
        try:
            sink(name, start_s, dur_s, cat, args)
        except Exception:
            pass


class TraceContext:
    __slots__ = ("trace_id", "span_id", "job", "task_id", "lease_epoch")

    def __init__(
        self, trace_id=None, span_id="", job="", task_id=-1, lease_epoch=-1
    ):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.span_id = span_id
        self.job = job
        self.task_id = task_id
        self.lease_epoch = lease_epoch

    def args(self):
        out = {"trace_id": self.trace_id}
        if self.job:
            out["job"] = self.job
        if self.task_id >= 0:
            out["task_id"] = self.task_id
        if self.lease_epoch >= 0:
            out["lease_epoch"] = self.lease_epoch
        return out


def set_context(task_id=None, lease_epoch=None, job=None, trace_id=None):
    """Create/refresh this thread's trace context; returns it. Starting a
    new task (task_id given, different from the current one) mints a new
    trace id so each task forms its own trace tree."""
    ctx = _context.get()
    if ctx is None or (
        trace_id is not None and trace_id != ctx.trace_id
    ) or (
        task_id is not None and task_id != ctx.task_id
    ):
        ctx = TraceContext(
            trace_id=trace_id,
            job=job if job is not None else (ctx.job if ctx else ""),
            task_id=task_id if task_id is not None else -1,
            lease_epoch=(
                lease_epoch
                if lease_epoch is not None
                else (ctx.lease_epoch if ctx else -1)
            ),
        )
        _context.set(ctx)
        return ctx
    if job is not None:
        ctx.job = job
    if lease_epoch is not None:
        ctx.lease_epoch = lease_epoch
    return ctx


def role_pid(role):
    """Deterministic per-role trace pid (distinct process rows in the
    merged trace even when several roles share one OS process)."""
    return zlib.crc32(role.encode()) & 0x7FFFFFF


class SpanRecorder:
    """Appends Chrome-trace events to a JSONL file; thread-safe.
    Size-capped (observability/rotation.py): a rotated generation keeps
    the previous cap's worth of spans as <path>.1 and re-stamps the
    process-name metadata plus a `rotated` marker so the fresh file is
    independently loadable in Perfetto."""

    def __init__(self, path, process_name, max_bytes=None):
        from elasticdl_tpu_torch.observability.rotation import SizeCappedFile

        self.path = path
        self.process_name = process_name
        self.pid = role_pid(process_name)
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = SizeCappedFile(
            path, max_bytes=max_bytes, on_rotate=self._on_rotate
        )
        # Perfetto reads process names from this metadata event.
        self._write(self._process_meta())

    def _process_meta(self):
        return {
            "ph": "M",
            "name": "process_name",
            "pid": self.pid,
            "tid": 0,
            "args": {"name": self.process_name},
        }

    def _on_rotate(self, generation):
        # Runs under self._lock mid-write (rotation.py callback): these
        # are the new generation's first lines.
        for event in (
            self._process_meta(),
            {
                "ph": "i",
                "s": "p",
                "name": "rotated",
                "cat": "edl",
                "ts": round(time.time() * 1e6, 1),
                "pid": self.pid,
                "tid": 0,
                "args": {"generation": generation},
            },
        ):
            self._file.append_line(
                json.dumps(event, separators=(",", ":"))
            )

    def _write(self, event):
        line = json.dumps(event, separators=(",", ":"))
        with self._lock:
            if self._file.closed:
                return
            self._file.write_line(line)

    def record(self, name, start_s, dur_s, cat="edl", args=None):
        """One complete span; times in seconds (perf-epoch: time.time)."""
        ctx = _context.get()
        merged = ctx.args() if ctx is not None else {}
        if args:
            merged.update(args)
        self._write(
            {
                "ph": "X",
                "name": name,
                "cat": cat,
                "ts": round(start_s * 1e6, 1),
                "dur": round(dur_s * 1e6, 1),
                "pid": self.pid,
                "tid": threading.get_ident() & 0xFFFF,
                "args": merged,
            }
        )

    def instant(self, name, cat="edl", args=None):
        ctx = _context.get()
        merged = ctx.args() if ctx is not None else {}
        if args:
            merged.update(args)
        self._write(
            {
                "ph": "i",
                "s": "p",
                "name": name,
                "cat": cat,
                "ts": round(time.time() * 1e6, 1),
                "pid": self.pid,
                "tid": threading.get_ident() & 0xFFFF,
                "args": merged,
            }
        )

    def close(self):
        with self._lock:
            if not self._file.closed:
                self._file.close()


def set_recorder(recorder):
    global _recorder
    _recorder = recorder


def get_recorder():
    return _recorder


@contextlib.contextmanager
def span(name, cat="edl", **args):
    """Record a span around the with-body (no-op without a recorder or
    sink; the body's exceptions still propagate and the span still
    closes)."""
    rec = _recorder
    if rec is None and not _sinks:
        yield
        return
    start = time.time()
    try:
        yield
    finally:
        dur = time.time() - start
        if rec is not None:
            rec.record(name, start, dur, cat=cat, args=args)
        _feed_sinks(name, start, dur, cat, args)


def record_span(name, start_s, dur_s, cat="edl", args=None):
    """Record an already-measured span (recorder + sinks), for callers
    that time the interval themselves."""
    rec = _recorder
    if rec is not None:
        rec.record(name, start_s, dur_s, cat=cat, args=args)
    _feed_sinks(name, start_s, dur_s, cat, args)


def instant(name, cat="edl", **args):
    rec = _recorder
    if rec is not None:
        rec.instant(name, cat=cat, args=args)


# ---------- propagation across the transport ----------


def inject(metadata):
    """`metadata` (pairs) plus the caller's trace context, if any."""
    ctx = _context.get()
    if ctx is None:
        return metadata
    extra = [(_MD_TRACE, ctx.trace_id)]
    if ctx.span_id:
        extra.append((_MD_PARENT, ctx.span_id))
    if ctx.job:
        extra.append((_MD_JOB, ctx.job))
    if ctx.task_id >= 0:
        extra.append((_MD_TASK, str(ctx.task_id)))
    if ctx.lease_epoch >= 0:
        extra.append((_MD_EPOCH, str(ctx.lease_epoch)))
    return list(metadata or ()) + extra


def context_from_metadata(metadata):
    """TraceContext extracted from invocation metadata, or None."""
    md = {k: v for k, v in (metadata or ())}
    trace_id = md.get(_MD_TRACE)
    if trace_id is None:
        return None
    return TraceContext(
        trace_id=trace_id,
        span_id=md.get(_MD_PARENT, ""),
        job=md.get(_MD_JOB, ""),
        task_id=int(md.get(_MD_TASK, -1)),
        lease_epoch=int(md.get(_MD_EPOCH, -1)),
    )


def record_client_call(method, start_s, code, sent=0, received=0):
    """The client span of one call attempt, from `start_s` to now, with the
    status and the message bytes sent and received (the port's transport
    adds the byte counts to the JAX span's args)."""
    rec = _recorder
    if rec is None and not _sinks:
        return
    dur = time.time() - start_s
    args = {"code": str(code), "sent": sent, "received": received}
    if rec is not None:
        rec.record(f"rpc_client{method}", start_s, dur, cat="rpc", args=args)
    _feed_sinks(f"rpc_client{method}", start_s, dur, "rpc", args)


def serve_traced(method, metadata, handler):
    """Runs `handler()` under the trace context propagated in `metadata`
    and records the server span."""
    ctx = context_from_metadata(metadata)
    token = _context.set(ctx) if ctx is not None else None
    try:
        rec = _recorder
        if rec is None and not _sinks:
            return handler()
        start = time.time()
        try:
            return handler()
        finally:
            dur = time.time() - start
            if rec is not None:
                rec.record(f"rpc_server{method}", start, dur, cat="rpc")
            _feed_sinks(f"rpc_server{method}", start, dur, "rpc", None)
    finally:
        if token is not None:
            _context.reset(token)
