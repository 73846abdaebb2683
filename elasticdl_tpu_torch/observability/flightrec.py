"""Crash-dump flight recorder: the last N spans, dumped when we die
(counterpart of elasticdl_tpu/observability/flightrec.py).

A bounded in-memory ring of recent step-phase spans and RPC timings per
role, written to ``<dir>/flightrec-<role>.json`` when the process
crashes (unhandled exception), receives SIGTERM, or a watchdog gives up
on it — so a dead run or drill leaves attributable evidence ("died 41 s
into phase X, last event a push_gradients wire wait") instead of a
timeout and an empty log tail.

Design constraints:

- ALWAYS CHEAP: recording is an append to a ``deque(maxlen=N)`` under a
  lock; nothing is written to disk until a dump trigger fires. The
  recorder feeds off the tracing plane (``tracing.add_sink``) so every
  span the instrumentation already emits — step phases, RPC
  client/server spans, the push serialize/wire/apply sub-spans — lands
  in the ring with no second instrumentation pass.
- NAMES THE PHASE IT DIED IN: ``phase()`` tracks a per-thread stack of
  OPEN phases (entered, not yet exited). A span only reaches the ring
  when it *closes*; the open-phase stack is what says where execution
  currently is — exactly the thing a timeout needs attributed.
- TRIGGER-SAFE: the dump path builds the JSON from plain dicts and
  writes atomically (tmp + rename); signal handlers chain to whatever
  handler was installed before, and the excepthook chains to the
  previous hook, so arming the recorder never changes process
  semantics.

Knobs: ELASTICDL_FLIGHTREC (auto/1/0), ELASTICDL_FLIGHTREC_CAPACITY,
ELASTICDL_FLIGHTREC_DIR (falls back to ELASTICDL_OBS_DIR, then cwd).
"""

import collections
import contextlib
import json
import os
import signal
import sys
import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.observability import tracing

_recorder = None
_prev_excepthook = None
_prev_handlers = {}

# Signals that mean "you are being killed, leave evidence". SIGTERM is
# what k8s, a harness's `timeout`, and drills send.
_SIGNALS = (signal.SIGTERM,)


class FlightRecorder:
    """Bounded ring of recent spans + open-phase tracking for one role."""

    def __init__(self, role, capacity, dump_dir):
        self.role = role
        self.dump_dir = dump_dir
        # RLock, not Lock: the SIGTERM handler dumps via snapshot(),
        # and Python delivers signals on the MAIN thread at bytecode
        # boundaries — including inside on_span()/phase()'s critical
        # sections. With a plain Lock the handler would self-deadlock
        # trying to re-acquire a lock its own (interrupted) thread
        # holds, and the process would neither dump nor die. Reentrancy
        # means the dump may read a snapshot mid-mutation (at worst one
        # event torn/missing) — the right trade for crash tooling.
        # Another thread holding the lock only delays the handler by
        # one tiny append, never deadlocks it.
        self._lock = threading.RLock()
        self._events = collections.deque(maxlen=capacity)
        self._rpc = {}
        self._open = {}
        self._started = time.time()
        self._dumps = 0

    # ---------- recording ----------

    def on_span(self, name, start_s, dur_s, cat, args):
        """tracing sink: one CLOSED span."""
        event = {
            "ts": round(start_s, 3),
            "name": name,
            "cat": cat,
            "dur_ms": round(dur_s * 1e3, 2),
        }
        if args:
            # Keep only scalar args: the ring must stay tiny and
            # JSON-serializable no matter what a caller attached.
            scalars = {
                k: v
                for k, v in args.items()
                if isinstance(v, (str, int, float, bool))
            }
            if scalars:
                event["args"] = scalars
        with self._lock:
            self._events.append(event)
            if cat == "rpc":
                agg = self._rpc.get(name)
                if agg is None:
                    agg = self._rpc[name] = [0, 0.0]
                agg[0] += 1
                agg[1] += dur_s

    @contextlib.contextmanager
    def phase(self, name):
        """Track an OPEN phase on this thread; the dump names every
        phase still open at trigger time, innermost last."""
        ident = threading.get_ident()
        entry = (name, time.time())
        with self._lock:
            self._open.setdefault(ident, []).append(entry)
        try:
            yield
        finally:
            closed = time.time() - entry[1]
            with self._lock:
                stack = self._open.get(ident)
                if stack and stack[-1] is entry:
                    stack.pop()
                if not stack:
                    self._open.pop(ident, None)
            self.on_span(entry[0], entry[1], closed, "phase", None)

    # ---------- dumping ----------

    def snapshot(self, reason):
        now = time.time()
        with self._lock:
            open_phases = [
                {
                    "name": name,
                    "age_s": round(now - start, 3),
                    "thread": ident,
                }
                for ident, stack in self._open.items()
                for name, start in stack
            ]
            events = list(self._events)
            rpc = {
                method: {
                    "count": count,
                    "total_ms": round(total_s * 1e3, 2),
                    "mean_ms": round(total_s * 1e3 / max(count, 1), 2),
                }
                for method, (count, total_s) in self._rpc.items()
            }
        # Innermost (most recent) open phase last: the phase it died in.
        open_phases.sort(key=lambda p: -p["age_s"])
        return {
            "role": self.role,
            "reason": reason,
            "ts": now,
            "uptime_s": round(now - self._started, 3),
            "open_phases": open_phases,
            "rpc": rpc,
            "events": events,
        }

    def dump(self, reason):
        """Write the ring to flightrec-<role>.json (atomic). Returns the
        path. Never raises — this runs from signal handlers and
        excepthooks, where a secondary failure would mask the primary."""
        try:
            snap = self.snapshot(reason)
            with self._lock:
                self._dumps += 1
                snap["dump_seq"] = self._dumps
            os.makedirs(self.dump_dir or ".", exist_ok=True)
            path = os.path.join(
                self.dump_dir or ".", f"flightrec-{self.role}.json"
            )
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1)
            os.replace(tmp, path)
            return path
        except Exception:
            return None


# ---------------------------------------------------------------------------
# Module-level lifecycle: one recorder per process, armed triggers.
# ---------------------------------------------------------------------------


def get():
    return _recorder


def _resolve_dir(dump_dir):
    if dump_dir:
        return dump_dir
    configured = knobs.get_str("ELASTICDL_FLIGHTREC_DIR")
    if configured:
        return configured
    obs_dir = knobs.get_str("ELASTICDL_OBS_DIR")
    return obs_dir or "."


def install(role, capacity=None, dump_dir=None, arm_signals=True):
    """Arm the flight recorder for this process (idempotent; returns the
    recorder, or None when ELASTICDL_FLIGHTREC disables it)."""
    global _recorder, _prev_excepthook
    if _recorder is not None:
        return _recorder
    enabled = knobs.get_str("ELASTICDL_FLIGHTREC").strip().lower()
    if enabled in ("0", "false", "off"):
        return None
    if capacity is None:
        capacity = knobs.get_int("ELASTICDL_FLIGHTREC_CAPACITY")
    recorder = FlightRecorder(
        role, max(capacity, 8), _resolve_dir(dump_dir)
    )
    _recorder = recorder
    tracing.add_sink(recorder.on_span)
    _prev_excepthook = sys.excepthook
    sys.excepthook = _crash_hook
    if arm_signals:
        for sig in _SIGNALS:
            try:
                _prev_handlers[sig] = signal.signal(sig, _signal_hook)
            except ValueError:
                # Not the main thread: signal triggers stay with whoever
                # owns them; explicit dump()/excepthook still work.
                pass
    return recorder


def uninstall():
    """Disarm (tests): remove the sink, restore hooks and handlers."""
    global _recorder, _prev_excepthook
    if _recorder is None:
        return
    tracing.remove_sink(_recorder.on_span)
    if sys.excepthook is _crash_hook and _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
    _prev_excepthook = None
    for sig, prev in list(_prev_handlers.items()):
        try:
            if signal.getsignal(sig) is _signal_hook:
                signal.signal(sig, prev)
        except ValueError:
            pass
        _prev_handlers.pop(sig, None)
    _recorder = None


def dump(reason):
    """Dump now (e.g. a watchdog naming the run it abandoned).
    Returns the dump path, or None when no recorder is armed."""
    if _recorder is None:
        return None
    return _recorder.dump(reason)


def phase(name):
    """Context manager marking an open phase; no-op when not armed."""
    if _recorder is None:
        return contextlib.nullcontext()
    return _recorder.phase(name)


def _crash_hook(exc_type, exc, tb):
    if _recorder is not None:
        _recorder.dump(f"crash:{exc_type.__name__}")
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _signal_hook(signum, frame):
    if _recorder is not None:
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        _recorder.dump(f"signal:{name}")
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    # Default/ignored before: restore and re-raise so the process dies
    # with the right wait status (k8s and the drills read it).
    signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
    os.kill(os.getpid(), signum)
