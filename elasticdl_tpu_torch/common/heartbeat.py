"""Master heartbeat files for the orphan reaper (tools/reap_orphans.py;
counterpart of elasticdl_tpu/common/heartbeat.py, the same file format).

A SIGKILLed or wedged launcher strands its whole `edl train` process tree:
workers block in rendezvous, the master keeps its ports, and every later
benchmark or chaos run on the machine inherits the noise. Each master therefore
writes a small JSON heartbeat — pid, process group, a /proc-verifiable
cmdline marker, and a timestamp — to a central directory on a short
period. The reaper kills the process group of any heartbeat that went
stale while its pid still runs the recorded command, and deletes
heartbeats of dead pids. The cmdline check makes pid reuse safe: a
recycled pid running something else is never signalled.

Heartbeats are best-effort by design: a full disk or read-only dir must
never take training down, so every write failure is swallowed after the
first warning.
"""

import json
import os
import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.heartbeat")

HEARTBEAT_DIR_ENV = "ELASTICDL_HEARTBEAT_DIR"
HEARTBEAT_SECONDS_ENV = "ELASTICDL_HEARTBEAT_SECONDS"


def read_cmdline(pid):
    """The process's argv joined with spaces, or None when it is gone
    (or /proc is unreadable — non-Linux; the reaper then refuses to
    kill, which fails safe)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            raw = f.read()
    except OSError:
        return None
    return raw.replace(b"\0", b" ").decode(errors="replace").strip()


class HeartbeatWriter:
    """Periodic `<dir>/<job>-<pid>.json` toucher for one master."""

    def __init__(self, job="", directory=None, period=None):
        if directory is None:
            directory = knobs.get_str(HEARTBEAT_DIR_ENV)
        if period is None:
            period = knobs.get_float(HEARTBEAT_SECONDS_ENV)
        self._dir = directory
        self.period = float(period)
        self._job = job or "job"
        self.path = (
            os.path.join(
                directory, f"{self._job}-{os.getpid()}.json"
            )
            if directory
            else None
        )
        self._warned = False
        self._stop = threading.Event()
        self._thread = None

    @property
    def enabled(self):
        return bool(self.path) and self.period > 0

    def beat(self):
        """Write one heartbeat now (also the thread body's step)."""
        if not self.path:
            return False
        record = {
            "pid": os.getpid(),
            "pgid": os.getpgid(0),
            "job": self._job,
            "ts": time.time(),
            "period_s": self.period,
            # The reaper only kills while the pid still runs THIS
            # command — pid reuse by an unrelated process fails the
            # match and spares it.
            "cmdline": read_cmdline(os.getpid()) or "",
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self._dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self.path)
            return True
        except OSError as e:
            if not self._warned:
                self._warned = True
                logger.warning("heartbeat write failed: %s", e)
            return False

    def start(self):
        if not self.enabled or self._thread is not None:
            return self
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name="edl-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.period):
            self.beat()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.path:
            try:
                os.unlink(self.path)
            except OSError:
                pass
