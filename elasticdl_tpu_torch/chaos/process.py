"""Process-level fault primitives for chaos drills (counterpart of
elasticdl_tpu/chaos/process.py).

Roles are addressed by command-line pattern: every instance of a local job
carries the master address on its argv, so (module, master_port, extra
needles) uniquely identifies one process without tracking pids across
relaunches. Command lines are read from /proc (Linux), where the JAX
package asks `pgrep -af`: the card's machine need not have procps."""

import os
import random
import signal
import time

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("chaos.process")

ROLE_MODULES = {
    "worker": "elasticdl_tpu_torch.worker.main",
    "ps": "elasticdl_tpu_torch.ps.main",
}


def _command_lines(module):
    """[(pid, command line)] of the live processes, this one aside, whose
    command line holds `module` (what `pgrep -af module` lists)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                raw = f.read()
        except OSError:
            continue  # gone, or not ours to read
        line = raw.rstrip(b"\0").replace(b"\0", b" ").decode(
            "utf-8", "replace")
        if module in line:
            out.append((int(entry), line))
    return out


def find_role_pid(role, instance_id, master_port, timeout=60):
    """Pid of the live worker/PS subprocess with this id in the job rooted
    at master_port. Raises RuntimeError when none shows up in time."""
    module = ROLE_MODULES[role]
    id_flag = "--worker_id" if role == "worker" else "--ps_id"
    needles = (
        f"--master_addr 127.0.0.1:{master_port}",
        f"{id_flag} {instance_id}",
    )
    deadline = time.time() + timeout
    while time.time() < deadline:
        for pid, line in _command_lines(module):
            if all(n in line for n in needles):
                return pid
        time.sleep(0.2)
    raise RuntimeError(
        f"{role} {instance_id} process not found for master port "
        f"{master_port}"
    )


def find_job_pids(master_port):
    """All live worker/PS pids of the job rooted at master_port (the
    leftover-process check drills run at teardown)."""
    pids = []
    needle = f"--master_addr 127.0.0.1:{master_port}"
    for module in ROLE_MODULES.values():
        for pid, line in _command_lines(module):
            if needle in line:
                pids.append((pid, line))
    return pids


def deliver(pid, sig):
    """Send a signal, tolerating an already-gone target. Returns True when
    the signal was delivered."""
    try:
        os.kill(pid, sig)
        return True
    except ProcessLookupError:
        return False


def kill_role(role, instance_id, master_port, timeout=60):
    """SIGKILL one role instance; returns its pid."""
    pid = find_role_pid(role, instance_id, master_port, timeout)
    logger.info("chaos: SIGKILL %s %d (pid %d)", role, instance_id, pid)
    deliver(pid, signal.SIGKILL)
    return pid


def preemption_wave(n_workers, master_port, fraction=0.3, seed=0,
                    timeout=60):
    """SIGKILL a seeded fraction of the job's workers in one sweep — the
    spot/maintenance preemption wave, process edition. Victims are drawn
    deterministically from (n_workers, fraction, seed); workers that are
    already gone are skipped. Returns [(worker_id, pid), ...] actually
    killed."""
    rng = random.Random(seed)
    n_victims = max(1, int(round(n_workers * fraction)))
    victims = sorted(
        rng.sample(range(n_workers), min(n_workers, n_victims))
    )
    logger.info(
        "chaos: preemption wave over workers %s (%.0f%% of %d)",
        victims, 100 * fraction, n_workers,
    )
    killed = []
    for wid in victims:
        try:
            pid = find_role_pid("worker", wid, master_port, timeout)
        except RuntimeError:
            continue
        if deliver(pid, signal.SIGKILL):
            killed.append((wid, pid))
    return killed


def stall(pid, seconds):
    """SIGSTOP a process for `seconds`, then SIGCONT it. Returns True when
    both signals were delivered (the target survived the stall)."""
    if not deliver(pid, signal.SIGSTOP):
        return False
    logger.info("chaos: SIGSTOP pid %d for %.1fs", pid, seconds)
    try:
        time.sleep(seconds)
    finally:
        resumed = deliver(pid, signal.SIGCONT)
    return resumed
