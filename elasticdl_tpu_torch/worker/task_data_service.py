"""Task-to-minibatch pipeline on the worker (counterpart of
elasticdl_tpu/worker/task_data_service.py; the port's rpc.RpcError stands
in for grpc.RpcError, and the chaos seam is left out).

Batches are task-scoped (a minibatch never spans tasks), so "task done" is
exactly "all its minibatches processed", and a recovered task re-runs
whole.
"""

import collections
import itertools
import time

from elasticdl_tpu_torch.chaos import injection
from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.rpc import RpcError, StatusCode
from elasticdl_tpu_torch.observability import datapath
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("worker.task_data_service")

_WAIT_SLEEP_SECONDS = 0.5
# How long the task loop tolerates an unreachable master (restart, stall)
# before letting the failure propagate and the worker exit. Each failed
# poll already burned the rpc plane's per-call retry budget.
_MASTER_PATIENCE_SECONDS = knobs.get_float(
    "ELASTICDL_MASTER_PATIENCE_SECONDS"
)

# Only CONNECTIVITY failures are worth riding out: a stalled or
# restarting master must not kill every worker (one control-plane blip
# would turn into a full fleet relaunch). Fail-fast statuses
# (INVALID_ARGUMENT, INTERNAL, ...) are deterministic — re-sending the
# same call for two minutes cannot fix them, matching the rpc plane's
# own retryability classification.
_CONNECTIVITY_CODES = (
    StatusCode.UNAVAILABLE,
    StatusCode.DEADLINE_EXCEEDED,
)


# A sustained outage usually means the master PROCESS restarted (not a
# network blip). After this long unreachable, a client that can rebuild its
# transport (a `reconnect` method) is asked to, periodically.
_RECONNECT_AFTER_SECONDS = 5.0


def _ride_master_outage(call, what, give_up=None, reconnect=None):
    """Run `call()`, re-trying through connectivity failures for up to the
    patience window. On exhaustion: `give_up(error)` when provided (drop
    semantics), else re-raise. Non-connectivity errors propagate
    immediately. `reconnect()` (when provided) is invoked periodically
    during a sustained outage so the transport can be rebuilt against a
    restarted master."""
    unreachable_since = None
    last_reconnect = 0.0
    while True:
        try:
            return call()
        except RpcError as e:
            code = e.code()
            if code not in _CONNECTIVITY_CODES:
                raise
            now = time.time()
            if unreachable_since is None:
                unreachable_since = now
                logger.warning(
                    "Master unreachable on %s (%s); holding on for up "
                    "to %.0fs",
                    what,
                    getattr(code, "name", code),
                    _MASTER_PATIENCE_SECONDS,
                )
            if now - unreachable_since > _MASTER_PATIENCE_SECONDS:
                if give_up is None:
                    raise
                return give_up(e)
            if (
                reconnect is not None
                and now - unreachable_since >= _RECONNECT_AFTER_SECONDS
                and now - last_reconnect >= _RECONNECT_AFTER_SECONDS
            ):
                last_reconnect = now
                if reconnect():
                    logger.info(
                        "Master accepting again; rebuilt the channel "
                        "(outage %.0fs, during %s)",
                        now - unreachable_since,
                        what,
                    )
            time.sleep(_WAIT_SLEEP_SECONDS * 2)


class TaskDataService:
    def __init__(self, master_client, data_reader):
        self._mc = master_client
        self._reader = data_reader
        # Lease batching (ELASTICDL_TASK_LEASE_BATCH > 1): amortize the
        # get/report round-trips over N tasks — leases arrive in one
        # TaskBatch, completed results accumulate locally and flush as one
        # batched report before the next lease fetch. The default of 1
        # keeps the original one-RPC-per-task protocol byte-for-byte.
        self._lease_batch = max(
            1, knobs.get_int("ELASTICDL_TASK_LEASE_BATCH")
        )
        self._leased = collections.deque()
        self._pending_reports = []
        # task_id -> lease token from the dispatched Task proto, echoed
        # with the result so a report that straddles a master restart
        # (delivered to the old master, retried against the new one)
        # counts exactly once. 0 = legacy master without tokens.
        self._lease_tokens = {}

    def _remember_lease(self, task):
        token = getattr(task, "lease_token", 0)
        if token:
            self._lease_tokens[task.task_id] = token
        return task

    def get_task(self, task_type=pb.TRAINING, wait=True):
        """Next task from the master; blocks through WAIT states (queue
        momentarily empty) and rides out transient master outages. Returns
        None when the job is finished. The whole wait — RPC round-trips
        plus WAIT-state sleeps — lands as the data plane's `task` stage
        (the worker is input-starved on control-plane latency here)."""
        with datapath.get().stage("task"):
            return self._get_task(task_type, wait)

    def _get_task(self, task_type, wait):
        if self._lease_batch > 1 and task_type == pb.TRAINING:
            return self._get_task_batched(wait)
        while True:
            task = _ride_master_outage(
                lambda: self._mc.get_task(task_type), "get_task",
                reconnect=getattr(self._mc, "reconnect", None),
            )
            if task.task_id >= 0:
                return self._remember_lease(task)
            if task.type == pb.WAIT and wait:
                time.sleep(_WAIT_SLEEP_SECONDS)
                continue
            return None

    def _get_task_batched(self, wait):
        """Serve from the local lease buffer; refill with one batched RPC
        (flushing pending result reports first, so the dispatcher's
        accounting never lags more than one buffer behind)."""
        while True:
            if self._leased:
                return self._leased.popleft()
            self.flush_reports()
            try:
                res = _ride_master_outage(
                    lambda: self._mc.get_task_batch(self._lease_batch),
                    "get_task_batch",
                    reconnect=getattr(self._mc, "reconnect", None),
                )
            except RpcError as e:
                if e.code() == StatusCode.UNIMPLEMENTED:
                    # Pre-batching master: drop to the single-task
                    # protocol for the rest of this worker's life.
                    logger.warning(
                        "Master lacks get_task_batch; falling back to "
                        "single-task leases"
                    )
                    self._lease_batch = 1
                    return self._get_task(pb.TRAINING, wait)
                raise
            if res.tasks:
                self._leased.extend(
                    self._remember_lease(t) for t in res.tasks
                )
                continue
            if res.finished:
                return None
            if wait:
                time.sleep(_WAIT_SLEEP_SECONDS)
                continue
            return None

    def try_get_eval_task(self):
        """Non-blocking eval-task poll for interleaving evaluation into the
        training loop."""
        task = self._mc.get_task(pb.EVALUATION)
        return self._remember_lease(task) if task.task_id >= 0 else None

    def read_batches(self, task, batch_size):
        """Yield lists of raw records for the task, batch_size at a time
        (last batch may be smaller).

        Data-plane attribution: with a prefetching reader (it marks
        itself with `datapath_starve_waits`) the producer thread already
        accounts record reads as the `read` stage, so the consumer's
        wait here is `starve` — the step could not start because no
        batch was ready. With a synchronous reader the pull IS the read.
        Records are counted here, at the delivery boundary, exactly
        once."""
        dp = datapath.get()
        wait_stage = (
            "starve"
            if getattr(self._reader, "datapath_starve_waits", False)
            else "read"
        )
        it = iter(self._reader.read_records(task))
        while True:
            with dp.stage(wait_stage) as s:
                if wait_stage == "read":
                    injection.inject_local("datapath.read")
                batch = list(itertools.islice(it, batch_size))
                s.records = len(batch)
            if not batch:
                return
            yield batch
            if len(batch) < batch_size:
                return

    def read_range(self, lease_range):
        """All records of one lease sub-range (LeaseRange carries the same
        shard_name/start/end attributes a Task does, so readers take it
        as-is)."""
        dp = datapath.get()
        with dp.stage("read") as s:
            injection.inject_local("datapath.read")
            records = list(self._reader.read_records(lease_range))
            s.records = len(records)
        return records

    def report_task(self, task_id, err_message="", exec_counters=None):
        """Report a task result, riding out a master outage the same way
        get_task does. A report that never lands is SAFE to drop after the
        patience window: the master's watchdog recovers the still-'doing'
        task and re-dispatches it — whereas letting the error propagate
        kills the worker and turns one control-plane blip into a relaunch.

        Under lease batching, successful results buffer locally and flush
        as one batched RPC (at buffer capacity or before the next lease
        fetch); failures flush immediately so the master's retry ladder
        starts without waiting out the buffer."""
        lease_token = self._lease_tokens.pop(task_id, 0)
        if self._lease_batch > 1:
            self._pending_reports.append(
                (task_id, err_message, exec_counters, lease_token)
            )
            if err_message or (
                len(self._pending_reports) >= self._lease_batch
            ):
                self.flush_reports()
            return

        def dropped(e):
            logger.warning(
                "Dropping result report for task %d after %.0fs of "
                "master unreachability; the watchdog will recover and "
                "re-dispatch it",
                task_id,
                _MASTER_PATIENCE_SECONDS,
            )

        _ride_master_outage(
            lambda: self._mc.report_task_result(
                task_id, err_message, exec_counters,
                lease_token=lease_token,
            ),
            "report_task_result",
            give_up=dropped,
            reconnect=getattr(self._mc, "reconnect", None),
        )

    def flush_reports(self):
        """Send any buffered task results in one batched report. Dropped
        after the patience window with the same watchdog-recovers
        semantics as single reports."""
        if not self._pending_reports:
            return
        reports, self._pending_reports = self._pending_reports, []

        def dropped(e):
            logger.warning(
                "Dropping %d batched result reports after %.0fs of "
                "master unreachability; the watchdog will recover and "
                "re-dispatch them",
                len(reports),
                _MASTER_PATIENCE_SECONDS,
            )

        _ride_master_outage(
            lambda: self._mc.report_task_results(reports),
            "report_task_results",
            give_up=dropped,
            reconnect=getattr(self._mc, "reconnect", None),
        )

    @property
    def data_reader(self):
        return self._reader
