"""Dynamic data sharding: the master's task state machine (counterpart of
elasticdl_tpu/master/task_dispatcher.py, the same decisions in the same
order).

The dataset is partitioned into record-range tasks; workers pull tasks and
report completion; failed tasks are re-queued up to MAX_TASK_RETRIES; a dead
worker's in-flight tasks are recovered; training tasks regenerate per epoch.
This is what makes training elastic without checkpoint-restart — task
assignment is the only distributed state, and it lives here.

Once a write-ahead journal is attached (attach_journal, master/journal.py),
every mutation is mirrored into it through `_j` before the call returns;
without one `_j` records nothing.
"""

import collections
import random
import threading
import time

from elasticdl_tpu_torch.common.constants import MAX_TASK_RETRIES
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("master.task_dispatcher")

_REG = default_registry()
_DISPATCHED = _REG.counter(
    "edl_tasks_dispatched_total",
    "Tasks handed to workers",
    labelnames=("type",),
)
_REPORTED = _REG.counter(
    "edl_tasks_reported_total",
    "Task completions by result",
    labelnames=("result",),
)
_RECOVERED = _REG.counter(
    "edl_tasks_recovered_total",
    "In-flight tasks requeued after worker death/timeouts",
)
_ABANDONED = _REG.counter(
    "edl_tasks_abandoned_total",
    "Tasks dropped after exhausting max_task_retries (fails the job)",
)
_BACKUPS = _REG.counter(
    "edl_backup_tasks_total",
    "Speculative backup task copies, by lifecycle outcome",
    labelnames=("outcome",),
)
_BLACKLISTED = _REG.gauge(
    "edl_workers_blacklisted",
    "Workers currently blacklisted by the dispatcher (no new tasks)",
)
_TODO = _REG.gauge("edl_tasks_todo", "Tasks waiting for dispatch")
_DOING = _REG.gauge("edl_tasks_doing", "Tasks currently in flight")
_RECORDS = _REG.gauge(
    "edl_records_done", "Training records successfully processed"
)
# Control-plane latency: time spent inside the dispatcher's lock per
# operation. Sub-millisecond buckets — at 500 workers the dispatch path
# runs thousands of times a second and this histogram is how the fleet
# harness proves it stays flat.
_DISPATCH_SECONDS = _REG.histogram(
    "edl_master_dispatch_seconds",
    "Task dispatcher critical-section latency, by operation",
    labelnames=("op",),
    buckets=(
        0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
        0.1, 0.5, 1.0,
    ),
)


def _type_name(task_type):
    try:
        return pb.TaskType.Name(task_type)
    except ValueError:
        return str(task_type)


class _Task:
    """A record range [start, end) in a named shard, plus retry accounting."""

    def __init__(self, shard_name, start, end, task_type, model_version=-1):
        self.shard_name = shard_name
        self.start = start
        self.end = end
        self.type = task_type
        self.model_version = model_version
        self.retry_count = 0

    def to_proto(self, task_id):
        return pb.Task(
            task_id=task_id,
            shard_name=self.shard_name,
            start=self.start,
            end=self.end,
            type=self.type,
            model_version=self.model_version,
        )

    def __repr__(self):
        return (
            f"_Task({self.shard_name}[{self.start}:{self.end}] "
            f"type={self.type} v={self.model_version})"
        )


def _task_to_tuple(task):
    """Journal wire form of a task: a plain JSON list (see journal.py)."""
    return [
        task.shard_name, task.start, task.end, int(task.type),
        task.model_version, task.retry_count,
    ]


def _task_from_tuple(t):
    task = _Task(t[0], t[1], t[2], t[3], t[4])
    task.retry_count = t[5]
    return task


class TaskDispatcher:
    """Thread-safe todo/doing task queues with elastic recovery."""

    def __init__(
        self,
        training_shards,
        evaluation_shards=None,
        prediction_shards=None,
        records_per_task=1024,
        num_epochs=1,
        shuffle=True,
        max_task_retries=MAX_TASK_RETRIES,
        seed=None,
    ):
        """Shard dicts map shard_name -> (start_index, num_records)."""
        self._lock = threading.Lock()
        self._training_shards = dict(training_shards or {})
        self._evaluation_shards = dict(evaluation_shards or {})
        self._prediction_shards = dict(prediction_shards or {})
        self._records_per_task = records_per_task
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._max_task_retries = max_task_retries
        self._rng = random.Random(seed)

        self._epoch = 0
        self._next_task_id = 0
        self._todo = collections.deque()  # _Task queue, consumed from the front
        self._doing = {}  # task_id -> (worker_id, _Task, start_time)
        self._job_failed = False
        self._stop_training = False
        self._train_end_pending = False
        # Rolling completion-time stats per task type, for the timeout
        # watchdog.
        self._task_durations = {}  # task_type -> deque of seconds (bounded)
        self._records_done = 0  # successful TRAINING records, for monitors
        self._tasks_recovered = 0  # cumulative, for the job-status RPC
        self._tasks_abandoned = 0  # retry-exhausted drops, ditto
        self._eval_complete_callbacks = []
        self._tasks_done_callbacks = []
        # Policy plane: blacklist + speculative backup copies.
        self._blacklist = {}  # worker_id -> (expires_at, reason)
        self._backup_queue = collections.deque()  # primary ids needing a copy
        self._twins = {}  # task_id <-> twin task_id (both directions)
        self._backup_ids = set()  # ids in _doing that are backup copies
        # Copies retired because their twin won the race: the loser's late
        # report is acknowledged-but-discarded instead of warned about.
        # Entries leave on use or with the job, and the set is bounded by
        # the backup rate limit — at most one per launched backup.
        self._retired_twins = set()
        self._backups_launched = 0
        self._backup_wins = 0
        # Survivable control plane: monotonic lease tokens defend result
        # reports across a master restart, and every mutation below is
        # mirrored into the attached write-ahead journal BEFORE the RPC
        # ack (attach_journal). No journal attached -> zero overhead.
        self._journal = None
        self._next_lease_token = 0
        self._lease_tokens = {}  # task_id -> token, lives with _doing

        if self._training_shards:
            logger.info("Starting epoch 0")
            self._epoch = 1
            self._create_tasks_locked(pb.TRAINING)
        elif self._evaluation_shards:
            self._create_tasks_locked(pb.EVALUATION)
        elif self._prediction_shards:
            self._create_tasks_locked(pb.PREDICTION)

    # ---------- journal plane ----------

    def attach_journal(self, journal):
        """Mirror every mutation into the write-ahead journal from now on.

        Call AFTER construction-time setup (initial task creation,
        set_completed_records fast-forward, restore_state): the caller
        snapshots immediately after attaching, so the WAL only ever holds
        post-start ops and replay never has to re-derive RNG shuffles."""
        with self._lock:
            self._journal = journal

    def _j(self, op):
        """Append one op to the journal (write-ahead: callers hold the
        dispatch lock, so the op lands before the RPC ack leaves)."""
        if self._journal is not None:
            self._journal.record(op)

    def lease_token(self, task_id):
        """The token stamped into the dispatched Task proto (0 = no lease)."""
        with self._lock:
            return self._lease_tokens.get(task_id, 0)

    def export_state(self):
        """Journal-snapshot slice of the dispatcher state (journal.py's
        vocabulary; JSON-safe)."""
        with self._lock:
            return {
                "next_task_id": self._next_task_id,
                "next_lease_token": self._next_lease_token,
                "epoch": self._epoch,
                "todo": [_task_to_tuple(t) for t in self._todo],
                "doing": {
                    str(tid): {
                        "worker": wid,
                        "task": _task_to_tuple(task),
                        "token": self._lease_tokens.get(tid, 0),
                    }
                    for tid, (wid, task, _) in self._doing.items()
                },
                "records_done": self._records_done,
                "tasks_recovered": self._tasks_recovered,
                "tasks_abandoned": self._tasks_abandoned,
                "job_failed": self._job_failed,
                "stop_training": self._stop_training,
                "train_end_pending": self._train_end_pending,
                "twins": {str(k): v for k, v in self._twins.items()},
                "backup_ids": sorted(self._backup_ids),
                "retired_twins": sorted(self._retired_twins),
                "backups_launched": self._backups_launched,
                "backup_wins": self._backup_wins,
                "blacklist": {
                    str(wid): [expires_at, reason]
                    for wid, (expires_at, reason) in self._blacklist.items()
                },
            }

    def restore_state(self, state):
        """Load a replayed journal state (journal.replay output). In-flight
        leases are restored with a RECOVERY-TIME start so the watchdog
        grants reappearing owners a fresh grace window and sweeps the rest;
        the caller emits the lease_reissued trail."""
        now = time.time()
        with self._lock:
            self._epoch = int(state["epoch"])
            self._next_task_id = int(state["next_task_id"])
            self._next_lease_token = int(state["next_lease_token"])
            self._todo = collections.deque(
                _task_from_tuple(t) for t in state["todo"]
            )
            self._doing = {}
            self._lease_tokens = {}
            for tid, entry in state["doing"].items():
                tid = int(tid)
                self._doing[tid] = (
                    entry["worker"], _task_from_tuple(entry["task"]), now
                )
                self._lease_tokens[tid] = int(entry.get("token", 0))
            self._records_done = int(state["records_done"])
            self._tasks_recovered = int(state["tasks_recovered"])
            self._tasks_abandoned = int(state["tasks_abandoned"])
            self._job_failed = bool(state["job_failed"])
            self._stop_training = bool(state["stop_training"])
            self._train_end_pending = bool(state["train_end_pending"])
            self._twins = {
                int(k): int(v) for k, v in state.get("twins", {}).items()
            }
            self._backup_ids = set(state.get("backup_ids", []))
            self._retired_twins = set(state.get("retired_twins", []))
            self._backups_launched = int(state.get("backups_launched", 0))
            self._backup_wins = int(state.get("backup_wins", 0))
            self._blacklist = {
                int(wid): (float(v[0]), str(v[1]))
                for wid, v in state.get("blacklist", {}).items()
            }
            _BLACKLISTED.set(len(self._blacklist))
            self._gauges_locked()

    def inflight_leases(self):
        """[(task_id, worker_id, _Task)] snapshot, for the recovery trail."""
        with self._lock:
            return [
                (tid, wid, task)
                for tid, (wid, task, _) in self._doing.items()
            ]

    # ---------- task creation ----------

    def _shards_for(self, task_type):
        return {
            pb.TRAINING: self._training_shards,
            pb.EVALUATION: self._evaluation_shards,
            pb.PREDICTION: self._prediction_shards,
        }[task_type]

    def _create_tasks_locked(self, task_type, model_version=-1, at_front=False):
        tasks = []
        for name, (start, num_records) in self._shards_for(task_type).items():
            for begin in range(start, start + num_records, self._records_per_task):
                end = min(begin + self._records_per_task, start + num_records)
                tasks.append(_Task(name, begin, end, task_type, model_version))
        if task_type == pb.TRAINING and self._shuffle:
            self._rng.shuffle(tasks)
        if at_front:
            # extendleft reverses; pre-reverse to preserve task order.
            self._todo.extendleft(reversed(tasks))
        else:
            self._todo.extend(tasks)
        self._gauges_locked()
        if tasks:
            self._j({
                "op": "tasks_created",
                "epoch": self._epoch,
                "at_front": at_front,
                "tasks": [_task_to_tuple(t) for t in tasks],
            })
            emit_event(
                "task_create",
                type=_type_name(task_type),
                count=len(tasks),
                epoch=self._epoch,
            )
        return len(tasks)

    def _gauges_locked(self):
        _TODO.set(len(self._todo))
        _DOING.set(len(self._doing))
        _RECORDS.set(self._records_done)

    def set_completed_records(self, records):
        """Fast-forward past already-trained data on restart-from-checkpoint,
        so finished work is not re-dispatched. Whole
        epochs are skipped exactly; the partial epoch is trimmed from the
        front of the current (shuffled) task queue. Call before any worker
        pulls a task."""
        with self._lock:
            if not self._training_shards or records <= 0 or self._doing:
                return 0
            epoch_records = sum(
                n for _, n in self._training_shards.values()
            )
            full_epochs = min(records // epoch_records, self._num_epochs)
            remainder = (
                0
                if full_epochs >= self._num_epochs
                else records - full_epochs * epoch_records
            )
            if full_epochs >= self._num_epochs:
                # Everything already trained: drain training work.
                self._todo = collections.deque(
                    t for t in self._todo if t.type != pb.TRAINING
                )
                self._epoch = self._num_epochs
            elif full_epochs:
                self._epoch = full_epochs + 1
                # The queue currently holds epoch 1's permutation, but the
                # interrupted run was consuming epoch full_epochs+1's — and
                # each epoch rollover advanced the shared shuffle RNG once.
                # Regenerate full_epochs times (discarding all but the
                # last) so the trim below removes the records the original
                # run actually trained.
                self._todo = collections.deque(
                    t for t in self._todo if t.type != pb.TRAINING
                )
                for i in range(full_epochs):
                    n = self._create_tasks_locked(pb.TRAINING)
                    if i < full_epochs - 1:
                        for _ in range(n):
                            self._todo.pop()
            skipped = full_epochs * epoch_records
            if remainder:
                kept = collections.deque()
                for task in self._todo:
                    if task.type != pb.TRAINING or remainder <= 0:
                        kept.append(task)
                        continue
                    size = task.end - task.start
                    if remainder >= size:
                        remainder -= size
                        skipped += size
                    else:
                        task.start += remainder
                        skipped += remainder
                        remainder = 0
                        kept.append(task)
                self._todo = kept
            if skipped:
                # Seed the cumulative counter so monitors/metrics continue
                # from the pre-restart figure instead of restarting at 0.
                self._records_done += skipped
                logger.info(
                    "Resume: skipping %d already-trained records "
                    "(%d full epochs)",
                    skipped,
                    full_epochs,
                )
            return skipped

    def create_evaluation_tasks(self, model_version):
        """Version-triggered eval: tasks go to the FRONT of the queue so
        training workers pick them up promptly."""
        with self._lock:
            n = self._create_tasks_locked(
                pb.EVALUATION, model_version, at_front=True
            )
        logger.info(
            "Created %d evaluation tasks at model version %d", n, model_version
        )
        return n

    def enable_train_end_task(self):
        """Arm a final TRAIN_END_CALLBACK task (model export) dispatched
        exactly once, after all training work drains. The task materializes
        lazily inside finished() so it cannot be picked up mid-epoch."""
        with self._lock:
            self._train_end_pending = bool(self._training_shards)
            self._j({
                "op": "train_end_enabled",
                "pending": self._train_end_pending,
            })

    # ---------- worker-facing operations ----------

    def _roll_epoch_locked(self, drained):
        """One epoch-rollover state machine for both pop paths: when the
        caller-supplied drain condition holds and epochs remain, generate
        the next epoch's (shuffled) training tasks."""
        if (
            drained
            and not self._stop_training
            and self._epoch < self._num_epochs
            and self._training_shards
        ):
            logger.info("Starting epoch %d", self._epoch)
            self._epoch += 1
            self._create_tasks_locked(pb.TRAINING)

    def get(self, worker_id):
        """Pop the next task for a worker; () epoch rollover when the
        training queue drains. Returns (task_id, _Task) or (-1, None)."""
        t0 = time.perf_counter()
        try:
            with self._lock:
                if self._blacklisted_locked(worker_id):
                    return -1, None
                backup = self._serve_backup_locked(worker_id)
                if backup is not None:
                    return backup
                self._roll_epoch_locked(not self._todo)
                if not self._todo:
                    return -1, None
                task = self._todo.popleft()
                task_id = self._next_task_id
                self._next_task_id += 1
                self._doing[task_id] = (worker_id, task, time.time())
                self._next_lease_token += 1
                self._lease_tokens[task_id] = self._next_lease_token
                self._j({
                    "op": "lease",
                    "task_id": task_id,
                    "worker": worker_id,
                    "task": _task_to_tuple(task),
                    "token": self._next_lease_token,
                })
                _DISPATCHED.labels(type=_type_name(task.type)).inc()
                self._gauges_locked()
                return task_id, task
        finally:
            _DISPATCH_SECONDS.labels(op="get").observe(
                time.perf_counter() - t0
            )

    def get_batch(self, worker_id, max_tasks):
        """Lease up to max_tasks tasks in one call: [(task_id, _Task)].
        Shares get()'s blacklist/backup/epoch semantics per popped task."""
        tasks = []
        for _ in range(max(1, max_tasks)):
            task_id, task = self.get(worker_id)
            if task_id < 0:
                break
            tasks.append((task_id, task))
        return tasks

    def get_eval_task(self, worker_id):
        """Pop the first EVALUATION task only."""
        return self.get_typed(worker_id, pb.EVALUATION)

    def get_typed(self, worker_id, task_type):
        """Pop the first task of one type only. For TRAINING this also
        rolls the epoch when the training queue drains (the step-lease
        manager consumes training work through here while evaluation tasks
        stay available to get_eval_task)."""
        t0 = time.perf_counter()
        try:
            with self._lock:
                if self._blacklisted_locked(worker_id):
                    return -1, None
                if task_type == pb.TRAINING:
                    backup = self._serve_backup_locked(worker_id)
                    if backup is not None:
                        return backup
                    self._roll_epoch_locked(
                        not any(t.type == pb.TRAINING for t in self._todo)
                    )
                for i, task in enumerate(self._todo):
                    if task.type == task_type:
                        del self._todo[i]
                        task_id = self._next_task_id
                        self._next_task_id += 1
                        self._doing[task_id] = (
                            worker_id, task, time.time()
                        )
                        self._next_lease_token += 1
                        self._lease_tokens[task_id] = self._next_lease_token
                        self._j({
                            "op": "lease",
                            "task_id": task_id,
                            "worker": worker_id,
                            "task": _task_to_tuple(task),
                            "token": self._next_lease_token,
                        })
                        _DISPATCHED.labels(
                            type=_type_name(task.type)
                        ).inc()
                        self._gauges_locked()
                        return task_id, task
                return -1, None
        finally:
            _DISPATCH_SECONDS.labels(op="get").observe(
                time.perf_counter() - t0
            )

    # ---------- policy plane: blacklist + speculative backups ----------

    def _blacklisted_locked(self, worker_id, now=None):
        entry = self._blacklist.get(worker_id)
        if entry is None:
            return False
        expires_at, _ = entry
        if (now or time.time()) >= expires_at:
            # TTL expiry re-admits the worker even if its relaunch never
            # completed — the self-healing default.
            del self._blacklist[worker_id]
            _BLACKLISTED.set(len(self._blacklist))
            return False
        return True

    def blacklist_worker(self, worker_id, ttl_seconds, reason=""):
        """No new task routes to this worker until the TTL expires or
        unblacklist_worker is called. In-flight tasks are untouched (the
        caller decides whether to recover them)."""
        with self._lock:
            until = time.time() + max(ttl_seconds, 0.0)
            self._blacklist[worker_id] = (until, reason)
            self._j({
                "op": "blacklist",
                "worker": worker_id,
                "until": until,
                "reason": reason[:200],
            })
            _BLACKLISTED.set(len(self._blacklist))
        emit_event(
            "worker_blacklist",
            worker=worker_id,
            ttl_seconds=round(ttl_seconds, 1),
            reason=reason[:200],
        )
        logger.info(
            "Blacklisted worker %d for %.0fs (%s)",
            worker_id, ttl_seconds, reason,
        )

    def unblacklist_worker(self, worker_id):
        with self._lock:
            removed = self._blacklist.pop(worker_id, None) is not None
            if removed:
                self._j({"op": "unblacklist", "worker": worker_id})
            _BLACKLISTED.set(len(self._blacklist))
        if removed:
            emit_event("worker_blacklist", worker=worker_id, cleared=True)
        return removed

    def blacklisted_workers(self):
        """Currently blacklisted worker ids (expired entries dropped)."""
        now = time.time()
        with self._lock:
            return sorted(
                wid for wid in list(self._blacklist)
                if self._blacklisted_locked(wid, now)
            )

    def backup_candidates(self, factor=3.0, min_samples=5, limit=1):
        """In-flight TRAINING tasks running > factor x the rolling mean
        completion time with no backup copy yet, slowest first:
        [(task_id, worker_id, elapsed_seconds)]."""
        now = time.time()
        with self._lock:
            durations = self._task_durations.get(pb.TRAINING, [])
            if len(durations) < min_samples:
                return []
            mean = max(sum(durations) / len(durations), 1e-3)
            queued = set(self._backup_queue)
            out = []
            for tid, (wid, task, start) in self._doing.items():
                if task.type != pb.TRAINING:
                    continue
                if tid in self._twins or tid in self._backup_ids:
                    continue
                if tid in queued:
                    continue
                elapsed = now - start
                if elapsed > factor * mean:
                    out.append((tid, wid, elapsed))
            out.sort(key=lambda item: -item[2])
            return out[:limit]

    def request_backup(self, task_id):
        """Queue a speculative second copy of an in-flight TRAINING task.
        The copy goes to the next eligible worker that asks for work (never
        the primary's owner); first result wins, the loser's late report is
        acknowledged and discarded, records_done counts once."""
        with self._lock:
            entry = self._doing.get(task_id)
            if (
                entry is None
                or entry[1].type != pb.TRAINING
                or task_id in self._twins
                or task_id in self._backup_ids
                or task_id in self._backup_queue
            ):
                return False
            self._backup_queue.append(task_id)
        _BACKUPS.labels(outcome="requested").inc()
        emit_event("backup_task", task_id=task_id, phase="requested")
        return True

    def _serve_backup_locked(self, worker_id):
        """Hand a queued backup copy to worker_id if one is eligible (the
        primary is still in flight and owned by someone else). Returns
        (backup_task_id, _Task) or None."""
        for _ in range(len(self._backup_queue)):
            primary_id = self._backup_queue.popleft()
            entry = self._doing.get(primary_id)
            if entry is None or primary_id in self._twins:
                continue  # primary resolved (or raced) while queued
            owner_id, task, _ = entry
            if owner_id == worker_id:
                # Never give the straggler its own backup; retry later.
                self._backup_queue.append(primary_id)
                continue
            backup_id = self._next_task_id
            self._next_task_id += 1
            self._doing[backup_id] = (worker_id, task, time.time())
            self._twins[primary_id] = backup_id
            self._twins[backup_id] = primary_id
            self._backup_ids.add(backup_id)
            self._backups_launched += 1
            self._next_lease_token += 1
            self._lease_tokens[backup_id] = self._next_lease_token
            self._j({
                "op": "backup_lease",
                "task_id": backup_id,
                "primary_id": primary_id,
                "worker": worker_id,
                "task": _task_to_tuple(task),
                "token": self._next_lease_token,
            })
            _DISPATCHED.labels(type=_type_name(task.type)).inc()
            _BACKUPS.labels(outcome="dispatched").inc()
            self._gauges_locked()
            emit_event(
                "backup_task",
                task_id=primary_id,
                backup_id=backup_id,
                phase="dispatched",
                worker=worker_id,
                primary_worker=owner_id,
            )
            return backup_id, task
        return None

    def _resolve_twin_locked(self, task_id, success):
        """First-result-wins bookkeeping for a reported copy of a twinned
        task. Returns (verdict, twin_id): "win" (count this report's
        records), "lone_failure" (no live twin: run the normal retry
        ladder), or "copy_failed" (this copy failed but its twin is still
        racing: discard). twin_id is the retired twin, None when untwinned."""
        twin_id = self._twins.pop(task_id, None)
        if twin_id is None:
            return ("win" if success else "lone_failure"), None
        self._twins.pop(twin_id, None)
        if success:
            # Retire the losing copy: its in-flight entry leaves _doing
            # now and its eventual late report is ack-and-discard.
            if self._doing.pop(twin_id, None) is not None:
                self._retired_twins.add(twin_id)
                self._backup_ids.discard(twin_id)
                self._lease_tokens.pop(twin_id, None)
            self._backup_wins += 1
            outcome = (
                "backup_win" if task_id in self._backup_ids
                else "primary_win"
            )
            _BACKUPS.labels(outcome=outcome).inc()
            emit_event(
                "backup_task",
                task_id=task_id,
                twin=twin_id,
                phase=outcome,
            )
            return "win", twin_id
        # This copy failed but the twin is still running: the twin owns
        # the work now (requeueing here would triple-run the range).
        _BACKUPS.labels(outcome="copy_failed").inc()
        emit_event(
            "backup_task", task_id=task_id, twin=twin_id,
            phase="copy_failed",
        )
        return "copy_failed", twin_id

    def report(self, task_id, success, err_message="", lease_token=0):
        """Worker finished (or failed) a task. Failed tasks are re-queued at
        the front until retries are exhausted, which fails the job.

        lease_token defends exactly-once accounting across master restarts:
        a nonzero token that mismatches the stored lease is a report for a
        lease this incarnation never issued (or already resolved) — it is
        acknowledged and discarded. Token 0 is the legacy/no-journal path
        and is always accepted."""
        t0 = time.perf_counter()
        try:
            return self._report_timed(task_id, success, err_message,
                                      lease_token)
        finally:
            _DISPATCH_SECONDS.labels(op="report").observe(
                time.perf_counter() - t0
            )

    def _report_timed(self, task_id, success, err_message="", lease_token=0):
        with self._lock:
            if lease_token:
                stored = self._lease_tokens.get(task_id)
                if stored is not None and stored != lease_token:
                    # Stale lease: the report belongs to a superseded lease
                    # of the same task id (re-issued after recovery). Ack
                    # and discard — the live lease owns the accounting.
                    _REPORTED.labels(result="stale_lease").inc()
                    emit_event(
                        "task_stale_lease", task_id=task_id,
                        token=lease_token, expected=stored,
                    )
                    return None
            entry = self._doing.pop(task_id, None)
            if entry is None:
                if task_id in self._retired_twins:
                    # The loser of a backup race reporting late: its twin
                    # already won and took the accounting. Acknowledge and
                    # discard — records_done must never double-count.
                    self._retired_twins.discard(task_id)
                    _REPORTED.labels(result="duplicate").inc()
                    emit_event(
                        "backup_task", task_id=task_id,
                        phase="late_duplicate",
                    )
                    return None
                logger.warning("Unknown task id reported: %d", task_id)
                return None
            self._lease_tokens.pop(task_id, None)
            worker_id, task, start_time = entry
            verdict, twin_id = self._resolve_twin_locked(task_id, success)
            self._backup_ids.discard(task_id)
            if verdict == "copy_failed":
                # Failed copy of a still-racing twin: no retry ladder.
                self._j({"op": "dropped", "task_id": task_id})
                self._gauges_locked()
                return task
            if success:
                _REPORTED.labels(result="success").inc()
                self._task_durations.setdefault(
                    task.type, collections.deque(maxlen=100)
                ).append(time.time() - start_time)
                if task.type == pb.TRAINING:
                    self._records_done += task.end - task.start
                self._j({
                    "op": "done",
                    "task_id": task_id,
                    "records": (
                        task.end - task.start
                        if task.type == pb.TRAINING else 0
                    ),
                    "retire_twin": twin_id,
                    "backup_win": twin_id is not None,
                })
                evaluation_done = task.type == pb.EVALUATION
                job_done = self._finished_locked()
            elif self._stop_training and task.type == pb.TRAINING:
                # Early stop: don't resurrect failed training tasks.
                self._j({"op": "dropped", "task_id": task_id})
                evaluation_done = False
                job_done = self._finished_locked()
            else:
                _REPORTED.labels(result="failure").inc()
                task.retry_count += 1
                if task.retry_count > self._max_task_retries:
                    logger.error(
                        "Task %s failed %d times (last: %s); abandoning "
                        "it and failing the job",
                        task,
                        task.retry_count,
                        err_message,
                    )
                    self._abandon_locked(task, task_id, worker_id,
                                         err_message)
                    emit_event(
                        "job_failed",
                        task_id=task_id,
                        worker=worker_id,
                        error=err_message[:200],
                    )
                    # Terminal: drop remaining work so workers drain and
                    # exit; the master process checks job_failed.
                    self._todo.clear()
                else:
                    logger.warning(
                        "Re-queueing failed task %s (%s)", task, err_message
                    )
                    emit_event(
                        "task_failed",
                        task_id=task_id,
                        worker=worker_id,
                        retry=task.retry_count,
                        error=err_message[:200],
                    )
                    self._todo.appendleft(task)
                    self._j({
                        "op": "failed_requeue",
                        "task_id": task_id,
                        "task": _task_to_tuple(task),
                    })
                evaluation_done = False
                job_done = False
            self._gauges_locked()
        # Callbacks run outside the lock: they may call back into us.
        if success and evaluation_done:
            for cb in self._eval_complete_callbacks:
                cb(task_id, task)
        if success and job_done:
            for cb in self._tasks_done_callbacks:
                cb()
        return task

    def fail_owner_tasks(self, owner_id, err_message=""):
        """Requeue every in-flight task of an owner THROUGH the retry
        ladder (unlike recover_tasks, which requeues for free). Used for
        fault-attributed lease aborts: a deterministic per-range failure
        must exhaust max_task_retries and fail the job, exactly as the
        same error would on the non-lease path, instead of relenting
        forever."""
        failed = []
        with self._lock:
            ids = [
                tid
                for tid, (wid, _, _) in self._doing.items()
                if wid == owner_id
            ]
            for tid in ids:
                _, task, _ = self._doing.pop(tid)
                self._lease_tokens.pop(tid, None)
                if self._drop_copy_if_twinned_locked(tid):
                    self._j({"op": "dropped", "task_id": tid})
                    continue
                if self._stop_training and task.type == pb.TRAINING:
                    self._j({"op": "dropped", "task_id": tid})
                    continue
                task.retry_count += 1
                if task.retry_count > self._max_task_retries:
                    failed.append(task)
                    self._abandon_locked(task, tid, owner_id, err_message)
                    self._todo.clear()
                else:
                    self._todo.appendleft(task)
                    self._j({
                        "op": "failed_requeue",
                        "task_id": tid,
                        "task": _task_to_tuple(task),
                    })
            self._gauges_locked()
        for task in failed:
            logger.error(
                "Task %s failed %d times (last: %s); failing job",
                task,
                task.retry_count,
                err_message,
            )
        if ids:
            emit_event(
                "task_reassign",
                worker=owner_id,
                count=len(ids),
                penalized=True,
                error=err_message[:200],
            )
        if ids and not failed:
            logger.warning(
                "Re-queueing %d failed tasks of owner %d (%s)",
                len(ids),
                owner_id,
                err_message,
            )

    def _drop_copy_if_twinned_locked(self, tid):
        """A popped in-flight task copy turned out to be half of a backup
        twin pair. Break the links; True when the OTHER copy is still in
        flight (so this one is simply dropped, not requeued)."""
        twin_id = self._twins.pop(tid, None)
        if twin_id is None:
            return False
        self._twins.pop(twin_id, None)
        self._backup_ids.discard(tid)
        _BACKUPS.labels(outcome="copy_recovered").inc()
        emit_event(
            "backup_task", task_id=tid, twin=twin_id,
            phase="copy_recovered",
        )
        return twin_id in self._doing

    def _abandon_locked(self, task, task_id, worker_id, err_message):
        """A task's retry ladder is exhausted: count it LOUDLY (elasticity
        event + counter + job-status field) and fail the job. A silently
        vanishing task is the one failure mode a monitor can never
        distinguish from slow progress."""
        self._tasks_abandoned += 1
        self._job_failed = True
        self._j({
            "op": "abandoned",
            "task_id": task_id,
            "job_failed": True,
        })
        _ABANDONED.inc()
        emit_event(
            "task_abandoned",
            task_id=task_id,
            worker=worker_id,
            shard=task.shard_name,
            start=task.start,
            end=task.end,
            retries=task.retry_count,
            error=err_message[:200],
        )

    def recover_tasks(self, worker_id):
        """Re-queue every in-flight task owned by a dead worker. Called by
        the instance manager on pod failure and by the timeout watchdog."""
        with self._lock:
            ids = [
                tid
                for tid, (wid, _, _) in self._doing.items()
                if wid == worker_id
            ]
            requeued = 0
            recovered_ids, recovered_tasks = [], []
            for tid in ids:
                _, task, _ = self._doing.pop(tid)
                self._lease_tokens.pop(tid, None)
                if self._drop_copy_if_twinned_locked(tid):
                    # A copy of a still-racing twin dies with its worker:
                    # the surviving copy owns the work, nothing to requeue.
                    self._j({"op": "dropped", "task_id": tid})
                    continue
                if self._stop_training and task.type == pb.TRAINING:
                    self._j({"op": "dropped", "task_id": tid})
                    continue
                self._todo.appendleft(task)
                requeued += 1
                recovered_ids.append(tid)
                recovered_tasks.append(_task_to_tuple(task))
            if recovered_ids:
                self._j({
                    "op": "recovered",
                    "worker": worker_id,
                    "task_ids": recovered_ids,
                    "tasks": recovered_tasks,
                })
            self._tasks_recovered += requeued
            self._gauges_locked()
        if requeued:
            _RECOVERED.inc(requeued)
            emit_event(
                "task_reassign",
                worker=worker_id,
                count=requeued,
                task_ids=ids[:32],
            )
            logger.info(
                "Recovered %d tasks from worker %d", requeued, worker_id
            )

    # ---------- status ----------

    def _finished_locked(self):
        epochs_exhausted = (
            not self._training_shards
            or self._epoch >= self._num_epochs
            or self._stop_training
        )
        done = (not self._todo) and (not self._doing) and epochs_exhausted
        if done and self._train_end_pending and not self._job_failed:
            # All training/eval work drained: NOW dispatch the armed
            # train-end task (model export) and report not-finished until a
            # worker completes it.
            self._train_end_pending = False
            name = next(iter(self._training_shards))
            task = _Task(name, 0, 0, pb.TRAIN_END_CALLBACK)
            self._todo.append(task)
            self._j({
                "op": "train_end_consumed",
                "task": _task_to_tuple(task),
            })
            logger.info("Dispatching train-end callback task")
            return False
        return done

    def training_exhausted(self):
        """True when no TRAINING task exists or can ever appear again (todo
        and doing are training-free and the epochs are spent). Once true it
        stays true: new training tasks come only from epoch rollover or
        from requeueing in-flight ones. The lease loop exits on this rather
        than on finished(), which stays False while evaluation/train-end
        work remains."""
        with self._lock:
            if any(t.type == pb.TRAINING for t in self._todo):
                return False
            if any(
                task.type == pb.TRAINING
                for (_, task, _) in self._doing.values()
            ):
                return False
            return (
                not self._training_shards
                or self._epoch >= self._num_epochs
                or self._stop_training
            )

    def finished(self):
        # NB: after stop_training() this still waits for in-flight tasks and
        # queued evaluation tasks to drain (_finished_locked treats the
        # remaining epochs as exhausted) so final evals are not orphaned.
        with self._lock:
            return self._finished_locked()

    @property
    def job_failed(self):
        return self._job_failed

    def stop_training(self):
        """Early-stop hook (max-steps / callback driven)."""
        with self._lock:
            self._stop_training = True
            self._todo = collections.deque(
                t for t in self._todo if t.type != pb.TRAINING
            )
            self._j({
                "op": "stop_training",
                "training_type": int(pb.TRAINING),
            })

    def doing_tasks_over_timeout(self, factor=3.0, min_samples=5):
        """Worker ids whose in-flight task has run > factor x the rolling mean
        completion time for its type."""
        now = time.time()
        with self._lock:
            slow_workers = set()
            for tid, (wid, task, start) in self._doing.items():
                durations = self._task_durations.get(task.type, [])
                if len(durations) < min_samples:
                    continue
                mean = sum(durations) / len(durations)
                if now - start > factor * max(mean, 1e-3):
                    slow_workers.add(wid)
            return slow_workers

    def add_evaluation_complete_callback(self, cb):
        self._eval_complete_callbacks.append(cb)

    def add_tasks_done_callback(self, cb):
        self._tasks_done_callbacks.append(cb)

    def pending_tasks(self, task_type):
        """Tasks of `task_type` queued or in flight; a backup copy counts
        with its primary, as only one of the two completes."""
        with self._lock:
            return sum(t.type == task_type for t in self._todo) + sum(
                task.type == task_type and tid not in self._backup_ids
                for tid, (_, task, _) in self._doing.items()
            )

    def counts(self):
        stats = self.stats()
        return {"todo": stats["todo"], "doing": stats["doing"]}

    def stats(self):
        """Telemetry snapshot for monitors / the metrics service."""
        with self._lock:
            doing_by_worker = {}
            for wid, _, _ in self._doing.values():
                doing_by_worker[wid] = doing_by_worker.get(wid, 0) + 1
            now = time.time()
            blacklisted = sorted(
                wid for wid in list(self._blacklist)
                if self._blacklisted_locked(wid, now)
            )
            return {
                "todo": len(self._todo),
                "doing": len(self._doing),
                "doing_by_worker": doing_by_worker,
                "epoch": self._epoch,
                "num_epochs": self._num_epochs,
                "epoch_records": sum(
                    n for _, n in self._training_shards.values()
                ),
                "records_done": self._records_done,
                "tasks_recovered": self._tasks_recovered,
                "tasks_abandoned": self._tasks_abandoned,
                "job_failed": self._job_failed,
                "blacklisted": blacklisted,
                "backups_inflight": len(self._backup_ids),
                "backups_launched": self._backups_launched,
                "backup_wins": self._backup_wins,
            }
