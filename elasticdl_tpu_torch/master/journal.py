"""Write-ahead journal + snapshot plane for job-critical master state
(counterpart of elasticdl_tpu/master/journal.py; one on-disk format for both
packages: either replays the other's files).

The master is the one component whose death used to kill the job
unrecoverably: the task queue, records_done accounting, membership epoch,
world-hint seq, and policy cooldowns all lived only in process memory.
This module externalizes that state so a relaunched master replays it and
re-enters the job with a bumped incarnation.

Stdlib only — no torch, no proto imports — so the unit surface runs in
milliseconds.

On-disk layout (under ELASTICDL_MASTER_JOURNAL_DIR):

    snapshot.json       last compacted full state (atomic os.replace)
    snapshot.json.tmp   torn snapshot litter — ignored at load (the
                        previous snapshot stays authoritative, as for a
                        torn checkpoint)
    wal.log             CRC-framed append records SINCE the snapshot

WAL framing, per record:

    [4-byte LE payload length][4-byte LE zlib.crc32][payload JSON bytes]

Read rules: an *incomplete* frame at EOF is a torn tail from a crash
mid-append — silently dropped, never poisons replay. A *complete* frame
whose CRC mismatches is real corruption mid-file — fails loudly
(JournalCorruptError) because silently skipping it would desync the
replayed state machine from the acked RPC history.

Write-ahead ordering contract: every mutating op is appended (and fsynced
when durable) BEFORE the RPC ack leaves the master.  That is what makes
result reporting exactly-once across a master restart: a `done` journaled
then crashed is replayed, so the worker's retried report hits the
unknown-task discard path; a crash *before* the append leaves the lease
in doing, so the retried report is accepted exactly once.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

_FRAME_HEADER = struct.Struct("<II")  # payload length, crc32(payload)

SNAPSHOT_NAME = "snapshot.json"
WAL_NAME = "wal.log"


class JournalCorruptError(RuntimeError):
    """A complete mid-file record failed its CRC — replay must not continue."""


def _encode_frame(payload: bytes) -> bytes:
    return _FRAME_HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def read_frames(data: bytes) -> List[dict]:
    """Decode framed records; torn tail dropped, mid-file corruption loud."""
    out: List[dict] = []
    off, n = 0, len(data)
    while off < n:
        if off + _FRAME_HEADER.size > n:
            break  # torn tail: header itself truncated
        length, crc = _FRAME_HEADER.unpack_from(data, off)
        start = off + _FRAME_HEADER.size
        end = start + length
        if end > n:
            break  # torn tail: payload truncated by the crash
        payload = data[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise JournalCorruptError(
                "journal record at offset %d failed CRC (len=%d)" % (off, length)
            )
        out.append(json.loads(payload.decode("utf-8")))
        off = end
    return out


class Journal:
    """Low-level framed WAL + atomic snapshot pair in one directory."""

    def __init__(self, directory: str, durable: bool = True):
        self._dir = directory
        self._durable = durable
        os.makedirs(directory, exist_ok=True)
        self._snapshot_path = os.path.join(directory, SNAPSHOT_NAME)
        self._wal_path = os.path.join(directory, WAL_NAME)
        self._lock = threading.Lock()
        self._wal_f = open(self._wal_path, "ab")

    # -- read side ---------------------------------------------------------

    def load(self) -> Tuple[Optional[dict], List[dict]]:
        """Return (snapshot_state_or_None, wal_ops). Torn .tmp litter ignored."""
        snapshot = None
        if os.path.exists(self._snapshot_path):
            with open(self._snapshot_path, "rb") as f:
                snapshot = json.loads(f.read().decode("utf-8"))
        with open(self._wal_path, "rb") as f:
            ops = read_frames(f.read())
        return snapshot, ops

    # -- write side --------------------------------------------------------

    def append(self, op: dict) -> None:
        payload = json.dumps(op, separators=(",", ":"), sort_keys=True).encode("utf-8")
        with self._lock:
            self._wal_f.write(_encode_frame(payload))
            self._wal_f.flush()
            if self._durable:
                os.fsync(self._wal_f.fileno())

    def snapshot(self, state: dict) -> None:
        """Atomically replace the snapshot and truncate the WAL (compaction).

        Crash before os.replace leaves `.tmp` litter and the previous
        snapshot + full WAL authoritative; crash after it but before the
        truncate merely replays ops already folded into the snapshot,
        which the replay machine tolerates (ops are keyed by ids that the
        snapshot already consumed — see replay()).  To keep that window
        harmless we truncate FIRST into a fresh WAL handle, then publish.
        """
        payload = json.dumps(state, separators=(",", ":"), sort_keys=True).encode(
            "utf-8"
        )
        tmp = self._snapshot_path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                if self._durable:
                    os.fsync(f.fileno())
            # Publish the snapshot, then reset the WAL: if we crash between
            # the two, replaying the stale WAL on top of the new snapshot
            # must be idempotent — replay() drops ops whose subjects the
            # snapshot has already retired.
            os.replace(tmp, self._snapshot_path)
            self._wal_f.close()
            self._wal_f = open(self._wal_path, "wb")
            self._wal_f.flush()
            if self._durable:
                os.fsync(self._wal_f.fileno())

    def close(self) -> None:
        with self._lock:
            try:
                self._wal_f.close()
            except Exception:  # noqa: BLE001 - close is best-effort
                pass


# ---------------------------------------------------------------------------
# Replay state machine
# ---------------------------------------------------------------------------
#
# The journaled state is a plain JSON dict with this shape (all keys always
# present after empty_state()):
#
#   incarnation        int   bumped by each master (re)start
#   next_task_id       int   dispatcher allocation cursor
#   next_lease_token   int   monotonic lease-token cursor
#   epoch              int   dispatcher epoch cursor
#   todo               list  of task tuples [shard, start, end, type, mv, retry]
#   doing              dict  task_id(str) -> {worker, task, token}
#   records_done       int
#   tasks_recovered    int
#   tasks_abandoned    int
#   job_failed         bool
#   stop_training      bool
#   train_end_pending  bool
#   done_ids           list  task_ids acked done (retired-lease dedup ring)
#   twins              dict  task_id(str) -> twin task_id
#   backup_ids         list
#   retired_twins      list
#   backups_launched   int
#   backup_wins        int
#   blacklist          dict  worker -> expiry ts (absolute)
#   hint_seq           int   world-hint board cursor
#   hint_target        int
#   hint_reason        str
#   membership_epoch   int
#   cooldowns          dict  "action|subject" -> ts (policy hysteresis)
#   train_end_enabled  bool
#
# Tasks travel the journal as 6-tuples (lists in JSON):
#   [shard_name, start, end, task_type, model_version, retry_count]

TaskTuple = List[Any]

# Retired-lease dedup ring: enough to absorb any realistic in-flight set
# while bounding snapshot size.
_DONE_RING = 4096


def empty_state() -> Dict[str, Any]:
    return {
        "incarnation": 0,
        "next_task_id": 0,
        "next_lease_token": 0,
        "epoch": 0,
        "todo": [],
        "doing": {},
        "records_done": 0,
        "tasks_recovered": 0,
        "tasks_abandoned": 0,
        "job_failed": False,
        "stop_training": False,
        "train_end_pending": False,
        "done_ids": [],
        "twins": {},
        "backup_ids": [],
        "retired_twins": [],
        "backups_launched": 0,
        "backup_wins": 0,
        "blacklist": {},
        "hint_seq": 0,
        "hint_target": 0,
        "hint_reason": "",
        "membership_epoch": 0,
        "cooldowns": {},
        "train_end_enabled": False,
    }


def _trim_ring(state: Dict[str, Any]) -> None:
    if len(state["done_ids"]) > _DONE_RING:
        del state["done_ids"][: len(state["done_ids"]) - _DONE_RING]


def _drop_twin_links(state: Dict[str, Any], tid: str) -> None:
    twin = state["twins"].pop(tid, None)
    if twin is not None:
        state["twins"].pop(str(twin), None)


def apply_op(state: Dict[str, Any], op: Dict[str, Any]) -> None:
    """Fold one journaled op into state. Mechanical — no RNG, no clocks."""
    kind = op["op"]
    if kind == "incarnation":
        state["incarnation"] = max(state["incarnation"], int(op["value"]))
    elif kind == "tasks_created":
        # Epoch roll / eval batch: the op carries the explicit task tuples
        # so replay never re-derives a shuffle from RNG state.
        state["epoch"] = int(op.get("epoch", state["epoch"]))
        tasks = [list(t) for t in op["tasks"]]
        if op.get("at_front"):
            state["todo"][0:0] = tasks
        else:
            state["todo"].extend(tasks)
    elif kind == "lease":
        tid = str(op["task_id"])
        task = list(op["task"])
        # Remove the first matching todo entry (the dispatcher popped it).
        for i, t in enumerate(state["todo"]):
            if t == task:
                del state["todo"][i]
                break
        state["doing"][tid] = {
            "worker": op["worker"],
            "task": task,
            "token": int(op.get("token", 0)),
        }
        state["next_task_id"] = max(state["next_task_id"], int(op["task_id"]) + 1)
        state["next_lease_token"] = max(
            state["next_lease_token"], int(op.get("token", 0))
        )
    elif kind == "backup_lease":
        tid = str(op["task_id"])
        primary = str(op["primary_id"])
        state["doing"][tid] = {
            "worker": op["worker"],
            "task": list(op["task"]),
            "token": int(op.get("token", 0)),
        }
        state["twins"][primary] = int(op["task_id"])
        state["twins"][tid] = int(op["primary_id"])
        if int(op["task_id"]) not in state["backup_ids"]:
            state["backup_ids"].append(int(op["task_id"]))
        state["backups_launched"] += 1
        state["next_task_id"] = max(state["next_task_id"], int(op["task_id"]) + 1)
        state["next_lease_token"] = max(
            state["next_lease_token"], int(op.get("token", 0))
        )
    elif kind == "done":
        tid = str(op["task_id"])
        entry = state["doing"].pop(tid, None)
        if entry is None and tid in map(str, state["done_ids"]):
            return  # idempotent re-apply (stale-WAL-over-new-snapshot window)
        state["done_ids"].append(int(op["task_id"]))
        _trim_ring(state)
        state["records_done"] += int(op.get("records", 0))
        if op.get("backup_win"):
            state["backup_wins"] += 1
        retire = op.get("retire_twin")
        if retire is not None:
            rid = str(retire)
            state["doing"].pop(rid, None)
            if int(retire) not in state["retired_twins"]:
                state["retired_twins"].append(int(retire))
        _drop_twin_links(state, tid)
        if retire is not None:
            state["twins"].pop(str(retire), None)
        if int(op["task_id"]) in state["backup_ids"]:
            state["backup_ids"].remove(int(op["task_id"]))
        if retire is not None and int(retire) in state["backup_ids"]:
            state["backup_ids"].remove(int(retire))
    elif kind == "failed_requeue":
        tid = str(op["task_id"])
        state["doing"].pop(tid, None)
        state["done_ids"].append(int(op["task_id"]))
        _trim_ring(state)
        state["todo"].insert(0, list(op["task"]))
        _drop_twin_links(state, tid)
        if int(op["task_id"]) in state["backup_ids"]:
            state["backup_ids"].remove(int(op["task_id"]))
    elif kind == "abandoned":
        tid = str(op["task_id"])
        state["doing"].pop(tid, None)
        state["done_ids"].append(int(op["task_id"]))
        _trim_ring(state)
        state["tasks_abandoned"] += 1
        if op.get("job_failed"):
            state["job_failed"] = True
            state["todo"] = []
        _drop_twin_links(state, tid)
    elif kind == "recovered":
        # A worker's in-flight leases were requeued (watchdog / explicit).
        for tid, task in zip(op["task_ids"], op["tasks"]):
            entry = state["doing"].pop(str(tid), None)
            if entry is None:
                continue
            state["todo"].insert(0, list(task))
            state["tasks_recovered"] += 1
            _drop_twin_links(state, str(tid))
    elif kind == "dropped":
        # A lease resolved without accounting: failed copy of a racing
        # twin, early-stop discard, or a dead twin copy.
        tid = str(op["task_id"])
        if state["doing"].pop(tid, None) is not None:
            state["done_ids"].append(int(op["task_id"]))
            _trim_ring(state)
        _drop_twin_links(state, tid)
        if int(op["task_id"]) in state["backup_ids"]:
            state["backup_ids"].remove(int(op["task_id"]))
    elif kind == "blacklist":
        state["blacklist"][str(op["worker"])] = [
            float(op["until"]), str(op.get("reason", "")),
        ]
    elif kind == "unblacklist":
        state["blacklist"].pop(str(op["worker"]), None)
    elif kind == "train_end_enabled":
        state["train_end_pending"] = bool(op.get("pending", True))
        state["train_end_enabled"] = True
    elif kind == "train_end_consumed":
        state["train_end_pending"] = False
        if op.get("task") is not None:
            state["todo"].append(list(op["task"]))
    elif kind == "stop_training":
        state["stop_training"] = True
        state["todo"] = [t for t in state["todo"] if t[3] != op.get("training_type", 0)]
    elif kind == "hint":
        if int(op["seq"]) > state["hint_seq"]:
            state["hint_seq"] = int(op["seq"])
            state["hint_target"] = int(op.get("target", 0))
            state["hint_reason"] = str(op.get("reason", ""))
    elif kind == "membership_epoch":
        state["membership_epoch"] = max(
            state["membership_epoch"], int(op["group_id"])
        )
    elif kind == "cooldown":
        state["cooldowns"][str(op["key"])] = float(op["ts"])
    else:
        # Forward compatibility: an op vocabulary grown by a newer master
        # must not brick an older replayer in tests; log and continue.
        logger.warning("journal: unknown op kind %r ignored", kind)


def replay(snapshot: Optional[Dict[str, Any]], ops: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure function: fold ops onto a snapshot (or empty state)."""
    state = empty_state()
    if snapshot:
        state.update(json.loads(json.dumps(snapshot)))  # deep copy via JSON
        # Tolerate snapshots from older vocabularies.
        for key, default in empty_state().items():
            state.setdefault(key, default)
    for op in ops:
        apply_op(state, op)
    return state


class MasterJournal:
    """Coordinator: append ops, auto-compact, and load replayed state.

    State providers register a zero-arg callable returning their slice of
    the snapshot dict; compaction merges all slices. `record()` is called
    from inside the providers' own locks (the dispatcher appends under its
    dispatch lock, BEFORE the RPC ack), so the append path takes only the
    Journal's internal file lock — and NEVER compacts inline: compaction
    calls back INTO the providers, so compacting from record() would
    self-deadlock on the caller's lock. Owners call maybe_compact() from
    a maintenance tick (the master's watchdog loop, the fleet master's
    aggregation loop) where no provider lock is held.
    """

    def __init__(self, directory: str, snapshot_every: Optional[int] = None,
                 durable: bool = True):
        self._journal = Journal(directory, durable=durable)
        self._snapshot_every = (
            knobs.get_int("ELASTICDL_JOURNAL_SNAPSHOT_EVERY")
            if snapshot_every is None
            else snapshot_every
        )
        self._ops_since_snapshot = 0
        self._providers: List[Callable[[], Dict[str, Any]]] = []
        self._lock = threading.Lock()
        self.directory = directory

    def add_state_provider(self, provider: Callable[[], Dict[str, Any]]) -> None:
        self._providers.append(provider)

    def load(self) -> Dict[str, Any]:
        snapshot, ops = self._journal.load()
        state = replay(snapshot, ops)
        with self._lock:
            self._ops_since_snapshot = len(ops)
        return state

    def record(self, op: Dict[str, Any]) -> None:
        self._journal.append(op)
        with self._lock:
            self._ops_since_snapshot += 1

    def compaction_due(self) -> bool:
        with self._lock:
            return (
                self._snapshot_every > 0
                and self._ops_since_snapshot >= self._snapshot_every
            )

    def maybe_compact(self) -> bool:
        """Compact when the WAL has outgrown snapshot_every ops. Call with
        no provider lock held (see class docstring). True when a snapshot
        was taken."""
        if not self.compaction_due():
            return False
        self.compact()
        return True

    def compact(self) -> None:
        """Gather provider slices into a fresh snapshot and truncate the WAL."""
        state: Dict[str, Any] = empty_state()
        for provider in self._providers:
            try:
                state.update(provider())
            except Exception:  # noqa: BLE001 - a bad provider must not lose the WAL
                logger.exception("journal: state provider failed; skipping compaction")
                return
        self._journal.snapshot(state)
        with self._lock:
            self._ops_since_snapshot = 0

    def close(self) -> None:
        self._journal.close()


def open_master_journal(directory: Optional[str] = None,
                        durable: bool = True) -> Optional[MasterJournal]:
    """Open the journal at the knob-configured (or given) dir; None if disabled."""
    directory = directory or knobs.get_str("ELASTICDL_MASTER_JOURNAL_DIR")
    if not directory:
        return None
    return MasterJournal(directory, durable=durable)
