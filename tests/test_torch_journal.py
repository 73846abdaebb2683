"""The port's master write-ahead journal (master/journal.py and
TaskDispatcher.attach_journal) against the JAX package's: the same seeded
schedules of leases, reports, failures, recoveries and blacklists drive a
journaled dispatcher of each package; the live states, the WAL and the
snapshot bytes agree, and each package's `replay` reads the other's files
into the same state (one journal format for both). Then the framing rules
on the port's side, each held against the JAX reader: a torn tail is
dropped, a complete record with a bad CRC mid-file raises, and a crash
mid-snapshot leaves the previous snapshot and the WAL authoritative."""

import json
import os
import random
import struct
import time
import zlib

import pytest

from elasticdl_tpu.master import journal as jax_journal
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxTaskDispatcher,
)
from elasticdl_tpu_torch.master import journal
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

SHARDS = {"f1": (0, 90), "f2": (0, 60)}
CLOCK = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    """The blacklist stores absolute expiry times: both packages read the
    same clock, so their states and files can be compared byte for
    byte."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)


def _journaled(cls, journal_mod, directory, snapshot_every):
    mj = journal_mod.MasterJournal(directory, snapshot_every=snapshot_every,
                                   durable=False)
    d = cls(training_shards=SHARDS, records_per_task=30, num_epochs=2,
            shuffle=False)
    d.attach_journal(mj)
    mj.add_state_provider(d.export_state)
    # The documented protocol: snapshot right after attach, so the WAL
    # only ever holds post-start ops.
    mj.compact()
    return d, mj


def _drive(d, mj, seed, snapshot_every):
    """The randomized schedule of the JAX package's journal test: leases,
    reports (with duplicate and failed retries), recoveries, blacklists,
    compactions racing along."""
    rng = random.Random(seed)
    outstanding = {}
    for _ in range(120):
        roll = rng.random()
        if roll < 0.45:
            worker = rng.randrange(3)
            tid, task = d.get(worker)
            if task is not None:
                outstanding[tid] = d.lease_token(tid)
        elif roll < 0.75 and outstanding:
            tid = rng.choice(sorted(outstanding))
            token = outstanding.pop(tid)
            d.report(tid, True, lease_token=token)
            if rng.random() < 0.2:
                d.report(tid, True, lease_token=token)
        elif roll < 0.85 and outstanding:
            tid = rng.choice(sorted(outstanding))
            outstanding.pop(tid)
            d.report(tid, False, err_message="injected", lease_token=0)
        elif roll < 0.92:
            d.recover_tasks(rng.randrange(3))
            outstanding.clear()
        elif roll < 0.96:
            d.blacklist_worker(rng.randrange(3), 300.0, reason="slow")
        else:
            d.unblacklist_worker(rng.randrange(3))
        if snapshot_every and rng.random() < 0.1:
            mj.maybe_compact()
    return d.export_state()


def _files(directory):
    out = {}
    for name in (journal.SNAPSHOT_NAME, journal.WAL_NAME):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def _load(journal_mod, directory):
    snapshot, ops = journal_mod.Journal(directory, durable=False).load()
    return journal_mod.replay(snapshot, ops)


@pytest.mark.parametrize("seed,snapshot_every", [(1, 0), (7, 7),
                                                 (20260807, 7)])
def test_same_schedule_same_files_and_cross_replay(tmp_path, seed,
                                                   snapshot_every):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    d, mj = _journaled(TaskDispatcher, journal, port_dir, snapshot_every)
    jd, jmj = _journaled(JaxTaskDispatcher, jax_journal, jax_dir,
                         snapshot_every)
    live = _drive(d, mj, seed, snapshot_every)
    assert live == _drive(jd, jmj, seed, snapshot_every)
    mj.close()
    jmj.close()
    assert _files(port_dir) == _files(jax_dir)
    # Without compaction the WAL holds every op since the start.
    assert snapshot_every or _files(port_dir)[journal.WAL_NAME]

    # Each package replays the other's files into the same state, and a
    # dispatcher restored from it exports the live state.
    port_state = _load(journal, port_dir)
    assert _load(jax_journal, port_dir) == port_state
    assert _load(journal, jax_dir) == _load(jax_journal, jax_dir)
    assert port_state == _load(jax_journal, jax_dir)
    assert port_state.keys() == journal.empty_state().keys()
    restored = TaskDispatcher(training_shards=SHARDS, records_per_task=30,
                              num_epochs=2, shuffle=False)
    restored.restore_state(port_state)
    assert restored.export_state() == live


def test_master_journal_knobs_and_records_once(tmp_path, monkeypatch):
    """open_master_journal follows ELASTICDL_MASTER_JOURNAL_DIR, compaction
    follows ELASTICDL_JOURNAL_SNAPSHOT_EVERY, and retried reports count
    once in the replayed records_done, as in the JAX package."""
    monkeypatch.delenv("ELASTICDL_MASTER_JOURNAL_DIR", raising=False)
    assert journal.open_master_journal() is None
    monkeypatch.setenv("ELASTICDL_MASTER_JOURNAL_DIR", str(tmp_path / "j"))
    monkeypatch.setenv("ELASTICDL_JOURNAL_SNAPSHOT_EVERY", "5")
    mj = journal.open_master_journal(durable=False)
    assert mj.directory == str(tmp_path / "j")
    d = TaskDispatcher(training_shards=SHARDS, records_per_task=30,
                       num_epochs=1, shuffle=False)
    d.attach_journal(mj)
    mj.add_state_provider(d.export_state)
    mj.compact()
    compactions = 0
    while True:
        tid, task = d.get(0)
        if task is None:
            break
        token = d.lease_token(tid)
        d.report(tid, True, lease_token=token)
        d.report(tid, True, lease_token=token)  # a retry: discarded
        compactions += mj.maybe_compact()
    mj.close()
    assert compactions == 1  # 5 leases + 5 reports, every 5 ops
    for journal_mod in (journal, jax_journal):
        state = _load(journal_mod, str(tmp_path / "j"))
        assert state["records_done"] == 150
        assert not state["todo"] and not state["doing"]


# ---------- framing: torn tails silent, corruption loud ----------


def _framed(ops):
    out = b""
    for op in ops:
        payload = json.dumps(op, separators=(",", ":"),
                             sort_keys=True).encode()
        out += struct.pack("<II", len(payload),
                           zlib.crc32(payload) & 0xFFFFFFFF) + payload
    return out


OPS = [{"op": "incarnation", "value": 1},
       {"op": "tasks_created", "epoch": 1, "tasks": [["f1", 0, 30, 0, -1,
                                                      0]]},
       {"op": "lease", "task_id": 0, "worker": 2,
        "task": ["f1", 0, 30, 0, -1, 0], "token": 1}]


def test_framing_matches_the_jax_encoder():
    framed = _framed(OPS)
    assert b"".join(journal._encode_frame(json.dumps(
        op, separators=(",", ":"), sort_keys=True).encode())
        for op in OPS) == framed
    assert journal.read_frames(framed) == jax_journal.read_frames(framed) \
        == OPS


@pytest.mark.parametrize("cut", [3, 8, 20])
def test_torn_tail_is_dropped(cut):
    framed = _framed(OPS)
    torn = framed[:-cut]
    assert journal.read_frames(torn) == jax_journal.read_frames(torn) \
        == OPS[:2]


def test_mid_file_crc_error_raises():
    framed = bytearray(_framed(OPS))
    framed[10] ^= 0xFF  # inside the first payload, a complete frame
    for journal_mod in (journal, jax_journal):
        with pytest.raises(journal_mod.JournalCorruptError):
            journal_mod.read_frames(bytes(framed))


def test_crash_mid_snapshot_keeps_previous_snapshot_and_wal(tmp_path):
    """A crash between writing snapshot.json.tmp and publishing it leaves
    the litter ignored: the previous snapshot plus the full WAL replay to
    the live state, in both packages."""
    directory = str(tmp_path / "j")
    d, mj = _journaled(TaskDispatcher, journal, directory, 0)
    live = _drive(d, mj, 3, 0)
    mj.close()
    with open(os.path.join(directory, journal.SNAPSHOT_NAME + ".tmp"),
              "wb") as f:
        f.write(b'{"incarnation": 99, "todo": [')  # torn litter
    for journal_mod in (journal, jax_journal):
        state = _load(journal_mod, directory)
        assert state["incarnation"] == 0
        restored = TaskDispatcher(training_shards=SHARDS,
                                  records_per_task=30, num_epochs=2,
                                  shuffle=False)
        restored.restore_state(state)
        assert restored.export_state() == live
