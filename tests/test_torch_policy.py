"""The port's policy engine and world-hint board (master/policy.py) against
the JAX package's: the same summary sequences at the same `now` (a fake
clock, `tick(now)`) give the same decisions, hysteresis, cooldowns, rate
limiting, dry runs, backup requests, announce-first scaling, and the same
`export_state`; applied decisions journal their cooldowns in the one
journal format, and an engine restored from the replayed state keeps them
suppressed across a master relaunch."""

import time

import pytest

from elasticdl_tpu.master import journal as jax_journal
from elasticdl_tpu.master import policy as jax_policy
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxTaskDispatcher,
)
from elasticdl_tpu_torch.master import journal
from elasticdl_tpu_torch.master import policy
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

SIDES = {"port": (policy, journal, TaskDispatcher),
         "jax": (jax_policy, jax_journal, JaxTaskDispatcher)}
CLOCK = 1_700_000_000.0


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now


class FakeDispatcher:
    """The actuator surface the engine sees, recording every call."""

    def __init__(self, candidates=()):
        self.calls = []
        self.blacklisted = []
        self.candidates = list(candidates)

    def blacklisted_workers(self):
        return list(self.blacklisted)

    def blacklist_worker(self, wid, ttl_seconds, reason=""):
        self.calls.append(("blacklist", wid, ttl_seconds, reason))
        self.blacklisted.append(wid)

    def recover_tasks(self, wid):
        self.calls.append(("recover", wid))

    def backup_candidates(self, factor=3.0, min_samples=5, limit=1):
        return self.candidates[:limit]

    def request_backup(self, tid):
        self.calls.append(("backup", tid))
        self.candidates = [c for c in self.candidates if c[0] != tid]
        return True

    def stats(self):
        return {"todo": 40, "doing": 2, "epoch": 1, "num_epochs": 1,
                "epoch_records": 0, "records_done": 100,
                "blacklisted": list(self.blacklisted),
                "backups_inflight": 0, "backups_launched": 0,
                "backup_wins": 0}


class FakeInstanceManager:
    def __init__(self, n, hints):
        self.n = n
        self.hints = hints
        self.calls = []

    def worker_count(self):
        return self.n

    def restart_worker(self, wid, reason=""):
        self.calls.append(("restart", wid, reason))

    def scale_workers(self, delta, reason=""):
        # The hint is announced before the actuation: record its seq.
        self.calls.append(("scale", delta, reason,
                           self.hints.current()["hint_seq"]))
        self.n += delta


def _healthy():
    return {"records_per_second": 100.0,
            "workers": {"worker-0": {"straggler_score": 1.0},
                        "worker-1": {"straggler_score": 1.1}},
            "tasks": {"eta_seconds": 5.0}}


def _straggler(score=9.0):
    summary = _healthy()
    summary["workers"]["worker-0"]["straggler_score"] = score
    return summary


def _behind():
    summary = _healthy()
    summary["tasks"] = {"eta_seconds": 5000.0}
    return summary


# name -> (engine options, [(seconds to advance, summary)] per tick)
SCENARIOS = {
    "healthy_one_worker": (
        {}, [(2.0, {"records_per_second": 16.0,
                    "workers": {}, "tasks": {"eta_seconds": 3.0}})] * 12),
    "straggler_blacklisted_once": (
        {}, [(2.0, _straggler())] * 6 + [(40.0, _straggler())]
        + [(2.0, _straggler())] * 3),
    "hysteresis_resets": (
        {}, [(2.0, _straggler()), (2.0, _healthy()), (2.0, _straggler()),
             (2.0, _straggler()), (2.0, _straggler(2.0))]),
    "dry_run": ({"dry_run": True}, [(2.0, _straggler())] * 4),
    "rate_limited": (
        {"rate_limit": 1, "cooldown_seconds": 0},
        [(2.0, {"records_per_second": 1.0,
                "workers": {f"worker-{i}": {"straggler_score": 9.0}
                            for i in range(4)},
                "tasks": {}})] * 4),
    "backup_tasks": (
        {"candidates": [(7, 1, 90.0), (9, 0, 80.0)]},
        [(2.0, _healthy())] * 5),
    "deadline_scale_up_announced_first": (
        {"deadline_seconds": 600.0, "im": 2}, [(5.0, _behind())] * 5),
}


def _run(side, options, ticks):
    mod = SIDES[side][0]
    options = dict(options)
    clock = FakeClock()
    dispatcher = FakeDispatcher(options.pop("candidates", ()))
    hints = mod.WorldHintBoard(time_fn=clock)
    n_workers = options.pop("im", None)
    im = FakeInstanceManager(n_workers, hints) if n_workers else None
    current = {}
    kw = dict(interval=3600, dry_run=False, hysteresis=2,
              cooldown_seconds=30, rate_limit=6, deadline_seconds=0)
    kw.update(options)
    engine = mod.PolicyEngine(lambda: current["summary"], dispatcher,
                              instance_manager=im, world_hints=hints,
                              time_fn=clock, **kw)
    trail = []
    for advance, summary in ticks:
        clock.now += advance
        current["summary"] = summary
        trail.append(engine.tick(clock.now))
    return dict(trail=trail, state=engine.export_state(),
                actions=engine.actions_total(), calls=dispatcher.calls,
                im=im.calls if im else None, hint=hints.current(),
                summary=engine.summary())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_summaries_same_decisions(name):
    options, ticks = SCENARIOS[name]
    got = _run("port", options, ticks)
    assert got == _run("jax", options, ticks)
    outcomes = [d["outcome"] for tick in got["trail"] for d in tick]
    if name == "healthy_one_worker":
        # The no-flap property on the in-process job's summaries.
        assert not outcomes and got["actions"] == 0
    elif name == "straggler_blacklisted_once":
        # Once blacklisted, the worker is not judged again.
        assert outcomes == ["applied"]
        assert got["calls"][:2] == [
            ("blacklist", 0, 60.0, got["calls"][0][3]), ("recover", 0)]
    elif name == "dry_run":
        assert outcomes == ["dry_run", "dry_run"] and not got["calls"]
    elif name == "rate_limited":
        assert outcomes.count("applied") == 1
        assert "rate_limited" in outcomes
    elif name == "backup_tasks":
        assert ("backup", 7) in got["calls"]
    elif name == "deadline_scale_up_announced_first":
        assert got["im"][0][:2] == ("scale", 1)
        assert got["im"][0][3] == got["hint"]["hint_seq"] >= 1


def test_policy_enabled_knob_matches_jax(monkeypatch):
    for value, want in (("", False), ("0", False), ("1", True),
                        ("true", True), ("on", True)):
        monkeypatch.setenv("ELASTICDL_POLICY", value)
        assert policy.policy_enabled() is jax_policy.policy_enabled() \
            is want


def test_applied_decisions_survive_a_relaunch_in_the_journal(
        tmp_path, monkeypatch):
    """A straggler blacklisted on a real dispatcher, its cooldown and the
    announced world journaled: both packages write the same WAL; a
    successor engine restored from the port's replay keeps the decision
    in cooldown, and its hint board resumes the sequence."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    wals = {}
    for side, (mod, journal_mod, dispatcher_cls) in SIDES.items():
        directory = str(tmp_path / side)
        mj = journal_mod.MasterJournal(directory, snapshot_every=0,
                                       durable=False)
        dispatcher = dispatcher_cls({"f": (0, 64)}, {}, {},
                                    records_per_task=16, num_epochs=1)
        clock = FakeClock()
        hints = mod.WorldHintBoard(time_fn=clock)
        engine = mod.PolicyEngine(lambda: _straggler(), dispatcher,
                                  world_hints=hints, time_fn=clock,
                                  interval=3600, dry_run=False,
                                  hysteresis=2, cooldown_seconds=30,
                                  rate_limit=6, deadline_seconds=0)
        for provider in (dispatcher.export_state, hints.export_state,
                         engine.export_state):
            mj.add_state_provider(provider)
        mj.compact()
        for target in (dispatcher, hints, engine):
            target.attach_journal(mj)
        for _ in range(2):
            clock.now += 2.0
            engine.tick(clock.now)
        hints.announce(3, "scale probe")
        mj.close()
        with open(tmp_path / side / journal.WAL_NAME, "rb") as f:
            wals[side] = f.read()
    assert wals["port"] == wals["jax"]

    snapshot, ops = journal.Journal(str(tmp_path / "port"),
                                    durable=False).load()
    state = journal.replay(snapshot, ops)
    assert state["cooldowns"] == {"straggler_blacklist|worker-0": 1004.0}
    assert state["blacklist"]["0"][0] == CLOCK + 60.0
    assert state["hint_seq"] == 1
    clock = FakeClock(1010.0)
    hints = policy.WorldHintBoard(time_fn=clock)
    hints.restore_state(state)
    dispatcher = FakeDispatcher()
    successor = policy.PolicyEngine(lambda: _straggler(), dispatcher,
                                    world_hints=hints, time_fn=clock,
                                    interval=3600, dry_run=False,
                                    hysteresis=2, cooldown_seconds=30,
                                    rate_limit=6, deadline_seconds=0)
    successor.restore_state(state)
    outcomes = []
    for _ in range(2):
        clock.now += 2.0
        outcomes += [d["outcome"] for d in successor.tick(clock.now)]
    assert outcomes == ["cooldown"] and not dispatcher.calls
    assert hints.announce(4, "after relaunch") == 2
