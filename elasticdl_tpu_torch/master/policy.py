"""Self-healing policy engine: the control loop that ACTS on telemetry
(counterpart of elasticdl_tpu/master/policy.py).

The master's telemetry aggregator detects (straggler scores, PS load skew,
drain ETA, alert rules); this module closes the loop. A master-side control thread reads
the telemetry aggregator's derived summary every tick and turns signals
into actions through three actuators:

- straggler mitigation: a worker whose straggler_score stays above the
  threshold is blacklisted in the task dispatcher (no new tasks route to
  it), its in-flight tasks recover, and the instance manager restarts it
  (the restart is "forgiven" — deliberate mitigation never consumes the
  max_relaunches failure budget).
- speculative backup tasks: the slowest-percentile in-flight tasks get a
  second copy on a healthy worker; first result wins, the loser's late
  report is acknowledged-but-discarded, records_done counts exactly once
  (the dispatcher owns the twin accounting).
- drain-ETA scaling: when the task-queue ETA diverges from
  ELASTICDL_JOB_DEADLINE_SECONDS, the instance manager is asked for ±k
  workers — ANNOUNCED first through the world-hint board so every
  worker's AOT speculator compiles the announced next world instead of
  guessing N±delta (the regroup that follows consumes a prebuilt
  executable).

Every decision — applied, dry-run, or suppressed — lands as a
`policy_decision` event in events.jsonl and increments
`edl_policy_actions_total{action,outcome}`; `edl dash`/`edl top` render
the recent-decision trail. Flap control is layered: per-(rule, subject)
hysteresis (a condition must hold for N consecutive ticks), per-(action,
subject) cooldowns, and a global applied-actions rate limit per sliding
window. A healthy fleet produces ZERO decisions (the no-flap property
the JAX package's fleet harness tests at 200+ simulated pods).

The engine is detection-framework-agnostic: inputs are the aggregator's
summary() dict plus duck-typed dispatcher / instance-manager actuators,
so a harness can embed it against simulated pods unchanged. Without an
instance manager (a job in one process) a blacklisted straggler is not
restarted and the drain-ETA scaling rule stays off; the dispatcher's
blacklist and backup tasks still apply. The JAX package's docs/POLICY.md
carries the rule catalog and tuning guide.
"""

import collections
import re
import threading
import time

from elasticdl_tpu_torch.chaos import injection
from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("master.policy")

_REG = default_registry()
_ACTIONS = _REG.counter(
    "edl_policy_actions_total",
    "Policy-engine decisions, by action and outcome",
    labelnames=("action", "outcome"),
)

_RATE_WINDOW_S = 60.0
_WORKER_ROLE = re.compile(r"^worker-(\d+)$")


def policy_enabled():
    """ELASTICDL_POLICY truthiness (opt-in: unset means detection-only)."""
    return knobs.get_str("ELASTICDL_POLICY").lower() in (
        "1", "true", "on", "yes",
    )


def _truthy(name):
    return knobs.get_str(name).lower() in ("1", "true", "on", "yes")


class WorldHintBoard:
    """The master-driven half of the world-hint RPC: the policy engine
    announces the target worker world BEFORE actuating a scale event;
    workers poll get_world_hint and speculatively compile the announced
    world. hint_seq is monotonic; 0 means nothing was ever announced.

    The seq survives master restarts: a journal-recovered board resumes
    from the replayed seq (restore_state) and every announce is journaled
    — a board restarting at 0 would make trainers silently ignore every
    post-restart hint as stale."""

    def __init__(self, time_fn=time.time):
        self._lock = threading.Lock()
        self._time = time_fn
        self._seq = 0
        self._target = 0
        self._reason = ""
        self._ts = 0.0
        self._journal = None

    def attach_journal(self, journal):
        with self._lock:
            self._journal = journal

    def restore_state(self, state):
        """Resume from a replayed journal state (hint_seq monotonicity
        across incarnations)."""
        with self._lock:
            self._seq = max(self._seq, int(state.get("hint_seq", 0)))
            self._target = int(state.get("hint_target", 0))
            self._reason = str(state.get("hint_reason", ""))
            if self._seq:
                self._ts = self._time()

    def export_state(self):
        with self._lock:
            return {
                "hint_seq": self._seq,
                "hint_target": self._target,
                "hint_reason": self._reason,
            }

    def announce(self, target_world_size, reason=""):
        with self._lock:
            self._seq += 1
            self._target = int(target_world_size)
            self._reason = reason
            self._ts = self._time()
            seq = self._seq
            if self._journal is not None:
                # Write-ahead: the hint is durable BEFORE any worker can
                # observe it, so a crash between announce and actuation
                # cannot regress hint_seq on recovery.
                self._journal.record({
                    "op": "hint",
                    "seq": seq,
                    "target": int(target_world_size),
                    "reason": reason[:200],
                })
        emit_event(
            "world_hint",
            # Named hint_seq, NOT seq: the event envelope stamps its own
            # `seq` (file order) over the payload, which would silently
            # shadow the hint's sequence number.
            hint_seq=seq,
            target_world_size=int(target_world_size),
            reason=reason[:200],
        )
        logger.info(
            "World hint #%d: target world %d (%s)",
            seq, target_world_size, reason,
        )
        return seq

    def current(self):
        """Dict snapshot mirroring pb.WorldHintResponse."""
        with self._lock:
            return {
                "hint_seq": self._seq,
                "target_world_size": self._target,
                "reason": self._reason,
                "age_seconds": (
                    0.0 if not self._seq else self._time() - self._ts
                ),
            }


class PolicyEngine:
    """Hysteresis/cooldown/rate-limited rule evaluator over the
    aggregator summary, actuating through the dispatcher, the instance
    manager, and the world-hint board."""

    def __init__(
        self,
        summary_fn,
        dispatcher,
        instance_manager=None,
        world_hints=None,
        interval=None,
        dry_run=None,
        hysteresis=None,
        cooldown_seconds=None,
        rate_limit=None,
        deadline_seconds=None,
        time_fn=time.time,
    ):
        self._summary_fn = summary_fn
        self._dispatcher = dispatcher
        self._instance_manager = instance_manager
        self._world_hints = world_hints
        self._time = time_fn

        self._interval = (
            knobs.get_float("ELASTICDL_POLICY_INTERVAL")
            if interval is None else interval
        )
        self._dry_run = (
            _truthy("ELASTICDL_POLICY_DRY_RUN")
            if dry_run is None else dry_run
        )
        self._hysteresis = max(1, (
            knobs.get_int("ELASTICDL_POLICY_HYSTERESIS")
            if hysteresis is None else hysteresis
        ))
        self._cooldown_s = (
            knobs.get_float("ELASTICDL_POLICY_COOLDOWN_SECONDS")
            if cooldown_seconds is None else cooldown_seconds
        )
        self._rate_limit = (
            knobs.get_int("ELASTICDL_POLICY_RATE_LIMIT")
            if rate_limit is None else rate_limit
        )
        self._deadline_s = (
            knobs.get_float("ELASTICDL_JOB_DEADLINE_SECONDS")
            if deadline_seconds is None else deadline_seconds
        )
        self._straggler_score = knobs.get_float(
            "ELASTICDL_POLICY_STRAGGLER_SCORE"
        )
        self._blacklist_s = knobs.get_float(
            "ELASTICDL_POLICY_BLACKLIST_SECONDS"
        )
        self._max_backups = knobs.get_int("ELASTICDL_POLICY_MAX_BACKUPS")
        self._backup_factor = knobs.get_float(
            "ELASTICDL_POLICY_BACKUP_FACTOR"
        )
        self._scale_step = max(
            1, knobs.get_int("ELASTICDL_POLICY_SCALE_STEP")
        )
        self._max_workers = knobs.get_int("ELASTICDL_POLICY_MAX_WORKERS")

        self._job_start = self._time()
        self._initial_workers = None
        if instance_manager is not None:
            try:
                self._initial_workers = instance_manager.worker_count()
            except Exception:
                self._initial_workers = None

        self._counters = {}  # (rule, subject) -> consecutive trigger ticks
        self._cooldowns = {}  # (action, subject) -> last applied ts
        self._journal = None  # applied decisions journal their cooldowns
        self._applied_window = collections.deque()  # applied-action stamps
        self._recent = collections.deque(maxlen=64)  # decision dicts
        self._actions_total = 0  # APPLIED actions only
        self._ticks = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # ---------- journal plane ----------

    def attach_journal(self, journal):
        self._journal = journal

    def restore_state(self, state):
        """Resume without re-firing decisions already applied: the
        journaled (action, subject) -> ts cooldown map is restored, so a
        decision applied just before the crash stays in cooldown after
        the relaunch instead of firing again."""
        cooldowns = {}
        for key, ts in (state.get("cooldowns") or {}).items():
            action, _, subject = key.partition("|")
            cooldowns[(action, subject)] = float(ts)
        with self._lock:
            self._cooldowns.update(cooldowns)

    def export_state(self):
        with self._lock:
            return {
                "cooldowns": {
                    f"{action}|{subject}": ts
                    for (action, subject), ts in self._cooldowns.items()
                },
            }

    # ---------- lifecycle ----------

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="policy-engine"
        )
        self._thread.start()
        logger.info(
            "Policy engine started (interval=%.1fs dry_run=%s "
            "hysteresis=%d cooldown=%.0fs rate_limit=%d/min)",
            self._interval, self._dry_run, self._hysteresis,
            self._cooldown_s, self._rate_limit,
        )
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                logger.exception("Policy tick failed (loop continues)")
            self._stop.wait(self._interval)

    # ---------- evaluation ----------

    def tick(self, now=None):
        """Evaluate every rule once; returns the decisions made this
        tick (empty on a healthy fleet — the no-flap property)."""
        now = self._time() if now is None else now
        summary = self._summary_fn() or {}
        decisions = []
        decisions += self._rule_straggler(summary, now)
        decisions += self._rule_backup(summary, now)
        decisions += self._rule_deadline(summary, now)
        with self._lock:
            self._ticks += 1
        return decisions

    def _hold(self, rule, subject, triggered):
        """Per-(rule, subject) hysteresis: True once the condition held
        for the configured number of CONSECUTIVE ticks."""
        key = (rule, subject)
        if not triggered:
            self._counters.pop(key, None)
            return False
        count = self._counters.get(key, 0) + 1
        self._counters[key] = count
        return count >= self._hysteresis

    def _prune_counters(self, rule, live_subjects):
        """Drop hysteresis state for subjects that left the signal set
        (completed tasks, scaled-away workers)."""
        for key in list(self._counters):
            if key[0] == rule and key[1] not in live_subjects:
                del self._counters[key]

    def _decide(self, action, subject, reason, actuate, now,
                rule_key=None):
        """Run one decision through dry-run -> cooldown -> rate limit ->
        actuation; always emits the policy_decision event + counter."""
        cd_key = (action, subject)
        if self._dry_run:
            outcome = "dry_run"
        elif (
            self._cooldown_s > 0
            and now - self._cooldowns.get(cd_key, -1e18) < self._cooldown_s
        ):
            outcome = "cooldown"
        elif self._rate_limit > 0 and not self._admit_rate(now):
            outcome = "rate_limited"
        else:
            try:
                actuate()
                outcome = "applied"
                with self._lock:
                    self._cooldowns[cd_key] = now
                if self._journal is not None:
                    self._journal.record({
                        "op": "cooldown",
                        "key": f"{action}|{subject}",
                        "ts": now,
                    })
                self._applied_window.append(now)
                with self._lock:
                    self._actions_total += 1
            except Exception as exc:
                logger.exception("Policy action %s(%s) failed",
                                 action, subject)
                outcome = "error"
                reason = f"{reason}; error={exc!r}"
        # Any decision (applied or suppressed) restarts the hysteresis
        # window, so a suppressed rule re-earns its trigger instead of
        # spamming one decision per tick.
        if rule_key is not None:
            self._counters.pop(rule_key, None)
        _ACTIONS.labels(action=action, outcome=outcome).inc()
        decision = {
            "ts": round(now, 3),
            "action": action,
            "subject": str(subject),
            "outcome": outcome,
            "reason": reason,
        }
        emit_event(
            "policy_decision",
            action=action,
            subject=str(subject),
            outcome=outcome,
            reason=reason[:200],
        )
        logger.info(
            "Policy decision: %s(%s) -> %s (%s)",
            action, subject, outcome, reason,
        )
        with self._lock:
            self._recent.append(decision)
        return decision

    def _admit_rate(self, now):
        while (
            self._applied_window
            and now - self._applied_window[0] > _RATE_WINDOW_S
        ):
            self._applied_window.popleft()
        return len(self._applied_window) < self._rate_limit

    # ---------- rules ----------

    def _rule_straggler(self, summary, now):
        """Persistent straggler -> blacklist + recover tasks + restart."""
        workers = summary.get("workers") or {}
        blacklisted = set(self._dispatcher.blacklisted_workers())
        decisions = []
        live = set()
        for role in sorted(workers):
            match = _WORKER_ROLE.match(role)
            if not match:
                continue
            wid = int(match.group(1))
            live.add(role)
            score = workers[role].get("straggler_score") or 0.0
            triggered = (
                score >= self._straggler_score
                and wid not in blacklisted
            )
            if not self._hold("straggler", role, triggered):
                continue
            reason = (
                f"straggler_score={score:.2f} >= "
                f"{self._straggler_score:.2f} for "
                f"{self._hysteresis} ticks"
            )
            decisions.append(self._decide(
                "straggler_blacklist", role, reason,
                lambda wid=wid, reason=reason: self._mitigate_straggler(
                    wid, reason
                ),
                now,
                rule_key=("straggler", role),
            ))
        self._prune_counters("straggler", live)
        return decisions

    def _mitigate_straggler(self, wid, reason):
        self._dispatcher.blacklist_worker(wid, self._blacklist_s, reason)
        # Its in-flight tasks re-dispatch to healthy workers immediately;
        # the restart (when an instance manager exists) gives the slot a
        # fresh process that rehydrates from the compile cache.
        self._dispatcher.recover_tasks(wid)
        if self._instance_manager is not None:
            self._instance_manager.restart_worker(wid, reason)

    def _rule_backup(self, summary, now):
        """Slowest-percentile in-flight tasks -> speculative copy."""
        if self._max_backups <= 0:
            return []
        stats = self._dispatcher.stats()
        budget = self._max_backups - stats.get("backups_inflight", 0)
        if budget <= 0:
            self._prune_counters("backup", set())
            return []
        candidates = self._dispatcher.backup_candidates(
            factor=self._backup_factor, limit=budget
        )
        decisions = []
        live = set()
        for tid, wid, elapsed in candidates:
            live.add(tid)
            if not self._hold("backup", tid, True):
                continue
            reason = (
                f"task {tid} on worker {wid} in flight "
                f"{elapsed:.1f}s (> {self._backup_factor:.1f}x mean)"
            )
            decisions.append(self._decide(
                "backup_task", f"task-{tid}", reason,
                lambda tid=tid: self._dispatcher.request_backup(tid),
                now,
                rule_key=("backup", tid),
            ))
        self._prune_counters("backup", live)
        return decisions

    def _job_eta(self, summary):
        """Whole-job drain ETA in seconds, or None while unmeasurable.

        The aggregator's eta_seconds gauge is EPOCH-scoped: the
        dispatcher regenerates training tasks lazily per epoch, so its
        todo queue — and any ETA built on it — only ever sees the
        current epoch's tail. A deadline rule fed that number would
        declare a 400-epoch job "nearly done" from epoch 1. Compute the
        job-wide ETA from total planned records instead, and fall back
        to the queue-scoped ETA for jobs without a records plan
        (evaluation-only)."""
        stats = self._dispatcher.stats()
        epoch_records = stats.get("epoch_records") or 0
        total = epoch_records * stats.get("num_epochs", 0)
        rps = summary.get("records_per_second")
        if total > 0 and rps:
            return max(0.0, total - stats.get("records_done", 0)) / rps
        return (summary.get("tasks") or {}).get("eta_seconds")

    def _rule_deadline(self, summary, now):
        """Drain ETA vs. deadline -> announce the next world, then ±k."""
        if self._deadline_s <= 0 or self._instance_manager is None:
            return []
        eta = self._job_eta(summary)
        if eta is None:
            self._prune_counters("scale_up", set())
            self._prune_counters("scale_down", set())
            return []
        remaining = self._deadline_s - (now - self._job_start)
        n = self._instance_manager.worker_count()
        initial = self._initial_workers or n or 1
        max_workers = self._max_workers or 2 * initial
        k = self._scale_step
        behind = eta > 1.2 * max(remaining, 1.0)
        ahead = remaining > 0 and eta < 0.5 * remaining
        decisions = []
        if self._hold("scale_up", "fleet", behind and n + k <= max_workers):
            reason = (
                f"eta={eta:.0f}s overshoots remaining="
                f"{remaining:.0f}s; {n} -> {n + k} workers"
            )
            decisions.append(self._decide(
                "scale_up", "fleet", reason,
                lambda n=n, reason=reason: self._scale(k, n + k, reason),
                now,
                rule_key=("scale_up", "fleet"),
            ))
        if self._hold("scale_down", "fleet", ahead and n - k >= initial):
            reason = (
                f"eta={eta:.0f}s well under remaining="
                f"{remaining:.0f}s; {n} -> {n - k} workers"
            )
            decisions.append(self._decide(
                "scale_down", "fleet", reason,
                lambda n=n, reason=reason: self._scale(-k, n - k, reason),
                now,
                rule_key=("scale_down", "fleet"),
            ))
        return decisions

    def _scale(self, delta, target_world, reason):
        # Announce FIRST: workers poll the hint and speculatively compile
        # the announced world while the instance manager actuates, so the
        # regroup consumes a prebuilt executable (aot_consumed).
        if self._world_hints is not None:
            self._world_hints.announce(target_world, reason)
        # Chaos seam for the master-kill-during-scale drill: the hint is
        # journaled/announced but the actuation below never happens.
        injection.inject_local("master.scale")
        self._instance_manager.scale_workers(delta, reason)

    # ---------- status ----------

    def actions_total(self):
        with self._lock:
            return self._actions_total

    def summary(self):
        """JSON-able policy section for /api/summary and `edl dash`."""
        stats = self._dispatcher.stats()
        with self._lock:
            recent = list(self._recent)[-8:]
            total = self._actions_total
            ticks = self._ticks
        out = {
            "enabled": True,
            "dry_run": self._dry_run,
            "interval_s": self._interval,
            "ticks": ticks,
            "actions_total": total,
            "recent": recent,
            "blacklisted": [
                f"worker-{wid}" for wid in stats.get("blacklisted", [])
            ],
            "backups_inflight": stats.get("backups_inflight", 0),
            "backups_launched": stats.get("backups_launched", 0),
            "backup_wins": stats.get("backup_wins", 0),
        }
        if self._world_hints is not None:
            hint = self._world_hints.current()
            if hint["hint_seq"]:
                out["world_hint"] = {
                    "seq": hint["hint_seq"],
                    "target_world_size": hint["target_world_size"],
                    "reason": hint["reason"],
                    "age_seconds": round(hint["age_seconds"], 1),
                }
        return out
