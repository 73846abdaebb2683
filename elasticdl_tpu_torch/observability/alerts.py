"""Declarative alert rules over the aggregator's job-level signals
(counterpart of elasticdl_tpu/observability/alerts.py).

The TelemetryAggregator derives one `signals` dict per scrape
(aggregator.py documents the keys); this engine evaluates a small set of
rules against it and turns rule transitions into durable records:

- an `alert` event in events.jsonl on activation (and `alert_resolved`
  when the condition clears),
- `edl_alerts_total{rule=...}` counter increments,
- an `edl_alerts_active{rule=...}` gauge while the condition holds,
- an `active()` snapshot consumed by /api/summary, `edl dash`, and the
  straggler field of JobStatusResponse.

Three rule kinds cover the anomaly classes of the elasticity drills:

  threshold  a scalar signal crossed a bound (tasks abandoned, ...)
  skew       one subject of a {subject: score} map diverges from the
             fleet (stragglers, PS shard load imbalance; scores are
             value/median, computed by the aggregator)
  stall      a progress counter stopped moving for too long while the
             job still claims in-flight work

Alerts fire on the RISING edge only — a straggler that stays slow is one
alert, not one per scrape — and re-arm after the condition clears.

Tuning (all optional):
  ELASTICDL_ALERT_STRAGGLER_SKEW  flag workers slower than this multiple
                                  of the fleet median step time (def 2.0)
  ELASTICDL_ALERT_PS_SKEW         flag PS shards above this multiple of
                                  the mean byte rate (def 3.0)
  ELASTICDL_ALERT_STALL_SECONDS   records_done frozen this long with
                                  tasks in flight -> stall (def 60)
  ELASTICDL_ALERT_ABANDONED       abandoned-task count threshold (def 1)
  ELASTICDL_ALERT_STARVE_SHARE    flag workers whose step sat on an
                                  empty feed queue more than this
                                  fraction of wall time (def 0.25)
"""

import threading
import time

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("observability.alerts")

STRAGGLER_SKEW_ENV = "ELASTICDL_ALERT_STRAGGLER_SKEW"
PS_SKEW_ENV = "ELASTICDL_ALERT_PS_SKEW"
STALL_SECONDS_ENV = "ELASTICDL_ALERT_STALL_SECONDS"
ABANDONED_ENV = "ELASTICDL_ALERT_ABANDONED"
STARVE_SHARE_ENV = "ELASTICDL_ALERT_STARVE_SHARE"

class Rule:
    """One named condition; evaluate() returns {subject: detail_dict} for
    every subject currently violating it (empty dict = all clear)."""

    def __init__(self, name):
        self.name = name

    def evaluate(self, signals, now):
        raise NotImplementedError


class ThresholdRule(Rule):
    def __init__(self, name, signal, threshold):
        super().__init__(name)
        self.signal = signal
        self.threshold = threshold

    def evaluate(self, signals, now):
        value = signals.get(self.signal)
        if value is None or value < self.threshold:
            return {}
        return {
            self.signal: {"value": value, "threshold": self.threshold}
        }


class SkewRule(Rule):
    """Fires per subject whose precomputed skew score (value / fleet
    median or mean — the aggregator owns the normalization) crosses the
    threshold."""

    def __init__(self, name, signal, threshold):
        super().__init__(name)
        self.signal = signal
        self.threshold = threshold

    def evaluate(self, signals, now):
        scores = signals.get(self.signal) or {}
        return {
            subject: {"score": round(score, 3),
                      "threshold": self.threshold}
            for subject, score in scores.items()
            if score >= self.threshold
        }


class StallRule(Rule):
    """A progress signal (monotonic counter, e.g. records_done) that has
    not advanced for `seconds` while the gate signal is truthy (work is
    supposedly in flight). Carries state across evaluations."""

    def __init__(self, name, progress, gate, seconds):
        super().__init__(name)
        self.progress = progress
        self.gate = gate
        self.seconds = seconds
        self._last_value = None
        self._last_advance = None

    def evaluate(self, signals, now):
        value = signals.get(self.progress)
        if value is None:
            return {}
        if self._last_value is None or value != self._last_value:
            self._last_value = value
            self._last_advance = now
            return {}
        if not signals.get(self.gate):
            # Nothing in flight: an idle queue is not a stall.
            self._last_advance = now
            return {}
        stalled_for = now - self._last_advance
        if stalled_for < self.seconds:
            return {}
        return {
            self.progress: {
                "stalled_seconds": round(stalled_for, 1),
                "value": value,
                "threshold_seconds": self.seconds,
            }
        }


def straggler_skew_threshold():
    return knobs.get_float(STRAGGLER_SKEW_ENV)


def default_rules():
    """The stock rule set, thresholds from the environment."""
    return [
        SkewRule(
            "straggler", "straggler_scores", straggler_skew_threshold()
        ),
        SkewRule(
            "ps_imbalance",
            "ps_skew_scores",
            knobs.get_float(PS_SKEW_ENV),
        ),
        ThresholdRule(
            "tasks_abandoned",
            "tasks_abandoned",
            knobs.get_float(ABANDONED_ENV),
        ),
        StallRule(
            "throughput_stall",
            progress="records_done",
            gate="tasks_doing",
            seconds=knobs.get_float(STALL_SECONDS_ENV),
        ),
        # input_starve_shares are ABSOLUTE fractions of wall time (the
        # aggregator owns the normalization, per the SkewRule contract),
        # so the threshold compares against the share itself rather
        # than a fleet median — starvation on every worker at once is
        # still an incident.
        SkewRule(
            "input_starvation",
            "input_starve_shares",
            knobs.get_float(STARVE_SHARE_ENV),
        ),
    ]


class AlertEngine:
    """Evaluates rules each scrape; edge-triggered emission + active set.

    evaluate() runs on the aggregator's single scrape thread; active()
    snapshots are read from gRPC handler threads, so the active set is
    lock-guarded.
    """

    def __init__(self, rules=None, registry=None):
        self.rules = default_rules() if rules is None else list(rules)
        reg = registry or default_registry()
        self._fired = reg.counter(
            "edl_alerts_total",
            "Alert rule activations (rising edge), by rule",
            labelnames=("rule",),
        )
        self._active_gauge = reg.gauge(
            "edl_alerts_active",
            "Alert conditions currently holding, by rule",
            labelnames=("rule",),
        )
        self._lock = threading.Lock()
        self._active = {}  # (rule, subject) -> detail dict
        self.fired_total = 0

    def evaluate(self, signals, now=None):
        """Run every rule; returns the list of NEWLY fired alerts as
        {"rule", "subject", ...detail} dicts."""
        now = time.time() if now is None else now
        fired = []
        resolved = []
        seen = set()
        with self._lock:
            for rule in self.rules:
                try:
                    violations = rule.evaluate(signals, now)
                except Exception:
                    logger.warning(
                        "Alert rule %s failed to evaluate", rule.name,
                        exc_info=True,
                    )
                    continue
                for subject, detail in violations.items():
                    key = (rule.name, subject)
                    seen.add(key)
                    if key in self._active:
                        self._active[key] = detail
                        continue
                    self._active[key] = detail
                    self.fired_total += 1
                    self._fired.labels(rule=rule.name).inc()
                    fired.append(
                        {"rule": rule.name, "subject": subject, **detail}
                    )
            for key in list(self._active):
                if key not in seen:
                    rule_name, subject = key
                    del self._active[key]
                    resolved.append((rule_name, subject))
            counts = {}
            for rule_name, _ in self._active:
                counts[rule_name] = counts.get(rule_name, 0) + 1
            for rule in self.rules:
                self._active_gauge.labels(rule=rule.name).set(
                    counts.get(rule.name, 0)
                )
        # Event-log appends happen OUTSIDE the lock: get_job_status reads
        # active_subjects() under it, and a slow obs-dir mount must not
        # stall the very RPCs reporting the incident.
        for record in fired:
            emit_event("alert", **record)
            logger.warning(
                "ALERT %s: %s %s",
                record["rule"],
                record["subject"],
                {
                    k: v
                    for k, v in record.items()
                    if k not in ("rule", "subject")
                },
            )
        for rule_name, subject in resolved:
            emit_event("alert_resolved", rule=rule_name, subject=subject)
        return fired

    def active(self):
        """Currently-holding alerts, most useful fields first."""
        with self._lock:
            return [
                {"rule": rule, "subject": subject, **detail}
                for (rule, subject), detail in sorted(
                    self._active.items()
                )
            ]

    def active_subjects(self, rule_name):
        with self._lock:
            return sorted(
                subject
                for (rule, subject) in self._active
                if rule == rule_name
            )
