"""Job-level telemetry aggregation: the master watches *performance*
(counterpart of elasticdl_tpu/observability/aggregator.py).

Every process has its own /metrics endpoint; this module closes the
loop. A TelemetryAggregator thread runs inside the master, discovers every
per-role endpoint from `<obs_dir>/endpoints/*.json`, scrapes each /metrics
on an interval, parses the exposition text back into samples
(promtext.py), and keeps a bounded ring-buffer time-series store per
(role, metric, labels). From the store it derives job-level signals:

  records/s throughput (+ a short history for sparklines)
  per-worker step-time mean/p50/p99/EWMA from the phase histograms
  straggler scores (per-worker step latency vs. the fleet median)
  PS shard push/pull byte rates and load-imbalance scores
  task-queue drain rate and completion ETA
  per-worker MFU (when the worker publishes its estimate)

The signals are re-exported on the master's own registry as `edl_job_*`
gauges (so one scrape of the master answers "who is slow" without fanning
out), fed through the alert rules engine (alerts.py), and published as a
JSON dict behind the exporter's /api/summary — the feed for the
dashboard (dashboard.py).

Scrape failures are expected steady-state noise (processes relaunch,
endpoints rewrite) and only count `edl_job_scrape_errors_total`.
"""

import collections
import json
import math
import os
import statistics
import threading
import time
import urllib.request

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import alerts as alerts_mod
from elasticdl_tpu_torch.observability import promtext
from elasticdl_tpu_torch.observability import push as push_mod
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("observability.aggregator")

INTERVAL_ENV = "ELASTICDL_AGGREGATOR_INTERVAL"

# Ring depth per series: at the default 2 s interval this is ~8.5 min of
# history — enough for rate windows and dashboard sparklines, bounded
# regardless of job length.
SERIES_DEPTH = 256

# Throughput/step-time rates are computed over a sliding window of this
# many seconds (at least two scrapes apart).
RATE_WINDOW_S = 20.0

_EWMA_ALPHA = 0.3

# Minimum windowed step-count before a worker's latency participates in
# straggler scoring: one slow compile must not flag a healthy worker.
MIN_STEP_SAMPLES = 3

STALE_SCRAPES_ENV = "ELASTICDL_ENDPOINT_STALE_SCRAPES"


def read_endpoints(endpoints_dir):
    """Parse every advertisement under one endpoints/ dir (shared with
    the master's StartProfile fan-out)."""
    endpoints = []
    try:
        entries = os.listdir(endpoints_dir)
    except OSError:
        return endpoints
    for entry in sorted(entries):
        if not entry.endswith(".json"):
            continue
        try:
            with open(os.path.join(endpoints_dir, entry)) as f:
                info = json.load(f)
        except (OSError, ValueError):
            continue  # mid-rewrite; next pass sees it whole
        if info.get("port"):
            endpoints.append(info)
    return endpoints


def _snap_field(snap, name, default):
    """Field access across pb.TelemetrySnapshot / dict / namespace —
    ingest_push accepts all three (tests and relays skip the proto)."""
    if isinstance(snap, dict):
        return snap.get(name, default)
    return getattr(snap, name, default)


class SeriesStore:
    """Bounded (role, metric, labels) -> deque[(ts, value)] store."""

    def __init__(self, depth=SERIES_DEPTH):
        self._depth = depth
        self._series = {}

    def add(self, role, name, labels, value, ts):
        key = (role, name, tuple(sorted(labels)))
        series = self._series.get(key)
        if series is None:
            series = collections.deque(maxlen=self._depth)
            self._series[key] = series
        series.append((ts, value))

    def latest(self, role, name, labels=()):
        series = self._series.get((role, name, tuple(sorted(labels))))
        return series[-1][1] if series else None

    def rate(self, role, name, labels=(), window_s=RATE_WINDOW_S,
             now=None):
        """(newest - oldest-within-window) / dt, or None with < 2 points.
        Counter resets (process relaunch) clamp to None for the window.
        With `now`, a series whose newest point is older than the window
        is STALE (the process stopped reporting) and answers None — a
        dead worker's last numbers must age out, not freeze."""
        series = self._series.get((role, name, tuple(sorted(labels))))
        if not series or len(series) < 2:
            return None
        t_new, v_new = series[-1]
        if now is not None and t_new < now - window_s:
            return None
        # The loop always binds: series[-1] itself satisfies the cutoff.
        t_old = v_old = None
        for ts, value in series:
            if ts >= t_new - window_s:
                t_old, v_old = ts, value
                break
        if t_old is None or t_new <= t_old:
            return None
        if v_new < v_old:
            return None  # reset mid-window
        return (v_new - v_old) / (t_new - t_old)

    def delta(self, role, name, labels=(), window_s=RATE_WINDOW_S,
              now=None):
        series = self._series.get((role, name, tuple(sorted(labels))))
        if not series or len(series) < 2:
            return None
        t_new, v_new = series[-1]
        if now is not None and t_new < now - window_s:
            return None  # stale series (see rate())
        v_old = None
        for ts, value in series:
            if ts >= t_new - window_s:
                v_old = value
                break
        if v_old is None or v_new < v_old:
            return None
        return v_new - v_old

    def roles(self):
        return sorted({role for role, _, _ in self._series})

    def labelsets(self, role, name):
        """Label tuples of every stored series of one (role, family) —
        the query surface for family-wide sums (keeps callers off the
        internal key layout)."""
        return [
            labels
            for (s_role, s_name, labels) in list(self._series)
            if s_role == role and s_name == name
        ]


def percentile(sorted_values, q):
    """Nearest-rank percentile of an ascending list; None when empty.
    (The histogram-bucket estimator above is for cumulative buckets;
    this one is for plain value lists — fleet rollups.)"""
    if not sorted_values:
        return None
    rank = math.ceil(q * len(sorted_values)) - 1
    return sorted_values[min(len(sorted_values) - 1, max(0, rank))]


def skew_scores(values, min_subjects=2):
    """{subject: value} -> {subject: value / fleet median}; empty when
    fewer than min_subjects report or the median is degenerate. The
    straggler and PS-imbalance signals are both this shape.

    median_low, not median: with an even fleet the interpolating median
    averages the two middle values, so in the smallest elastic world (2
    workers) one straggler drags the baseline up with it and its score
    asymptotes to 2.0 — the default threshold would be unreachable
    exactly where the drill runs. The low median keeps the baseline on a
    healthy member."""
    vals = {
        k: v
        for k, v in values.items()
        if v is not None and v > 0 and math.isfinite(v)
    }
    if len(vals) < min_subjects:
        return {}
    median = statistics.median_low(sorted(vals.values()))
    if median <= 0:
        return {}
    return {k: v / median for k, v in vals.items()}


def histogram_quantile(bounds_counts, q):
    """Estimate a quantile from cumulative histogram buckets.

    bounds_counts: [(upper_bound, cumulative_count)] sorted by bound,
    +Inf last. Returns the first bound whose cumulative count covers
    q * total (Prometheus-style upper-bound estimate; the +Inf bucket
    answers with the largest finite bound)."""
    if not bounds_counts:
        return None
    total = bounds_counts[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_finite = None
    for bound, cumulative in bounds_counts:
        if math.isfinite(bound):
            prev_finite = bound
        if cumulative >= target:
            return bound if math.isfinite(bound) else prev_finite
    return prev_finite


class TelemetryAggregator:
    """Background scrape/derive/export loop in the master process."""

    def __init__(
        self,
        obs_dir,
        registry=None,
        job="",
        interval=None,
        alert_engine=None,
        scrape_timeout=1.0,
    ):
        self._obs_dir = obs_dir
        self._endpoints_dir = os.path.join(obs_dir, "endpoints")
        self._registry = registry or default_registry()
        self._job = job
        if interval is None:
            interval = knobs.get_float(INTERVAL_ENV)
        self.interval = max(0.2, interval)
        self._scrape_timeout = scrape_timeout
        self.store = SeriesStore()
        self.engine = alert_engine or alerts_mod.AlertEngine(
            registry=self._registry
        )
        self._straggler_skew = alerts_mod.straggler_skew_threshold()
        self._lock = threading.Lock()
        self._summary = {"job": job, "ts": None}
        self._ewma = {}  # worker role -> EWMA step seconds
        self._gauged_workers = set()  # roles with exported per-worker gauges
        # (role, pid, port) -> consecutive scrape failures; at
        # _stale_after the endpoint is dropped until its advertisement
        # is rewritten (relaunch) or withdrawn (clean shutdown).
        self._scrape_failures = {}
        self._stale_after = max(
            1, knobs.get_int(STALE_SCRAPES_ENV)
        )
        self._throughput_history = collections.deque(maxlen=60)
        self._stop = threading.Event()
        self._thread = None
        # Store/derive mutations happen from the poll thread AND from
        # RPC handler threads (ingest_push); one lock covers both.
        self._ingest_lock = threading.RLock()
        # (role, pid) -> {"seq", "families", "ts"}: per-origin merged
        # push state. A delta only applies when it extends the held seq.
        self._push_states = {}
        self._push_last_by_role = {}  # role -> last accepted push ts
        # role -> [accepted snapshots, their payload bytes] (push_tally)
        self._push_by_role = {}
        # role -> ts of the last ingested payload (push or pull); the
        # telemetry-freshness signal.
        self._last_report = {}
        # Endpoint directory cache: rescan only when the dir mtime moved
        # (advert add/withdraw/rewrite touches the parent dir) — O(1)
        # steady-state instead of a listdir+parse of N files per pass.
        self._ep_cache = []
        self._ep_sig = None

        reg = self._registry
        self._g_rps = reg.gauge(
            "edl_job_records_per_second",
            "Job-level training throughput (aggregated by the master)",
        )
        self._g_step = reg.gauge(
            "edl_job_step_seconds",
            "Per-worker step latency stats derived from scraped phase "
            "histograms",
            labelnames=("worker", "stat"),
        )
        self._g_straggler = reg.gauge(
            "edl_job_straggler",
            "1 while the worker is flagged as a straggler",
            labelnames=("worker",),
        )
        self._g_straggler_score = reg.gauge(
            "edl_job_straggler_score",
            "Worker step latency / fleet median",
            labelnames=("worker",),
        )
        self._g_ps_bps = reg.gauge(
            "edl_job_ps_bytes_per_second",
            "Per-PS-shard gradient/parameter byte rates",
            labelnames=("shard", "direction"),
        )
        self._g_ps_ratio = reg.gauge(
            "edl_job_ps_load_ratio",
            "PS shard byte rate / fleet median",
            labelnames=("shard",),
        )
        self._g_eta = reg.gauge(
            "edl_job_task_eta_seconds",
            "Estimated seconds until the task queue drains",
        )
        self._g_drain = reg.gauge(
            "edl_job_task_drain_per_second",
            "Task completions per second (windowed)",
        )
        self._g_mfu = reg.gauge(
            "edl_job_mfu",
            "Per-worker model FLOPs utilization estimate (re-exported)",
            labelnames=("worker",),
        )
        self._g_workers = reg.gauge(
            "edl_job_workers_reporting",
            "Worker endpoints scraped successfully on the last pass",
        )
        self._c_scrapes = reg.counter(
            "edl_job_scrapes_total",
            "Aggregator endpoint scrapes, by role",
            labelnames=("role",),
        )
        self._c_scrape_errors = reg.counter(
            "edl_job_scrape_errors_total",
            "Aggregator scrapes that failed (endpoint mid-restart, ...)",
            labelnames=("role",),
        )
        self._g_stale = reg.gauge(
            "edl_job_endpoints_stale",
            "Advertised endpoints dropped after consecutive scrape "
            "failures (dead pods whose advertisement file survived)",
        )
        self._g_compiles = reg.gauge(
            "edl_job_compiles",
            "Tracked step-function compiles summed across all scraped "
            "roles, by attributed cause",
            labelnames=("cause",),
        )
        self._g_compile_seconds = reg.gauge(
            "edl_job_compile_seconds",
            "Seconds spent compiling tracked step functions, summed "
            "across all scraped roles",
        )
        # Data-plane rollups (observability/datapath.py): fleet-level
        # views of the per-worker edl_datapath_* series.
        self._g_dp_stage = reg.gauge(
            "edl_job_datapath_stage_share",
            "Fleet-summed input-pipeline stage rate (seconds of stage "
            "time per wall second, over all workers)",
            labelnames=("stage",),
        )
        self._g_dp_records = reg.gauge(
            "edl_job_datapath_records_per_second",
            "Fleet decode throughput: records/s delivered by the input "
            "pipeline across all workers",
        )
        self._g_starve_share = reg.gauge(
            "edl_job_input_starve_share",
            "Fraction of the worker's wall time its step spent blocked "
            "on an empty feed queue",
            labelnames=("worker",),
        )
        self._g_input_starved = reg.gauge(
            "edl_job_input_starved",
            "1 while the input_starvation alert is active for the worker",
            labelnames=("worker",),
        )
        # Control-plane self-instrumentation (edl_master_*): the master
        # is itself a first-class telemetry subject at fleet scale.
        self._h_fanout = reg.histogram(
            "edl_master_scrape_fanout_seconds",
            "Wall time of the pull-scrape fan-out portion of one "
            "aggregation pass",
        )
        self._h_tick = reg.histogram(
            "edl_master_aggregation_tick_seconds",
            "Wall time of one full aggregation pass (scrape + ingest + "
            "derive)",
        )
        self._c_ep_rescans = reg.counter(
            "edl_master_endpoint_rescans_total",
            "Endpoint-directory rescans (bounded by membership events, "
            "not by aggregation passes)",
        )
        self._c_ep_diffs = reg.counter(
            "edl_master_endpoint_diffs_total",
            "Endpoint membership diffs observed on rescan",
            labelnames=("op",),
        )
        self._c_push_reports = reg.counter(
            "edl_master_push_reports_total",
            "ReportTelemetry batches handled",
        )
        self._c_push_snapshots = reg.counter(
            "edl_master_push_snapshots_total",
            "Pushed telemetry snapshots accepted, by encoding",
            labelnames=("kind",),
        )
        self._c_push_bytes = reg.counter(
            "edl_master_push_payload_bytes_total",
            "Pushed telemetry payload volume",
        )
        self._c_push_resyncs = reg.counter(
            "edl_master_push_resyncs_total",
            "Pushed deltas rejected for a sequence gap (need_full "
            "answered)",
        )
        self._g_push_roles = reg.gauge(
            "edl_master_push_roles",
            "Roles whose telemetry arrived by push within the freshness "
            "horizon",
        )
        self._g_freshness = reg.gauge(
            "edl_master_telemetry_freshness_seconds",
            "Age of the stalest reporting role's telemetry at the end "
            "of the last pass",
        )
        self._h_staleness = reg.histogram(
            "edl_master_telemetry_staleness_seconds",
            "Per-role telemetry age observed each pass",
            buckets=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0, 60.0),
        )

    # ---------- lifecycle ----------

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="edl-telemetry-aggregator", daemon=True
        )
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                logger.warning("Aggregation pass failed", exc_info=True)
            self._stop.wait(self.interval)

    # ---------- scraping ----------

    def discover_endpoints(self):
        """Live endpoint advertisements (the StartProfile fan-out reads
        this too; stale-skipped endpoints are excluded)."""
        return [
            info
            for info in read_endpoints(self._endpoints_dir)
            if not self._is_stale(info)
        ]

    def _endpoint_key(self, info):
        # A relaunch rewrites the advertisement with a new pid/port —
        # that is a NEW endpoint and must reset the failure count.
        return (info.get("role", ""), info.get("pid"), info.get("port"))

    def _is_stale(self, info):
        return (
            self._scrape_failures.get(self._endpoint_key(info), 0)
            >= self._stale_after
        )

    def _scrape(self, info):
        host = info.get("host") or "127.0.0.1"
        url = f"http://{host}:{info['port']}/metrics"
        return (
            urllib.request.urlopen(url, timeout=self._scrape_timeout)
            .read()
            .decode()
        )

    def _refresh_endpoints(self):
        """Cached advertisement list, rescanned only when the endpoints
        directory's mtime says an advert landed, was rewritten, or was
        withdrawn (os.replace/unlink bump the parent dir's mtime) —
        O(1) per pass steady-state, one rescan per membership event.
        The counters below make that claim test-assertable."""
        try:
            st = os.stat(self._endpoints_dir)
            sig = st.st_mtime_ns
        except OSError:
            self._ep_cache = []
            self._ep_sig = None
            return self._ep_cache
        # While the dir mtime sits inside the last second, keep
        # rescanning: coarse-mtime filesystems and a write landing in
        # the same tick would otherwise be invisible.
        if sig == self._ep_sig and (time.time() - st.st_mtime) > 1.0:
            return self._ep_cache
        before = {self._endpoint_key(i) for i in self._ep_cache}
        self._ep_cache = read_endpoints(self._endpoints_dir)
        self._ep_sig = sig
        self._c_ep_rescans.inc()
        after = {self._endpoint_key(i) for i in self._ep_cache}
        for _ in after - before:
            self._c_ep_diffs.labels(op="add").inc()
        for _ in before - after:
            self._c_ep_diffs.labels(op="withdraw").inc()
        return self._ep_cache

    def _push_horizon(self):
        """How recently a role must have pushed for the pull loop to
        leave it alone (and for it to count as push-reporting)."""
        return 3.0 * self.interval

    def _push_fresh(self, role, now):
        ts = self._push_last_by_role.get(role)
        return ts is not None and (now - ts) <= self._push_horizon()

    def poll_once(self, now=None):
        """One scrape + derive + export pass (the thread's body; callable
        directly from tests and `edl dash --once` style flows). Without
        an explicit `now`, each endpoint's samples are stamped when they
        were actually read — endpoints scrape sequentially with a
        per-endpoint timeout, and a wedged peer must not skew the rate
        denominators of everyone scraped after it. Roles with a fresh
        push are skipped here: push owns their freshness, pull stays the
        fallback when pushes stop."""
        t_tick = time.perf_counter()
        live = now is None
        scraped = set()
        stale = 0
        live_keys = set()
        texts = []  # (role, text, ts) — ingested under the lock below
        wall = time.time() if live else now
        t_fanout = time.perf_counter()
        for info in self._refresh_endpoints():
            role = info.get("role", "")
            if role == "master" and info.get("pid") == os.getpid():
                continue  # own registry is read in-process below
            key = self._endpoint_key(info)
            live_keys.add(key)
            if self._push_fresh(role, wall):
                continue
            if self._is_stale(info):
                # Dead pod whose advertisement survived (SIGKILL skips
                # the clean-shutdown removal): stop hammering the port.
                stale += 1
                continue
            try:
                text = self._scrape(info)
            except (OSError, ValueError):
                self._c_scrape_errors.labels(role=role or "?").inc()
                self._scrape_failures[key] = (
                    self._scrape_failures.get(key, 0) + 1
                )
                if self._is_stale(info):
                    stale += 1
                    logger.warning(
                        "Endpoint %s (pid %s, port %s) failed %d "
                        "consecutive scrapes; dropping it until its "
                        "advertisement is rewritten",
                        role, info.get("pid"), info.get("port"),
                        self._stale_after,
                    )
                continue
            self._scrape_failures.pop(key, None)
            texts.append((role, text, time.time() if live else now))
        self._h_fanout.observe(time.perf_counter() - t_fanout)
        # Forget failure counts of withdrawn/rewritten advertisements so
        # the map stays bounded by the live endpoint set.
        for key in list(self._scrape_failures):
            if key not in live_keys:
                del self._scrape_failures[key]
        self._g_stale.set(stale)
        now = time.time() if live else now
        with self._ingest_lock:
            for role, text, ts in texts:
                if self._ingest(role, text, ts):
                    scraped.add(role)
                    self._c_scrapes.labels(role=role or "?").inc()
            # Push-reporting roles are as good as scraped for derive.
            for role, ts in self._push_last_by_role.items():
                if (now - ts) <= self._push_horizon():
                    scraped.add(role)
            # The master's own registry never travels over HTTP:
            # reading it in-process keeps master-side signals alive
            # even when its exporter could not bind a port.
            if self._ingest("master", self._registry.expose(), now):
                scraped.add("master")
                self._c_scrapes.labels(role="master").inc()
            self._derive(now, scraped)
        self._h_tick.observe(time.perf_counter() - t_tick)

    def _ingest(self, role, text, now):
        """Parse + store one payload; False (and a scrape-error count)
        when the text does not parse — a corrupt endpoint must not be
        reported as healthy."""
        try:
            families = promtext.parse(text)
        except promtext.ParseError:
            self._c_scrape_errors.labels(role=role or "?").inc()
            return False
        self._ingest_families(role, families, now)
        return True

    def _ingest_families(self, role, families, now):
        """Store every sample of already-parsed families (the push path
        lands here directly — merged state needs no text round-trip)."""
        for family in families.values():
            # The aggregator's own edl_job_* output must not feed back
            # into its input when it ingests the master registry.
            if family.name.startswith("edl_job_"):
                continue
            for sample in family.samples:
                self.store.add(
                    role, sample.name, sample.labels, sample.value, now
                )
        if role != "master":
            self._last_report[role] = now

    # ---------- push ingestion ----------

    def ingest_push(self, snapshots, origin="", now=None):
        """Apply one ReportTelemetry batch; -> (accepted, need_full).

        Each snapshot is a pb.TelemetrySnapshot (or any object/dict with
        the same fields). Fulls replace the per-(role, pid) state;
        deltas must extend the held sequence (seq == last+1) or the
        role lands on the need_full list and the reporter resends a
        full snapshot next push. The merged state — not the delta — is
        ingested each time, so the series store ends up exactly where a
        pull scrape of the same registry would have put it."""
        wall = time.time() if now is None else now
        accepted = 0
        need_full = set()
        self._c_push_reports.inc()
        with self._ingest_lock:
            for snap in snapshots:
                role = _snap_field(snap, "role", "")
                pid = _snap_field(snap, "pid", 0)
                seq = _snap_field(snap, "seq", 0)
                full = _snap_field(snap, "full", False)
                payload = _snap_field(snap, "payload", "")
                key = (role, pid)
                self._c_push_bytes.inc(len(payload))
                try:
                    delta = (
                        promtext.parse(payload)
                        if payload
                        else collections.OrderedDict()
                    )
                except promtext.ParseError:
                    self._c_scrape_errors.labels(role=role or "?").inc()
                    need_full.add(role)
                    continue
                state = self._push_states.get(key)
                if full:
                    state = {"seq": seq, "families": delta, "ts": wall}
                    self._push_states[key] = state
                    self._c_push_snapshots.labels(kind="full").inc()
                elif state is None or seq != state["seq"] + 1:
                    # Lost/reordered push (or a master restart): the
                    # held state no longer matches what the reporter
                    # diffed against.
                    self._c_push_resyncs.inc()
                    need_full.add(role)
                    continue
                else:
                    push_mod.apply_delta(state["families"], delta)
                    state["seq"] = seq
                    state["ts"] = wall
                    self._c_push_snapshots.labels(kind="delta").inc()
                self._ingest_families(role, state["families"], wall)
                self._push_last_by_role[role] = wall
                tally = self._push_by_role.setdefault(role, [0, 0])
                tally[0] += 1
                tally[1] += len(payload)
                accepted += 1
        return accepted, sorted(need_full)

    def push_tally(self):
        """{role: {"snapshots", "payload_bytes"}}: the pushed snapshots
        this aggregator accepted, by role, since it started."""
        with self._ingest_lock:
            return {role: {"snapshots": n, "payload_bytes": b}
                    for role, (n, b) in sorted(self._push_by_role.items())}

    # ---------- derivation ----------

    def _worker_roles(self):
        return [r for r in self.store.roles() if r.startswith("worker")]

    def _ps_roles(self):
        return [r for r in self.store.roles() if r.startswith("ps")]

    def _step_labels(self):
        return (("phase", "batch_process"),)

    def _worker_step_stats(self, role, now=None):
        """Windowed step-time stats for one worker from its scraped
        edl_phase_seconds{phase="batch_process"} histogram."""
        labels = self._step_labels()
        dsum = self.store.delta(
            role, "edl_phase_seconds_sum", labels, now=now
        )
        dcount = self.store.delta(
            role, "edl_phase_seconds_count", labels, now=now
        )
        if not dcount or dsum is None or dcount < MIN_STEP_SAMPLES:
            return None
        mean = dsum / dcount
        bounds = []
        for s_labels in self.store.labelsets(
            role, "edl_phase_seconds_bucket"
        ):
            label_map = dict(s_labels)
            if label_map.get("phase") != "batch_process":
                continue
            le = label_map.get("le", "")
            bound = math.inf if le == "+Inf" else float(le)
            delta = self.store.delta(
                role, "edl_phase_seconds_bucket", s_labels, now=now
            )
            if delta is not None:
                bounds.append((bound, delta))
        bounds.sort(key=lambda bc: bc[0])
        p50 = histogram_quantile(bounds, 0.50)
        p99 = histogram_quantile(bounds, 0.99)
        ewma = self._ewma.get(role)
        ewma = (
            mean
            if ewma is None
            else _EWMA_ALPHA * mean + (1 - _EWMA_ALPHA) * ewma
        )
        self._ewma[role] = ewma
        return {
            "mean": mean,
            "p50": p50,
            "p99": p99,
            "ewma": ewma,
            "steps_in_window": dcount,
        }

    def _derive(self, now, scraped):
        # --- throughput ---
        rps = self.store.rate("master", "edl_records_done", now=now)
        if rps is not None:
            self._g_rps.set(rps)
            self._throughput_history.append(
                (round(now, 3), round(rps, 3))
            )
        records_done = self.store.latest("master", "edl_records_done")

        # --- per-worker step time + stragglers ---
        workers = {}
        step_means = {}
        for role in self._worker_roles():
            stats = self._worker_step_stats(role, now)
            if stats is None:
                continue
            workers[role] = stats
            step_means[role] = stats["ewma"]
            for stat in ("mean", "p50", "p99", "ewma"):
                value = stats[stat]
                if value is not None:
                    self._g_step.labels(worker=role, stat=stat).set(value)
            mfu = self.store.latest(role, "edl_worker_mfu")
            if mfu is not None:
                workers[role]["mfu"] = mfu
                self._g_mfu.labels(worker=role).set(mfu)
        straggler_scores = skew_scores(step_means)
        for role, score in straggler_scores.items():
            self._g_straggler_score.labels(worker=role).set(score)
            workers[role]["straggler_score"] = round(score, 3)

        # --- PS shard load ---
        ps = {}
        ps_rates = {}
        for role in self._ps_roles():
            # Per-shard byte counters carry labels (shard, rpc): fold
            # every labeled series of the family into one per-role rate.
            push = self._family_rate(
                role, "edl_ps_push_bytes_total", now=now
            )
            pull = self._family_rate(
                role, "edl_ps_pull_bytes_total", now=now
            )
            if push is None and pull is None:
                continue
            ps[role] = {
                "push_bytes_per_second": push,
                "pull_bytes_per_second": pull,
            }
            ps_rates[role] = (push or 0.0) + (pull or 0.0)
            if push is not None:
                self._g_ps_bps.labels(shard=role, direction="push").set(
                    push
                )
            if pull is not None:
                self._g_ps_bps.labels(shard=role, direction="pull").set(
                    pull
                )
        ps_skew = skew_scores(ps_rates)
        for role, ratio in ps_skew.items():
            self._g_ps_ratio.labels(shard=role).set(ratio)
            ps[role]["load_ratio"] = round(ratio, 3)

        # --- task queue drain / ETA ---
        todo = self.store.latest("master", "edl_tasks_todo")
        doing = self.store.latest("master", "edl_tasks_doing")
        # Success reports only: failed tasks are requeued, so counting
        # them as drain would make the ETA optimistic exactly during the
        # incidents this dashboard diagnoses.
        drain = self.store.rate(
            "master",
            "edl_tasks_reported_total",
            (("result", "success"),),
            now=now,
        )
        eta = None
        if drain and todo is not None:
            eta = (todo + (doing or 0)) / drain
            self._g_eta.set(eta)
        if drain is not None:
            self._g_drain.set(drain)
        abandoned = self._family_total(
            "master", "edl_tasks_abandoned_total"
        )
        recovered = self._family_total(
            "master", "edl_tasks_recovered_total"
        )

        # --- compile accounting (the profiling plane, aggregated) ---
        # Sum the per-role edl_compile_* counters over EVERY scraped
        # role so one master scrape answers "how much recompiling did
        # this elastic job do, and why".
        compile_counts = {}  # cause -> count
        compile_seconds = 0.0
        for role in self.store.roles():
            for labels in self.store.labelsets(role, "edl_compile_total"):
                value = self.store.latest(
                    role, "edl_compile_total", labels
                )
                if value:
                    cause = dict(labels).get("cause", "?")
                    compile_counts[cause] = (
                        compile_counts.get(cause, 0) + value
                    )
            for labels in self.store.labelsets(
                role, "edl_compile_seconds_total"
            ):
                value = self.store.latest(
                    role, "edl_compile_seconds_total", labels
                )
                if value:
                    compile_seconds += value
        for cause, count in compile_counts.items():
            self._g_compiles.labels(cause=cause).set(count)
        self._g_compile_seconds.set(compile_seconds)

        # --- data-plane rollups (observability/datapath.py) ---
        # Per-stage rates are seconds-of-stage-time per wall second, so
        # the per-worker `starve` rate reads directly as "fraction of
        # this worker's wall time the step sat on an empty feed".
        dp_stage_rates = {}
        starve_shares = {}
        dp_records_rate = None
        dp_queue_depth = {}
        dp_backpressure = None
        for role in self.store.roles():
            if not role.startswith("worker"):
                continue
            for labels in self.store.labelsets(
                role, "edl_datapath_seconds_total"
            ):
                rate = self.store.rate(
                    role, "edl_datapath_seconds_total", labels, now=now
                )
                if rate is None:
                    continue
                stage = dict(labels).get("stage", "?")
                dp_stage_rates[stage] = (
                    dp_stage_rates.get(stage, 0.0) + rate
                )
                if stage == "starve":
                    starve_shares[role] = (
                        starve_shares.get(role, 0.0) + rate
                    )
            rec_rate = self._family_rate(
                role, "edl_datapath_records_total", now=now
            )
            if rec_rate is not None:
                dp_records_rate = (dp_records_rate or 0.0) + rec_rate
            for labels in self.store.labelsets(
                role, "edl_datapath_queue_depth"
            ):
                depth = self.store.latest(
                    role, "edl_datapath_queue_depth", labels
                )
                if depth is not None:
                    qname = dict(labels).get("queue", "?")
                    dp_queue_depth[f"{role}/{qname}"] = depth
            bp = self._family_total(
                role, "edl_datapath_backpressure_total"
            )
            if bp is not None:
                dp_backpressure = (dp_backpressure or 0.0) + bp
        for stage, rate in dp_stage_rates.items():
            self._g_dp_stage.labels(stage=stage).set(rate)
        if dp_records_rate is not None:
            self._g_dp_records.set(dp_records_rate)
        dominant_stage = (
            max(dp_stage_rates, key=dp_stage_rates.get)
            if dp_stage_rates
            else None
        )

        # --- alerts ---
        signals = {
            "records_per_second": rps,
            "records_done": records_done,
            "straggler_scores": straggler_scores,
            "ps_skew_scores": ps_skew,
            "tasks_abandoned": abandoned,
            "tasks_todo": todo,
            "tasks_doing": doing,
            "input_starve_shares": starve_shares,
        }
        self.engine.evaluate(signals, now)
        flagged = set(self.engine.active_subjects("straggler"))
        for role in step_means:
            is_straggler = role in flagged
            self._g_straggler.labels(worker=role).set(
                1 if is_straggler else 0
            )
            workers[role]["straggler"] = is_straggler
        starved = set(self.engine.active_subjects("input_starvation"))
        for role, share in starve_shares.items():
            self._g_starve_share.labels(worker=role).set(share)
            self._g_input_starved.labels(worker=role).set(
                1 if role in starved else 0
            )
        # A worker that stopped reporting (scaled away, dead) must not
        # pin ANY of its per-worker gauges on /metrics forever — and its
        # EWMA must not seed a relaunched instance's scoring.
        for role in self._gauged_workers - set(step_means):
            self._g_straggler.labels(worker=role).set(0)
            self._g_straggler_score.labels(worker=role).set(0)
            for stat in ("mean", "p50", "p99", "ewma"):
                self._g_step.labels(worker=role, stat=stat).set(0)
            self._g_mfu.labels(worker=role).set(0)
            if role not in starve_shares:
                self._g_starve_share.labels(worker=role).set(0)
                self._g_input_starved.labels(worker=role).set(0)
            self._ewma.pop(role, None)
        self._gauged_workers |= set(step_means)
        self._g_workers.set(len(workers))

        # --- telemetry freshness + fleet rollups ---
        # Per-role age of the last ingested payload (push or pull).
        # Roles silent for 30 intervals are dead/scaled away and leave
        # the freshness sample set (their series age out via rate()'s
        # staleness window already).
        freshness = {}
        for role, ts in list(self._last_report.items()):
            age = now - ts
            if age > 30.0 * self.interval:
                del self._last_report[role]
                continue
            freshness[role] = age
            self._h_staleness.observe(max(0.0, age))
        # _derive always runs under _ingest_lock (re-entrant), but take
        # it explicitly here: these maps are also written by the RPC
        # handler path and the pruning must visibly share that guard.
        with self._ingest_lock:
            for key, state in list(self._push_states.items()):
                if now - state["ts"] > 30.0 * self.interval:
                    del self._push_states[key]
            for role, ts in list(self._push_last_by_role.items()):
                if now - ts > 30.0 * self.interval:
                    del self._push_last_by_role[role]
        push_roles = sum(
            1
            for ts in self._push_last_by_role.values()
            if (now - ts) <= self._push_horizon()
        )
        self._g_push_roles.set(push_roles)
        ages = sorted(freshness.values())
        fresh_max = ages[-1] if ages else None
        if fresh_max is not None:
            self._g_freshness.set(fresh_max)
        step_vals = sorted(step_means.values())
        fleet = {
            "workers_reporting": len(workers),
            "ps_reporting": len(ps),
            "roles_reporting": len(freshness),
            "push_roles": push_roles,
            "pull_roles": max(0, len(freshness) - push_roles),
            "step_ewma_p50": percentile(step_vals, 0.50),
            "step_ewma_p90": percentile(step_vals, 0.90),
            "step_ewma_p99": percentile(step_vals, 0.99),
            "freshness_max_s": (
                None if fresh_max is None else round(fresh_max, 3)
            ),
            "freshness_p99_s": (
                None
                if not ages
                else round(percentile(ages, 0.99), 3)
            ),
        }

        membership_epoch = self.store.latest(
            "master", "edl_membership_epoch"
        )
        summary = {
            "job": self._job,
            "ts": round(now, 3),
            "interval_s": self.interval,
            "records_per_second": rps,
            "records_done": records_done,
            "throughput_history": list(self._throughput_history),
            "workers": workers,
            "stragglers": sorted(flagged),
            "straggler_skew_threshold": self._straggler_skew,
            "ps": ps,
            "tasks": {
                "todo": todo,
                "doing": doing,
                "drain_per_second": drain,
                "eta_seconds": eta,
                "abandoned": abandoned,
                "recovered": recovered,
            },
            "alerts": self.engine.active(),
            "alerts_fired": self.engine.fired_total,
            "membership_epoch": membership_epoch,
            "roles_scraped": sorted(scraped),
            "fleet": fleet,
            "compiles": {
                "total": sum(compile_counts.values()),
                "by_cause": compile_counts,
                "edl_compile_seconds_total": round(compile_seconds, 4),
            },
            # Empty until workers report edl_datapath_* series (older
            # workers, ELASTICDL_DATAPATH=0): consumers skip the panel.
            "datapath": (
                {
                    "stages": {
                        s: round(v, 4)
                        for s, v in sorted(dp_stage_rates.items())
                    },
                    "dominant_stage": dominant_stage,
                    "records_per_second": dp_records_rate,
                    "starve_shares": {
                        r: round(v, 4)
                        for r, v in sorted(starve_shares.items())
                    },
                    "starved": sorted(starved),
                    "queue_depth": dp_queue_depth,
                    "backpressure_total": dp_backpressure,
                }
                if dp_stage_rates or dp_records_rate is not None
                else {}
            ),
        }
        with self._lock:
            self._summary = summary

    def _family_rate(self, role, name, window_s=RATE_WINDOW_S,
                     now=None):
        """Sum of rate() across every labeled series of one family."""
        total = None
        for labels in self.store.labelsets(role, name):
            rate = self.store.rate(
                role, name, labels, window_s, now=now
            )
            if rate is not None:
                total = (total or 0.0) + rate
        return total

    def _family_total(self, role, name):
        total = None
        for labels in self.store.labelsets(role, name):
            value = self.store.latest(role, name, labels)
            if value is not None:
                total = (total or 0.0) + value
        return total

    # ---------- consumption ----------

    def summary(self):
        """JSON-able snapshot for /api/summary and `edl dash`."""
        with self._lock:
            return dict(self._summary)

    def stragglers(self):
        """Worker roles currently flagged (JobStatusResponse field)."""
        return self.engine.active_subjects("straggler")

    def alerts_fired(self):
        return self.engine.fired_total
