"""The port's telemetry plane and its control-plane helpers against the
JAX package's, on the same inputs: the exposition parser (promtext), the
/metrics exporter (one GET of each route on 127.0.0.1, ephemeral ports),
push deltas, the alert rules, the aggregator's summary from the same
scrape texts at the same `now`, the flight recorder, observability.setup()
(the endpoint file and the handle), the master heartbeat, the metrics
service, the chaos schedule and its local seams, the dashboard frame and
the prediction-outputs hook. No subprocess, no sleep, no fixed port."""

import json
import os
import signal
import sys
import time
import types
import urllib.error
import urllib.request

import pytest

import elasticdl_tpu.observability as jax_obs
from elasticdl_tpu.chaos import injection as jax_injection
from elasticdl_tpu.common import heartbeat as jax_heartbeat
from elasticdl_tpu.master import metrics_service as jax_metrics_service
from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxTaskDispatcher,
)
from elasticdl_tpu.observability import aggregator as jax_aggregator
from elasticdl_tpu.observability import alerts as jax_alerts
from elasticdl_tpu.observability import dashboard as jax_dashboard
from elasticdl_tpu.observability import flightrec as jax_flightrec
from elasticdl_tpu.observability import metrics as jax_metrics
from elasticdl_tpu.observability import promtext as jax_promtext
from elasticdl_tpu.observability import push as jax_push
from elasticdl_tpu.observability.exporter import (
    MetricsExporter as JaxExporter,
)
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu_torch import observability
from elasticdl_tpu_torch.chaos import injection
from elasticdl_tpu_torch.common import heartbeat
from elasticdl_tpu_torch.master import metrics_service
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.observability import aggregator
from elasticdl_tpu_torch.observability import alerts
from elasticdl_tpu_torch.observability import dashboard
from elasticdl_tpu_torch.observability import flightrec
from elasticdl_tpu_torch.observability import metrics
from elasticdl_tpu_torch.observability import promtext
from elasticdl_tpu_torch.observability import push
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.exporter import MetricsExporter
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

PORT = "port"
JAX = "jax"
MODULES = {
    PORT: dict(registry=metrics.MetricsRegistry, promtext=promtext,
               push=push, alerts=alerts, aggregator=aggregator,
               flightrec=flightrec, exporter=MetricsExporter,
               heartbeat=heartbeat, metrics_service=metrics_service,
               dashboard=dashboard, injection=injection),
    JAX: dict(registry=jax_metrics.MetricsRegistry, promtext=jax_promtext,
              push=jax_push, alerts=jax_alerts, aggregator=jax_aggregator,
              flightrec=jax_flightrec, exporter=JaxExporter,
              heartbeat=jax_heartbeat, metrics_service=jax_metrics_service,
              dashboard=jax_dashboard, injection=jax_injection),
}


def _rich_registry(cls, scale=1):
    """The same metric operations on a registry of either package."""
    reg = cls()
    reg.counter("edl_rt_total", "counter help").inc(3 * scale)
    labeled = reg.counter("edl_rt_labeled_total", "labeled counter",
                          labelnames=("kind",))
    labeled.labels(kind="a").inc(2)
    labeled.labels(kind='esc"ape\\n\new').inc(5 * scale)
    reg.gauge("edl_rt_gauge", "gauge", labelnames=("x", "y")).labels(
        x="1", y="2").set(1.5 * scale)
    hist = reg.histogram("edl_rt_seconds", "hist", labelnames=("phase",),
                         buckets=(0.1, 1.0, 10.0))
    for value in (0.05, 0.5, 5.0, 50.0)[:2 + scale]:
        hist.labels(phase="p").observe(value)
    return reg


def _families(families):
    return [(name, f.name, f.type, f.help,
             [(s.name, tuple(s.labels), s.value) for s in f.samples])
            for name, f in families.items()]


def test_promtext_both_packages_parse_both_expositions():
    texts = [observability.default_registry().expose(),
             jax_obs.default_registry().expose(),
             _rich_registry(metrics.MetricsRegistry).expose()]
    assert "edl_tasks_dispatched_total" in texts[0]
    for text in texts:
        port, jax = promtext.parse(text), jax_promtext.parse(text)
        assert _families(port) == _families(jax)
        assert promtext.to_text(port) == jax_promtext.to_text(jax) == text
    # The two packages' registries write the same text.
    assert texts[2] == _rich_registry(jax_metrics.MetricsRegistry).expose()


def _get(port, path):
    url = f"http://127.0.0.1:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=10) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def test_exporter_routes_match_jax():
    summary = {"job": "j", "records_done": 64, "alerts": []}
    answers = {}
    for side, mods in MODULES.items():
        reg = _rich_registry(mods["registry"])
        exporter = mods["exporter"](reg, port=0, host="127.0.0.1")
        try:
            assert exporter.port > 0
            routes = {"/healthz": _get(exporter.port, "/healthz"),
                      "/api/summary (none)": _get(exporter.port,
                                                  "/api/summary"),
                      "/debug/profile": _get(exporter.port,
                                             "/debug/profile")}
            before = reg.expose()
            routes["/metrics"] = _get(exporter.port, "/metrics")
            assert routes["/metrics"] == (200, before.encode())
            exporter.summary_provider = lambda: summary
            status, body = _get(exporter.port, "/api/summary")
            routes["/api/summary"] = (status, json.loads(body))
        finally:
            exporter.close()
        answers[side] = routes
    assert answers[PORT] == answers[JAX]
    assert answers[PORT]["/api/summary"] == (200, summary)
    assert answers[PORT]["/debug/profile"][0] == 404


def test_push_delta_matches_jax():
    prev_text = _rich_registry(metrics.MetricsRegistry).expose()
    cur_text = _rich_registry(metrics.MetricsRegistry, scale=2).expose()
    out = {}
    for side, mods in MODULES.items():
        parse, mod = mods["promtext"].parse, mods["push"]
        delta = mod.snapshot_delta(parse(prev_text), parse(cur_text))
        merged = mod.apply_delta(parse(prev_text), delta)
        assert mods["promtext"].to_text(merged) == cur_text
        out[side] = mods["promtext"].to_text(delta)
    assert out[PORT] == out[JAX]
    assert "edl_rt_total 6" in out[PORT] and 'kind="a"' not in out[PORT]


class _ScriptedRegistry:
    """A registry whose exposition advances one text per expose()."""

    def __init__(self, texts):
        self._texts = list(texts)
        self._i = 0

    def expose(self):
        text = self._texts[min(self._i, len(self._texts) - 1)]
        self._i += 1
        return text


def _run_reporter(mods):
    """One package's TelemetryReporter through scripted master answers:
    accepted, need_full, an error, accepted twice; then its thread on a
    short interval. -> (what the master was sent and push_once returned,
    the counters, the thread's pushes)."""
    texts = [_rich_registry(metrics.MetricsRegistry, scale=k).expose()
             for k in (1, 2, 2, 3, 4)]
    answers = [
        types.SimpleNamespace(accepted=1, need_full=[]),
        types.SimpleNamespace(accepted=0, need_full=["worker-3"]),
        RuntimeError("master unreachable"),
        types.SimpleNamespace(accepted=1, need_full=[]),
        types.SimpleNamespace(accepted=1, need_full=[]),
    ]
    sent = []

    def report(snaps, origin=""):
        snap = snaps[0]
        sent.append((origin, snap["role"], snap["seq"], snap["full"],
                     snap["payload"]))
        answer = answers[len(sent) - 1]
        if isinstance(answer, Exception):
            raise answer
        return answer

    reporter = mods["push"].TelemetryReporter(
        report, _ScriptedRegistry(texts), role="worker-3", interval=0.01,
        jitter=0.0, full_every=0, seed=3)
    returned = [reporter.push_once() for _ in answers]
    counters = (reporter.pushes, reporter.errors)
    threaded = mods["push"].TelemetryReporter(
        lambda snaps, origin="": types.SimpleNamespace(
            accepted=len(snaps), need_full=[]),
        _ScriptedRegistry(texts), role="worker-3", interval=0.01,
        jitter=0.2, seed=3).start()
    deadline = time.time() + 10
    while threaded.pushes < 3 and time.time() < deadline:
        time.sleep(0.01)
    threaded.close()
    idle = mods["push"].TelemetryReporter(
        report, _ScriptedRegistry(texts), role="worker-3", interval=0)
    return (sent, returned, counters, threaded.pushes >= 3,
            idle.enabled, idle.start()._thread), reporter


def test_telemetry_reporter_matches_jax(monkeypatch):
    """The port's reporter sends the JAX reporter's snapshots (seq, full
    after need_full, deltas otherwise) for the same answers, counts the
    same pushes and errors, and runs its thread the same way. Its own
    counters add the accepted snapshots and payload bytes. Its default
    interval is 2 s where the JAX package's is 0 (off)."""
    got, reporter = _run_reporter(MODULES[PORT])
    want, _ = _run_reporter(MODULES[JAX])
    assert got == want
    sent = got[0]
    assert [(seq, full) for _, _, seq, full, _ in sent] == [
        (1, True), (2, False), (3, True), (4, False), (5, False)]
    assert got[1] == [True, True, False, True, True]
    assert got[2] == (4, 1)
    stats = reporter.stats()
    assert stats["accepted"] == 3 and stats["errors"] == 1
    assert stats["payload_bytes"] == sum(len(p) for *_, p in sent)
    monkeypatch.delenv(push.PUSH_INTERVAL_ENV, raising=False)
    assert push.TelemetryReporter(None, None, "worker-0").interval == 2.0
    assert jax_push.TelemetryReporter(None, None, "worker-0").interval == 0.0


SIGNALS = [
    # (now, signals): a straggler rises and clears, a PS shard runs hot,
    # progress stalls with tasks in flight, a task is abandoned, a worker
    # starves on its feed.
    (1000.0, {"records_done": 0, "tasks_doing": 2, "tasks_abandoned": 0,
              "straggler_scores": {"worker-0": 1.0, "worker-1": 1.0},
              "ps_skew_scores": {"ps-0": 1.0, "ps-1": 1.0},
              "input_starve_shares": {"worker-0": 0.01}}),
    (1010.0, {"records_done": 50, "tasks_doing": 2, "tasks_abandoned": 0,
              "straggler_scores": {"worker-0": 5.0, "worker-1": 0.6},
              "ps_skew_scores": {"ps-0": 4.0, "ps-1": 0.2},
              "input_starve_shares": {"worker-0": 0.5}}),
    (1020.0, {"records_done": 50, "tasks_doing": 2, "tasks_abandoned": 1,
              "straggler_scores": {"worker-0": 5.0, "worker-1": 0.6},
              "ps_skew_scores": {"ps-0": 1.0, "ps-1": 1.0},
              "input_starve_shares": {"worker-0": 0.5}}),
    (1100.0, {"records_done": 50, "tasks_doing": 2, "tasks_abandoned": 1,
              "straggler_scores": {"worker-0": 1.0, "worker-1": 1.0},
              "ps_skew_scores": {}, "input_starve_shares": {}}),
]


def test_alert_engine_firings_match_jax():
    trails = {}
    for side, mods in MODULES.items():
        engine = mods["alerts"].AlertEngine(registry=mods["registry"]())
        trail = []
        for now, signals in SIGNALS:
            engine.evaluate(signals, now)
            trail.append((engine.active(), engine.fired_total,
                          engine.active_subjects("straggler")))
        trails[side] = trail
    assert trails[PORT] == trails[JAX]
    fired = {a["rule"] for active, _, _ in trails[PORT] for a in active}
    assert fired == {"straggler", "ps_imbalance", "throughput_stall",
                     "tasks_abandoned", "input_starvation"}, fired


def _scrape_texts(step):
    """The texts two workers and two PS shards serve at poll `step`:
    worker-0 steps 20x slower than worker-1; ps-0 takes 9x the bytes."""
    texts = {}
    for role, seconds in (("worker-0", 0.2), ("worker-1", 0.01)):
        reg = metrics.MetricsRegistry()
        hist = reg.histogram("edl_phase_seconds", "phases",
                             labelnames=("phase",))
        for _ in range(5 * (step + 1)):
            hist.labels(phase="batch_process").observe(seconds)
        reg.counter("edl_datapath_seconds_total", "stage seconds",
                    labelnames=("stage",)).labels(stage="read").inc(
            (step + 1) * (3.0 if role == "worker-0" else 0.2))
        reg.counter("edl_datapath_records_total", "records").inc(
            100 * (step + 1))
        texts[role] = reg.expose()
    for role, rate in (("ps-0", 9000), ("ps-1", 1000)):
        reg = metrics.MetricsRegistry()
        reg.counter("edl_ps_push_bytes_total", "push",
                    labelnames=("shard",)).labels(shard=role[-1]).inc(
            rate * (step + 1))
        texts[role] = reg.expose()
    return texts


def _run_aggregator(mods, obs_dir):
    """Four polls of one package's aggregator over the same scrape texts
    at the same `now`, the master's own registry fed alike; returns the
    summaries."""
    master_reg = mods["registry"]()
    records = master_reg.gauge("edl_records_done", "records")
    todo = master_reg.gauge("edl_tasks_todo", "todo")
    master_reg.gauge("edl_tasks_doing", "doing").set(2)
    reported = master_reg.counter("edl_tasks_reported_total", "reported",
                                  labelnames=("result",))
    agg = mods["aggregator"].TelemetryAggregator(
        obs_dir, registry=master_reg, job="agg", interval=1.0)
    state = {"step": 0}
    agg._scrape = lambda info: _scrape_texts(state["step"])[info["role"]]
    summaries = []
    for step, now in enumerate((1000.0, 1010.0, 1020.0, 1030.0)):
        state["step"] = step
        records.set(16 * step)
        todo.set(100 - 10 * step)
        reported.labels(result="success").inc(10 if step else 0)
        agg.poll_once(now=now)
        summaries.append(agg.summary())
    agg.close()
    return summaries, agg


def test_aggregator_summary_matches_jax(tmp_path):
    obs_dir = str(tmp_path)
    os.makedirs(os.path.join(obs_dir, "endpoints"))
    for role in ("worker-0", "worker-1", "ps-0", "ps-1"):
        with open(os.path.join(obs_dir, "endpoints", f"{role}.json"),
                  "w") as f:
            json.dump({"role": role, "port": 1, "pid": 0,
                       "host": "127.0.0.1"}, f)
    got, agg = _run_aggregator(MODULES[PORT], obs_dir)
    want, _ = _run_aggregator(MODULES[JAX], obs_dir)
    assert got == want
    last = got[-1]
    assert last["records_done"] == 48
    assert last["records_per_second"] == pytest.approx(1.6)
    assert last["stragglers"] == ["worker-0"] == agg.stragglers()
    assert last["roles_scraped"] == ["master", "ps-0", "ps-1", "worker-0",
                                     "worker-1"]
    json.dumps(last)
    # One frame of the dashboard from that summary, as the JAX package
    # renders it.
    frame = dashboard.render(last, width=100)
    assert frame == jax_dashboard.render(last, width=100)
    assert "worker-0" in frame


class _TextRegistry:
    """A registry whose exposition is a given text (a role's at a step)."""

    def __init__(self, role, state):
        self._role = role
        self._state = state

    def expose(self):
        return _scrape_texts(self._state["step"])[self._role]


def _run_push(mods, servicer_cls, dispatcher_cls, request_module, obs_dir):
    """The aggregator of one package fed by push (worker-0 and ps-0, through
    its servicer's ReportTelemetry handler) and by pull (the other two
    roles) at the same `now`; one worker-0 push is lost on the way, so the
    next delta is refused and the reporter resends a full snapshot."""
    agg = mods["aggregator"].TelemetryAggregator(
        obs_dir, registry=mods["registry"](), job="agg", interval=1.0)
    state = {"step": 0}
    agg._scrape = lambda info: _scrape_texts(state["step"])[info["role"]]
    servicer = servicer_cls(dispatcher_cls({}, {}, {}))
    servicer.bind_job_context(aggregator=agg)
    pushers = {role: mods["push"].TelemetryPusher(
        _TextRegistry(role, state), role, full_every=4)
        for role in ("worker-0", "ps-0")}
    trail = []
    for step, now in enumerate((1000.0, 1010.0, 1020.0, 1030.0, 1040.0)):
        state["step"] = step
        for role, pusher in pushers.items():
            snap = pusher.snapshot()
            if role == "worker-0" and step == 1:
                continue  # lost on the way
            request = request_module.ReportTelemetryRequest(origin=role)
            request.snapshots.add(**snap)
            agg_now = agg.ingest_push
            agg.ingest_push = lambda snaps, origin="", _f=agg_now: _f(
                snaps, origin=origin, now=now)
            try:
                response = servicer.report_telemetry(request, None)
            finally:
                agg.ingest_push = agg_now
            if role in response.need_full:
                pusher.reset()
            trail.append((role, snap["seq"], snap["full"],
                          response.accepted, list(response.need_full)))
        agg.poll_once(now=now)
        trail.append(agg.summary())
    agg.close()
    return trail


def test_pushed_telemetry_gives_the_jax_summary(tmp_path):
    obs_dir = str(tmp_path)
    os.makedirs(os.path.join(obs_dir, "endpoints"))
    for role in ("worker-0", "worker-1", "ps-0", "ps-1"):
        with open(os.path.join(obs_dir, "endpoints", f"{role}.json"),
                  "w") as f:
            json.dump({"role": role, "port": 1, "pid": 0,
                       "host": "127.0.0.1"}, f)
    got = _run_push(MODULES[PORT], MasterServicer, TaskDispatcher, pb,
                    obs_dir)
    want = _run_push(MODULES[JAX], JaxServicer, JaxTaskDispatcher, pb2,
                     obs_dir)
    assert got == want
    assert ("worker-0", 3, False, 0, ["worker-0"]) in got  # the gap
    fleet = got[-1]["fleet"]
    assert fleet["push_roles"] == 2 and fleet["pull_roles"] == 2
    assert got[-1]["stragglers"] == ["worker-0"]


def _flight_trail(side, tmp_path):
    rec = MODULES[side]["flightrec"].FlightRecorder("worker-0", 4,
                                                    str(tmp_path / side))
    for i in range(6):
        rec.on_span(f"step{i}", 100.0 + i, 0.25, "edl",
                    {"task_id": i, "blob": [1, 2]})
    rec.on_span("rpc_client/get_task", 107.0, 0.002, "rpc", None)
    with rec.phase("train"):
        with rec.phase("push"):
            snap = rec.snapshot("probe")
    path = rec.dump("watchdog")
    with open(path) as f:
        dumped = json.load(f)
    return (snap["role"], snap["reason"], snap["rpc"], snap["events"],
            [p["name"] for p in snap["open_phases"]],
            dumped["dump_seq"], dumped["reason"],
            [e["name"] for e in dumped["events"]])


def test_flight_recorder_matches_jax(tmp_path, monkeypatch):
    assert _flight_trail(PORT, tmp_path) == _flight_trail(JAX, tmp_path)
    # Armed without signal handlers, it records the tracing plane's spans
    # through its sink and dumps from the crash hook, which chains on.
    chained = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: chained.append(a[0]))
    previous_sigterm = signal.getsignal(signal.SIGTERM)
    rec = flightrec.install("master", capacity=8,
                            dump_dir=str(tmp_path / "armed"),
                            arm_signals=False)
    try:
        assert flightrec.get() is rec
        assert signal.getsignal(signal.SIGTERM) is previous_sigterm
        with tracing.span("dispatch", task_id=3):
            pass
        with flightrec.phase("train_step"):
            flightrec._crash_hook(ValueError, ValueError("boom"), None)
    finally:
        flightrec.uninstall()
    assert flightrec.get() is None and chained == [ValueError]
    with open(tmp_path / "armed" / "flightrec-master.json") as f:
        dumped = json.load(f)
    assert dumped["reason"] == "crash:ValueError"
    assert [p["name"] for p in dumped["open_phases"]] == ["train_step"]
    assert [e["name"] for e in dumped["events"]] == ["dispatch"]


def test_setup_advertises_one_endpoint_like_jax(tmp_path):
    handle = observability.current_handle()
    if handle is not None:
        handle.close()
    obs_dir = str(tmp_path / "obs")
    handle = observability.setup(role="master", job="edl-job",
                                 obs_dir=obs_dir, metrics_port=0,
                                 arm_signals=False)
    try:
        assert observability.setup(role="worker-0") is handle
        assert (handle.role, handle.job, handle.obs_dir) == (
            "master", "edl-job", obs_dir)
        assert handle.metrics_port == handle.exporter.port > 0
        assert handle.flight is flightrec.get() is not None
        assert tracing.get_recorder() is handle.recorder
        observability.emit_event("master_recovered", incarnation=2)
        with open(os.path.join(obs_dir, "endpoints", "master.json")) as f:
            advertised = json.load(f)
        jax_obs._advertise_endpoint(str(tmp_path / "jax"), "master",
                                    "edl-job", handle.metrics_port)
        with open(tmp_path / "jax" / "endpoints" / "master.json") as f:
            assert advertised == json.load(f)
        status, body = _get(handle.metrics_port, "/metrics")
        assert status == 200 and b"edl_tasks_dispatched_total" in body
    finally:
        handle.close()
    assert observability.current_handle() is None
    assert flightrec.get() is None and tracing.get_recorder() is None
    assert not os.path.exists(os.path.join(obs_dir, "endpoints",
                                           "master.json"))
    events = [json.loads(line) for line in open(
        os.path.join(obs_dir, "events.jsonl"))]
    assert [(e["kind"], e["incarnation"]) for e in events] == [
        ("master_recovered", 2)]


def test_heartbeat_matches_jax_and_goes_stale(tmp_path):
    import reap_orphans

    beats = {}
    for side, mods in MODULES.items():
        writer = mods["heartbeat"].HeartbeatWriter(
            job="edl-job", directory=str(tmp_path / side), period=5.0)
        assert writer.enabled and writer.beat()
        with open(writer.path) as f:
            beats[side] = json.load(f)
        assert os.path.basename(writer.path) == f"edl-job-{os.getpid()}.json"
    ts = beats[PORT].pop("ts")
    beats[JAX].pop("ts")
    assert beats[PORT] == beats[JAX]
    assert beats[PORT]["pid"] == os.getpid()
    directory = str(tmp_path / PORT)
    kills = []
    fresh = reap_orphans.reap(directory, dry_run=True, now=ts + 29.0,
                              kill=lambda *a: kills.append(a))
    assert len(fresh["fresh"]) == 1
    # Stale after max(30, 3 x period) s; this process's own group is never
    # signalled.
    stale = reap_orphans.reap(directory, dry_run=True, now=ts + 31.0,
                              kill=lambda *a: kills.append(a))
    assert len(stale["skipped"]) == 1 and not kills
    writer = heartbeat.HeartbeatWriter(job="edl-job", directory=directory,
                                       period=5.0)
    writer.close()
    assert not os.listdir(directory)


def test_metrics_service_lines_match_jax(tmp_path, monkeypatch):
    lines = {}
    for side, mods in MODULES.items():
        mod = mods["metrics_service"]
        # TensorBoard only when a writer imports: its absence is the
        # JSONL-only service of both packages.
        monkeypatch.setattr(mod, "_make_summary_writer", lambda d: None)
        service = mod.MetricsService(str(tmp_path / side))
        service.on_evaluation_results(8, {"token_ce": 1.25, "step": 3})
        service.log_scalars("train", 16, {"records_done": 64, "epoch": 1})
        service.close()
        with open(tmp_path / side / "metrics.jsonl") as f:
            lines[side] = [json.loads(line) for line in f]
        for line in lines[side]:
            assert isinstance(line.pop("ts"), float)
    assert lines[PORT] == lines[JAX] == [
        {"group": "eval", "step": 8, "token_ce": 1.25, "metric_step": 3.0},
        {"group": "train", "step": 16, "records_done": 64.0, "epoch": 1.0}]


CHAOS = {"seed": 11, "rules": [
    {"method": "datapath.read", "kind": "latency", "start": 1, "count": 3,
     "latency_s": 0.5, "side": "client"},
    {"method": "master.dispatch", "kind": "latency", "start": 0,
     "count": -1, "latency_s": 0.01, "side": "client"},
    {"method": "master.dispatch", "kind": "kill", "start": 2, "count": 1,
     "side": "client"},
    {"method": "Pserver", "kind": "unavailable", "start": 0, "count": 2,
     "side": "server", "role": "ps-*"},
]}


def test_chaos_schedule_matches_jax(monkeypatch):
    """The same rule strings and call order give the same decisions and
    jitters (the kill rule is checked by its decision, never fired)."""
    monkeypatch.setenv("ELASTICDL_ROLE", "ps-1")
    calls = ["datapath.read"] * 5 + ["master.dispatch"] * 4 + [
        "/elasticdl_tpu.Pserver/push_gradients"] * 3
    trails = {}
    for side, mods in MODULES.items():
        schedule = mods["injection"].FaultSchedule.from_json(
            json.dumps(CHAOS))
        trail = []
        for method in calls:
            for s in ("client", "server"):
                for rule in schedule.decide(method, s):
                    jitter = (schedule.jitter(rule)
                              if rule.kind == "latency" else None)
                    trail.append((method, s, rule.kind, jitter))
        trails[side] = trail
        assert json.loads(schedule.to_json()) == CHAOS | {
            "rules": [dict(r, **{k: v for k, v in
                                 (("latency_s", 0.25), ("role", ""),
                                  ("start", 0), ("count", -1))
                                 if k not in r}) for r in CHAOS["rules"]]}
    assert trails[PORT] == trails[JAX]
    kinds = [(m, k) for m, _, k, _ in trails[PORT]]
    assert kinds.count(("master.dispatch", "kill")) == 1
    assert kinds.count(("datapath.read", "latency")) == 3


def test_local_seams_inject_like_jax(monkeypatch):
    """inject_local at the master's dispatch seam: one latency draw per
    dispatch (get_task and get_task_batch), the same draws through the
    port's servicer as through the JAX servicer, from ELASTICDL_CHAOS."""
    rules = {"seed": 5, "rules": [
        {"method": "master.dispatch", "kind": "latency", "start": 0,
         "count": -1, "latency_s": 0.02, "side": "client"},
        {"method": "datapath.read", "kind": "latency", "start": 0,
         "count": 1, "latency_s": 0.5, "side": "client"}]}
    monkeypatch.setenv("ELASTICDL_CHAOS", json.dumps(rules))
    slept = {}
    for side, (mod, servicer_cls, dispatcher_cls, msgs) in {
            PORT: (injection, MasterServicer, TaskDispatcher, pb),
            JAX: (jax_injection, JaxServicer, JaxTaskDispatcher,
                  pb2)}.items():
        monkeypatch.setattr(mod, "_env_schedule", None)
        naps = slept.setdefault(side, [])
        # The module's clock only: no other thread's sleep lands here.
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            sleep=naps.append))
        servicer = servicer_cls(dispatcher_cls(
            {"f": (0, 64)}, {}, {}, records_per_task=16, num_epochs=1))
        servicer.get_task(msgs.GetTaskRequest(worker_id=0), None)
        servicer.get_task_batch(
            msgs.GetTaskRequest(worker_id=0, max_tasks=2), None)
        mod.inject_local("datapath.read")
        mod.inject_local("datapath.read")
    assert slept[PORT] == slept[JAX]
    assert len(slept[PORT]) == 3 and slept[PORT][-1] > 0.2


def test_prediction_outputs_processor_is_the_abc():
    with pytest.raises(TypeError):
        BasePredictionOutputsProcessor()

    class Keep(BasePredictionOutputsProcessor):
        def __init__(self):
            self.seen = []

        def process(self, predictions, worker_id):
            self.seen.append((predictions, worker_id))

    keep = Keep()
    keep.process([1.0], 3)
    assert keep.seen == [([1.0], 3)]

