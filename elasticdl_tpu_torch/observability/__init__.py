"""Observability plane of the port (counterpart of elasticdl_tpu/observability).

Components use `default_registry()` (process-local metrics), `emit_event()`
(the structured event log, a no-op until a log is installed) and
`tracing.span()`, all cheap until configured. `setup()` configures them for
one process: the trace and event files under the obs dir, the flight
recorder, and the /metrics exporter advertised under
`<obs_dir>/endpoints/<role>.json`, where the master's telemetry aggregator
finds it. Configuration travels to other processes of the job through the
ELASTICDL_OBS_DIR / ELASTICDL_JOB_NAME environment variables.

Against the JAX package's setup(): no persistent compile cache (the port
runs eagerly), no device-memory accountant and no on-demand profile
provider yet (the exporter's /debug/profile answers 404), and no JSON log
identity (the port's log_utils has none).
"""

import json
import os

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.observability import events as _events
from elasticdl_tpu_torch.observability import tracing as _tracing
from elasticdl_tpu_torch.observability.metrics import default_registry  # noqa: F401

OBS_DIR_ENV = "ELASTICDL_OBS_DIR"
JOB_NAME_ENV = "ELASTICDL_JOB_NAME"
METRICS_PORT_ENV = "ELASTICDL_METRICS_PORT"

emit_event = _events.emit

_handle = None


class ObservabilityHandle:
    """One process's configured observability plane."""

    def __init__(self, role, job, obs_dir, exporter, recorder, event_log,
                 flight=None):
        self.role = role
        self.job = job
        self.obs_dir = obs_dir
        self.exporter = exporter
        self.recorder = recorder
        self.event_log = event_log
        self.flight = flight

    @property
    def metrics_port(self):
        return self.exporter.port if self.exporter is not None else 0

    def close(self):
        global _handle
        if self.flight is not None:
            from elasticdl_tpu_torch.observability import flightrec

            if flightrec.get() is self.flight:
                flightrec.uninstall()
        if self.exporter is not None:
            self.exporter.close()
            # Clean shutdown withdraws the endpoint advertisement so the
            # master's aggregator stops scraping a port nobody serves.
            # Only when the file is still OURS: a relaunched successor
            # with the same role may have rewritten it.
            if self.obs_dir:
                path = os.path.join(
                    self.obs_dir, "endpoints", f"{self.role}.json"
                )
                try:
                    with open(path) as f:
                        advertised = json.load(f)
                    if advertised.get("pid") == os.getpid():
                        os.remove(path)
                except (OSError, ValueError):
                    pass
        if self.recorder is not None:
            self.recorder.close()
            if _tracing.get_recorder() is self.recorder:
                _tracing.set_recorder(None)
        if self.event_log is not None:
            if _events.get_event_log() is self.event_log:
                _events.set_event_log(None)
            self.event_log.close()
        if _handle is self:
            _handle = None


def current_handle():
    return _handle


def setup(role, job="", obs_dir=None, metrics_port=None, registry=None,
          arm_signals=True, host=None):
    """Configure this process's observability plane and return its handle.

    obs_dir=None reads ELASTICDL_OBS_DIR; still-None disables traces and
    events but keeps the in-process metrics registry live (and exported,
    when metrics_port says so). metrics_port=None reads
    ELASTICDL_METRICS_PORT; 0 binds an ephemeral port; a negative value
    disables the endpoint. The bound endpoint is advertised under
    <obs_dir>/endpoints/<role>.json so monitors and tests can find every
    process of a job without guessing ports. arm_signals=False installs
    the flight recorder without its SIGTERM/SIGINT handlers (a process
    that hosts several roles, or a test, keeps its own). host=None binds
    ELASTICDL_METRICS_HOST (default 0.0.0.0); a process whose scrapers
    all live in it binds "127.0.0.1".

    Idempotent: a second setup() in the same process returns the first
    call's live handle unchanged (double wiring would double-register
    exporters). Port-collision-safe: a fixed metrics_port that is already
    bound falls back to an ephemeral port and the advertisement carries
    whatever port actually bound.
    """
    global _handle
    if _handle is not None:
        return _handle
    from elasticdl_tpu_torch.common import log_utils
    from elasticdl_tpu_torch.observability.exporter import MetricsExporter

    if obs_dir is None:
        obs_dir = knobs.get_str(OBS_DIR_ENV)
    if not job:
        job = knobs.get_str(JOB_NAME_ENV)
    if metrics_port is None:
        metrics_port = knobs.get_int(METRICS_PORT_ENV)

    recorder = None
    event_log = None
    flight = None
    if obs_dir:
        os.makedirs(obs_dir, exist_ok=True)
        recorder = _tracing.SpanRecorder(
            os.path.join(obs_dir, f"trace_{role}.jsonl"),
            process_name=f"{job}/{role}" if job else role,
        )
        _tracing.set_recorder(recorder)
        event_log = _events.EventLog(
            os.path.join(obs_dir, "events.jsonl"), job=job, role=role
        )
        _events.set_event_log(event_log)
        # Crash-dump flight recorder: a bounded ring of the spans the
        # plane just started emitting, dumped to
        # <obs_dir>/flightrec-<role>.json on crash/SIGTERM so a dead
        # role leaves attributable evidence (ELASTICDL_FLIGHTREC=0
        # disables).
        from elasticdl_tpu_torch.observability import flightrec

        flight = flightrec.install(role, dump_dir=obs_dir,
                                   arm_signals=arm_signals)

    exporter = None
    if metrics_port >= 0:
        try:
            exporter = MetricsExporter(
                registry or default_registry(), port=metrics_port, host=host
            )
        except OSError:
            # A busy fixed port must not kill (or silence) a training
            # process: fall back to an ephemeral port and re-advertise.
            log_utils.get_logger("observability").warning(
                "Could not bind metrics endpoint on port %d; falling "
                "back to an ephemeral port", metrics_port,
            )
            try:
                exporter = MetricsExporter(
                    registry or default_registry(), port=0, host=host
                )
            except OSError:
                log_utils.get_logger("observability").warning(
                    "Could not bind any metrics endpoint; metrics stay "
                    "in-process only"
                )
    if obs_dir and exporter is not None:
        _advertise_endpoint(obs_dir, role, job, exporter.port, host)

    _handle = ObservabilityHandle(
        role, job, obs_dir, exporter, recorder, event_log, flight
    )
    return _handle


def _scrape_host(bind=None):
    bind = bind or knobs.get_str("ELASTICDL_METRICS_HOST")
    if bind and bind not in ("0.0.0.0", "::"):
        return bind
    return os.environ.get("MY_POD_IP", "127.0.0.1")


def _advertise_endpoint(obs_dir, role, job, port, host=None):
    endpoints = os.path.join(obs_dir, "endpoints")
    os.makedirs(endpoints, exist_ok=True)
    path = os.path.join(endpoints, f"{role}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(
            {
                "role": role,
                "job": job,
                "pid": os.getpid(),
                "port": port,
                # Scrape host for off-host monitors (the aggregator):
                # an explicit non-wildcard bind address wins (the
                # exporter only listens there), then the pod IP, then
                # localhost.
                "host": _scrape_host(host),
            },
            f,
        )
    os.replace(tmp, path)  # atomic: readers never see a partial file
