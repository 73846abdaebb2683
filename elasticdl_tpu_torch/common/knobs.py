"""Registry of the ELASTICDL_* environment knobs the port reads
(counterpart of elasticdl_tpu/common/knobs.py).

Every environment variable a port module reads is declared here once, with
its type, default and documentation, under the JAX package's name and
default, so one environment means the same to both packages. Call sites
read values through the typed accessors (`get_str` / `get_int` /
`get_float`). Reads are live: os.environ is consulted on every call.

Stdlib-only, imports nothing from the package.
"""

import logging
import os
import tempfile

_logger = logging.getLogger("elasticdl_tpu_torch.common.knobs")

_TYPES = ("str", "int", "float")


class Knob:
    """One declared environment knob: name, type, default, doc."""

    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name, type, default, doc):
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc


_REGISTRY = {}


def declare(name, type, default, doc):
    """Register a knob. Re-declaring with a conflicting type or default
    is an error (two modules silently disagreeing on a default is exactly
    the bug the registry exists to prevent)."""
    if type not in _TYPES:
        raise ValueError(f"knob {name}: unknown type {type!r}")
    if not name.startswith("ELASTICDL_"):
        raise ValueError(f"knob {name}: names must start with ELASTICDL_")
    prior = _REGISTRY.get(name)
    if prior is not None:
        if (prior.type, prior.default) != (type, default):
            raise ValueError(
                f"knob {name} re-declared as ({type}, {default!r}); "
                f"conflicts with ({prior.type}, {prior.default!r})"
            )
        return prior
    knob = Knob(name, type, default, doc)
    _REGISTRY[name] = knob
    return knob


def _knob(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"environment knob {name!r} is not declared in "
            f"elasticdl_tpu_torch/common/knobs.py"
        ) from None


def raw(name):
    """The raw environment string for a DECLARED knob ("" when unset).
    For callers that need presence/emptiness semantics (JSON blobs,
    forward-to-child-env logic) rather than a parsed value."""
    _knob(name)
    return os.environ.get(name, "")


def is_set(name):
    """True when the declared knob is present and non-empty."""
    return bool(raw(name))


def get_str(name):
    knob = _knob(name)
    value = os.environ.get(name, "")
    return value if value else knob.default


def get_int(name):
    knob = _knob(name)
    value = os.environ.get(name, "")
    if value:
        try:
            return int(value)
        except ValueError:
            # Float-formatted values ("12.0") truncate, matching the
            # int(float(...)) parsing the pre-registry helpers used.
            try:
                return int(float(value))
            except ValueError:
                _logger.warning("Bad %s=%r; using default %r", name,
                                value, knob.default)
    return knob.default


def get_float(name):
    knob = _knob(name)
    value = os.environ.get(name, "")
    if value:
        try:
            return float(value)
        except ValueError:
            _logger.warning("Bad %s=%r; using default %r", name, value,
                            knob.default)
    return knob.default


# ---------------------------------------------------------------------------
# The registry: the knobs of the modules ported so far.
# ---------------------------------------------------------------------------

# -- observability plane (observability/) --
declare("ELASTICDL_OBS_MAX_LOG_MB", "float", 64.0,
        "Size cap in MB for each observability log (traces.jsonl / "
        "events.jsonl); crossing it rotates the file to <name>.1 with a "
        "rotated marker event. 0 disables rotation.")
declare("ELASTICDL_DATAPATH", "int", 1,
        "Stage-level input-pipeline instrumentation (task/read/decode/"
        "collate/h2d/starve stages as Timing phases, spans, and "
        "edl_datapath_* series); 0 turns every stage into a no-op.")
declare("ELASTICDL_DATAPATH_QUEUE_CAPACITY", "int", 1024,
        "Default capacity QueueTelemetry assumes for a hand-off queue "
        "whose constructor does not pass one (the prefetch queue passes "
        "its real bound); sizes the backpressure watermark.")
declare("ELASTICDL_DATAPATH_QUEUE_WATERMARK", "float", 0.8,
        "Fraction of a hand-off queue's capacity at which occupancy "
        "fires the edge-triggered datapath_backpressure event; <=0 "
        "disables watermark events (the depth gauge stays live).")
declare("ELASTICDL_EVENT_COALESCE_SECONDS", "float", 0.0,
        "Coalescing window for high-frequency event kinds: after one "
        "event of a coalesced kind is written, further events of that "
        "kind within the window are folded into the next write (which "
        "carries a coalesced=N field) instead of each taking a line. "
        "0 (default) writes every event.")
declare("ELASTICDL_EVENT_COALESCE_KINDS", "str", "membership_epoch",
        "Comma-separated event kinds subject to the coalescing window "
        "(per-epoch membership churn is the canonical spammer).")

# -- worker task loop (worker/task_data_service.py) --
declare("ELASTICDL_MASTER_PATIENCE_SECONDS", "float", 120.0,
        "How long the worker task loop rides out an unreachable master "
        "before letting the failure propagate.")
declare("ELASTICDL_TASK_LEASE_BATCH", "int", 1,
        "Tasks a worker leases per GetTask RPC (results are reported "
        "in matching batches); 1 keeps the classic one-task-per-RPC "
        "protocol. Raising it divides dispatch RPC load at fleet "
        "scale.")

# -- PS wire codec, prefetch overlap and shard recovery (worker/, ps/) --
declare("ELASTICDL_WIRE_DTYPE", "str", "float32",
        "Default PS wire codec when the PSClient isn't given one "
        "explicitly: float32, bfloat16 (bf16 embedding legs), or int8 "
        "(block-quantized dense grads with error feedback + bf16 "
        "embedding legs).")
declare("ELASTICDL_WIRE_BLOCK_SIZE", "int", 256,
        "Block size for the int8 block-scaled gradient codec: one "
        "float32 absmax/127 scale per this many consecutive elements.")
declare("ELASTICDL_PS_MAX_PUSH_BYTES", "int", 64 * 1024 * 1024,
        "Packed gradient pushes larger than this split into chunked "
        "sub-requests, so one giant embedding slice can't stall the "
        "channel. <=0 disables chunking.")
declare("ELASTICDL_PREFETCH_DEPTH", "int", 1,
        "PS-trainer embedding prefetch lookahead: 1 issues the next "
        "batch's pull RPCs while the current step computes (async "
        "pipelined mode only); 0 restores the inline blocking prefetch.")
declare("ELASTICDL_PREFETCH_CACHE_ROWS", "int", 1 << 22,
        "Max cached embedding rows per table in the worker's versioned "
        "row cache (the table flushes whole when exceeded and re-fills "
        "on the following misses). 0 disables the cache.")
declare("ELASTICDL_PREFETCH_CACHE_DENSE_IDS", "int", 1 << 24,
        "Upper bound on embedding ids the worker row cache will index "
        "(its id->slot index is a dense int32 array of this size at "
        "most, ~64 MB at the cap). A table with larger ids stops "
        "caching and pulls every prefetch from the PS.")
declare("ELASTICDL_PREFETCH_CACHE_STALENESS", "int", 8,
        "Staleness budget of the worker row cache, in PS model "
        "versions: a cached row only hits while it was filled within "
        "this many versions of the newest version the worker has seen "
        "— the bounded-staleness contract async SGD already absorbs. "
        "Negative disables the version check (never invalidate).")
declare("ELASTICDL_PS_DEGRADED_BLOCK_SECONDS", "float", 20.0,
        "Budget for _sync_model's re-seed/backoff loop on a degraded PS "
        "shard before failing the minibatch up the retry ladder.")

# -- observability setup, telemetry plane and flight recorder (observability/) --
declare("ELASTICDL_ROLE", "str", "",
        "This process's role stamp (master, ps-0, worker-3, ...); chaos "
        "rules target processes by it.")
declare("ELASTICDL_JOB_NAME", "str", "",
        "Job name stamped into JSON log records and event logs; set by "
        "the master for every spawned instance.")
declare("ELASTICDL_LOG_LEVEL", "str", "",
        "Package log level: DEBUG/INFO/WARNING/ERROR or a number; "
        "default INFO. The k8s master forwards it to its pods.")
declare("ELASTICDL_OBS_DIR", "str", "",
        "Directory for traces, the event log, and endpoint "
        "advertisements; the master seeds it into every child process.")
declare("ELASTICDL_METRICS_PORT", "int", 0,
        "Port for the /metrics exporter; 0 binds an ephemeral port, "
        "negative disables the endpoint.")
declare("ELASTICDL_METRICS_HOST", "str", "",
        "Bind address for the /metrics exporter (default 0.0.0.0); also "
        "the advertised scrape host when it names a real interface.")
declare("ELASTICDL_AGGREGATOR_INTERVAL", "float", 2.0,
        "Master telemetry aggregator scrape period in seconds.")
declare("ELASTICDL_ENDPOINT_STALE_SCRAPES", "int", 5,
        "Consecutive scrape failures after which the master's "
        "aggregator stops scraping an advertised endpoint (counted in "
        "edl_job_endpoints_stale; a rewritten advertisement resets it).")
declare("ELASTICDL_ALERT_STRAGGLER_SKEW", "float", 2.0,
        "Straggler alert threshold: worker EWMA step latency over fleet "
        "median.")
declare("ELASTICDL_ALERT_PS_SKEW", "float", 3.0,
        "PS load alert threshold: hottest shard byte rate over the mean "
        "byte rate.")
declare("ELASTICDL_ALERT_STALL_SECONDS", "float", 60.0,
        "Stall alert: records_done frozen this long with tasks in "
        "flight.")
declare("ELASTICDL_ALERT_ABANDONED", "float", 1.0,
        "Abandoned-task count threshold for the abandonment alert.")
declare("ELASTICDL_ALERT_STARVE_SHARE", "float", 0.25,
        "Input-starvation alert threshold: fraction of a worker's wall "
        "time spent with the step blocked on an empty feed queue "
        "(datapath `starve` stage rate).")
declare("ELASTICDL_FLIGHTREC", "str", "auto",
        "Crash-dump flight recorder: 0/false/off disables; anything "
        "else arms it wherever observability.setup() runs (and in "
        "bench runs).")
declare("ELASTICDL_FLIGHTREC_CAPACITY", "int", 256,
        "Ring capacity: how many recent spans the flight recorder "
        "keeps in memory per process.")
declare("ELASTICDL_FLIGHTREC_DIR", "str", "",
        "Directory for flightrec-<role>.json dumps; empty falls back "
        "to ELASTICDL_OBS_DIR, then the working directory.")

# -- master heartbeat (common/heartbeat.py) --
declare("ELASTICDL_HEARTBEAT_DIR", "str",
        os.path.join(tempfile.gettempdir(), "elasticdl_heartbeats"),
        "Directory where each master writes its <job>-<pid>.json "
        "heartbeat (pid, pgid, ts); tools/reap_orphans.py kills process "
        "groups whose heartbeat went stale. Empty disables the heartbeat. "
        "The default lies in the temporary directory (TMPDIR), which is "
        "the JAX package's /tmp where TMPDIR is unset.")
declare("ELASTICDL_HEARTBEAT_SECONDS", "float", 10.0,
        "Master heartbeat touch period in seconds; 0 disables.")

# -- policy engine (master/policy.py) --
declare("ELASTICDL_POLICY", "str", "",
        "1/true enables the master's self-healing policy engine (the "
        "control loop that blacklists stragglers, launches speculative "
        "backup tasks, and scales on drain ETA). Unset/0 leaves the "
        "loop off — detection-only, exactly the pre-policy behavior.")
declare("ELASTICDL_POLICY_INTERVAL", "float", 2.0,
        "Policy evaluation period in seconds (each tick reads the "
        "aggregator summary and evaluates every rule once).")
declare("ELASTICDL_POLICY_DRY_RUN", "str", "",
        "1/true makes the policy engine evaluate rules and emit "
        "policy_decision events with outcome=dry_run without actuating "
        "anything — the rehearsal mode for tuning thresholds.")
declare("ELASTICDL_POLICY_HYSTERESIS", "int", 3,
        "Consecutive policy ticks a rule's condition must hold before "
        "it fires (one clean tick resets the counter); the flap guard.")
declare("ELASTICDL_POLICY_COOLDOWN_SECONDS", "float", 30.0,
        "Per-(action, subject) cooldown: after an action applies, the "
        "same action on the same subject is suppressed this long.")
declare("ELASTICDL_POLICY_RATE_LIMIT", "int", 6,
        "Global cap on applied policy actions per 60 s sliding window; "
        "further decisions in the window land as outcome=rate_limited.")
declare("ELASTICDL_POLICY_STRAGGLER_SCORE", "float", 3.0,
        "Straggler-mitigation trigger: a worker whose aggregator "
        "straggler_score (EWMA step latency over fleet median) stays "
        "at or above this for the hysteresis window is blacklisted "
        "and relaunched.")
declare("ELASTICDL_POLICY_BLACKLIST_SECONDS", "float", 60.0,
        "TTL of a dispatcher blacklist entry created by the straggler "
        "rule; expiry re-admits the worker even if its relaunch never "
        "completed (self-healing default).")
declare("ELASTICDL_POLICY_MAX_BACKUPS", "int", 2,
        "Upper bound on speculative backup task copies in flight at "
        "once; 0 disables the backup-task rule.")
declare("ELASTICDL_POLICY_BACKUP_FACTOR", "float", 3.0,
        "Backup-task trigger: an in-flight training task whose elapsed "
        "time exceeds this multiple of the recent mean task duration "
        "gets a speculative second copy on a healthy worker.")
declare("ELASTICDL_POLICY_SCALE_STEP", "int", 1,
        "How many workers one drain-ETA scaling decision adds or "
        "retires (the k in ±k).")
declare("ELASTICDL_POLICY_MAX_WORKERS", "int", 0,
        "Ceiling for policy-driven scale-up; 0 defaults to twice the "
        "job's initial worker count.")
declare("ELASTICDL_JOB_DEADLINE_SECONDS", "float", 0.0,
        "Soft job deadline for the drain-ETA scaling rule: when the "
        "aggregator's task-drain ETA overshoots the time remaining, "
        "the policy engine asks the instance manager for more workers "
        "(and retires them when far ahead). 0 disables the rule.")

# -- master write-ahead journal (master/journal.py) --
declare("ELASTICDL_MASTER_JOURNAL_DIR", "str", "",
        "Directory for the master write-ahead journal + snapshots. Empty "
        "disables journaling (state is process-local, as before the "
        "survivable control plane).")
declare("ELASTICDL_JOURNAL_SNAPSHOT_EVERY", "int", 512,
        "Compact the master journal into a fresh snapshot after this many "
        "appended ops (bounds replay time and WAL growth).")

# -- RPC plane (common/rpc.py) --
declare("ELASTICDL_RPC_DEADLINES", "str", "",
        "JSON {method: seconds} per-method deadline overrides.")
declare("ELASTICDL_RPC_MAX_ATTEMPTS", "int", 0,
        "Override max retry attempts for all methods; 0/unset keeps the "
        "per-method matrix.")
declare("ELASTICDL_RPC_BACKOFF_BASE", "float", 0.0,
        "Override retry backoff base seconds for all methods; 0/unset "
        "keeps the matrix.")
declare("ELASTICDL_RPC_BACKOFF_MAX", "float", 0.0,
        "Override retry backoff cap seconds for all methods; 0/unset "
        "keeps the matrix.")
declare("ELASTICDL_RPC_BREAKER_THRESHOLD", "int", 8,
        "Consecutive connectivity failures that trip a peer's circuit "
        "breaker; <=0 disables the breaker.")
declare("ELASTICDL_RPC_BREAKER_COOLDOWN", "float", 5.0,
        "Seconds an open breaker waits before a half-open probe.")
declare("ELASTICDL_RPC_READY_TIMEOUT", "float", 30.0,
        "Channel-readiness TCP probe budget in seconds; 0 disables the "
        "ready-wait.")

# -- push telemetry (observability/push.py) --
declare("ELASTICDL_TELEMETRY_PUSH_INTERVAL", "float", 2.0,
        "Seconds between push-telemetry reports from the worker and PS "
        "processes to the master's ReportTelemetry RPC (default 2, the "
        "aggregator's own interval, so pushed roles stay fresh and the "
        "pull loop skips them); 0 disables pushing and leaves the master's "
        "pull scrape as the only path. The JAX package defaults to 0.")
declare("ELASTICDL_TELEMETRY_PUSH_JITTER", "float", 0.2,
        "Fractional jitter applied to each push interval so a fleet of "
        "reporters does not dogpile the master in lockstep.")
declare("ELASTICDL_TELEMETRY_FULL_EVERY", "int", 16,
        "Every Nth telemetry push is a full snapshot instead of a delta "
        "(bounded resync horizon after a lost/reordered push); 0 sends "
        "a full snapshot only when the master asks (need_full).")

# -- process entry points (worker/main.py) --
declare("ELASTICDL_TORCH_DEVICE", "str", "",
        "The device a worker process trains on: unset means the CUDA "
        "device (and a host without one makes the worker exit with an "
        "error); 'cpu' trains on the CPU, as the tests ask. Set in the "
        "master's environment, it reaches every worker it spawns.")

# -- elastic AllReduce (worker/allreduce_trainer.py) --
declare("ELASTICDL_JOIN_GATE_SECONDS", "float", 0.0,
        "Join-gate wait budget at an elastic regroup; 0 (default) "
        "auto-derives the budget (the port: 90 s, having no compile "
        "tracker to scale it by).")
declare("ELASTICDL_POLICY_HINT_POLL_SECONDS", "float", 2.0,
        "How often an AllReduce worker polls the master's world-hint RPC; "
        "0 disables polling. The port records the announced world (it has "
        "no AOT speculator to hand it to).")
declare("ELASTICDL_LOCAL_DEVICES", "int", 0,
        "Shards per AllReduce worker process (parallel/mesh.py): the "
        "CUDA devices torch sees unless this says more; shard i runs on "
        "cuda:(i mod count), so on one card the shards share it. The "
        "counterpart of the XLA flag that gives the JAX tests 8 host "
        "devices.")

# -- chaos (chaos/injection.py) --
declare("ELASTICDL_CHAOS", "str", "",
        "JSON fault schedule injected into the rpc plane; set by drills, "
        "absent in production.")
