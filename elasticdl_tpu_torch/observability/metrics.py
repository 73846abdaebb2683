"""Process-local metrics registry with Prometheus text exposition
(counterpart of elasticdl_tpu/observability/metrics.py).

Counter / Gauge / Histogram over plain dicts and one lock per metric —
enough for control-plane rates (RPCs, tasks, bytes) without pulling in
prometheus_client. The exposition format is the plain-text v0.0.4 format
every Prometheus scraper speaks:

    # HELP edl_tasks_dispatched_total Tasks handed to workers
    # TYPE edl_tasks_dispatched_total counter
    edl_tasks_dispatched_total{type="TRAINING"} 42

Naming scheme (the JAX package's docs/OBSERVABILITY.md): every metric starts with `edl_`,
counters end in `_total`, durations are `_seconds`, sizes `_bytes`.
Histograms keep BOUNDED state: fixed buckets plus a bounded reservoir so
`quantile()` can answer p50/p99 without unbounded sample growth.
"""

import random
import threading

# Latency-shaped default: 1ms .. ~100s, roughly x4 per step.
DEFAULT_BUCKETS = (
    0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 16.0, 64.0,
)

_RESERVOIR_SIZE = 512


class Reservoir:
    """Bounded Algorithm-R sample reservoir with index-based quantiles.
    NOT thread-safe on its own — holders guard it with their own lock
    (one estimator shared by the Histogram metric and common/timing.py,
    so p50/p99 agree between /metrics and the DEBUG timing reports)."""

    def __init__(self, size, seed=0x5EED):
        self.size = size
        self._samples = []
        self._seen = 0
        self._rng = random.Random(seed)

    def add(self, value):
        self._seen += 1
        if len(self._samples) < self.size:
            self._samples.append(value)
        else:
            j = self._rng.randrange(self._seen)
            if j < self.size:
                self._samples[j] = value

    def snapshot(self):
        return list(self._samples)

    @staticmethod
    def quantile_of(ordered, q):
        """Index-based quantile of a pre-sorted sample list."""
        if not ordered:
            return None
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    def quantile(self, q):
        return self.quantile_of(sorted(self._samples), q)


def _format_value(v):
    if v == int(v):
        return str(int(v))
    return repr(float(v))


def _format_labels(labelnames, labelvalues):
    if not labelnames:
        return ""
    parts = []
    for name, value in zip(labelnames, labelvalues):
        value = (
            str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )
        parts.append(f'{name}="{value}"')
    return "{" + ",".join(parts) + "}"


class _Child:
    """One labeled time series of a metric."""

    def __init__(self, parent, labelvalues):
        self._parent = parent
        self._labelvalues = labelvalues
        self._lock = threading.Lock()
        self._value = 0.0
        if parent.type == "histogram":
            self._bucket_counts = [0] * len(parent.buckets)
            self._count = 0
            self._sum = 0.0
            self._reservoir = Reservoir(_RESERVOIR_SIZE)

    # -- counter / gauge --

    def inc(self, amount=1):
        if self._parent.type == "counter" and amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        if self._parent.type != "gauge":
            raise ValueError("only gauges can decrease")
        with self._lock:
            self._value -= amount

    def set(self, value):
        if self._parent.type != "gauge":
            raise ValueError("only gauges can be set")
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value

    # -- histogram --

    def observe(self, value):
        if self._parent.type != "histogram":
            raise ValueError("observe() is histogram-only")
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            # Per-bucket counts; exposition cumulates them (le semantics).
            for i, bound in enumerate(self._parent.buckets):
                if value <= bound:
                    self._bucket_counts[i] += 1
                    break
            self._reservoir.add(value)

    def quantile(self, q):
        """Reservoir-estimated quantile in [0, 1]; None when empty."""
        with self._lock:
            return self._reservoir.quantile(q)

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def _expose(self, lines):
        name = self._parent.name
        labelnames = self._parent.labelnames
        if self._parent.type == "histogram":
            with self._lock:
                bucket_counts = list(self._bucket_counts)
                count, total = self._count, self._sum
            cumulative = 0
            for bound, n in zip(self._parent.buckets, bucket_counts):
                cumulative += n
                labels = _format_labels(
                    labelnames + ("le",),
                    self._labelvalues + (_format_value(bound),),
                )
                lines.append(f"{name}_bucket{labels} {cumulative}")
            labels = _format_labels(
                labelnames + ("le",), self._labelvalues + ("+Inf",)
            )
            lines.append(f"{name}_bucket{labels} {count}")
            labels = _format_labels(labelnames, self._labelvalues)
            lines.append(f"{name}_sum{labels} {_format_value(total)}")
            lines.append(f"{name}_count{labels} {count}")
        else:
            labels = _format_labels(labelnames, self._labelvalues)
            lines.append(f"{name}{labels} {_format_value(self.value)}")


class Metric:
    """A named metric family; with labelnames it fans out via labels()."""

    def __init__(self, name, help, type, labelnames=(), buckets=None):
        self.name = name
        self.help = help
        self.type = type
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._children = {}
        self._default = None if self.labelnames else _Child(self, ())

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            if labelvalues:
                raise ValueError("pass labels positionally OR by name")
            labelvalues = tuple(
                labelkw[name] for name in self.labelnames
            )
        labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}"
            )
        with self._lock:
            child = self._children.get(labelvalues)
            if child is None:
                child = _Child(self, labelvalues)
                self._children[labelvalues] = child
            return child

    def __getattr__(self, item):
        # Unlabeled metrics act as their own single child (counter.inc()).
        default = self.__dict__.get("_default")
        if default is not None and item in (
            "inc", "dec", "set", "observe", "quantile",
            "value", "count", "sum",
        ):
            return getattr(default, item)
        raise AttributeError(item)

    def expose(self, lines):
        lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.type}")
        if self._default is not None:
            self._default._expose(lines)
            return
        with self._lock:
            children = sorted(self._children.items())
        for _, child in children:
            child._expose(lines)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, name, help, type, labelnames, buckets=None):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is not None:
                if metric.type != type or metric.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type/labels"
                    )
                return metric
            metric = Metric(name, help, type, labelnames, buckets)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(
            name, help, "histogram", labelnames, buckets
        )

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def expose(self):
        """The full registry in Prometheus text-exposition format."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for _, metric in metrics:
            metric.expose(lines)
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()


def default_registry():
    """The process-global registry every component records into."""
    return _default
