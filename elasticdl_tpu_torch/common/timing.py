"""Phase timing accumulators for the worker hot path (counterpart of
elasticdl_tpu/common/timing.py).

A context-manager API so a phase can't be left open, with per-phase call
counts, means, min/max and bounded-reservoir percentiles (p50/p99): what a
step-time breakdown needs.

A Timing can mirror every sample into a labeled observability Histogram
(`bind_histogram`), which is how the per-phase totals reach the metrics
registry without a second instrumentation pass.
"""

import contextlib
import threading
import time

from elasticdl_tpu_torch.observability.metrics import Reservoir

# Bounded per-phase sample reservoir for percentile estimation.
RESERVOIR_SIZE = 256


class _Phase:
    __slots__ = ("total", "count", "min", "max", "reservoir")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = 0.0
        self.reservoir = Reservoir(RESERVOIR_SIZE)


class Timing:
    """Accumulates wall-clock per named phase. Thread-safe; one instance is
    typically owned by a trainer and reported per task or per N steps."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._phases = {}
        self._histogram = None

    def bind_histogram(self, histogram):
        """Mirror every sample into a metrics.Histogram labeled by phase
        (e.g. default_registry().histogram("edl_phase_seconds",
        labelnames=("phase",)))."""
        self._histogram = histogram
        return self

    @contextlib.contextmanager
    def record(self, phase):
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(phase, time.perf_counter() - start)

    def add(self, phase, seconds):
        """Fold in an externally-measured duration (e.g. from a jitted
        step whose completion is observed asynchronously)."""
        if not self.enabled:
            return
        with self._lock:
            p = self._phases.get(phase)
            if p is None:
                p = self._phases[phase] = _Phase()
            p.total += seconds
            p.count += 1
            p.min = min(p.min, seconds)
            p.max = max(p.max, seconds)
            p.reservoir.add(seconds)
        if self._histogram is not None:
            self._histogram.labels(phase=phase).observe(seconds)

    def summary(self):
        """{phase: {"total_s", "count", "mean_s", "min_s", "max_s",
        "p50_s", "p99_s"}}; percentiles are reservoir estimates over up to
        RESERVOIR_SIZE samples."""
        with self._lock:
            out = {}
            for phase, p in self._phases.items():
                ordered = sorted(p.reservoir.snapshot())
                out[phase] = {
                    "total_s": p.total,
                    "count": p.count,
                    "mean_s": p.total / max(p.count, 1),
                    "min_s": p.min,
                    "max_s": p.max,
                    "p50_s": Reservoir.quantile_of(ordered, 0.50),
                    "p99_s": Reservoir.quantile_of(ordered, 0.99),
                }
            return out

    def reset(self):
        with self._lock:
            self._phases.clear()

    def report(self, logger, reset=False):
        """DEBUG-log the per-phase breakdown."""
        for phase, s in sorted(self.summary().items()):
            logger.debug(
                "%s: %.6gs total / %d calls / %.6gs mean / "
                "%.6gs p50 / %.6gs p99",
                phase,
                s["total_s"],
                s["count"],
                s["mean_s"],
                s["p50_s"],
                s["p99_s"],
            )
        if reset:
            self.reset()
