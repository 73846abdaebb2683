"""Master-side metrics publishing: structured JSONL + TensorBoard events
(counterpart of elasticdl_tpu/master/metrics_service.py).

A framework-neutral JSONL stream is the source of truth (greppable, no
reader dependency), with TensorBoard event files written alongside when a
SummaryWriter implementation is importable (torch.utils.tensorboard, which
needs the tensorboard package). `tensorboard --logdir` at the job's metrics
directory shows them.
"""

import json
import os
import threading
import time

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("master.metrics_service")


def _make_summary_writer(log_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:
        logger.info(
            "No TensorBoard SummaryWriter available; writing JSONL only"
        )
        return None


class MetricsService:
    """Append-only scalar metrics sink.

    Layout under `metrics_dir`:
      metrics.jsonl             one {"ts", "group", "step", <name>: value}
                                object per line
      events.out.tfevents.*     TensorBoard scalars (tag "<group>/<name>"),
                                when a writer is available
    """

    def __init__(self, metrics_dir, tensorboard=True):
        self._dir = metrics_dir
        os.makedirs(metrics_dir, exist_ok=True)
        self._path = os.path.join(metrics_dir, "metrics.jsonl")
        self._lock = threading.Lock()
        self._tb = _make_summary_writer(metrics_dir) if tensorboard else None

    def log_scalars(self, group, step, scalars):
        """scalars: {name: number}; step: model version / global step."""
        clean = {}
        for k, v in scalars.items():
            # A user metric named like a metadata field must not clobber
            # the record's ts/group/step.
            key = f"metric_{k}" if k in ("ts", "group", "step") else k
            clean[key] = float(v)
        line = json.dumps(
            {"ts": time.time(), "group": group, "step": int(step), **clean}
        )
        with self._lock:
            with open(self._path, "a") as f:
                f.write(line + "\n")
            if self._tb is not None:
                for name, value in clean.items():
                    self._tb.add_scalar(f"{group}/{name}", value, int(step))
                self._tb.flush()

    def on_evaluation_results(self, model_version, results):
        """EvaluationService.on_results hook."""
        self.log_scalars("eval", model_version, results)

    def close(self):
        if self._tb is not None:
            self._tb.close()
