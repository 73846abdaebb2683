"""Streaming evaluation metrics, framework-free (counterpart of
elasticdl_tpu/common/evaluation_utils.py:MeanMetric)."""

import numpy as np


class MeanMetric:
    """Averages fn(outputs, labels) per-example values across updates."""

    def __init__(self, fn):
        self._fn = fn
        self._total = 0.0
        self._count = 0

    def update(self, outputs, labels):
        values = np.asarray(self._fn(outputs, labels), dtype=np.float64)
        self._total += float(values.sum())
        self._count += int(values.size)

    def result(self):
        return self._total / max(self._count, 1)

    def reset(self):
        self._total, self._count = 0.0, 0
