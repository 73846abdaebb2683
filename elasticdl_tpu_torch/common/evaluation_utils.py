"""Streaming evaluation metrics, framework-free (counterpart of
elasticdl_tpu/common/evaluation_utils.py).

Worker-reported raw model outputs + labels accumulate on the master into
small numpy accumulator objects with update(outputs, labels) / result(), so
the master needs no ML framework. The model-zoo contract's eval_metrics_fn
returns {name: metric}, where a metric is either one of these objects or a
plain fn(outputs, labels) -> per-example values (averaged automatically).
"""

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


def accuracy_metric():
    return MeanMetric(
        lambda outputs, labels: (
            np.argmax(outputs, axis=-1) == np.asarray(labels).reshape(-1)
        ).astype(np.float64)
    )


class AUCMetric:
    """Streaming ROC AUC via fixed-threshold confusion buckets (the same
    approach as Keras' AUC metric, 200 thresholds)."""

    def __init__(self, num_thresholds=200):
        self._thresholds = np.linspace(0.0, 1.0, num_thresholds)
        self._tp = np.zeros(num_thresholds)
        self._fp = np.zeros(num_thresholds)
        self._tn = np.zeros(num_thresholds)
        self._fn = np.zeros(num_thresholds)

    def update(self, outputs, labels):
        scores = np.asarray(outputs, dtype=np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1).astype(bool)
        pred_pos = scores[None, :] >= self._thresholds[:, None]
        self._tp += (pred_pos & labels[None, :]).sum(axis=1)
        self._fp += (pred_pos & ~labels[None, :]).sum(axis=1)
        self._fn += (~pred_pos & labels[None, :]).sum(axis=1)
        self._tn += (~pred_pos & ~labels[None, :]).sum(axis=1)

    def result(self):
        tpr = self._tp / np.maximum(self._tp + self._fn, 1e-9)
        fpr = self._fp / np.maximum(self._fp + self._tn, 1e-9)
        # Thresholds ascend -> fpr/tpr descend; integrate with trapezoids.
        return float(np.trapezoid(tpr[::-1], fpr[::-1]))

    def reset(self):
        for acc in (self._tp, self._fp, self._tn, self._fn):
            acc[:] = 0


def as_metric(obj):
    """Normalize a zoo-provided metric (object or callable) to the
    update/result protocol."""
    if hasattr(obj, "update") and hasattr(obj, "result"):
        return obj
    return MeanMetric(obj)


CHUNK_SIZE = 4096


def update_metrics_chunked(metrics, outputs, labels):
    """Feed large eval payloads to metrics in chunks, to bound memory."""
    n = len(labels)
    multi_output = isinstance(outputs, (list, tuple))
    for begin in range(0, n, CHUNK_SIZE):
        sl = slice(begin, min(begin + CHUNK_SIZE, n))
        chunk = [o[sl] for o in outputs] if multi_output else outputs[sl]
        for metric in metrics.values():
            metric.update(chunk, labels[sl])
