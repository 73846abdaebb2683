"""Pieces the image and tabular zoo models share (the JAX package writes
them inline in each model module): the dense tower, the two losses, the
logit accuracy of the binary classifiers, and the image feed.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.evaluation_utils import MeanMetric
from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.example import batch_examples


def add_dense_layers(model, in_features, widths):
    """nn.Linear layers Dense_0, Dense_1, ... directly in `model`, as a
    flax compact module names the nn.Dense layers it declares inline."""
    for i, width in enumerate(widths):
        model.add_module(f"Dense_{i}", nn.Linear(in_features, width))
        in_features = width


def dense_tower(model, x, n):
    """x through Dense_0 .. Dense_{n-1} of `model`, relu between them."""
    for i in range(n):
        x = getattr(model, f"Dense_{i}")(x)
        if i < n - 1:
            x = F.relu(x)
    return x


def softmax_cross_entropy(labels, logits):
    """Mean softmax cross-entropy with integer labels (optax's
    softmax_cross_entropy_with_integer_labels), in float32 or wider."""
    labels = torch.as_tensor(labels, device=logits.device)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.cross_entropy(logits, labels.reshape(-1).long())


def sigmoid_cross_entropy(labels, logits):
    """Mean sigmoid binary cross-entropy (optax's, in its stable form)."""
    labels = torch.as_tensor(labels, device=logits.device)
    return F.binary_cross_entropy_with_logits(
        logits.reshape(-1), labels.reshape(-1).to(logits.dtype))


def logit_accuracy():
    """Accuracy of a binary classifier's logits: positive means class 1."""
    def correct(outputs, labels):
        preds = (np.asarray(outputs).reshape(-1) > 0).astype(np.float32)
        return (preds == np.asarray(labels).reshape(-1)).astype(np.float32)

    return MeanMetric(correct)


def image_feed(records, mode):
    """{"image", "label"} records -> (float32 images, labels). uint8 images
    (the IDX and pickle converters' raw bytes) are scaled by 1/255;
    synthetic float images are already unit-scale."""
    batch = batch_examples(records)
    image = batch["image"]
    features = image.astype("float32")
    if image.dtype == "uint8":
        features = features / 255.0
    labels = batch["label"] if mode != Modes.PREDICTION else None
    return features, labels
