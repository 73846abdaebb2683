"""Synthetic data (counterpart of elasticdl_tpu/data/gen/synthetic.py:
synthetic_classification_arrays and synthetic_lm_tokens; same numpy draws,
so both packages see identical data for a seed)."""

import numpy as np


def synthetic_classification_arrays(
    num_examples,
    image_shape=(28, 28),
    num_classes=10,
    noise=0.3,
    seed=0,
):
    """Per-class random template + gaussian noise: separable enough that a
    small model's loss visibly drops within a few steps."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(num_classes,) + image_shape).astype(
        np.float32
    )
    labels = rng.integers(0, num_classes, num_examples)
    images = templates[labels] + noise * rng.normal(
        size=(num_examples,) + image_shape
    ).astype(np.float32)
    return images.astype(np.float32), labels.astype(np.int64)


def synthetic_lm_tokens(
    num_sequences, seq_len, vocab=256, branching=4, seed=0
):
    """Order-1 Markov sequences where each token has `branching` equally
    likely successors: a trained LM's token CE floor is log(branching),
    well below the log(vocab) of random guessing."""
    rng = np.random.default_rng(seed)
    successors = rng.integers(0, vocab, size=(vocab, branching))
    seqs = np.empty((num_sequences, seq_len + 1), np.int32)
    state = rng.integers(0, vocab, num_sequences)
    for t in range(seq_len + 1):
        seqs[:, t] = state
        choice = rng.integers(0, branching, num_sequences)
        state = successors[state, choice]
    return seqs
