"""Synthetic LM data (counterpart of
elasticdl_tpu/data/gen/synthetic.py:synthetic_lm_tokens; same numpy draws,
so both packages see identical sequences for a seed)."""

import numpy as np


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
