"""Batch padding and the world fingerprint of data-parallel worlds
(counterpart of elasticdl_tpu/parallel/mesh.py, its data-parallel part).

In the port a process holds one device and data parallelism runs across
processes: one rank per process, the gradients all-reduced over the
epoch's process group. A world of N ranks is the JAX package's pure
data-parallel world of N one-device processes, and `world_fingerprint`
names it as the JAX `WorldSpec.fingerprint()` does. The JAX resolver's
model, seq, stage and zero axes are ROADMAP Queue 1 item 4 (Slice 6); the
trainer rejects their options before a world is formed.
"""

import numpy as np

DATA_AXIS = "data"


def _tree_map(fn, batch):
    """fn over the arrays of a batch: an array, or a dict, list or tuple of
    them (the CTR models' features are dicts)."""
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


def _first_leaf(batch):
    if isinstance(batch, dict):
        return next((leaf for leaf in map(_first_leaf, batch.values())
                     if leaf is not None), None)
    if isinstance(batch, (list, tuple)):
        return next((leaf for leaf in map(_first_leaf, batch)
                     if leaf is not None), None)
    return batch


def pad_batch_to_multiple(batch, multiple):
    """Pad a numpy batch's leading dim up to a multiple by cyclic
    repetition. Returns (padded_batch, real_n)."""
    leaf = _first_leaf(batch)
    if leaf is None:
        return batch, 0
    real_n = np.shape(leaf)[0]
    padded_n = -(-real_n // multiple) * multiple
    if padded_n == real_n:
        return batch, real_n
    idx = np.arange(padded_n) % real_n
    padded = _tree_map(lambda x: np.take(np.asarray(x), idx, axis=0), batch)
    return padded, real_n


def world_fingerprint(world_size):
    """The fingerprint of a data-parallel world of `world_size` one-device
    processes. The process count is part of it: a one-process world takes
    its loss over the real rows, a multi-process one over the padded
    batch, so the two compute different steps."""
    n = max(1, int(world_size))
    return f"{DATA_AXIS}={n}" + (f"|p{n}" if n > 1 else "")
