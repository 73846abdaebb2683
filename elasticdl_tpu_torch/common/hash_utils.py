"""Stable partitioning of parameters and embedding ids across PS shards
(a copy of elasticdl_tpu/common/hash_utils.py:14-32).

Dense parameters go to shard sha256(name) mod N, embedding ids to id mod N,
so both packages put the same names and ids on the same shard.
"""

import hashlib

import numpy as np


def string_to_id(name: str, num_buckets: int) -> int:
    h = hashlib.sha256(name.encode("utf-8")).hexdigest()
    return int(h, 16) % num_buckets


def scatter_embedding_ids(ids: np.ndarray, num_ps: int):
    """Partition embedding ids by modulo; returns {ps_id: (ids, positions)}.

    `positions` are the indices into the original `ids` array, so pulled rows
    can be scattered back into batch order.
    """
    ids = np.asarray(ids, dtype=np.int64)
    result = {}
    mods = ids % num_ps
    for ps_id in range(num_ps):
        mask = mods == ps_id
        if mask.any():
            result[ps_id] = (ids[mask], np.nonzero(mask)[0])
    return result
