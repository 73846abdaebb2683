"""Host-side feature transforms the dac_ctr feed uses, in numpy (counterpart
of elasticdl_tpu/preprocessing/layers.py:22-35, 136-202, 240-253).

Normalizer, Discretization and Hashing on dense arrays, computing what the
JAX package's classes compute on numpy input, so `feed` gives both packages
the same features and ids. The padded-dense inputs (PaddedFeature), the
other transforms and the flax SparseEmbedding are not ported yet.
"""

import hashlib

import numpy as np


def _stable_hash64(s) -> int:
    """Process-independent 64-bit hash of a string/bytes token (Python's
    builtin hash() is randomized per process)."""
    if isinstance(s, bytes):
        s = s.decode("utf-8", "ignore")
    elif not isinstance(s, str):
        s = str(s)
    return int.from_bytes(
        hashlib.sha256(s.encode("utf-8")).digest()[:8], "little"
    )


class Hashing:
    """Deterministic hash of values into [0, num_bins): strings by a stable
    sha256 prefix, integers by murmur3's fmix32 over the id folded to 32
    bits (hi ^ lo)."""

    def __init__(self, num_bins):
        if num_bins < 1:
            raise ValueError("num_bins must be >= 1")
        self.num_bins = num_bins

    def __call__(self, x):
        x = np.asarray(x)
        if x.dtype.kind in ("U", "S", "O"):
            flat = np.asarray(
                [_stable_hash64(s) % self.num_bins for s in x.reshape(-1)],
                np.int64,
            )
            return flat.reshape(x.shape)
        wide = x.astype(np.uint64)
        z = ((wide & np.uint64(0xFFFFFFFF)) ^ (wide >> np.uint64(32))).astype(
            np.uint32)
        c1, c2 = np.uint32(0x85EBCA6B), np.uint32(0xC2B2AE35)
        z = z ^ (z >> np.uint32(16))
        z = z * c1
        z = z ^ (z >> np.uint32(13))
        z = z * c2
        z = z ^ (z >> np.uint32(16))
        return (z % np.uint32(self.num_bins)).astype(np.int64)


class Discretization:
    """Bucketize by boundaries: output in [0, len(bins)]."""

    def __init__(self, bins):
        self.bins = np.asarray(sorted(bins), np.float64)

    def __call__(self, x):
        return np.digitize(x, self.bins).astype(np.int64)


class Normalizer:
    """(x - subtractor) / divisor."""

    def __init__(self, subtractor, divisor):
        self.subtractor = float(subtractor)
        self.divisor = float(divisor) or 1.0

    def __call__(self, x):
        return (x - self.subtractor) / self.divisor
