"""The preprocessing transforms (counterpart of
elasticdl_tpu/preprocessing/layers.py:22-317), as dense or padded-dense
functions.

Variable-length features travel as padded dense arrays with a mask
(PaddedFeature, to_padded), and every transform maps the values and keeps
the mask. Each class computes on numpy arrays what the JAX package's
computes on them, so a `feed` gives both packages the same features and
ids. Where the JAX class also runs on device arrays (RoundIdentity,
LogRound, Hashing, Discretization, Normalizer, ConcatenateWithOffset), the
port's takes a torch tensor and computes there; string transforms (ToNumber,
IndexLookup, Hashing of strings) run on the host only. SparseEmbedding is
an nn.Module over padded ids with a masked combiner.

Hashing of integers is murmur3's fmix32 in unsigned 32-bit arithmetic. The
port has no usable uint32 on CUDA, so a tensor computes it in int64 on the
low 32 bits (`mul_u32` keeps every product below 2**49).
"""

import dataclasses
import hashlib

import numpy as np
import torch
from torch import nn

_U32 = 0xFFFFFFFF


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


def mul_u32(x, c):
    """(x * c) mod 2**32 for an int64 tensor x in [0, 2**32) and a constant
    c < 2**32, without leaving int64: c splits into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 0x10000) & _U32


@dataclasses.dataclass
class PaddedFeature:
    """Padded-dense stand-in for sparse or ragged inputs: `values` [batch,
    max_len] and boolean `mask` [batch, max_len] (True = real element)."""

    values: object
    mask: object


def to_padded(list_of_lists, max_len=None, pad_value=0, dtype=np.int64):
    """Variable-length rows -> PaddedFeature with a static [batch, max_len]
    shape (rows longer than max_len are cut)."""
    if max_len is None:
        max_len = max((len(r) for r in list_of_lists), default=0) or 1
    n = len(list_of_lists)
    values = np.full((n, max_len), pad_value, dtype=dtype)
    mask = np.zeros((n, max_len), dtype=bool)
    for i, row in enumerate(list_of_lists):
        row = list(row)[:max_len]
        values[i, : len(row)] = row
        mask[i, : len(row)] = True
    return PaddedFeature(values=values, mask=mask)


def _map_values(fn, inputs):
    if isinstance(inputs, PaddedFeature):
        return PaddedFeature(values=fn(inputs.values), mask=inputs.mask)
    return fn(inputs)


class ToNumber:
    """Strings/bytes -> numbers; unparsable entries take default_value.
    Host-side only."""

    def __init__(self, out_type=np.float32, default_value=0):
        self.out_type = out_type
        self.default_value = default_value

    def __call__(self, inputs):
        def convert(arr):
            flat = []
            for x in np.asarray(arr).reshape(-1):
                if isinstance(x, bytes):
                    x = x.decode("utf-8", "ignore")
                try:
                    flat.append(self.out_type(x))
                except (TypeError, ValueError):
                    flat.append(self.out_type(self.default_value))
            return np.asarray(flat, self.out_type).reshape(
                np.asarray(arr).shape
            )

        return _map_values(convert, inputs)


class RoundIdentity:
    """round() (half to even) + clip to [0, num_buckets), int64."""

    def __init__(self, num_buckets, default_value=0):
        self.num_buckets = num_buckets
        self.default_value = default_value

    def __call__(self, inputs):
        def fn(x):
            if isinstance(x, torch.Tensor):
                return torch.clamp(torch.round(x), 0,
                                   self.num_buckets - 1).long()
            return np.clip(np.round(x), 0, self.num_buckets - 1).astype(
                np.int64)

        return _map_values(fn, inputs)


class LogRound:
    """round(log_base(x)) clipped to [0, num_bins), int64 (natural log
    without a base)."""

    def __init__(self, num_bins, default_value=0, base=None):
        self.num_bins = num_bins
        self.base = base
        self.default_value = default_value

    def __call__(self, inputs):
        def fn(x):
            if isinstance(x, torch.Tensor):
                logged = torch.log(torch.clamp_min(x, 1e-12))
            else:
                logged = np.log(np.maximum(x, 1e-12))
            if self.base is not None:
                logged = logged / np.log(self.base)
            return RoundIdentity(self.num_bins)(logged)

        return _map_values(fn, inputs)


def _fmix32(z):
    """murmur3's 32-bit finalizer on a uint32 array or on an int64 tensor
    holding uint32 values."""
    c1, c2 = 0x85EBCA6B, 0xC2B2AE35
    if isinstance(z, torch.Tensor):
        z = z ^ (z >> 16)
        z = mul_u32(z, c1)
        z = z ^ (z >> 13)
        z = mul_u32(z, c2)
        return z ^ (z >> 16)
    z = z ^ (z >> np.uint32(16))
    z = z * np.uint32(c1)
    z = z ^ (z >> np.uint32(13))
    z = z * np.uint32(c2)
    return z ^ (z >> np.uint32(16))


class Hashing:
    """Deterministic hash of values into [0, num_bins): strings by a stable
    sha256 prefix, integers by murmur3's fmix32 over the id folded to 32
    bits (hi ^ lo) on the host; a tensor takes its low 32 bits, as a device
    array of the JAX package is 32-bit."""

    def __init__(self, num_bins):
        if num_bins < 1:
            raise ValueError("num_bins must be >= 1")
        self.num_bins = num_bins

    def __call__(self, inputs):
        return _map_values(self._hash, inputs)

    def _hash(self, x):
        if isinstance(x, torch.Tensor):
            return _fmix32(x.long() & _U32) % self.num_bins
        x = np.asarray(x)
        if x.dtype.kind in ("U", "S", "O"):
            flat = np.asarray(
                [_stable_hash64(s) % self.num_bins for s in x.reshape(-1)],
                np.int64,
            )
            return flat.reshape(x.shape)
        wide = x.astype(np.uint64)
        z = ((wide & np.uint64(_U32)) ^ (wide >> np.uint64(32))).astype(
            np.uint32)
        return (_fmix32(z) % np.uint32(self.num_bins)).astype(np.int64)


class Discretization:
    """Bucketize by boundaries: output in [0, len(bins)], int64."""

    def __init__(self, bins):
        self.bins = np.asarray(sorted(bins), np.float64)

    def __call__(self, inputs):
        def fn(x):
            if isinstance(x, torch.Tensor):
                bins = torch.as_tensor(self.bins, dtype=x.dtype,
                                       device=x.device)
                return torch.searchsorted(bins, x.contiguous(), right=True)
            return np.digitize(x, self.bins).astype(np.int64)

        return _map_values(fn, inputs)


class IndexLookup:
    """Vocabulary -> index; an out-of-vocabulary token maps to len(vocab) +
    its stable hash mod num_oov_indices. Host-side (string keys)."""

    def __init__(self, vocabulary, num_oov_indices=1):
        if isinstance(vocabulary, str):
            with open(vocabulary) as f:
                vocabulary = [line.rstrip("\n") for line in f if line.strip()]
        self.vocab = {v: i for i, v in enumerate(vocabulary)}
        self.num_oov_indices = max(1, num_oov_indices)

    def vocab_size(self):
        return len(self.vocab) + self.num_oov_indices

    def __call__(self, inputs):
        def fn(x):
            arr = np.asarray(x)
            oov_base = len(self.vocab)

            def lookup(s):
                if isinstance(s, bytes):
                    s = s.decode("utf-8", "ignore")
                idx = self.vocab.get(s)
                if idx is None:
                    idx = oov_base + (
                        _stable_hash64(s) % self.num_oov_indices
                    )
                return idx

            return np.asarray(
                [lookup(s) for s in arr.reshape(-1)], np.int64
            ).reshape(arr.shape)

        return _map_values(fn, inputs)


class Normalizer:
    """(x - subtractor) / divisor."""

    def __init__(self, subtractor, divisor):
        self.subtractor = float(subtractor)
        self.divisor = float(divisor) or 1.0

    def __call__(self, inputs):
        return _map_values(
            lambda x: (x - self.subtractor) / self.divisor, inputs
        )


class ConcatenateWithOffset:
    """Concatenate id features, each offset so the id spaces don't collide;
    PaddedFeature inputs concatenate values and masks."""

    def __init__(self, offsets, axis=-1):
        self.offsets = list(offsets)
        self.axis = axis

    def __call__(self, inputs):
        if len(self.offsets) != len(inputs):
            raise ValueError(
                f"{len(self.offsets)} offsets != {len(inputs)} inputs"
            )
        first = inputs[0]
        if isinstance(first, PaddedFeature):
            return PaddedFeature(
                values=self._cat([f.values + off for f, off in
                                  zip(inputs, self.offsets)]),
                mask=self._cat([f.mask for f in inputs]))
        return self._cat([x + off for x, off in zip(inputs, self.offsets)])

    def _cat(self, arrays):
        if isinstance(arrays[0], torch.Tensor):
            return torch.cat(arrays, dim=self.axis)
        return np.concatenate(arrays, axis=self.axis)


class SparseEmbedding(nn.Module):
    """Embedding over padded multivalent ids with a masked combiner (sum,
    mean or sqrtn over each row's real ids). The trainable table is the
    parameter `table` [vocab_size, dim], flax's name and layout;
    initialized uniform in [0, 0.05) (`init_flax`)."""

    def __init__(self, vocab_size, dim, combiner="sum"):
        super().__init__()
        self.combiner = combiner
        self.table = nn.Parameter(torch.empty(vocab_size, dim))

    @torch.no_grad()
    def init_flax(self, generator):
        self.table.uniform_(0.0, 0.05, generator=generator)

    def forward(self, feature: PaddedFeature):
        device = self.table.device
        ids = torch.as_tensor(feature.values, device=device).long()
        mask = torch.as_tensor(feature.mask, device=device)
        emb = self.table[ids] * mask[..., None]  # [B, L, D]
        total = emb.sum(dim=-2)
        count = mask.sum(dim=-1, keepdim=True).clamp_min(1)
        if self.combiner == "sum":
            return total
        if self.combiner == "mean":
            return total / count
        if self.combiner == "sqrtn":
            return total / torch.sqrt(count.to(total.dtype))
        raise ValueError(f"unknown combiner {self.combiner!r}")
