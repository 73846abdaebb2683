"""Slab-backed embedding table with lazy per-id initialization (counterpart
of elasticdl_tpu/ps/embedding_table.py:73-289).

Rows live in ONE contiguous [capacity, dim] float32 slab that doubles on
growth, with the host library's id -> row map beside it (native/idmap.cc).
Rows are assigned in first-seen order, so row i belongs to the i-th distinct
id and a checkpoint page is a contiguous slab slice. Unseen ids are created
on lookup, each row filled from its own seed (table_seed * 0x9E3779B1 + row
+ 1) by the library's bulk initializers: the same ids in the same order give
the JAX package's rows bit for bit.

Slot tables (Adam m/v, momentum velocity, ...) are companion slabs
allocated by the optimizer with the SAME row mapping, so one row-index array
drives the parameter and all its slots.
"""

import ctypes
import threading

import numpy as np

from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.ps.initializers import resolve_native_init

DEFAULT_CAPACITY = 1024


class _IdMap:
    """ctypes wrapper over the library's open-addressing id->row map."""

    def __init__(self, lib, capacity):
        self._lib = lib
        self._handle = lib.edl_idmap_new(capacity)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.edl_idmap_free(self._handle)
            self._handle = None

    def __len__(self):
        return self._lib.edl_idmap_size(self._handle)

    def rows_for_ids(self, ids, create_missing):
        """-> (rows [n] int64, size_after). New rows are exactly
        [size_before, size_after) in first-seen order."""
        rows = np.empty(len(ids), dtype=np.int64)
        size_after = self._lib.edl_idmap_rows_for_ids(
            self._handle, native.i64p(ids), len(ids),
            1 if create_missing else 0, native.i64p(rows),
        )
        return rows, size_after

    def export_ids(self, start, count):
        out = np.empty(count, dtype=np.int64)
        self._lib.edl_idmap_export_ids(
            self._handle, start, count, native.i64p(out)
        )
        return out


class EmbeddingTable:
    def __init__(self, name, dim, initializer="uniform",
                 capacity=DEFAULT_CAPACITY, seed=0):
        self.name = name
        self.dim = int(dim)
        self.initializer = initializer
        self._init = resolve_native_init(initializer)
        self._lib = native.lib()
        self._lock = threading.RLock()
        self._slab = np.zeros((capacity, self.dim), dtype=np.float32)
        self._map = _IdMap(self._lib, capacity)
        self._seed = seed
        # Companion slabs (optimizer slots) registered via create_slot;
        # grown in lockstep with the parameter slab.
        self._slots = {}
        self._slot_init_val = {}

    # ---------- row management ----------

    def __len__(self):
        with self._lock:
            return len(self._map)

    def _grow_locked(self, min_capacity):
        capacity = self._slab.shape[0]
        while capacity < min_capacity:
            capacity *= 2
        grown = np.zeros((capacity, self.dim), dtype=np.float32)
        grown[: self._slab.shape[0]] = self._slab
        self._slab = grown
        for slot_name, slab in self._slots.items():
            g = np.full((capacity, self.dim), self._slot_init_val[slot_name],
                        dtype=np.float32)
            g[: slab.shape[0]] = slab
            self._slots[slot_name] = g

    def _init_rows_locked(self, start, n):
        """Initialize the fresh contiguous rows [start, start+n). Called
        under the lock, after any grow."""
        spec = self._init
        if spec[0] == "zeros":
            return  # grown slab area is already zeroed
        if spec[0] == "constant":
            self._slab[start:start + n] = spec[1]
            return
        slab_p = native.f32p(self._slab)
        if spec[0] == "uniform":
            self._lib.edl_uniform_init_rows(
                slab_p, self.dim, start, n, spec[1], spec[2],
                ctypes.c_uint64(self._seed),
            )
        else:
            self._lib.edl_normal_init_rows(
                slab_p, self.dim, start, n, spec[1], spec[2],
                ctypes.c_uint64(self._seed), 1 if spec[3] else 0,
            )

    def rows_for_ids(self, ids, create_missing=True):
        """id array -> row-index array, lazily materializing unseen ids
        (-1 for an unseen id when not create_missing)."""
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        with self._lock:
            size_before = len(self._map)
            rows, size_after = self._map.rows_for_ids(ids, create_missing)
            n_new = size_after - size_before
            if n_new:
                if size_after > self._slab.shape[0]:
                    self._grow_locked(size_after)
                self._init_rows_locked(size_before, n_new)
            return rows

    # ---------- lookup / assign ----------

    def lookup(self, ids):
        """[k] ids -> [k, dim] values; unseen ids are lazily initialized."""
        with self._lock:
            rows = self.rows_for_ids(ids)
            out = np.empty((len(rows), self.dim), dtype=np.float32)
            self._lib.edl_gather_rows(
                native.f32p(self._slab), native.i64p(rows), len(rows),
                self.dim, native.f32p(out),
            )
            return out

    def assign(self, ids, values):
        values = np.ascontiguousarray(values, dtype=np.float32)
        if values.shape != (len(ids), self.dim):
            raise ValueError(
                f"table {self.name!r}: values {values.shape} for "
                f"{len(ids)} ids of dim {self.dim}"
            )
        with self._lock:
            rows = self.rows_for_ids(ids)
            self._lib.edl_scatter_rows(
                native.f32p(self._slab), native.i64p(rows), len(rows),
                self.dim, native.f32p(values),
            )

    # ---------- optimizer slots ----------

    def create_slot(self, slot_name, init_value=0.0):
        with self._lock:
            if slot_name not in self._slots:
                self._slot_init_val[slot_name] = init_value
                self._slots[slot_name] = np.full(
                    self._slab.shape, init_value, dtype=np.float32
                )
            return self._slots[slot_name]

    @property
    def slab(self):
        return self._slab

    @property
    def lock(self):
        """RLock guarding the slab: callers that hold row indices across a
        kernel call take this so a concurrent grow can't swap the buffer
        out from under the raw pointers."""
        return self._lock

    # ---------- checkpoint export/import ----------

    def export_rows(self, start=0, count=None):
        """(ids, values) for materialized ids in insertion order,
        row-aligned; `start`/`count` page through the table (new ids only
        append, so earlier pages stay stable while paging)."""
        with self._lock:
            n = len(self._map)
            end = n if count is None else min(n, start + count)
            if start >= end:
                return (np.empty(0, np.int64),
                        np.empty((0, self.dim), np.float32))
            ids = self._map.export_ids(start, end - start)
            return ids, self._slab[start:end].copy()