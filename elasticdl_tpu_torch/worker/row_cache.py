"""Versioned per-table embedding-row cache for the PS trainer's prefetch
(counterpart of elasticdl_tpu/worker/row_cache.py:67-257).

The cache keeps recently pulled rows per table, stamped with the PS model
version at fill time, and serves a hit only while the row is younger than
the staleness budget (ELASTICDL_PREFETCH_CACHE_STALENESS versions): the
same bounded staleness async SGD and the pipelined push already impose. The
version advancing past the budget invalidates by construction.

Layout per table: a DENSE id -> slot index (int32, sized to the largest id
seen, capped by ELASTICDL_PREFETCH_CACHE_DENSE_IDS) over a growable row slab
plus per-slot fill versions, so every operation is one vectorized gather or
scatter. A table whose ids exceed the cap stops caching. Crossing
ELASTICDL_PREFETCH_CACHE_ROWS flushes the table (rows re-fill on the
following misses). Rows keep the dtype they were pulled in (float32, or the
bfloat16 wire's uint16 bit patterns).

Hit rates export as edl_prefetch_row_cache_{hits,misses}_total counters plus
the edl_prefetch_row_cache_hit_ratio gauge (cumulative).
"""

import threading

import numpy as np

from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("worker.row_cache")

_REG = default_registry()
_HITS = _REG.counter(
    "edl_prefetch_row_cache_hits_total",
    "Embedding prefetch ids served from the worker row cache",
    labelnames=("table",),
)
_MISSES = _REG.counter(
    "edl_prefetch_row_cache_misses_total",
    "Embedding prefetch ids that needed a PS pull",
    labelnames=("table",),
)
_HIT_RATIO = _REG.gauge(
    "edl_prefetch_row_cache_hit_ratio",
    "Cumulative hit ratio of the worker embedding row cache",
)


class _TableSlab:
    __slots__ = ("idx", "rows", "fill_versions", "used")

    def __init__(self, id_space, dim, dtype, capacity=65536):
        self.idx = np.full(id_space, -1, dtype=np.int32)
        self.rows = np.empty((capacity, dim), dtype=dtype)
        self.fill_versions = np.empty(capacity, dtype=np.int64)
        self.used = 0


class EmbeddingRowCache:
    def __init__(self, max_rows=None, staleness=None, dense_ids=None):
        self._max_rows = (
            knobs.get_int("ELASTICDL_PREFETCH_CACHE_ROWS")
            if max_rows is None
            else max_rows
        )
        self._staleness = (
            knobs.get_int("ELASTICDL_PREFETCH_CACHE_STALENESS")
            if staleness is None
            else staleness
        )
        self._dense_ids = (
            knobs.get_int("ELASTICDL_PREFETCH_CACHE_DENSE_IDS")
            if dense_ids is None
            else dense_ids
        )
        self._lock = threading.Lock()
        self._tables = {}
        self._disabled = set()  # tables whose ids exceed the index cap
        self._version = 0
        self._hits = 0
        self._lookups = 0

    def note_version(self, version):
        """Record the newest PS model version this worker observed (pull
        or push response). Monotonic; rows older than
        ``version - staleness`` stop hitting from here on."""
        version = int(version)
        with self._lock:
            if version > self._version:
                self._version = version

    def lookup(self, table, ids):
        """Unique ids [k] -> (hit mask [k], rows [nhit, dim] | None).

        A hit requires the id to be cached AND filled within the
        staleness budget of the current version. Returns rows as a
        gathered COPY in id order (callers scatter them into the batch
        layout)."""
        k = int(len(ids))
        with self._lock:
            entry = self._tables.get(table)
            if entry is None or not entry.used:
                hit = np.zeros(k, dtype=bool)
                rows = None
            else:
                # Negative ids never hit (a dense index can't represent
                # them — insert() disables such tables); the clip keeps
                # the gather in bounds for out-of-range ids either way.
                in_range = (ids >= 0) & (ids < len(entry.idx))
                slots = entry.idx[np.clip(ids, 0, len(entry.idx) - 1)]
                hit = in_range & (slots >= 0)
                if self._staleness >= 0:
                    fresh_floor = self._version - self._staleness
                    hit_slots = slots[hit]
                    fresh = (
                        entry.fill_versions[hit_slots] >= fresh_floor
                    )
                    hit[np.flatnonzero(hit)[~fresh]] = False
                rows = (
                    entry.rows[slots[hit]] if hit.any() else None
                )
            nhit = int(hit.sum())
            self._hits += nhit
            self._lookups += k
            if self._lookups:
                _HIT_RATIO.set(self._hits / self._lookups)
        if nhit:
            _HITS.labels(table=table).inc(nhit)
        if k - nhit:
            _MISSES.labels(table=table).inc(k - nhit)
        return hit, rows

    def insert(self, table, ids, rows):
        """Record freshly pulled rows (this lookup's misses), stamped
        with the current version. An id re-pulled after aging out
        overwrites its old slot in place. Overflowing max_rows flushes
        the table first (the following misses re-fill it)."""
        if not len(ids):
            return
        ids = np.asarray(ids, dtype=np.int64)
        rows = np.ascontiguousarray(rows)
        with self._lock:
            if table in self._disabled:
                return
            entry = self._tables.get(table)
            max_id = int(ids.max())
            min_id = int(ids.min())
            if max_id >= self._dense_ids or min_id < 0:
                self._disabled.add(table)
                self._tables.pop(table, None)
                logger.warning(
                    "row cache disabled for table %r: id range [%d, %d] "
                    "does not fit a dense index (cap "
                    "ELASTICDL_PREFETCH_CACHE_DENSE_IDS=%d, negatives "
                    "unsupported)",
                    table, min_id, max_id, self._dense_ids,
                )
                return
            if entry is not None and (
                entry.rows.shape[1:] != rows.shape[1:]
                or entry.rows.dtype != rows.dtype
            ):
                entry = None
            if entry is None:
                entry = self._tables[table] = _TableSlab(
                    max_id + 1, rows.shape[1], rows.dtype
                )
            elif max_id >= len(entry.idx):
                grown = np.full(max_id + 1, -1, dtype=np.int32)
                grown[: len(entry.idx)] = entry.idx
                entry.idx = grown
            # Refresh ids that still hold a (stale) slot in place; only
            # genuinely new ids consume fresh slots.
            slots = entry.idx[ids]
            fresh_mask = slots < 0
            n_new = int(fresh_mask.sum())
            if entry.used + n_new > self._max_rows:
                entry = self._tables[table] = _TableSlab(
                    len(entry.idx), rows.shape[1], rows.dtype
                )
                slots = entry.idx[ids]
                fresh_mask = slots < 0
                n_new = int(fresh_mask.sum())
                if n_new > self._max_rows:
                    return  # one batch exceeds the whole budget
            need = entry.used + n_new
            if need > len(entry.rows):
                capacity = len(entry.rows)
                while capacity < need:
                    capacity *= 2
                entry.rows = np.concatenate(
                    [
                        entry.rows,
                        np.empty(
                            (capacity - len(entry.rows),)
                            + entry.rows.shape[1:],
                            entry.rows.dtype,
                        ),
                    ]
                )
                entry.fill_versions = np.concatenate(
                    [
                        entry.fill_versions,
                        np.empty(
                            capacity - len(entry.fill_versions),
                            np.int64,
                        ),
                    ]
                )
            if n_new:
                new_slots = np.arange(
                    entry.used, entry.used + n_new, dtype=np.int32
                )
                slots = slots.copy()
                slots[fresh_mask] = new_slots
                entry.idx[ids[fresh_mask]] = new_slots
                entry.used += n_new
            entry.rows[slots] = rows
            entry.fill_versions[slots] = self._version

    def stats(self):
        with self._lock:
            return {
                "version": self._version,
                "lookups": self._lookups,
                "hits": self._hits,
                "hit_ratio": (
                    self._hits / self._lookups if self._lookups else 0.0
                ),
                "cached_rows": {
                    t: e.used for t, e in self._tables.items()
                },
            }
