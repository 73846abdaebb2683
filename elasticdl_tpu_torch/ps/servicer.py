"""The parameter-server servicer: async/sync gradient application over the
store (counterpart of elasticdl_tpu/ps/servicer.py:65-528).

- async mode: every push applies immediately; with
  lr_staleness_modulation a stale push (worker version < PS version) has its
  LR scaled down by the staleness.
- sync mode: pushes buffer until `grads_to_wait` distinct workers pushed,
  then dense grads average, sparse grads merge and apply once; pushes older
  than `sync_version_tolerance` are rejected (accepted=False: the worker
  re-pulls and recomputes).
- every apply bumps `version`; every `checkpoint_steps` versions the shard
  checkpoints itself (the snapshot is taken under the version lock, the file
  written after it); every `report_version_steps` it reports to the master.
- packed pushes decode spans as views into the received payload; a push
  split into chunks is reassembled before it applies.
"""

import threading
import time

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("ps.servicer")

DEFAULT_REPORT_VERSION_STEPS = 100

# Process-global so N in-process shards aggregate; byte counters carry the
# shard id so per-shard load stays visible.
_REG = default_registry()
_PUSH_BYTES = _REG.counter(
    "edl_ps_push_bytes_total",
    "Gradient push request bytes received, by shard",
    labelnames=("shard",),
)
_PULL_BYTES = _REG.counter(
    "edl_ps_pull_bytes_total",
    "Parameter/embedding pull response bytes sent",
    labelnames=("rpc", "shard"),
)
_PUSHES = _REG.counter(
    "edl_ps_push_total",
    "Gradient pushes by outcome",
    labelnames=("outcome",),
)
_PS_VERSION = _REG.gauge(
    "edl_ps_model_version", "Latest model version applied by this PS"
)
_APPLY_SECONDS = _REG.histogram(
    "edl_ps_apply_seconds", "Optimizer apply latency per push"
)


class PserverServicer:
    CHUNK_GC_SECONDS = 120.0

    def __init__(
        self,
        parameters,
        optimizer,
        use_async=True,
        grads_to_wait=1,
        sync_version_tolerance=0,
        sync_window_timeout=30.0,
        lr_staleness_modulation=False,
        checkpoint_saver=None,
        checkpoint_steps=0,
        master_client=None,
        report_version_steps=DEFAULT_REPORT_VERSION_STEPS,
        shard_id=0,
    ):
        self._params = parameters
        self._opt = optimizer
        self._shard = str(shard_id)
        self._use_async = use_async
        self._grads_to_wait = grads_to_wait
        self._sync_version_tolerance = sync_version_tolerance
        self._lr_staleness_modulation = lr_staleness_modulation
        self._checkpoint_saver = checkpoint_saver
        self._checkpoint_steps = checkpoint_steps
        self._mc = master_client
        self._report_version_steps = report_version_steps
        self._version_lock = threading.Lock()
        # sync-mode accumulation state (guarded by _version_lock)
        self._grad_sum = {}  # dense name -> np array
        self._grad_n = 0
        self._sparse_acc = {}  # table name -> ([values...], [ids...])
        # The quorum counts DISTINCT workers (a fast worker pushing twice
        # does not fill it alone); anonymous sync pushes are rejected. If
        # the quorum has not filled within sync_window_timeout of the
        # window's first push, the next push applies what accumulated.
        self._sync_window_timeout = sync_window_timeout
        self._push_workers = set()
        self._window_start = None
        # Chunked packed pushes mid-reassembly: (worker, push_id) -> entry;
        # entries whose worker died mid-push are dropped by age.
        self._chunk_lock = threading.Lock()
        self._pending_chunks = {}

    # ---------- rpc methods (names match rpc.PSERVER_SERVICE) ----------

    def push_model(self, request, context):
        if self._params.init_from_model_pb(request):
            logger.info(
                "Model initialized from worker push: %d dense, %d tables, "
                "version %d",
                len(self._params.dense),
                len(self._params.embedding_tables),
                self._params.version,
            )
        return pb.Empty()

    def push_embedding_table_infos(self, request, context):
        with self._params.init_lock:
            self._params.init_embedding_infos(request.embedding_table_infos)
        return pb.Empty()

    def pull_dense_parameters(self, request, context):
        if not self._params.initialized:
            return pb.PullDenseParametersResponse(initialized=False)
        # Workers poll with their current version and only need what is
        # newer; version 0 asks for everything.
        res = pb.PullDenseParametersResponse(
            initialized=True, version=self._params.version
        )
        if request.version < self._params.version or request.version == 0:
            for name in sorted(self._params.dense):
                res.dense_parameters.append(
                    tensor_utils.ndarray_to_tensor_pb(
                        self._params.dense[name], name
                    )
                )
        _PULL_BYTES.labels(rpc="pull_dense_parameters",
                           shard=self._shard).inc(res.ByteSize())
        return res

    def pull_embedding_vectors(self, request, context):
        table = self._params.embedding_tables.get(request.name)
        if table is None:
            raise ValueError(f"unknown embedding table {request.name!r}")
        if request.ids_bytes:
            ids = tensor_utils.ids_from_bytes(request.ids_bytes)
        elif request.ids:
            ids = np.asarray(request.ids, dtype=np.int64)
        else:
            return pb.Tensor(name=request.name)
        values = table.lookup(ids)
        wire_dtype = (pb.DT_BFLOAT16
                      if request.value_dtype == pb.DT_BFLOAT16 else None)
        res = tensor_utils.ndarray_to_tensor_pb(values, request.name,
                                                wire_dtype)
        _PULL_BYTES.labels(rpc="pull_embedding_vectors",
                           shard=self._shard).inc(res.ByteSize())
        return res

    def pull_embedding_table(self, request, context):
        """One page of a table's materialized rows (model export)."""
        table = self._params.embedding_tables.get(request.name)
        if table is None:
            raise ValueError(f"unknown embedding table {request.name!r}")
        ids, values = table.export_rows(
            start=request.start_row,
            count=request.max_rows or None,
        )
        res = tensor_utils.ndarray_to_indexed_slices_pb(
            values, ids, request.name
        )
        _PULL_BYTES.labels(rpc="pull_embedding_table",
                           shard=self._shard).inc(res.ByteSize())
        return res

    def push_gradients(self, request, context):
        _PUSH_BYTES.labels(shard=self._shard).inc(request.ByteSize())
        dense, sparse = self._decode_model_pb(request.gradients)
        return self._push_decoded(
            dense,
            sparse,
            version=request.gradients.version,
            worker_id_plus_one=request.worker_id_plus_one,
            batch_size=request.batch_size,
        )

    def push_gradients_packed(self, request, context):
        """Out-of-band push: spans decode as views into the received payload
        bytes. Multi-chunk pushes buffer until every payload byte arrived,
        then apply once."""
        _PUSH_BYTES.labels(shard=self._shard).inc(request.ByteSize())
        # Age-GC abandoned reassemblies on every packed push, so a worker
        # that died mid-push does not pin its buffer until the next chunked
        # push arrives.
        self._gc_pending_chunks()
        if request.chunk_count > 1:
            assembled = self._absorb_chunk(request)
            if assembled is None:
                # Buffered; the reassembly-completing chunk reports the
                # apply. accepted=True: the chunk itself was taken.
                return pb.PushGradientsResponse(
                    accepted=True, version=self._params.version
                )
            header, payload = assembled
        else:
            header, payload = request, request.payload
            if len(payload) != request.payload_total_bytes:
                raise ValueError(
                    f"packed push payload {len(payload)} bytes != "
                    f"declared {request.payload_total_bytes} (truncated)"
                )
        dense, sparse = self._decode_packed(header, payload)
        return self._push_decoded(
            dense,
            sparse,
            version=header.version,
            worker_id_plus_one=header.worker_id_plus_one,
            batch_size=header.batch_size,
        )

    # ---------- decode / chunk reassembly ----------

    def _decode_model_pb(self, model_pb):
        """Per-tensor Model -> ({name: grad}, {table: (values, ids)}), the
        shape the packed path decodes to, so both share one apply path."""
        dense = {
            t.name: tensor_utils.tensor_pb_to_ndarray(t)
            for t in model_pb.dense_parameters
        }
        sparse = {
            name: tensor_utils.indexed_slices_pb_to_ndarrays(slices)
            for name, slices in model_pb.embedding_tables.items()
        }
        return dense, sparse

    def _decode_packed(self, header, payload):
        dense = {
            span.name: tensor_utils.unpack_tensor_span(span, payload)
            for span in header.dense
        }
        sparse = {
            span.values.name: tensor_utils.unpack_slices_span(span, payload)
            for span in header.sparse
        }
        return dense, sparse

    def _gc_pending_chunks(self):
        now = time.monotonic()
        with self._chunk_lock:
            for k, entry in list(self._pending_chunks.items()):
                if now - entry["created"] > self.CHUNK_GC_SECONDS:
                    del self._pending_chunks[k]

    def _absorb_chunk(self, request):
        """Buffer one chunk; returns (header, payload) once the push is
        complete, else None. Chunks may arrive in any order (each carries
        its payload_offset); the spans ride chunk 0. A chunk index seen
        twice (a retried sub-request) is ignored."""
        key = (request.worker_id_plus_one, request.push_id)
        with self._chunk_lock:
            entry = self._pending_chunks.get(key)
            if entry is None:
                entry = self._pending_chunks[key] = {
                    "buf": bytearray(request.payload_total_bytes),
                    "received": 0,
                    "seen": set(),
                    "header": None,
                    "created": time.monotonic(),
                }
            if request.chunk_index == 0:
                entry["header"] = request
            if request.chunk_index not in entry["seen"]:
                entry["seen"].add(request.chunk_index)
                start = request.payload_offset
                end = start + len(request.payload)
                if end > len(entry["buf"]):
                    del self._pending_chunks[key]
                    raise ValueError(
                        f"packed chunk [{start}, {end}) outside the "
                        f"declared {len(entry['buf'])}-byte payload"
                    )
                entry["buf"][start:end] = request.payload
                entry["received"] += len(request.payload)
            if not (entry["header"] is not None
                    and len(entry["seen"]) == request.chunk_count):
                return None
            del self._pending_chunks[key]
        if entry["received"] != len(entry["buf"]):
            raise ValueError(
                f"packed push reassembled {entry['received']} of "
                f"{len(entry['buf'])} payload bytes (overlapping or "
                f"truncated chunks)"
            )
        # The bytearray backs the decoded views (no final copy); it left the
        # pending map, so nothing mutates it any more.
        return entry["header"], entry["buf"]

    # ---------- shared push entry ----------

    def _push_decoded(self, dense, sparse, version, worker_id_plus_one,
                      batch_size):
        if self._use_async:
            res = self._push_async(dense, sparse, version, batch_size)
        else:
            res = self._push_sync(
                dense, sparse, version, worker_id_plus_one, batch_size
            )
        _PUSHES.labels(
            outcome="accepted" if res.accepted else "rejected"
        ).inc()
        return res

    # ---------- async path ----------

    def _push_async(self, dense, sparse, version, batch_size):
        staleness = max(1, self._params.version - version)
        if self._lr_staleness_modulation:
            self._opt.lr_modulator.set_multiplier(1.0 / staleness)
        # Applies serialize on the version lock: ctypes releases the
        # interpreter lock, so concurrent native updates of one buffer
        # would race.
        with self._version_lock:
            start = time.perf_counter()
            with tracing.span("ps_apply_async"):
                self._apply_decoded(dense, sparse)
            apply_seconds = time.perf_counter() - start
            _APPLY_SECONDS.observe(apply_seconds)
            self._params.total_records += batch_size
            self._params.version += 1
            version = self._params.version
            snapshot = self._snapshot_if_due(version)
        _PS_VERSION.set(version)
        self._post_apply(version, snapshot)
        # apply_seconds lets the pushing worker split its wait into wire
        # and apply time.
        return pb.PushGradientsResponse(
            accepted=True, version=version, apply_seconds=apply_seconds
        )

    # ---------- sync path ----------

    def _push_sync(self, dense, sparse, version, worker_id_plus_one,
                   batch_size):
        if worker_id_plus_one <= 0:
            raise ValueError(
                "sync-mode gradient pushes must carry a worker_id; the "
                "distinct-worker quorum cannot count anonymous pushes"
            )
        with self._version_lock:
            if version < self._params.version - self._sync_version_tolerance:
                return pb.PushGradientsResponse(
                    accepted=False, version=self._params.version
                )
            for name, g in dense.items():
                if name in self._grad_sum:
                    self._grad_sum[name] += g
                else:
                    # Forced copy: packed grads are read-only views into
                    # the received payload.
                    self._grad_sum[name] = np.array(g, dtype=np.float32)
            for name, (values, ids) in sparse.items():
                acc = self._sparse_acc.setdefault(name, ([], []))
                acc[0].append(np.asarray(values, dtype=np.float32))
                acc[1].append(ids)
            self._grad_n += 1
            self._params.total_records += batch_size
            if self._window_start is None:
                self._window_start = time.monotonic()
            self._push_workers.add(worker_id_plus_one - 1)
            quorum = len(self._push_workers)
            window_expired = (
                time.monotonic() - self._window_start
                > self._sync_window_timeout
            )
            if quorum < self._grads_to_wait and not window_expired:
                return pb.PushGradientsResponse(
                    accepted=True, version=self._params.version
                )
            if window_expired and quorum < self._grads_to_wait:
                logger.warning(
                    "Sync window timed out with %d/%d workers; applying "
                    "%d buffered pushes",
                    quorum, self._grads_to_wait, self._grad_n,
                )
            # Quorum reached: average dense, merge sparse, apply once.
            apply_start = time.perf_counter()
            self._opt.begin_apply()
            try:
                for name, g in self._grad_sum.items():
                    self._opt.apply_dense(
                        name, self._params.dense[name], g / self._grad_n
                    )
                for name, (values_list, ids_list) in self._sparse_acc.items():
                    values, ids = tensor_utils.merge_indexed_slices(
                        values_list, ids_list
                    )
                    values /= self._grad_n
                    self._opt.apply_sparse(
                        self._params.embedding_tables[name], ids, values
                    )
            finally:
                self._opt.end_apply()
            apply_seconds = time.perf_counter() - apply_start
            _APPLY_SECONDS.observe(apply_seconds)
            self._grad_sum.clear()
            self._sparse_acc.clear()
            self._grad_n = 0
            self._push_workers.clear()
            self._window_start = None
            self._params.version += 1
            version = self._params.version
            snapshot = self._snapshot_if_due(version)
        _PS_VERSION.set(version)
        self._post_apply(version, snapshot)
        # Only the quorum-completing push reports the apply cost.
        return pb.PushGradientsResponse(
            accepted=True, version=version, apply_seconds=apply_seconds
        )

    # ---------- shared ----------

    def _apply_decoded(self, dense, sparse):
        # One optimizer step for the whole push: all params share Adam's
        # bias-correction step.
        self._opt.begin_apply()
        try:
            for name, grad in dense.items():
                param = self._params.dense.get(name)
                if param is None:
                    raise ValueError(
                        f"gradient for unknown parameter {name!r}"
                    )
                self._opt.apply_dense(name, param, grad)
            for name, (values, ids) in sparse.items():
                table = self._params.embedding_tables.get(name)
                if table is None:
                    raise ValueError(f"gradient for unknown table {name!r}")
                self._opt.apply_sparse(table, ids, values)
        finally:
            self._opt.end_apply()

    def _snapshot_if_due(self, version):
        """Call under _version_lock: concurrent pushes mutate the dense
        arrays in place, so a snapshot outside the lock could mix versions.
        The file write happens after the lock, in _post_apply."""
        if (
            self._checkpoint_saver is not None
            and self._checkpoint_steps
            and version % self._checkpoint_steps == 0
        ):
            try:
                return self._checkpoint_saver.snapshot(version, self._params)
            except Exception:
                logger.error(
                    "Checkpoint snapshot at version %d failed",
                    version, exc_info=True,
                )
        return None

    def _post_apply(self, version, snapshot=None):
        if snapshot is not None:
            try:
                self._checkpoint_saver.save_snapshot(version, snapshot)
            except Exception:
                logger.error(
                    "Checkpoint at version %d failed", version, exc_info=True
                )
        if (
            self._mc is not None
            and version % self._report_version_steps == 0
        ):
            try:
                self._mc.report_version(version)
            except Exception:
                logger.warning(
                    "report_version(%d) to master failed", version
                )
