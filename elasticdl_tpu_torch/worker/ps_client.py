"""Worker-side client of the sharded parameter servers (counterpart of
elasticdl_tpu/worker/ps_client.py:67-646).

Partitioning is the JAX package's (common/hash_utils.py): dense parameters
by sha256(name) mod N, embedding ids by id mod N. Every fan-out issues one
`.future` call per shard, so the shards work in parallel; sparse gradients
are deduplicated before the wire, and a push travels as one packed request
per shard (chunked past ELASTICDL_PS_MAX_PUSH_BYTES).

The client is built on a list with one entry per shard, index = shard id:
an address ("host:port", a shard process, reached over a hardened channel
of common/rpc.py) or a stub (in this process, `ParameterServer.stub()` or
the master's shard stubs).
"""

import concurrent.futures
import os
import time

import numpy as np

from elasticdl_tpu_torch.common import hash_utils, knobs, rpc, tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.rpc import RpcError
from elasticdl_tpu_torch.observability import emit_event, tracing
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("worker.ps_client")

_REG = default_registry()
_DEGRADED = _REG.gauge(
    "edl_ps_shards_degraded", "PS shards this worker currently sees as down"
)
_DROPPED_PUSHES = _REG.counter(
    "edl_ps_grad_pushes_dropped_total",
    "Per-shard gradient pushes dropped because the shard was unreachable",
)


class _PendingVectorPull:
    """In-flight pull_embedding_vectors fan-out; result() harvests."""

    def __init__(self, client, ids, futures, keep_wire_dtype):
        self._client = client
        self._ids = ids
        self._futures = futures
        self._keep_wire_dtype = keep_wire_dtype

    def result(self):
        out = None
        for ps_id, (positions, f) in self._futures.items():
            try:
                result = f.result()
            except RpcError as e:
                # Rows are required for this batch: mark the shard and
                # raise; the worker's minibatch retries pull again.
                self._client._mark_degraded(ps_id, e)
                raise
            self._client._mark_healthy(ps_id)
            if self._keep_wire_dtype and result.dtype == pb.DT_BFLOAT16:
                values = tensor_utils.tensor_pb_to_bfloat16_bits(result)
            else:
                values = tensor_utils.tensor_pb_to_ndarray(result)
            if out is None:
                out = np.empty(
                    (len(self._ids), values.shape[1]), dtype=values.dtype
                )
            out[positions] = values
        return out


class PSClient:
    def __init__(self, shards, worker_id=-1, wire_dtype=None):
        """shards: per shard (index = ps_id) its address "host:port" or a
        PSERVER_SERVICE stub.

        wire_dtype: "float32", "bfloat16" or "int8" (None reads the
        ELASTICDL_WIRE_DTYPE knob). bfloat16 halves the sparse legs: rows
        come down and row gradients go up as bfloat16 (rounded to nearest
        even). int8 also block-quantizes the DENSE gradients (an absmax
        scale per ELASTICDL_WIRE_BLOCK_SIZE elements), with error-feedback
        residuals kept here per gradient name, so the quantization error
        stays out of the training trajectory; its sparse legs are
        bfloat16. Dense parameter pulls are float32 on every wire."""
        if wire_dtype is None or wire_dtype == "":
            wire_dtype = knobs.get_str("ELASTICDL_WIRE_DTYPE")
        if wire_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
        self.wire_dtype = wire_dtype
        # Public: the trainer keeps rows and row gradients bfloat16 across
        # the host<->device hop too. int8 keeps the bfloat16 sparse legs.
        self.bf16_wire = wire_dtype in ("bfloat16", "int8")
        self.int8_dense = wire_dtype == "int8"
        self._block_size = knobs.get_int("ELASTICDL_WIRE_BLOCK_SIZE")
        # Error-feedback residuals, one per dense gradient name: what the
        # last quantization rounded away, added to the next push's gradient.
        self._ef_residual = {}
        # Packed-push chunking: sub-requests of one push share a push_id
        # (salted by pid so anonymous workers on one host can't collide in
        # the PS's reassembly map).
        self._max_push_bytes = knobs.get_int("ELASTICDL_PS_MAX_PUSH_BYTES")
        self._push_salt = (os.getpid() & 0xFFFFFFFF) << 24
        self._push_seq = 0
        # Optional common.timing.Timing: when bound (the PS trainer binds
        # its own), push_gradients records its serialize/wire/apply
        # sub-phases there.
        self.timing = None
        self._worker_id = worker_id
        shards = list(shards)
        self._addrs = [s if isinstance(s, str) else None for s in shards]
        # Readiness-probe the shard processes CONCURRENTLY, then build
        # channels without re-probing: serial probing would cost
        # num_dead * timeout at worker startup when shards are
        # mid-relaunch.
        self._probe_ready_concurrently()
        self._channels = [
            rpc.build_channel(a, ready_timeout=0) if a is not None else None
            for a in self._addrs
        ]
        self._stubs = [
            rpc.Stub(ch, rpc.PSERVER_SERVICE) if ch is not None else s
            for ch, s in zip(self._channels, shards)
        ]
        self.num_ps = len(self._stubs)
        # Per-shard pull cursors: each shard's version advances on its own.
        self._dense_versions = [-1] * self.num_ps
        # A shard whose calls fail is marked degraded instead of crashing
        # the worker: it skips gradient pushes, reports as uninitialized on
        # dense pulls (the trainer's re-seed path owns recovery), and turns
        # healthy on its first successful call.
        self._degraded = set()
        # Shards whose last dense pull answered initialized=False (or
        # failed): the targets of a re-seed push.
        self.unseeded_shards = set()

    def close(self):
        for channel, stub in zip(self._channels, self._stubs):
            owner = channel if channel is not None else stub
            close = getattr(owner, "close", None)
            if close is not None:
                close()

    def _probe_ready_concurrently(self):
        addrs = [a for a in self._addrs if a is not None]
        timeout = rpc.ready_timeout()
        if timeout <= 0 or not addrs:
            return
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(addrs)) as pool:
            ready = list(pool.map(
                lambda a: rpc.wait_channel_ready(a, timeout), addrs))
        for addr, ok in zip(addrs, ready):
            if not ok:
                logger.warning(
                    "PS shard %s not accepting connections after %.0fs; "
                    "proceeding (retries/degradation take over)",
                    addr, timeout)

    # ---------- shard health ----------

    @property
    def degraded_shards(self):
        return set(self._degraded)

    def _mark_degraded(self, ps_id, err):
        if ps_id not in self._degraded:
            self._degraded.add(ps_id)
            _DEGRADED.set(len(self._degraded))
            code = err.code() if hasattr(err, "code") else None
            logger.warning("PS shard %d degraded: %s", ps_id,
                           getattr(code, "name", code))
            emit_event("ps_shard_degraded", ps=ps_id,
                       code=str(getattr(code, "name", code)))

    def _mark_healthy(self, ps_id):
        if ps_id in self._degraded:
            self._degraded.discard(ps_id)
            _DEGRADED.set(len(self._degraded))
            logger.info("PS shard %d healthy again", ps_id)
            emit_event("ps_shard_recovered", ps=ps_id)

    # ---------- partitioning ----------

    def partition_dense_names(self, names):
        """{ps_id: [names]} by stable name hash."""
        parts = {}
        for name in names:
            parts.setdefault(
                hash_utils.string_to_id(name, self.num_ps), []
            ).append(name)
        return parts

    # ---------- model init / re-seed ----------

    def push_model(self, dense_params, embedding_infos=None, version=0,
                   only_shards=None):
        """Push each PS its shard of the dense params and all table infos
        (first-worker init AND the re-seed of a restarted shard).

        only_shards: restrict the fan-out to these ps_ids. A shard that
        fails is marked degraded and skipped; only when EVERY targeted
        shard fails does the error propagate. Returns the set of shards
        seeded."""
        parts = self.partition_dense_names(dense_params)
        futures = []
        for ps_id, stub in enumerate(self._stubs):
            if only_shards is not None and ps_id not in only_shards:
                continue
            model = pb.Model(version=version)
            for name in parts.get(ps_id, []):
                model.dense_parameters.append(
                    tensor_utils.ndarray_to_tensor_pb(
                        np.ascontiguousarray(
                            dense_params[name], dtype=np.float32
                        ),
                        name,
                    )
                )
            model.embedding_table_infos.extend(embedding_infos or [])
            futures.append((ps_id, stub.push_model.future(model)))
        seeded, last_err = set(), None
        for ps_id, f in futures:
            try:
                f.result()
            except RpcError as e:
                last_err = e
                self._mark_degraded(ps_id, e)
                continue
            self._mark_healthy(ps_id)
            seeded.add(ps_id)
        if not seeded and last_err is not None:
            raise last_err
        return seeded

    # ---------- pulls ----------

    def pull_dense_parameters(self, names, version=None):
        """Pull the given dense params from their shards.

        version=None uses the per-shard cursors (each shard only re-sends
        params newer than what this client already pulled); an explicit
        version overrides for all shards.

        Returns (all_initialized, max_version, {name: ndarray}); params is
        partial when some shard reported initialized=False or failed
        (marked degraded here; the caller's re-seed loop owns recovery)."""
        parts = self.partition_dense_names(names)
        futures = {
            ps_id: self._stubs[ps_id].pull_dense_parameters.future(
                pb.PullDenseParametersRequest(
                    version=self._dense_versions[ps_id]
                    if version is None
                    else version
                )
            )
            for ps_id in range(self.num_ps)
        }
        params, initialized, max_version = {}, True, 0
        for ps_id, f in futures.items():
            try:
                res = f.result()
            except RpcError as e:
                self._mark_degraded(ps_id, e)
                res = pb.PullDenseParametersResponse(initialized=False)
            else:
                self._mark_healthy(ps_id)
            if not res.initialized:
                initialized = False
                self.unseeded_shards.add(ps_id)
                # Force a full re-pull from this shard once it comes back.
                self._dense_versions[ps_id] = -1
                continue
            self.unseeded_shards.discard(ps_id)
            self._dense_versions[ps_id] = res.version
            max_version = max(max_version, res.version)
            wanted = set(parts.get(ps_id, []))
            for t in res.dense_parameters:
                if t.name in wanted:
                    params[t.name] = tensor_utils.tensor_pb_to_ndarray(t)
        return initialized, max_version, params

    def pull_embedding_vectors_async(self, name, ids, keep_wire_dtype=False):
        """Issue the per-shard pull fan-out of ids [k] and return a handle
        whose ``result()`` gathers the [k, dim] rows back into input order.
        Returns None for empty ids.

        keep_wire_dtype=True hands bfloat16-wire rows back as their uint16
        bit patterns instead of widening them on the host: a caller that
        uploads them to the device widens there (exactly) and moves half
        the bytes."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return None
        scattered = hash_utils.scatter_embedding_ids(ids, self.num_ps)
        value_dtype = pb.DT_BFLOAT16 if self.bf16_wire else pb.DT_INVALID
        futures = {
            ps_id: (
                positions,
                self._stubs[ps_id].pull_embedding_vectors.future(
                    pb.PullEmbeddingVectorsRequest(
                        name=name,
                        ids_bytes=tensor_utils.ids_to_bytes(shard_ids),
                        value_dtype=value_dtype,
                    )
                ),
            )
            for ps_id, (shard_ids, positions) in scattered.items()
        }
        return _PendingVectorPull(self, ids, futures, keep_wire_dtype)

    def pull_embedding_table(self, name, page_bytes=64 << 20, dim=None):
        """Every materialized (id, row) of a table, merged across shards
        (the export's reverse swap), pulled in pages of about `page_bytes`;
        pass `dim` so the first page is bounded too. Returns (ids [n],
        values [n, dim]); (empty, None) if no rows exist. A shard that
        fails raises: a partial table would corrupt the export."""
        first_page = max(1, page_bytes // (int(dim) * 4)) if dim else 65536
        all_ids, all_values = [], []
        for ps_id, stub in enumerate(self._stubs):
            start, requested = 0, first_page
            while True:
                try:
                    res = stub.pull_embedding_table(
                        pb.PullEmbeddingTableRequest(
                            name=name, start_row=start, max_rows=requested))
                except RpcError as e:
                    self._mark_degraded(ps_id, e)
                    raise
                values, ids = tensor_utils.indexed_slices_pb_to_ndarrays(res)
                if ids.size:
                    all_ids.append(ids)
                    all_values.append(values)
                if ids.size < requested:  # a short page is the last
                    break
                start += ids.size
                requested = max(1, page_bytes // max(
                    values.dtype.itemsize * values.shape[1], 1))
        if not all_ids:
            return np.empty(0, np.int64), None
        return np.concatenate(all_ids), np.concatenate(all_values)

    # ---------- gradient push ----------

    def push_gradients(self, dense_grads, sparse_grads, version,
                       learning_rate=0.0, batch_size=0):
        """dense_grads: {name: ndarray}; sparse_grads: {table_name: (values
        [k, dim], ids [k])}, deduplicated here before partitioning.
        batch_size = records behind this push (the checkpoint's exact
        consumed-record counter). Returns (accepted_all, max_version).

        With `timing` bound, the push splits into push_serialize (dedup and
        span packing), push_apply (the slowest shard's optimizer apply, as
        PushGradientsResponse.apply_seconds reports it: shards apply
        concurrently, so the slowest gates the wait) and push_wire (the
        rest of the wait: serialize-join, parse on both ends)."""
        serialize_start = time.perf_counter()
        with tracing.span("ps_push_serialize"):
            requests = self._build_packed_requests(
                dense_grads, sparse_grads, version, learning_rate,
                batch_size,
            )
        serialize_s = time.perf_counter() - serialize_start
        wait_start = time.perf_counter()
        apply_s = 0.0
        with tracing.span("ps_push_wait"):
            futures = [
                (ps_id, [self._stubs[ps_id].push_gradients_packed.future(r)
                         for r in reqs])
                for ps_id, reqs in requests.items()
            ]
            accepted, max_version = True, 0
            delivered, last_err = 0, None
            for ps_id, shard_futures in futures:
                shard_err = None
                for f in shard_futures:
                    try:
                        res = f.result()
                    except RpcError as e:
                        # Degraded shard: drop its slice of this step
                        # (async SGD tolerates a lost update as it does
                        # staleness); a failed chunk fails the slice.
                        shard_err = e
                        break
                    accepted = accepted and res.accepted
                    max_version = max(max_version, res.version)
                    apply_s = max(apply_s, res.apply_seconds)
                if shard_err is not None:
                    last_err = shard_err
                    self._mark_degraded(ps_id, shard_err)
                    _DROPPED_PUSHES.inc()
                    continue
                self._mark_healthy(ps_id)
                delivered += 1
        if self.timing is not None:
            wait_s = time.perf_counter() - wait_start
            self.timing.add("push_serialize", serialize_s)
            self.timing.add("push_apply", apply_s)
            self.timing.add("push_wire", max(wait_s - apply_s, 0.0))
        if not delivered and last_err is not None:
            # Every shard refused: surface it to the retry ladder.
            raise last_err
        return accepted, max_version

    def _quantize_with_feedback(self, name, grad, payload):
        """The int8 span of `grad` plus the residual the last quantization
        of `name` rounded away; the new round-off becomes the next
        residual."""
        residual = self._ef_residual.get(name)
        if residual is not None:
            grad = grad + residual
        q, scales = tensor_utils.quantize_int8_blocks(grad, self._block_size)
        dq = tensor_utils.dequantize_int8_blocks(q, scales, self._block_size)
        self._ef_residual[name] = grad - dq.reshape(grad.shape)
        return tensor_utils.pack_quantized_span(
            name, grad.shape, q, scales, self._block_size, payload)

    def _build_packed_requests(self, dense_grads, sparse_grads, version,
                               learning_rate, batch_size):
        """{ps_id: [PackedPushRequest, ...]} for one gradient push.

        Dense grads pack as float32 views, or under the int8 wire as
        block-quantized spans with error feedback. Sparse grads dedup
        once, then bucket by shard with ONE gather for all shards: each
        shard's rows are a contiguous block whose span is a view."""
        worker_id_plus_one = (
            self._worker_id + 1 if self._worker_id >= 0 else 0
        )
        sparse_wire = pb.DT_BFLOAT16 if self.bf16_wire else None
        headers, payloads = {}, {}

        def ensure(ps_id):
            if ps_id not in headers:
                headers[ps_id] = pb.PushGradientsPackedRequest(
                    version=version,
                    learning_rate=learning_rate,
                    worker_id_plus_one=worker_id_plus_one,
                    batch_size=batch_size,
                    chunk_count=1,
                )
                payloads[ps_id] = tensor_utils.PackedPayload()
            return headers[ps_id], payloads[ps_id]

        for ps_id, names in self.partition_dense_names(dense_grads).items():
            header, payload = ensure(ps_id)
            for name in names:
                arr = np.ascontiguousarray(dense_grads[name],
                                           dtype=np.float32)
                if self.int8_dense:
                    header.dense.append(self._quantize_with_feedback(
                        name, arr, payload))
                else:
                    header.dense.append(
                        tensor_utils.pack_tensor_span(name, arr, payload))
        # Tables that share one ids array (DeepFM's wide and deep) dedup to
        # identical id sets: the shard bucketing is computed once.
        bucket_memo = {}
        for table, (values, ids) in sparse_grads.items():
            memo_key = id(ids)
            values, ids = tensor_utils.deduplicate_indexed_slices(values, ids)
            if self.num_ps == 1:
                header, payload = ensure(0)
                header.sparse.append(tensor_utils.pack_slices_span(
                    table, values, ids, payload, sparse_wire))
                continue
            memo = bucket_memo.get(memo_key)
            if memo is not None and np.array_equal(memo[0], ids):
                ids_sorted, order, bounds = memo[1], memo[2], memo[3]
            else:
                shard = ids % self.num_ps
                order = np.lexsort((ids, shard))
                ids_sorted = ids[order]
                bounds = np.searchsorted(
                    shard[order], np.arange(self.num_ps + 1)
                )
                bucket_memo[memo_key] = (ids, ids_sorted, order, bounds)
            values_sorted = values[order]
            for ps_id in range(self.num_ps):
                lo, hi = int(bounds[ps_id]), int(bounds[ps_id + 1])
                if lo == hi:
                    continue
                header, payload = ensure(ps_id)
                header.sparse.append(tensor_utils.pack_slices_span(
                    table, values_sorted[lo:hi], ids_sorted[lo:hi], payload,
                    sparse_wire))
        requests = {}
        for ps_id, header in headers.items():
            payload = payloads[ps_id]
            header.payload_total_bytes = payload.nbytes
            max_bytes = self._max_push_bytes
            if max_bytes <= 0 or payload.nbytes <= max_bytes:
                requests[ps_id] = [tensor_utils.PackedPushRequest(
                    header, payload.parts, payload.nbytes)]
                continue
            n_chunks = -(-payload.nbytes // max_bytes)
            self._push_seq += 1
            push_id = self._push_salt | (self._push_seq & 0xFFFFFF)
            header.push_id = push_id
            header.chunk_count = n_chunks
            reqs = []
            for i in range(n_chunks):
                start = i * max_bytes
                end = min(start + max_bytes, payload.nbytes)
                if i == 0:
                    chunk_header = header  # spans ride the first chunk
                else:
                    chunk_header = pb.PushGradientsPackedRequest(
                        worker_id_plus_one=worker_id_plus_one,
                        push_id=push_id,
                        chunk_index=i,
                        chunk_count=n_chunks,
                        payload_offset=start,
                        payload_total_bytes=payload.nbytes,
                    )
                reqs.append(tensor_utils.PackedPushRequest(
                    chunk_header, payload.slice_parts(start, end),
                    end - start))
            requests[ps_id] = reqs
        return requests
