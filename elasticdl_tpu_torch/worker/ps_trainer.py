"""Parameter-server-strategy trainer (counterpart of
elasticdl_tpu/worker/ps_trainer.py:55-816).

- Before stepping, the trainer pulls the dense parameters; a shard that
  answers initialized=False is re-seeded by pushing the local weights (how
  a restarted shard recovers), with backoff while shards stay down.
- Embedding rows are looked up OUTSIDE the model: the batch's ids are
  deduplicated, the row cache serves what it can within its staleness
  budget, the misses are pulled from the shards. The unique rows go to the
  device once and are expanded to per-position rows there; those are the
  autograd leaves the model reads through its `rows` argument
  (layers/embedding.py). The step differentiates the loss with respect to
  the dense parameters and the rows together.
- All gradients come to the host in ONE device-to-host copy (a flat byte
  buffer), then the client deduplicates the row gradients by id and pushes
  (worker/ps_client.py). A sync-mode rejection (stale version) re-pulls and
  recomputes the minibatch.
- Async SGD pipelines by default: the push (with its device-to-host copy,
  which is where the host waits for the device) runs on a background
  thread, one push in flight, while this thread pulls and prefetches the
  next batch; with `next_features` the next batch's pulls go out right after
  this step. The loss stays a 0-d device tensor.
- With the bfloat16 wire, rows come up as bfloat16 and are widened on the
  device; their gradients are cast to bfloat16 on the device (through the
  widening's backward) before they come down.

Worker-side dense parameters are a cache of the PS state: the PS owns the
model version. Non-parameter state (the BatchNorm running statistics, torch
buffers) is the worker's own, as every non-`params` collection is in the JAX
trainer: the training forward of the PS step updates it, it never goes to
the PS, and the export and worker checkpoints carry it as `batch_stats/...`. With model_steps > 1 the worker also advances its cached
parameters through its own optimizer between pulls (the next pull
overwrites that drift).

Without `embedding_inputs`, placement is automatic (common/model_handler.py):
every nn.Embedding over the size threshold moves to the PS, its rows reach
it through the forward call's context, and the ids feed is derived from a
capture forward at the first batch (also for DistributedEmbedding models).
Dense names on the PS then carry the JAX wrapper's `inner/` scope, and the
export pulls the moved tables back into the stock model's parameters. A
model without tables trains dense-only.
"""

import concurrent.futures
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common import model_handler, tensor_utils
from elasticdl_tpu_torch.common.knobs import get_float, get_int
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.params import (
    FlaxLeaf,
    flax_leaves,
    leaves_to_flax,
    params_to_flax,
    state_to_flax,
)
from elasticdl_tpu_torch.common.rpc import RpcError
from elasticdl_tpu_torch.common.timing import Timing
from elasticdl_tpu_torch.layers.embedding import DistributedEmbedding
from elasticdl_tpu_torch.observability import datapath
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.row_cache import EmbeddingRowCache
from elasticdl_tpu_torch.worker.trainer import TorchTrainer

logger = get_logger("worker.ps_trainer")

DEFAULT_MAX_PUSH_RETRIES = 3


def _unique_inverse(flat):
    """np.unique(flat, return_inverse=True) in the ids' own dtype (int32
    ids sort faster), the unique set widened to the wire's int64."""
    unique, inverse = np.unique(flat, return_inverse=True)
    return np.ascontiguousarray(unique, dtype=np.int64), inverse


class ParameterServerTrainer(TorchTrainer):
    def __init__(
        self,
        model,
        loss_fn,
        optimizer_spec,
        ps_client,
        embedding_inputs=None,
        embedding_threshold_bytes=None,
        embedding_device_capacity_bytes=0,
        use_async=True,
        max_push_retries=DEFAULT_MAX_PUSH_RETRIES,
        seed=0,
        pipeline_pushes=None,
        model_steps=1,
        prefetch_overlap=None,
        device=None,
    ):
        super().__init__(model, loss_fn, optimizer_spec, seed=seed,
                         device=device)
        self._ps = ps_client
        self.timing = Timing()
        # push_gradients records its serialize/wire/apply sub-phases in the
        # trainer's Timing (thread-safe: the pipelined path pushes from the
        # background thread).
        if getattr(ps_client, "timing", None) is None:
            ps_client.timing = self.timing
        self._bf16_wire = bool(getattr(ps_client, "bf16_wire", False))
        # Pipelined pushes are async-SGD only: sync mode's stale-rejection
        # handshake must complete before the next pull.
        if pipeline_pushes is None:
            pipeline_pushes = use_async
        self._pipeline_pushes = pipeline_pushes and use_async
        self._push_executor = None
        self._push_future = None
        # Prefetch overlap (async only; sync mode's exactness excludes stale
        # rows): lookahead pulls of the next batch, and the versioned row
        # cache.
        if prefetch_overlap is None:
            prefetch_overlap = get_int("ELASTICDL_PREFETCH_DEPTH") > 0
        self._prefetch_overlap = bool(prefetch_overlap) and use_async
        self._row_cache = None
        if (self._prefetch_overlap
                and get_int("ELASTICDL_PREFETCH_CACHE_ROWS") > 0):
            self._row_cache = EmbeddingRowCache()
        # One lookahead prefetch in flight: (features object, handle).
        self._pending_prefetch = None
        # get_model_steps: pull fresh PS params every N minibatches and
        # train the LOCAL model in between (gradients still pushed every
        # step).
        self._model_steps = max(1, int(model_steps or 1))
        self._since_pull = self._model_steps  # force a pull first
        # callable(features) -> {table_name: ids ndarray}. Without it,
        # placement is automatic and the feed is derived at init.
        self._embedding_inputs = embedding_inputs
        self._embedding_threshold_bytes = (
            embedding_threshold_bytes
            or model_handler.DEFAULT_THRESHOLD_BYTES)
        self._embedding_device_capacity_bytes = (
            embedding_device_capacity_bytes)
        # {table: vocab} of the nn.Embedding tables moved to the PS (sizes
        # the export's reverse swap); empty when nothing moved.
        self._embedding_vocab = {}
        # Whether the model reads rows through a `rows` argument
        # (DistributedEmbedding) besides the forward call's context.
        self._rows_argument = False
        self._use_async = use_async
        self._max_push_retries = max_push_retries
        self._degraded_block_seconds = get_float(
            "ELASTICDL_PS_DEGRADED_BLOCK_SECONDS")
        self._leaves = None  # FlaxLeaf per dense parameter, wire order
        self._embedding_dims = {}  # table -> dim
        # Bytes this trainer moved to and from the device.
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    # ---------- init ----------

    def _place_tables(self):
        """{table: dim} of the PS-resident tables: the model's
        DistributedEmbedding tables and, without embedding_inputs, the
        nn.Embedding tables model_handler moves to the PS."""
        tables = {}
        for mod in self._model.modules():
            if isinstance(mod, DistributedEmbedding) and not mod.vocab_size:
                tables[mod.table_name] = mod.dim
        self._rows_argument = bool(tables)
        if self._embedding_inputs is None:
            model_handler.wrap_model_for_ps(
                self._model, self._embedding_threshold_bytes,
                device_capacity_bytes=self._embedding_device_capacity_bytes)
            moved = model_handler.discover_tables(self._model)
            self._embedding_vocab = {t: vocab
                                     for t, (_, vocab) in moved.items()}
            tables.update({t: dim for t, (dim, _) in moved.items()})
        return tables

    def _materialize(self):
        # Tables move before the model gets storage: a moved table never
        # has any.
        self._embedding_dims = self._place_tables()
        super()._materialize()

    def init_variables_if_needed(self, features):
        if self._leaves is not None:
            return
        super().init_variables_if_needed(features)
        self._leaves = flax_leaves(self._model)
        if self._embedding_vocab:
            # The JAX wrapper's scope: the PS holds the same dense names.
            self._leaves = [
                FlaxLeaf(f"{model_handler.WRAPPER_SCOPE}/{x.name}", x.param,
                         x.leaf, x.features, x.conv) for x in self._leaves]
        self._param_names = [leaf.name for leaf in self._leaves]
        self._flax_shapes = [tuple(leaf.to_flax(leaf.param.detach()).shape)
                             for leaf in self._leaves]
        if self._embedding_dims and self._embedding_inputs is None:
            self._embedding_inputs = model_handler.derive_embedding_inputs(
                self._capture_forward, features,
                # A model with DistributedEmbedding tables runs the whole
                # capture forward (a table called twice keeps its last ids).
                () if self._rows_argument else tuple(self._embedding_dims))
            if self._embedding_inputs is None:
                raise ValueError(
                    "model has PS-resident embedding tables "
                    f"{sorted(self._embedding_dims)} but the ids feed could "
                    "not be derived; provide embedding_inputs in the model "
                    "spec")
        # First worker seeds the PS; later pushes are ignored there.
        self._push_local_model()

    def _capture_forward(self, features):
        """The forward a capture runs (model_handler.capture_embedding_ids):
        in eval mode, on the device copy of `features`."""
        training = self._model.training
        self._model.eval()
        try:
            self._forward(self._to_device_batch(features), {})
        finally:
            self._model.train(training)

    def _embedding_infos(self):
        return [
            pb.EmbeddingTableInfo(name=name, dim=dim, initializer="uniform",
                                  dtype=pb.DT_FLOAT32)
            for name, dim in sorted(self._embedding_dims.items())
        ]

    def _push_local_model(self, only_unseeded=False):
        """only_unseeded: the re-seed targets just the shards the last pull
        found uninitialized or unreachable."""
        only_shards = None
        if only_unseeded and self._ps.unseeded_shards:
            only_shards = set(self._ps.unseeded_shards)
        self._ps.push_model(
            leaves_to_flax(self._leaves),
            self._embedding_infos(),
            version=self._version,
            only_shards=only_shards,
        )

    # ---------- host <-> device ----------

    def _upload(self, array):
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        self.h2d_bytes += tensor.numel() * tensor.element_size()
        return tensor.to(self._device, non_blocking=True)

    def _to_device_batch(self, batch):
        if isinstance(batch, dict):
            return {k: self._upload(np.asarray(v)) for k, v in batch.items()}
        return self._upload(np.asarray(batch))

    def _load_dense(self, named):
        """Pulled {wire name: flax-layout array} -> the model's parameters,
        in one host-to-device copy."""
        leaves = [leaf for leaf in self._leaves if leaf.name in named]
        if not leaves:
            return
        parts = [leaf.from_flax(named[leaf.name]).reshape(-1)
                 for leaf in leaves]
        flat = self._upload(torch.cat(parts).numpy())
        offset = 0
        with torch.no_grad():
            for leaf in leaves:
                n = leaf.param.numel()
                leaf.param.copy_(flat[offset:offset + n].view_as(leaf.param))
                offset += n

    # ---------- PS sync ----------

    def _maybe_sync_model(self):
        """Pull only when the local model is due (model_steps)."""
        if self._since_pull >= self._model_steps:
            self._sync_model()
        else:
            self._since_pull += 1

    def _apply_local(self, dense_grads):
        """Advance the LOCAL dense params with this step's grads so the next
        minibatch's forward needs no pull; the next pull overwrites the
        drift."""
        for leaf, g in zip(self._leaves, dense_grads):
            leaf.param.grad = g
        self._optimizer.step()
        self._optimizer.zero_grad(set_to_none=True)

    def _sync_model(self):
        """Pull dense params; re-seed any uninitialized shard from the local
        weights, backing off while shards stay down, until the budget runs
        out (then raise: the worker's minibatch retries and the master's
        task retries take over)."""
        deadline = time.time() + self._degraded_block_seconds
        backoff = 0.5
        while True:
            initialized, version, named = self._ps.pull_dense_parameters(
                self._param_names)
            if initialized:
                break
            logger.info(
                "Uninitialized/degraded PS shard found; re-seeding from "
                "local (degraded=%s)", sorted(self._ps.degraded_shards))
            try:
                self._push_local_model(only_unseeded=True)
                initialized, version, named = (
                    self._ps.pull_dense_parameters(self._param_names))
                if initialized:
                    break
            except RpcError:
                pass  # every shard refused the re-seed: keep backing off
            if time.time() >= deadline:
                raise RuntimeError(
                    "PS still uninitialized after re-seed (degraded "
                    f"shards: {sorted(self._ps.degraded_shards)})"
                )
            time.sleep(backoff)
            backoff = min(backoff * 2, 4.0)
        if version < self._version:
            # A shard came back BEHIND this worker (restored from an older
            # checkpoint or re-seeded): the PS owns the version.
            logger.warning(
                "PS model version regressed to %d (< local %d); adopting "
                "the PS version", version, self._version)
            self._version = version
        self._load_dense(named)
        self._version = max(self._version, version)
        if self._row_cache is not None:
            self._row_cache.note_version(self._version)
        # Reset the cadence only on a successful pull.
        self._since_pull = 1

    # ---------- embedding prefetch ----------

    def _start_prefetch(self, features, use_cache=True):
        """Issue the embedding pulls for one batch WITHOUT waiting: per
        table, dedup the ids, serve what the row cache can, pull the misses.
        Returns a handle for _finish_prefetch."""
        if not self._embedding_dims:
            return {}
        cache = self._row_cache if use_cache else None
        handle = {}
        # Tables often key off the SAME ids array (DeepFM's wide and deep):
        # dedup once per distinct array.
        uniq_memo = {}
        for table, ids in self._embedding_inputs(features).items():
            memo_key = id(ids)
            if memo_key not in uniq_memo:
                flat = np.asarray(ids).reshape(-1)
                uniq_memo[memo_key] = (flat, *_unique_inverse(flat))
            flat, unique, inverse = uniq_memo[memo_key]
            hit, cached_rows, miss_ids = None, None, unique
            if cache is not None:
                hit, cached_rows = cache.lookup(table, unique)
                miss_ids = unique[~hit]
            pending = None
            if miss_ids.size:
                pending = self._ps.pull_embedding_vectors_async(
                    table, miss_ids, keep_wire_dtype=self._bf16_wire)
            handle[table] = (memo_key, flat, unique, inverse, hit,
                             cached_rows, miss_ids, pending)
        return handle

    def _finish_prefetch(self, handle, use_cache=True):
        """Harvest a _start_prefetch handle -> (rows {table: per-position
        rows on the device, leaves that require grad}, flat_ids {table:
        [n_positions]}). Pulled misses enter the row cache."""
        cache = self._row_cache if use_cache else None
        rows, flat_ids, inverses = {}, {}, {}
        for table, (memo_key, flat, unique, inverse, hit, cached_rows,
                    miss_ids, pending) in handle.items():
            pulled = pending.result() if pending is not None else None
            if hit is None:  # cache not in play
                unique_rows = pulled
            else:
                if cache is not None and pulled is not None:
                    cache.insert(table, miss_ids, pulled)
                if pulled is None:
                    unique_rows = cached_rows  # every id hit
                elif cached_rows is None:
                    unique_rows = pulled  # every id missed
                else:
                    unique_rows = np.empty(
                        (unique.size,) + pulled.shape[1:], pulled.dtype)
                    unique_rows[hit] = cached_rows
                    unique_rows[~hit] = pulled
            if memo_key not in inverses:
                inverses[memo_key] = self._upload(
                    inverse.reshape(-1).astype(np.int32))
            device_rows = self._upload(
                unique_rows.view(np.int16) if self._bf16_wire
                else unique_rows)
            if self._bf16_wire:
                device_rows = device_rows.view(torch.bfloat16)
            rows[table] = device_rows.index_select(
                0, inverses[memo_key]).requires_grad_()
            flat_ids[table] = flat
        return rows, flat_ids

    def _prefetch_embeddings(self, features, use_cache=True):
        return self._finish_prefetch(
            self._start_prefetch(features, use_cache=use_cache),
            use_cache=use_cache,
        )

    def _take_pending_prefetch(self, features):
        """The lookahead handle issued for `features` last step, if the
        caller's hint matched (object identity); a mismatch discards it."""
        pending, self._pending_prefetch = self._pending_prefetch, None
        if pending is not None and pending[0] is features:
            return pending[1]
        return None

    # ---------- the step ----------

    def _forward(self, features, rows):
        if not self._embedding_dims:  # a dense-only model
            return self._model(features)
        # bfloat16 rows widen on the device (exact); their gradients come
        # back through the widening as bfloat16.
        rows = {t: r.float() for t, r in rows.items()}
        with model_handler.ps_rows(rows):
            if self._rows_argument:
                return self._model(features, rows)
            return self._model(features)

    def _ps_step(self, features, labels, rows):
        """fwd + bwd with respect to the dense parameters and the rows ->
        (loss, dense grads in wire order, {table: row grads})."""
        self._model.train()
        loss = self._loss_fn(labels, self._forward(features, rows))
        tables = list(rows)
        inputs = [leaf.param for leaf in self._leaves] + [
            rows[t] for t in tables]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        n = len(self._leaves)
        return loss.detach(), grads[:n], dict(zip(tables, grads[n:]))

    def _gather_grads(self, dense_grads, row_grads):
        """Every gradient in one flat device byte buffer (dense grads in
        their flax layout, then each table's row grads), so they come down
        in one copy; returns (buffer, layout)."""
        parts = [leaf.to_flax(g).reshape(-1).view(torch.uint8)
                 for leaf, g in zip(self._leaves, dense_grads)]
        layout = list(zip(self._param_names, self._flax_shapes))
        for table, g in row_grads.items():
            parts.append(g.reshape(-1).view(torch.uint8))
            layout.append((table, g.dtype))
        return torch.cat(parts), layout

    def _push_payload(self, buffer, layout, flat_ids, version, batch_size):
        """Copy the gradients to the host (the wait for the step's compute),
        split them, and push. Runs inline (sync mode) or on the push thread
        (pipelined async mode)."""
        with self.timing.record("push_gradients"):
            host = buffer.cpu().numpy()
            self.d2h_bytes += host.nbytes
            dense, sparse, offset = {}, {}, 0
            for name, kind in layout:
                if isinstance(kind, tuple):  # a dense grad's flax shape
                    size = 4 * int(np.prod(kind))
                    dense[name] = host[offset:offset + size].view(
                        np.float32).reshape(kind)
                else:  # a table's row grads, float32 or bfloat16
                    dim = self._embedding_dims[name]
                    size = flat_ids[name].size * dim * (
                        2 if kind == torch.bfloat16 else 4)
                    raw = host[offset:offset + size]
                    values = (tensor_utils.bfloat16_bits_to_float32(
                        raw.view(np.uint16)) if kind == torch.bfloat16
                        else raw.view(np.float32))
                    sparse[name] = (values.reshape(-1, dim), flat_ids[name])
                offset += size
            accepted, version = self._ps.push_gradients(
                dense, sparse, version=version, batch_size=batch_size)
        self._version = max(self._version, version)
        if self._row_cache is not None:
            # Our apply bumped the PS clock: age the cache.
            self._row_cache.note_version(self._version)
        return accepted, version

    def flush_pushes(self):
        """Wait for the in-flight background push (read-your-writes for
        eval and export; also where a failed push raises). The Worker
        calls it before it reports a training task done, so that a task
        counts as done only once its gradients are in the PS."""
        future, self._push_future = self._push_future, None
        if future is not None:
            future.result()

    # ---------- Trainer interface ----------

    def train_minibatch(self, features, labels, next_features=None):
        """next_features: optional hint, the NEXT batch the caller will
        train on; with prefetch overlap (async pipelined mode) its
        embedding pulls are issued while this step runs."""
        self.init_variables_if_needed(features)
        if self._pipeline_pushes:
            return self._train_minibatch_pipelined(features, labels,
                                                   next_features)
        with datapath.get().stage("h2d", timing=self.timing):
            device_features = self._to_device_batch(features)
            device_labels = self._to_device_batch(labels)
        batch_size = int(np.asarray(labels).shape[0])
        loss = None
        for attempt in range(self._max_push_retries):
            # Issue the embedding pulls BEFORE the dense pull waits: both
            # fan-outs run together.
            with self.timing.record("prefetch_issue"):
                handle = self._start_prefetch(features)
            with self.timing.record("pull_model"):
                if attempt == 0:
                    self._maybe_sync_model()
                else:
                    # A stale rejection: re-pull regardless of cadence.
                    self._sync_model()
            with self.timing.record("prefetch_embeddings"):
                rows, flat_ids = self._finish_prefetch(handle)
            with self.timing.record("train_step"):
                loss, dense_grads, row_grads = self._ps_step(
                    device_features, device_labels, rows)
                buffer, layout = self._gather_grads(dense_grads, row_grads)
            accepted, _ = self._push_payload(
                buffer, layout, flat_ids, self._version, batch_size)
            if accepted:
                # Local apply only for ACCEPTED steps: a rejected attempt
                # re-pulls anyway.
                if self._model_steps > 1:
                    self._apply_local(dense_grads)
                return True, self._version, loss
            logger.info(
                "Gradient push rejected as stale (attempt %d); re-pulling",
                attempt + 1)
        return False, self._version, loss

    def _train_minibatch_pipelined(self, features, labels,
                                   next_features=None):
        """Async-SGD step with the push and the embedding lookup off the
        critical path: while the device computes step N, this thread pulls
        params for step N+1, whose embedding pulls went out last call."""
        if self._push_executor is None:
            self._push_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="edl-ps-push")
        with datapath.get().stage("h2d", timing=self.timing):
            device_features = self._to_device_batch(features)
            device_labels = self._to_device_batch(labels)
        handle = self._take_pending_prefetch(features)
        if handle is None:
            with self.timing.record("prefetch_issue"):
                handle = self._start_prefetch(features)
        with self.timing.record("pull_model"):
            self._maybe_sync_model()
        with self.timing.record("prefetch_embeddings"):
            rows, flat_ids = self._finish_prefetch(handle)
        with self.timing.record("train_step_dispatch"):
            loss, dense_grads, row_grads = self._ps_step(
                device_features, device_labels, rows)
            buffer, layout = self._gather_grads(dense_grads, row_grads)
        if self._model_steps > 1:
            self._apply_local(dense_grads)
        # One push in flight: wait out the previous (raising its errors),
        # then hand this step's grads to the push thread, whose copy to the
        # host waits for this step's compute.
        self.flush_pushes()
        self._push_future = self._push_executor.submit(
            self._push_payload, buffer, layout, flat_ids, self._version,
            int(np.asarray(labels).shape[0]))
        if self._prefetch_overlap and next_features is not None:
            with self.timing.record("prefetch_issue"):
                self._pending_prefetch = (
                    next_features, self._start_prefetch(next_features))
        return True, self._version, loss

    def evaluate_minibatch(self, features, model_version=-1):
        self.init_variables_if_needed(features)
        self.flush_pushes()  # read-your-writes for the eval pull
        self._sync_model()
        # use_cache=False: evaluation reads the freshest rows.
        rows, _ = self._prefetch_embeddings(features, use_cache=False)
        self._model.eval()
        with torch.no_grad():
            outputs = self._forward(self._to_device_batch(features), rows)
        return outputs.cpu().numpy()

    def get_model_version(self):
        return self._version

    def close(self):
        try:
            self.flush_pushes()
        finally:
            if self._push_executor is not None:
                self._push_executor.shutdown(wait=True)
                self._push_executor = None

    def export_variables(self):
        """The final dense weights, pulled from the PS after the last push.
        Tables moved to the PS automatically come back into the stock
        model's parameters (model_handler.stuff_export_params); a
        DistributedEmbedding's table stays in the PS. A model with buffers
        adds the worker's "state" ({"batch_stats/<path>/mean" or "var"}),
        as LocalTrainer.export_variables does."""
        if self._leaves is None:
            return None
        self.flush_pushes()
        self._sync_model()
        variables = params_to_flax(self._model)
        if self._embedding_vocab:
            ps_tables = {}
            for table in self._embedding_vocab:
                ids, values = self._ps.pull_embedding_table(
                    table, dim=self._embedding_dims[table])
                if values is not None:
                    ps_tables[table] = (ids, values)
            variables = model_handler.stuff_export_params(
                variables, ps_tables, default_vocab=self._embedding_vocab)
        exported = {"variables": variables, "opt_state": None, "rng": None,
                    "version": self._version}
        state = state_to_flax(self._model)
        if state:
            exported["state"] = state
        return exported
