"""Automatic embedding placement for the parameter-server strategy
(counterpart of elasticdl_tpu/common/model_handler.py).

A user writes a stock model with ordinary `nn.Embedding` tables and no
`embedding_inputs` feed; under ParameterServerStrategy the trainer moves
every table too large for the device to the PS and derives the feed:

- `wrap_model_for_ps(model, ...)` is module surgery: every `nn.Embedding`
  (or subclass) whose storage exceeds the threshold is replaced, in place,
  by a `PSEmbedding` that holds no table. Its name in the PS is its module
  path with "/" (`tok_emb`, `encoder/item_emb`). Placement tiers:
    <= threshold_bytes                        stays on the device (stock)
    (threshold, device_capacity_bytes]        stays on the device too (the
        JAX package row-shards these over a mesh; parallel/sharded_embedding
        is not ported)
    > max(threshold, device_capacity_bytes)   PS-resident
- `derive_embedding_inputs(...)` runs one forward that records the ids
  each PS table is called with (layers/embedding.py's capture) and matches
  them to the features: the whole leaf, a column of a [B, F] leaf, or a
  reshape of a leaf. Tables whose ids are computed inside the forward (the
  LM's positions) are captured per batch by the same forward, which then
  stops as soon as every PS table was called.
- `stuff_export_params(...)` is the reverse swap for export: the tables'
  rows pulled from the PS go back into the stock model's parameters as
  `<table>/embedding`, which common/params.py loads as `<table>.weight`.

How rows reach a swapped table: the trainer sets them for one forward call
with `ps_rows(rows)`, a context variable; `PSEmbedding.forward` reads its
table's rows there. A stock model has no `rows` argument to pass them
through (DistributedEmbedding's contract, layers/embedding.py), and rows
kept as module state would be shared by every thread and every call: the
pipelined trainer's push thread runs beside the next step, and a context
variable is seen only by the thread, and the call, that set it. The context
also refuses a table applied twice in one forward (its rows are keyed by
table, so a second call site would train against the first one's ids).

The rows a swapped table returns are the PS's float32 rows as they are: the
table's compute dtype is not applied, as in the JAX package, whose swap
returns the collection's float32 rows without the Embed's `dtype`.

Dense parameter names on the PS carry the wrapper scope the JAX package's
flax wrapper adds (`inner/Block_0/...`), so both packages' shards hold the
same names; the export strips it.
"""

import contextlib
import contextvars

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.layers import embedding as edl_embedding

logger = get_logger("common.model_handler")

# A table goes to the PS when its storage exceeds this (the JAX package's
# and its reference's 2 MB).
DEFAULT_THRESHOLD_BYTES = 2 * 1024 * 1024
# The scope the JAX package's PSWrappedModel puts around a wrapped model's
# parameters: dense wire names on the PS start with it.
WRAPPER_SCOPE = "inner"

# The rows of the forward call in progress (a _Rows), set by ps_rows().
_ROWS = contextvars.ContextVar("edl_ps_rows", default=None)


class _Rows:
    def __init__(self, rows):
        self.rows = rows
        self.applied = set()


@contextlib.contextmanager
def ps_rows(rows):
    """The body's forward call reads its swapped tables' rows from `rows`
    ({table: [n_positions, dim]}, in the order of the flattened ids)."""
    token = _ROWS.set(_Rows(rows))
    try:
        yield
    finally:
        _ROWS.reset(token)


def _applied_twice(table):
    return ValueError(
        f"embedding table {table!r} is applied more than once per forward "
        "pass; automatic PS placement does not support shared tables: use "
        "DistributedEmbedding with an explicit embedding_inputs feed")


class PSEmbedding(nn.Module):
    """An oversized nn.Embedding moved to the PS: no table, the forward
    call's rows instead (see the module docstring)."""

    def __init__(self, table_name, num_embeddings, embedding_dim):
        super().__init__()
        self.table_name = table_name
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim

    def forward(self, ids):
        capture = edl_embedding.active_capture()
        if capture is not None:
            if self.table_name in capture.ids:
                raise _applied_twice(self.table_name)
            return capture.record(self.table_name, ids, self.embedding_dim)
        call = _ROWS.get()
        if call is None or self.table_name not in call.rows:
            raise RuntimeError(
                f"table {self.table_name!r} lives in the parameter server: "
                "its rows come from ParameterServerTrainer's forward")
        if self.table_name in call.applied:
            raise _applied_twice(self.table_name)
        call.applied.add(self.table_name)
        rows = call.rows[self.table_name]
        if rows.shape[0] != ids.numel():
            raise ValueError(
                f"table {self.table_name!r}: {rows.shape[0]} rows for "
                f"{ids.numel()} ids")
        return rows.reshape(*ids.shape, self.embedding_dim)

    def extra_repr(self):
        return (f"{self.table_name!r}, {self.num_embeddings}, "
                f"{self.embedding_dim}, in the parameter server")


def _storage_bytes(module):
    # By the storage dtype: an LM's table is float32 whatever its compute
    # dtype.
    return module.weight.numel() * module.weight.element_size()


def wrap_model_for_ps(model, threshold_bytes=DEFAULT_THRESHOLD_BYTES,
                      device_capacity_bytes=0):
    """Replaces, in place, every nn.Embedding of `model` whose storage
    exceeds max(threshold_bytes, device_capacity_bytes) by a PSEmbedding;
    returns the model."""
    cutoff = max(threshold_bytes, device_capacity_bytes)
    swapped = {}  # the original module -> its PSEmbedding
    for parent_name, parent in list(model.named_modules(
            remove_duplicate=False)):
        for name, child in list(parent.named_children()):
            if not isinstance(child, nn.Embedding):
                continue
            if child not in swapped:
                if _storage_bytes(child) <= cutoff:
                    continue
                if child.padding_idx is not None or child.max_norm:
                    raise ValueError(
                        f"nn.Embedding {name!r} sets padding_idx or "
                        "max_norm, which the parameter server's tables do "
                        "not have")
                path = f"{parent_name}.{name}" if parent_name else name
                swapped[child] = PSEmbedding(
                    path.replace(".", "/"), child.num_embeddings,
                    child.embedding_dim)
            setattr(parent, name, swapped[child])
    return model


def discover_tables(model):
    """{table: (dim, vocab)} of the model's swapped tables, the geometry
    the export sizes them by."""
    return {m.table_name: (m.embedding_dim, m.num_embeddings)
            for m in model.modules() if isinstance(m, PSEmbedding)}


def capture_embedding_ids(forward, features, tables=()):
    """{table: ids} that the PS tables are called with in
    `forward(features)` (zeros stand in for their rows). With `tables`,
    the forward stops once each of them was called."""
    capture = edl_embedding.IdCapture(tables)
    try:
        with edl_embedding.capturing(capture), torch.no_grad():
            forward(features)
    except edl_embedding.CaptureComplete:
        pass
    return capture.ids


def _walk(features, path=()):
    """(path, leaf) over nested dicts of features; a bare array is the
    leaf at ()."""
    if not hasattr(features, "items"):
        yield path, features
        return
    for key, value in features.items():
        yield from _walk(value, path + (key,))


def _get_at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _match_leaf(ids, leaf):
    """An extractor leaf -> ids, or None. Covers the ways models feed id
    features to embedding layers: the whole leaf, a single column of a
    [B, F] leaf, or a reshape of the leaf."""
    if ids.shape == leaf.shape and np.array_equal(ids, leaf):
        return lambda a: a
    if leaf.ndim == 2 and ids.ndim == 1 and ids.shape[0] == leaf.shape[0]:
        for j in range(leaf.shape[1]):
            if np.array_equal(ids, leaf[:, j]):
                return lambda a, j=j: a[:, j]
    if ids.size == leaf.size and np.array_equal(ids.reshape(-1),
                                                leaf.reshape(-1)):
        if ids.ndim >= 1 and ids.shape[0] == leaf.shape[0]:
            # Batch-preserving reshape ([B, F] -> [B, ...]).
            tail = ids.shape[1:]
            return lambda a, t=tail: a.reshape((a.shape[0],) + t)
        if ids.ndim == 1:
            return lambda a: a.reshape(-1)  # full flatten
    return None


def derive_embedding_inputs(forward, sample_features, tables=()):
    """The `embedding_inputs` feed, features -> {table: ids}, derived from
    one whole capture forward on `sample_features` (which also refuses a
    table applied twice); None when no PS table is called. Tables whose
    ids match no feature leaf are captured per batch, by a forward that
    stops once every table of `tables` was called."""
    captured = capture_embedding_ids(forward, sample_features)
    if not captured:
        return None
    leaves = [(path, np.asarray(leaf))
              for path, leaf in _walk(sample_features)]
    extractors, unmatched = {}, []
    for table, ids in captured.items():
        for path, leaf in leaves:
            extract = _match_leaf(ids, leaf)
            if extract is not None:
                extractors[table] = (path, extract)
                break
        else:
            unmatched.append(table)

    def from_leaves(features):
        return {table: np.asarray(extract(np.asarray(_get_at(features,
                                                             path))))
                for table, (path, extract) in extractors.items()}

    if not unmatched:
        return from_leaves
    logger.info("Tables %s compute ids inside the forward pass; using a "
                "per-batch capture feed for them", unmatched)

    def feed(features):
        out = capture_embedding_ids(forward, features, tables)
        out.update(from_leaves(features))
        return out

    return feed


def stuff_export_params(params, ps_tables, default_vocab=None):
    """The reverse swap for export: {wire name: array} of the stock model's
    other parameters plus `<table>/embedding` for each PS table, ready for
    common/params.py to load into the stock model.

    ps_tables: {table: (ids, values)} pulled from the PS. default_vocab:
    {table: vocab} sizes each table as the stock model declares it
    (default max(id)+1). Rows the PS never created stay zero; rows with
    ids past the declared vocab are dropped."""
    params = dict(params)
    for table, (ids, values) in ps_tables.items():
        ids, values = np.asarray(ids), np.asarray(values)
        vocab = (default_vocab or {}).get(
            table, int(ids.max()) + 1 if ids.size else 0)
        in_range = ids < vocab
        if not in_range.all():
            logger.warning(
                "Table %s: dropping %d rows with ids >= declared vocab %d "
                "at export", table, int((~in_range).sum()), vocab)
            ids, values = ids[in_range], values[in_range]
        full = np.zeros((vocab, values.shape[1]), values.dtype)
        full[ids] = values
        params[f"{table}/embedding"] = full
    return params
