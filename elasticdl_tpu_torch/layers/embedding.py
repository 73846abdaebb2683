"""PS-resident embedding layer (counterpart of
elasticdl_tpu/layers/embedding.py:32-92).

The table lives in the parameter server. The trainer pulls the rows of a
batch's ids OUTSIDE the model, then hands them to one forward call by table
name, as the `rows` argument: {table_name: [n_positions, dim]} in the order
of the flattened ids. The layer reshapes and combines them. The rows are an
argument, not module state, so the pipelined trainer's push thread and the
next step never see each other's rows. The trainer differentiates the loss
with respect to the rows and pushes the per-id gradients.

With `vocab_size` set (the local and AllReduce strategies, no PS) the layer
holds an ordinary trainable table of `vocab_size` rows instead.

The id capture below is how common/model_handler.py derives a model's ids
feed: a forward run inside `capturing()` records the ids each PS table is
called with and gives zeros in place of its rows.
"""

import contextlib
import contextvars
import math

import torch
from torch import nn

# The IdCapture of the forward that runs inside capturing(), if any. A
# context variable: other threads and other forwards never see it.
_CAPTURE = contextvars.ContextVar("edl_capture", default=None)


class CaptureComplete(Exception):
    """Raised inside a capture forward once every expected table was
    called: the rest of the forward cannot change what was captured."""


class IdCapture:
    """{table: ids (numpy)} of one forward; `expected` (table names), when
    given, ends the forward early once all of them were called."""

    def __init__(self, expected=()):
        self.ids = {}
        self._expected = set(expected)

    def record(self, table, ids, dim, combined=False):
        """Records `ids` for `table` (a second call replaces the first);
        returns the zeros standing in for the rows: [*ids.shape, dim], or
        without the last id axis when the layer combines it."""
        self.ids[table] = ids.detach().cpu().numpy()
        if self._expected and self._expected <= set(self.ids):
            raise CaptureComplete()
        shape = ids.shape[:-1] if combined else ids.shape
        return torch.zeros((*shape, dim), device=ids.device)


@contextlib.contextmanager
def capturing(capture):
    """Runs the body with `capture` recording the PS tables' ids."""
    token = _CAPTURE.set(capture)
    try:
        yield capture
    finally:
        _CAPTURE.reset(token)


def active_capture():
    return _CAPTURE.get()


class DistributedEmbedding(nn.Module):
    """table_name: PS table key (shared across workers).
    dim: embedding dimension.
    combiner: None -> per-id embeddings [*ids.shape, dim];
              "sum" | "mean" | "sqrtn" -> reduce the LAST id axis.
    vocab_size: >0 for a local table (flax param name `table`,
              initialized uniform in [0, 0.05) as flax's default)."""

    def __init__(self, table_name, dim, combiner=None, vocab_size=0):
        super().__init__()
        self.table_name = table_name
        self.dim = dim
        self.combiner = combiner
        self.vocab_size = vocab_size
        if vocab_size:
            self.table = nn.Parameter(torch.empty(vocab_size, dim))

    def init_weights(self, generator):
        if self.vocab_size:
            with torch.no_grad():
                self.table.uniform_(0.0, 0.05, generator=generator)

    def forward(self, ids, rows=None):
        capture = _CAPTURE.get()
        if capture is not None and not self.vocab_size:
            return capture.record(self.table_name, ids, self.dim,
                                  self.combiner is not None)
        if self.vocab_size:
            embeddings = self.table[ids.long()]
        else:
            embeddings = rows[self.table_name].reshape(
                *ids.shape, self.dim)
        if self.combiner is None:
            return embeddings
        if self.combiner == "sum":
            return embeddings.sum(dim=-2)
        if self.combiner == "mean":
            return embeddings.mean(dim=-2)
        if self.combiner == "sqrtn":
            return embeddings.sum(dim=-2) / math.sqrt(embeddings.shape[-2])
        raise ValueError(f"unknown combiner {self.combiner!r}")
