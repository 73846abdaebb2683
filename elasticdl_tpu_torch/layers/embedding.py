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
"""

import math

import torch
from torch import nn


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
