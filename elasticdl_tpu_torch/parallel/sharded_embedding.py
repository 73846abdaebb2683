"""Row-sharded embedding tables, looked up by collectives (counterpart of
elasticdl_tpu/parallel/sharded_embedding.py): the middle tier between a
replicated table and one hosted on a parameter server.

A table of V rows is cut into n equal row blocks (`padded_vocab` rounds V
up; the pad rows are never addressed) and member r of a group holds block
r only. The JAX package runs the lookup in a shard_map and lets autodiff
transpose it; the port writes both directions out over an AxisGroup
(parallel/distributed.py), each member running its own batch shard:

- forward: all-gather the ids, so that every member sees the whole id
  batch; gather the rows of the ids in its block (zeros elsewhere); and
  reduce-scatter the answers, so that each member receives its own ids'
  rows, summed over the owners (one owner per id, the rest zeros);
- backward: all-gather the row gradients and scatter-add those of the ids
  in its block into its block's gradient.

The backward's collectives run on the thread that called backward
(collectives.with_backward), so the members of one card do not deadlock.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.parallel.collectives import with_backward
from elasticdl_tpu_torch.parallel.mesh import DATA_AXIS


def padded_vocab(vocab, n_shards):
    """Rows are block-sharded; the table holds vocab rounded up so that
    every member owns an equal block."""
    return -(-vocab // n_shards) * n_shards


def sharded_embedding_lookup(block, ids, group):
    """This member's row block [V/n, D] of a table and its batch shard of
    ids [b, ...] -> the rows [b, ..., D] (every member calls it at once,
    with batch shards of one shape)."""
    rows_per = block.shape[0]
    saved = {}

    def forward(table):
        all_ids = group.all_gather(ids.long()[None], 0)  # [n, b, ...]
        rel = all_ids - group.rank * rows_per
        mine = (rel >= 0) & (rel < rows_per)
        rows = table[rel.clamp(0, rows_per - 1)]
        rows = torch.where(mine[..., None], rows, rows.new_zeros(()))
        saved["rel"], saved["mine"] = rel, mine
        # Member d receives the sum over owners of their answers to d.
        return group.reduce_scatter(rows, 0)[0]

    def backward(grad):
        all_grads = group.all_gather(grad.contiguous()[None], 0)
        rel, mine = saved.pop("rel"), saved.pop("mine")
        out = torch.zeros_like(block)
        out.index_put_((rel[mine],), all_grads[mine].to(block.dtype),
                       accumulate=True)
        return (out,)

    return with_backward(forward, backward, block)


class ShardedEmbed(nn.Module):
    """nn.Embed's counterpart whose table rows shard over `group`: the
    parameter `embedding` is this member's block [padded / n, features]
    of the [padded_vocab(num_embeddings, n), features] table. Built on the
    meta device like the port's models; `shard_table_rows` cuts a full
    table into the blocks."""

    def __init__(self, num_embeddings, features, group):
        super().__init__()
        self.group = group
        self.num_embeddings = num_embeddings
        vocab = padded_vocab(num_embeddings, group.size)
        self.embedding = nn.Parameter(
            torch.empty(vocab // group.size, features))

    def init_weights(self, generator):
        """flax's normal(0.01) on this member's block."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.01, generator=generator)

    def forward(self, ids):
        return sharded_embedding_lookup(self.embedding, torch.as_tensor(ids),
                                        self.group)


def sharded_embed_spec(axis=DATA_AXIS):
    """The spec of a row-sharded [V, D] table (parallel/tensor_parallel's
    spec form: the axis name at the split dim)."""
    return (axis, None)


def shard_table_rows(table, n_shards):
    """A full [V, D] table -> its n row blocks, V padded with zero rows up
    to padded_vocab(V, n)."""
    table = torch.as_tensor(table)
    v = table.shape[0]
    vp = padded_vocab(v, n_shards)
    if vp != v:
        table = torch.cat([table, table.new_zeros((vp - v,)
                                                  + tuple(table.shape[1:]))])
    return list(table.chunk(n_shards, dim=0))
