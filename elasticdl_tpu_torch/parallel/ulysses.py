"""Ulysses-style all-to-all sequence parallelism (counterpart of
elasticdl_tpu/parallel/ulysses.py).

Activations arrive sequence-sharded [B, H, S_local, D]; an all-to-all over
the seq group (parallel/collectives.py, gloo) re-shards them to
head-sharded [B, H/N, S, D], where each shard runs flash attention over
the whole sequence for its head subset (the flash kernels on the card),
and a second all-to-all restores sequence sharding. Two all-to-alls per
attention against the ring's N-1 block hops: better for moderate sequence
lengths when heads >= shards; the ring wins when the whole sequence's K/V
do not fit one device.
"""

from elasticdl_tpu_torch.ops.flash_attention import flash_attention
from elasticdl_tpu_torch.parallel.collectives import all_to_all


def ulysses_attention(q, k, v, group, causal=False, attention_fn=None):
    """q/k/v: this shard's blocks [B, H, S_local, D] over the seq `group`
    (an AxisGroup). Requires num_heads % group.size == 0."""
    if attention_fn is None:
        def attention_fn(q, k, v):
            return flash_attention(q, k, v, causal)
    h = q.shape[1]
    if h % group.size:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the seq axis "
            f"({group.size})"
        )

    def seq_to_heads(x):
        # [B, H, S_local, D] -> [B, H/N, S_global, D]
        return all_to_all(x, group, split_dim=1, concat_dim=2)

    def heads_to_seq(x):
        return all_to_all(x, group, split_dim=2, concat_dim=1)

    out = attention_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))
    return heads_to_seq(out)
