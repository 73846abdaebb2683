"""Differentiable collectives over an intra-process axis group
(parallel/distributed.py:AxisGroup).

The JAX package has none of its own: XLA inserts the collectives that a
sharding implies, and transposes them for the backward pass. The port
writes them out as torch.autograd.Functions, in two conventions:

- The model axis holds one loss on every member (each tensor-parallel
  shard computes the same replicated loss, counted once). Its pair is
  Megatron's: `copy_to` (identity forward, all-reduce backward) where a
  replicated activation enters sharded weights, and `reduce_from`
  (all-reduce forward, identity backward) where partial sums leave them.
  Replicated parameters then get the whole gradient on every member.
- The seq and data axes split one loss into the members' parts, summed.
  A sum every member uses (`all_reduce_sum`) then sums in both
  directions. There an
  all-gather's transpose is a reduce-scatter and the reverse
  (`all_gather`, `reduce_scatter`), an all-to-all's is the opposite
  all-to-all (`all_to_all`) and a ring step's is the step backwards
  (`ring_shift`).
"""

import torch

# ---------- collectives in the backward pass, on the caller's thread ----------
#
# The autograd engine runs every backward node whose gradients lie on a
# CUDA device on that device's one engine thread, for all the threads that
# call backward. A collective there blocks that thread until the peers'
# parts arrive, and the peers' backward nodes wait behind it in the same
# queue: the shards of one card deadlock. A node whose gradients lie on the
# CPU runs on the thread that called backward. So an op whose backward
# communicates is split in two nodes: `_Stash` on its outputs keeps their
# gradients and hands a CPU token's gradient on (it runs on the device's
# thread and never waits), and `_Hop`, fed by that token, runs the
# backward with its collectives on the shard's own thread.


class _Box:
    __slots__ = ("grads",)


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, box, backward, *inputs):
        ctx.box, ctx.backward = box, backward
        return torch.zeros(())

    @staticmethod
    def backward(ctx, _):
        grads = ctx.backward(*ctx.box.grads)
        ctx.box.grads = None
        return (None, None, *grads)


class _Stash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, box, token, *outputs):
        ctx.box = box
        return outputs if len(outputs) > 1 else outputs[0]

    @staticmethod
    def backward(ctx, *grads):
        ctx.box.grads = grads
        return (None, torch.zeros(()), *([None] * len(grads)))


def with_backward(forward, backward, *inputs):
    """forward(*inputs) -> outputs (a tensor or a tuple), run without
    autograd; backward(*grad_outputs) -> a tuple of input gradients, which
    may block in collectives: autograd runs it on the thread that called
    backward (see above)."""
    box = _Box()
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        return forward(*inputs)
    token = _Hop.apply(box, backward, *inputs)
    with torch.no_grad():
        outputs = forward(*inputs)
    single = isinstance(outputs, torch.Tensor)
    return _Stash.apply(box, token, *((outputs,) if single else outputs))


def copy_to(x, group):
    """Identity forward, all-reduce backward (model axis)."""
    if group.size == 1:
        return x
    return with_backward(lambda t: t.detach(),
                         lambda g: (group.all_reduce(g.contiguous()),), x)


def reduce_from(x, group):
    """All-reduce forward, identity backward (model axis)."""
    if group.size == 1:
        return x
    return _ReduceFrom.apply(x, group)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, group):
    """All-reduce sum forward and backward: every member's loss depends on
    the sum, so each member's part receives the sum of their gradients
    (the data axis' convention: BatchNorm's statistics over the global
    batch)."""
    if group.size == 1:
        return x
    return with_backward(lambda t: group.all_reduce(t.contiguous()),
                         lambda g: (group.all_reduce(g.contiguous()),), x)


def all_gather(x, group, dim):
    """All-gather along dim forward, reduce-scatter backward."""
    if group.size == 1:
        return x
    return with_backward(lambda t: group.all_gather(t, dim),
                         lambda g: (_scatter_sum(g, group, dim),), x)


def reduce_scatter(x, group, dim):
    """Reduce-scatter along dim forward, all-gather backward."""
    if group.size == 1:
        return x
    return with_backward(lambda t: _scatter_sum(t, group, dim),
                         lambda g: (group.all_gather(g, dim),), x)


def all_to_all(x, group, split_dim, concat_dim):
    """Chunks of split_dim out, received chunks concatenated along
    concat_dim; the backward runs the opposite all-to-all."""
    if group.size == 1:
        return x
    return with_backward(
        lambda t: group.all_to_all(t, split_dim, concat_dim),
        lambda g: (group.all_to_all(g.contiguous(), concat_dim,
                                    split_dim),), x)


def ring_shift(x, group):
    """Send to rank + 1, receive from rank - 1; the backward sends the
    gradient the other way round the ring."""
    if group.size == 1:
        return x
    return with_backward(
        lambda t: group.shift([t])[0],
        lambda g: (group.exchange([g.contiguous()], (group.rank - 1)
                                  % group.size, (group.rank + 1)
                                  % group.size)[0],), x)


def _scatter_sum(x, group, dim):
    """This member's chunk along `dim` of the group's sum of x."""
    if group.size == 1:
        return x
    return group.all_reduce(x.contiguous()).chunk(
        group.size, dim=dim)[group.rank].contiguous()


