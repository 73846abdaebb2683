"""Quantized cross-replica gradient reduction, EQuARX-style (counterpart of
elasticdl_tpu/parallel/quantized.py).

A ring all-reduce moves every gradient byte out twice; with the payload
quantized to int8 under one f32 scale per block, both legs carry a quarter
of the bytes at an error bounded by the block's rounding step. The JAX
package writes the reduction with shard_map collectives; the port runs the
same arithmetic over a group with `size`, `rank`, `all_to_all`,
`all_gather` and `all_reduce`: an AxisGroup among the shards of a process,
or the epoch's World as one (parallel/distributed.py:World.axis_group).

- `quantized_psum_1d` (all_to_all form): leg 1 sends every member's int8
  blocks and their scales by all_to_all; each member dequantizes the
  blocks it received and sums them exactly in f32; leg 2 quantizes that
  sum again and all-gathers it. Two roundings per element.
- `quantized_psum_lanes_1d` (psum_lanes form): one scale per block shared
  by the group (a max all-reduce), the values rounded onto the int8 grid
  in int16 lanes (int32 past 258 members) and summed exactly, so one
  rounding per element. JAX sums the lanes with one psum; gloo has no
  int16 all-reduce, so the port carries the lanes as bytes through an
  all_to_all, sums its block exactly in int32 and all-gathers the summed
  lanes as bytes: the same arithmetic, bit for bit, at the same 2 bytes
  per element and leg.
- `quantized_pmean` flattens the leaves into one f32 vector, padded to a
  multiple of the group's size, reduces it in one block per member (one
  scale each) and restores the leaves' shapes and dtypes. Which scale an
  element gets follows from the order and layout of the leaves: the
  trainer hands them over in the JAX tree order and layout (flax's sorted
  names, kernels as [in, out], common/params.py), as the JAX step
  flattens them.

A group of one still quantizes: the all_to_all form rounds twice there
too, as the JAX step does on a one-device data axis.
"""

import torch

_EPS = 1e-12


def _quantize(x):
    """f32 [n, ...] -> (int8 [n, ...], f32 per-row scales [n, 1, ...]):
    symmetric max-abs quantization per leading-dim block, rounding half to
    even (jnp.round's rule)."""
    absmax = torch.amax(x.abs(), dim=tuple(range(1, x.ndim)), keepdim=True)
    scale = absmax / 127.0 + _EPS
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


def quantized_psum_1d(x, group):
    """The sum over `group` of a flat f32 [L] vector (L divisible by the
    group's size), both legs int8."""
    n = group.size
    blocks = x.reshape(n, -1)  # block b is member b's return shard
    q, scale = _quantize(blocks)
    # Leg 1 (reduce-scatter): member r receives every member's quantized
    # block r and sums their dequantized values exactly in f32.
    q_t = group.all_to_all(q, 0, 0)  # [n, block], row j from member j
    s_t = group.all_to_all(scale, 0, 0)  # [n, 1]
    mine = torch.sum(_dequantize(q_t, s_t), dim=0)  # [block]
    # Leg 2 (all-gather): the member's sum goes back quantized.
    qm, sm = _quantize(mine[None])
    gathered_q = group.all_gather(qm, 0)  # [n, block]
    gathered_s = group.all_gather(sm, 0)  # [n, 1]
    return _dequantize(gathered_q, gathered_s).reshape(-1)


def _lanes_dtype(n):
    return torch.int16 if 127 * n <= 32767 else torch.int32


def quantized_psum_lanes_1d(x, group):
    """The sum over `group` of a flat f32 [L] vector with one shared scale
    per block: values on the int8 grid summed exactly in integer lanes, one
    rounding per element."""
    n = group.size
    blocks = x.reshape(n, -1)
    absmax = torch.amax(blocks.abs(), dim=1, keepdim=True)
    scale = group.all_reduce(absmax.contiguous(), op="max") / 127.0 + _EPS
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    lanes = _lanes_dtype(n)
    q = q.to(lanes).contiguous()
    # Block b's lanes of every member to member b, as bytes.
    mine = group.all_to_all(q.view(torch.int8), 0, 0).view(lanes)
    summed = torch.sum(mine.to(torch.int32), dim=0).to(lanes)  # exact
    gathered = group.all_gather(summed[None].contiguous().view(torch.int8),
                                0).view(lanes)  # [n, block]
    return (gathered.to(torch.float32) * scale).reshape(-1)


def quantized_pmean(leaves, group, collectives="all_to_all"):
    """The mean over `group` of a list of tensors (a gradient's leaves),
    with int8 wire payloads: one f32 vector padded to the group's size, one
    block and scale per member, the leaves' shapes and dtypes restored.
    collectives="all_to_all" is the two-leg int8 wire; "psum_lanes" the
    shared-scale form (the DP x TP step's)."""
    n = group.size
    leaves = list(leaves)
    sizes = [t.numel() for t in leaves]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    total = flat.numel()
    padded = -(-total // n) * n
    if padded != total:
        flat = torch.cat([flat, flat.new_zeros(padded - total)])
    reduce = (quantized_psum_lanes_1d if collectives == "psum_lanes"
              else quantized_psum_1d)
    summed = reduce(flat, group) / n
    out, offset = [], 0
    for t, size in zip(leaves, sizes):
        out.append(summed[offset:offset + size].reshape(t.shape).to(t.dtype))
        offset += size
    return out
