"""Switch-style mixture-of-experts FFN (counterpart of
elasticdl_tpu/layers/moe.py:20-109).

Top-1 routing with a fixed capacity per expert, as the JAX layer does it:
- the router is a float32 Dense(E) over the tokens cast to float32, then a
  softmax and the argmax of the probabilities (the first expert on a tie);
- the Switch load-balancing term E * sum(density * density_proxy);
- capacity max(1, int(capacity_factor * T / E)) with Python's truncation;
- each token's 1-based position in its expert is a cumulative sum over the
  tokens in [B*S] row-major order; a token past its expert's capacity is
  dropped and its output is zero (the caller's residual carries it);
- the gate is the kept token's router probability;
- the expert FFN gelu_tanh(x w_in[e]) w_out[e] in the activation dtype,
  w_in [E, D, H] and w_out [E, H, D], no biases; the output is cast back to
  the input's dtype.

The JAX layer dispatches and combines with one-hot [T, E, C] einsums: at
the flagship's width that is 687 GFLOP per einsum and a 1.34 GB float32
mask per MoE layer. This layer does both by index. The kept tokens are
copied into their slots of [E, C, D] (each slot holds at most one token,
so the one-hot dispatch sum is this copy, exactly), and each slot's output,
times its token's gate, is copied back to its token. The gate is rounded
to the activation dtype first, as the JAX einsum rounds dispatch * gate;
the product of two such values is exact in float32 and is rounded once, as
the einsum's one nonzero term is. Both copies are index_copy, whose
backward is a gather: no atomic adds, and none piling onto one row for the
dropped tokens or the empty slots. `switch_moe_plain` keeps the one-hot
einsums as the tests' plain version.

The routing and the expert products run inside the profiler ranges
ROUTING_RANGE and EXPERTS_RANGE, so a trace can split them out.
"""

import collections

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers import remat
from elasticdl_tpu_torch.layers.init import lecun_normal_

ROUTING_RANGE = "moe_routing"
EXPERTS_RANGE = "moe_expert_products"

# One layer's routing of T = B*S tokens: probs [T, E] float32, expert [T]
# int64, keep [T] bool, slot [T] int64 (expert * capacity + position - 1,
# or E * capacity for a dropped token), gate [T] float32 (0 where dropped),
# aux the load-balancing term (0-d float32).
Routing = collections.namedtuple(
    "Routing", "probs expert keep slot gate aux capacity")


def _capacity(capacity_factor, n_tokens, num_experts):
    return max(1, int(capacity_factor * n_tokens / num_experts))


def route(layer, x):
    """The routing of `layer` (a SwitchMoE) for x [B, S, D]."""
    tokens = x.reshape(-1, x.shape[-1])
    n_tokens, num_experts = tokens.shape[0], layer.num_experts
    capacity = _capacity(layer.capacity_factor, n_tokens, num_experts)
    router = layer.router
    probs = torch.softmax(
        remat.linear(tokens.float(), router.weight, router.bias), dim=-1)
    expert = probs.argmax(dim=-1)
    # The one-hot choice as [E, T]: the running count per expert is then a
    # scan along the contiguous axis. Along T in [T, E] it is a scan over
    # the outer dimension, a thread per expert: the slowest kernel of the
    # routing by far (PERF.md, section 6).
    hot = expert[None, :] == torch.arange(num_experts,
                                          device=expert.device)[:, None]
    density = hot.float().mean(1)
    aux = num_experts * torch.sum(density * probs.mean(0))
    position = torch.cumsum(hot, dim=1, dtype=torch.int32).gather(
        0, expert[None, :])[0]
    keep = position <= capacity
    slot = torch.where(keep, expert * capacity + position - 1,
                       num_experts * capacity)
    gate = probs.gather(1, expert[:, None])[:, 0] * keep
    return Routing(probs, expert, keep, slot, gate, aux, capacity)


class SwitchMoE(nn.Module):
    """Top-1 routed expert FFN: forward(x [B, S, D]) -> (output [B, S, D],
    aux_loss). Add aux_loss to the task loss scaled by ~1e-2."""

    def __init__(self, d_model, num_experts, d_hidden, capacity_factor=1.25,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.compute_dtype = dtype
        # float32 parameters and float32 inputs: flax's Dense(dtype=float32).
        self.router = nn.Linear(d_model, num_experts)
        self.w_in = nn.Parameter(torch.empty(num_experts, d_model, d_hidden))
        self.w_out = nn.Parameter(torch.empty(num_experts, d_hidden, d_model))

    @torch.no_grad()
    def init_flax(self, generator):
        """flax's lecun_normal on the [E, ...] expert weights, where
        variance scaling folds the leading expert axis into the fan-in
        (E * D for w_in, E * H for w_out). The router is an nn.Linear, which
        the model's initializer reaches on its own."""
        for w in (self.w_in, self.w_out):
            lecun_normal_(w, w.shape[0] * w.shape[1], generator)

    def forward(self, x):
        dtype = self.compute_dtype
        b, s, d = x.shape
        n_tokens = b * s
        with torch.profiler.record_function(ROUTING_RANGE):
            r = route(self, x)
            n_slots = self.num_experts * r.capacity
            # slot -> token (n_tokens where the slot stays empty), the
            # inverse of r.slot on the kept tokens.
            token_of_slot = torch.full(
                (n_slots + 1,), n_tokens, dtype=torch.int64,
                device=x.device).scatter_(
                0, r.slot, torch.arange(n_tokens, device=x.device))[:n_slots]
            # Copies by index, each token to its slot; dropped tokens all
            # land in the extra row n_slots, cut off. Their backward is a
            # gather: no atomics.
            expert_in = _to_slots(x.reshape(n_tokens, d).to(dtype), r.slot,
                                  n_slots)
            gate = _to_slots(r.gate, r.slot, n_slots)
        with torch.profiler.record_function(EXPERTS_RANGE):
            h = remat.bmm(expert_in.view(self.num_experts, r.capacity, d),
                          self.w_in.to(dtype))
        h = F.gelu(h, approximate="tanh")
        with torch.profiler.record_function(EXPERTS_RANGE):
            expert_out = remat.bmm(h, self.w_out.to(dtype))
        with torch.profiler.record_function(ROUTING_RANGE):
            weighted = (expert_out.reshape(n_slots, d).float()
                        * gate.to(dtype).float()[:, None]).to(dtype)
            # Each slot's output back to its token; empty slots land in
            # the extra row n_tokens, cut off, and dropped tokens stay 0.
            out = _to_slots(weighted, token_of_slot, n_tokens)
        return out.reshape(b, s, d).to(x.dtype), r.aux


def _to_slots(values, index, n):
    """Rows of `values` copied to rows `index` of n + 1 zero rows, row n
    cut off: index n marks a row to drop."""
    return values.new_zeros(n + 1, *values.shape[1:]).index_copy(
        0, index, values)[:n]


def switch_moe_plain(layer, x):
    """The JAX layer's one-hot [T, E, C] dispatch and combine einsums on
    `layer`'s weights: the plain version of SwitchMoE.forward."""
    dtype = layer.compute_dtype
    b, s, d = x.shape
    r = route(layer, x)
    pos_idx = torch.where(r.keep, r.slot - r.expert * r.capacity, 0)
    dispatch = (F.one_hot(r.expert, layer.num_experts).float()
                * r.keep[:, None])[:, :, None] * F.one_hot(
        pos_idx, r.capacity).float()[:, None, :]
    tokens = x.reshape(-1, d)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype),
                             tokens.to(dtype))
    h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, layer.w_in.to(dtype)),
               approximate="tanh")
    expert_out = torch.einsum("ech,ehd->ecd", h, layer.w_out.to(dtype))
    combined = torch.einsum(
        "tec,ecd->td", (dispatch * r.gate[:, None, None]).to(dtype),
        expert_out)
    return combined.reshape(b, s, d).to(x.dtype), r.aux


class ExpertParallelMoE(nn.Module):
    """One model-axis shard of a SwitchMoE (expert parallelism, the
    counterpart of elasticdl_tpu/layers/moe.py's moe_param_specs under
    the model axis): it holds experts [rank * E / mp, (rank + 1) * E / mp)
    and the replicated router. The tokens are replicated over the group:
    every shard computes the same routing, capacity and drops, runs the
    kept tokens of its own experts, and the combine is summed over the
    group (each token has one expert, so the sum is exact). The tokens and
    gates enter the shard's experts through copy_to, so the router and
    everything before it get the whole gradient on every shard."""

    def __init__(self, layer, group):
        super().__init__()
        if layer.num_experts % group.size:
            raise ValueError(
                f"num_experts {layer.num_experts} not divisible by the "
                f"model axis ({group.size})")
        self.num_experts = layer.num_experts
        self.capacity_factor = layer.capacity_factor
        self.compute_dtype = layer.compute_dtype
        self.group = group
        self.router = layer.router
        local = layer.num_experts // group.size
        self.first = group.rank * local
        self.w_in = nn.Parameter(torch.empty(local, *layer.w_in.shape[1:]))
        self.w_out = nn.Parameter(torch.empty(local, *layer.w_out.shape[1:]))

    def forward(self, x):
        from elasticdl_tpu_torch.parallel.collectives import (
            copy_to,
            reduce_from,
        )

        dtype = self.compute_dtype
        b, s, d = x.shape
        n_tokens = b * s
        local = self.w_in.shape[0]
        with torch.profiler.record_function(ROUTING_RANGE):
            r = route(self, x)
            n_slots = local * r.capacity
            mine = r.keep & (r.expert >= self.first) & (
                r.expert < self.first + local)
            slot = torch.where(mine, r.slot - self.first * r.capacity,
                               n_slots)
            token_of_slot = torch.full(
                (n_slots + 1,), n_tokens, dtype=torch.int64,
                device=x.device).scatter_(
                0, slot, torch.arange(n_tokens, device=x.device))[:n_slots]
            tokens = copy_to(x, self.group).reshape(n_tokens, d)
            expert_in = _to_slots(tokens.to(dtype), slot, n_slots)
            gate = _to_slots(copy_to(r.gate, self.group), slot, n_slots)
        with torch.profiler.record_function(EXPERTS_RANGE):
            h = remat.bmm(expert_in.view(local, r.capacity, d),
                          self.w_in.to(dtype))
        h = F.gelu(h, approximate="tanh")
        with torch.profiler.record_function(EXPERTS_RANGE):
            expert_out = remat.bmm(h, self.w_out.to(dtype))
        with torch.profiler.record_function(ROUTING_RANGE):
            weighted = (expert_out.reshape(n_slots, d).float()
                        * gate.to(dtype).float()[:, None]).to(dtype)
            out = reduce_from(_to_slots(weighted, token_of_slot, n_tokens),
                              self.group)
        return out.reshape(b, s, d).to(x.dtype), r.aux
