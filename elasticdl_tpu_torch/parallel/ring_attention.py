"""Ring attention: exact attention over sequences sharded across the shards
of a seq axis group (counterpart of elasticdl_tpu/parallel/ring_attention.py).

Each shard holds one sequence block of Q/K/V [B, H, S_local, D]. K/V blocks
travel round the ring (parallel/distributed.py:AxisGroup.shift, gloo),
and every shard runs the flash kernels on each block it may see:
`flash_fwd_lse` gives the block's normalized output and its per-row
log-sum-exp, and the partials merge in float32 by log-sum-exp
(lse = logaddexp(lse1, lse2), each output rescaled by exp(lse_i - lse)).
The JAX module folds (max, sum, acc) triples instead (`_block_attend` and
`_merge`, kept below as the plain version); the two are the same softmax.

The backward pass takes the merged lse and delta = rowsum(dO * O) once,
then runs `flash_dq` and `flash_dkv` on every visible block with them: the
merged lse makes each block's P the global softmax restricted to it. dQ
stays home; each block's dK and dV contributions ride round the ring with
the block and arrive back at its owner after the last step.

Causality uses the GLOBAL block order: the diagonal block is causal, a
block below it is visible, a block above it is skipped. Every launch
takes q, k and v of one shape, which the kernels require.

The zigzag variant (balanced causal ring) gives shard r the half-chunks
(r, 2N-1-r) through the JAX module's permutations (`to_zigzag`,
`from_zigzag`), so every shard runs 2N+1 half-blocks; inputs and outputs
stay contiguously sharded.

On the CPU the flash wrappers run their plain versions, so these functions
run there as they do on the card.
"""

import torch

from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel.collectives import with_backward

NEG_INF = fa.NEG_INF


def seq_axis_demand(context_parallel):
    """Sequence/context parallelism's mesh-axis contribution to world
    resolution (shared by ring attention and ulysses.py — both shard the
    same "seq" axis): intra-process, like model/stage, and the first
    axis the resolver drops when the trailing product stops dividing a
    world (the plain model trains identically without SP)."""
    from elasticdl_tpu_torch.parallel.mesh import SEQ_AXIS, AxisDemand

    return AxisDemand(SEQ_AXIS, int(context_parallel), intra_process=True)


# ---------- the JAX module's dense blockwise math (the plain version) ----------


def _block_attend(q, k, v, scale, mask=None):
    """One blockwise contribution: (m, l, acc) for q against this k/v
    block, in float32. q: [B,H,Sq,D]; k,v: [B,H,Sk,D]."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def _merge(m1, l1, acc1, m2, l2, acc2):
    """Merge two online-softmax partials (the associative combine)."""
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, acc1 * a1[..., None] + acc2 * a2[..., None]


def ring_attention_plain(q, k, v, n_blocks, causal=False):
    """The whole sequence [B, H, S, D] cut into n_blocks ring blocks, each
    q block folding the k/v blocks it may see with _block_attend and
    _merge in float32, as every shard of the JAX ring does: the plain
    version of ring and zigzag attention over a group of n_blocks."""
    scale = q.shape[-1] ** -0.5
    qs, ks, vs = (t.chunk(n_blocks, dim=2) for t in (q, k, v))
    outs = []
    for i, qb in enumerate(qs):
        acc = None
        for j, (kb, vb) in enumerate(zip(ks, vs)):
            if causal and j > i:
                continue
            mask = None
            if causal and j == i:
                n = qb.shape[2]
                mask = torch.ones(n, n, dtype=torch.bool,
                                  device=q.device).tril()
            part = _block_attend(qb, kb, vb, scale, mask)
            acc = part if acc is None else _merge(*acc, *part)
        m, l, a = acc
        outs.append((a / l[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)


# ---------- the kernels' path ----------


def _merge_lse(out, lse, out_b, lse_b):
    """Fold one block's (output, lse) into the running float32 pair."""
    if out is None:
        return out_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)
    out = (out * torch.exp(lse - new)[..., None]
           + out_b.float() * torch.exp(lse_b - new)[..., None])
    return out, new


def _visible(owner, my, causal):
    """(visible, diagonal) of block `owner` for the queries of block my."""
    if not causal or owner < my:
        return True, False
    return owner == my, owner == my


def _delta(g, out):
    return (g.float() * out.float()).sum(-1)


def _ring_forward(q, k, v, group, causal):
    n, my = group.size, group.rank
    out = lse = None
    kb, vb = k, v
    for t in range(n):
        owner = (my - t) % n
        seen, diag = _visible(owner, my, causal)
        if seen:
            o_b, lse_b = fa.flash_fwd(q, kb, vb, diag, emit_lse=True)
            out, lse = _merge_lse(out, lse, o_b, lse_b)
        if t + 1 < n:
            kb, vb = group.shift([kb, vb], tag=t)
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, g, group, causal):
    n, my = group.size, group.rank
    g = g.contiguous()
    delta = _delta(g, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros_like(dkb)
    for t in range(n):
        owner = (my - t) % n
        seen, diag = _visible(owner, my, causal)
        if seen:
            dq += fa.flash_dq(q, kb, vb, g, lse, delta, diag)
            dk_c, dv_c = fa.flash_dkv(q, kb, vb, g, lse, delta, diag)
            dkb += dk_c
            dvb += dv_c
        # The block's dK/dV go on with it; after the last step one more
        # hop brings them home.
        if t + 1 < n:
            kb, vb, dkb, dvb = group.shift([kb, vb, dkb, dvb], tag=t)
        else:
            dkb, dvb = group.shift([dkb, dvb], tag=t)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


def ring_attention(q, k, v, group, causal=False):
    """Exact attention with Q/K/V [B, H, S_local, D] sharded contiguously
    over `group` (an AxisGroup of the seq axis); returns the local output
    block. Differentiable; its backward runs on the calling thread
    (parallel/collectives.py:with_backward)."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    saved = {}

    def forward(q, k, v):
        saved["out"], saved["lse"] = _ring_forward(q, k, v, group, causal)
        return saved["out"]

    def backward(g):
        return _ring_backward(q, k, v, saved["out"], saved["lse"], g,
                              group, causal)

    return with_backward(forward, backward, q, k, v)


# ---------- zigzag variant: balanced causal ring ----------


def _zigzag_routes(n, my):
    """(dst, src) of this shard in the two permutations that move
    half-chunks from the contiguous layout (shard d holds chunks 2d, 2d+1)
    to the zigzag one (chunk c lives on shard c if c < n else 2n-1-c)."""

    def owner(c):
        return c if c < n else 2 * n - 1 - c

    routes = []
    for half in (0, 1):
        dst = owner(2 * my + half)
        src = next(d for d in range(n) if owner(2 * d + half) == my)
        routes.append((dst, src))
    return routes


def _to_zigzag(group, tensors, tag):
    """Contiguous [.., S_local, D] tensors -> (early, late) lists: the
    global chunks (my, 2N-1-my). Chunk my arrives through the permutation
    of my's parity."""
    (dst0, src0), (dst1, src1) = _zigzag_routes(group.size, group.rank)
    half = tensors[0].shape[2] // 2
    a = group.exchange([t[:, :, :half] for t in tensors], dst0, src0, tag)
    b = group.exchange([t[:, :, half:] for t in tensors], dst1, src1,
                       tag + 1)
    return (a, b) if group.rank % 2 == 0 else (b, a)


def _from_zigzag(group, early, late, tag):
    """The inverse of _to_zigzag: lists of (early, late) chunks -> the
    contiguous local blocks."""
    (dst0, src0), (dst1, src1) = _zigzag_routes(group.size, group.rank)
    via0, via1 = (early, late) if group.rank % 2 == 0 else (late, early)
    first = group.exchange(via0, src0, dst0, tag)
    second = group.exchange(via1, src1, dst1, tag + 1)
    return [torch.cat([a, b], dim=2) for a, b in zip(first, second)]


def _zigzag_pairs(owner, my):
    """The (q chunk, k chunk, diagonal) pairs of ring step `owner`: q
    early vs k early below the diagonal, q late vs k early always, q late
    vs k late above it (q early vs k late lies in the future)."""
    pairs = []
    if owner <= my:
        pairs.append(("e", "e", owner == my))
    pairs.append(("l", "e", False))
    if owner >= my:
        pairs.append(("l", "l", owner == my))
    return pairs


def _zigzag_forward(q, k, v, group):
    """-> (the output, what the backward needs)."""
    n, my = group.size, group.rank
    (qe, ke, ve), (ql, kl, vl) = _to_zigzag(group, [q, k, v], 0)
    qs = {"e": qe, "l": ql}
    acc = {"e": (None, None), "l": (None, None)}
    kv = {"e": (ke, ve), "l": (kl, vl)}
    home = (ke, kl, ve, vl)
    for t in range(n):
        owner = (my - t) % n
        for qc, kc, diag in _zigzag_pairs(owner, my):
            o_b, lse_b = fa.flash_fwd(qs[qc], *kv[kc], diag, emit_lse=True)
            acc[qc] = _merge_lse(*acc[qc], o_b, lse_b)
        if t + 1 < n:
            ke_, kl_, ve_, vl_ = group.shift(
                [kv["e"][0], kv["l"][0], kv["e"][1], kv["l"][1]],
                tag=2 + t)
            kv = {"e": (ke_, ve_), "l": (kl_, vl_)}
    oe, ol = (acc[c][0].to(q.dtype) for c in ("e", "l"))
    out = _from_zigzag(group, [oe], [ol], 0)[0]
    return out, (qe, ql, *home, oe, ol, acc["e"][1], acc["l"][1])


def _zigzag_backward(saved, g, group):
    qe, ql, ke, kl, ve, vl, oe, ol, lse_e, lse_l = saved
    n, my = group.size, group.rank
    [ge], [gl] = _to_zigzag(group, [g.contiguous()], 0)
    qs = {"e": qe, "l": ql}
    gs = {"e": ge, "l": gl}
    lses = {"e": lse_e, "l": lse_l}
    deltas = {"e": _delta(ge, oe), "l": _delta(gl, ol)}
    dq = {c: torch.zeros(qs[c].shape, dtype=torch.float32,
                         device=qe.device) for c in "el"}
    kv = {"e": (ke, ve), "l": (kl, vl)}
    dkv = {c: [torch.zeros(ke.shape, dtype=torch.float32, device=ke.device)
               for _ in range(2)] for c in "el"}
    for t in range(n):
        owner = (my - t) % n
        for qc, kc, diag in _zigzag_pairs(owner, my):
            args = (qs[qc], *kv[kc], gs[qc], lses[qc], deltas[qc], diag)
            dq[qc] += fa.flash_dq(*args)
            dk_c, dv_c = fa.flash_dkv(*args)
            dkv[kc][0] += dk_c
            dkv[kc][1] += dv_c
        grads = [dkv["e"][0], dkv["l"][0], dkv["e"][1], dkv["l"][1]]
        if t + 1 < n:
            moved = group.shift(
                [kv["e"][0], kv["l"][0], kv["e"][1], kv["l"][1]] + grads,
                tag=2 + t)
            kv = {"e": (moved[0], moved[2]), "l": (moved[1], moved[3])}
            grads = moved[4:]
        else:
            grads = group.shift(grads, tag=2 + t)
        dkv = {"e": [grads[0], grads[2]], "l": [grads[1], grads[3]]}
    dq_, dk, dv = _from_zigzag(
        group, [dq["e"], dkv["e"][0], dkv["e"][1]],
        [dq["l"], dkv["l"][0], dkv["l"][1]], 0)
    return dq_.to(qe.dtype), dk.to(ke.dtype), dv.to(ve.dtype)


def zigzag_ring_attention(q, k, v, group, causal=True):
    """Balanced causal ring attention; Q/K/V [B, H, S_local, D] sharded
    contiguously over `group`, S_local even. The zigzag relayout is
    internal: inputs/outputs stay contiguously sharded."""
    if not causal:
        return ring_attention(q, k, v, group, causal=False)
    if q.shape[2] % 2:
        raise ValueError(
            f"zigzag ring attention needs an even local sequence, got "
            f"{q.shape[2]}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    saved = {}

    def forward(q, k, v):
        out, saved["state"] = _zigzag_forward(q, k, v, group)
        return out

    return with_backward(
        forward, lambda g: _zigzag_backward(saved["state"], g, group),
        q, k, v)
