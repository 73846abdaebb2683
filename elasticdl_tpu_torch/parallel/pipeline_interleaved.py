"""Interleaved 1F1B pipeline parallelism (virtual pipeline stages;
counterpart of elasticdl_tpu/parallel/pipeline_interleaved.py).

Megatron-style interleaving on top of the 1F1B machinery in pipeline.py:
the Block stack splits into n_stages * v CHUNKS, stage d hosting chunks
{d, d+N, ...}, so every chunk-to-chunk hop still goes to the next stage of
the ring (forward to d+1, gradient to d-1, stage N-1 and stage 0
neighbours). What each tick runs comes from the STATIC schedule tables
(pipeline_schedule.py): per tick each stage runs its table's forward slot
and backward slot, skipping an idle one (JAX masks it). Messages carry
their (chunk, microbatch) in their tag and wait in mailboxes keyed by it;
each local chunk stashes its inputs for the backward, which recomputes the
chunk's forward under autograd; the LM head stays vocab-parallel across
the stage group exactly as in make_lm_pipeline_1f1b. The mailboxes and the
stash never hold more than the schedule sized them for (checked).

Same tree as make_lm_pipeline_1f1b over n*v rows: "stages" in GLOBAL
CHUNK ORDER [n*v, ...], so a checkpoint moves between it and a GPipe or
1F1B build of n*v stages. Stage d's copy holds the rows
interleaved_row_order lists for it (chunk r*N + d as its local row r).
"""

import numpy as np
import torch

from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.parallel.pipeline import (
    StagedLM,
    _activation_like,
    _check_rows,
    _check_vocab,
    _head_slot,
    _require_rng,
    _seed,
    _stage_backward,
    _stage_forward,
    _tag,
    _to_device,
)
from elasticdl_tpu_torch.parallel.pipeline_schedule import (
    build_interleaved_schedule,
)


def interleaved_row_order(n_stages, v):
    """Permutation taking chunk-ordered rows [c] to device-block order:
    position d*v + r holds chunk r*n_stages + d (device d's r-th local
    chunk)."""
    order = []
    for d in range(n_stages):
        for r in range(v):
            order.append(r * n_stages + d)
    return np.asarray(order, np.int32)


def make_lm_pipeline_interleaved(cfg, n_stages, v, num_microbatches):
    """Returns (init_fn, loss_and_grads_fn, stage_rows_fn) over the staged
    tree of n_stages * v rows."""
    total = n_stages * v
    _check_rows(cfg, total, f"{n_stages} stages x {v} chunks")
    _check_vocab(cfg, n_stages, "the head")
    dtype = tlm._dtype(cfg)
    sched = build_interleaved_schedule(n_stages, v, num_microbatches)
    order = interleaved_row_order(n_stages, v)

    def init_fn():
        with torch.device("meta"):
            return StagedLM(cfg, total)

    def stage_rows_fn(stage):
        return [int(c) for c in order[stage * v:(stage + 1) * v]]

    def loss_and_grads_fn(model, tokens, labels, group, rng=None,
                          data_index=0, stats=None):
        _require_rng(cfg, rng)
        n, s = group.size, group.rank
        m_total = num_microbatches
        tokens_mb, labels_mb = _to_device(model, tokens, labels, m_total)
        like = _activation_like(cfg, tokens_mb)
        prev, nxt = (s - 1) % n, (s + 1) % n
        last_dev = (total - 1) % n
        fwd_box, bwd_box, stash, dy_box = {}, {}, {}, {}
        peaks = {"fwd_mailbox": 0, "bwd_mailbox": 0, "stash": 0,
                 "dy_store": 0}
        loss_sum = torch.zeros((), device=tokens_mb.device)

        def seed(c, m):
            return None if rng is None else _seed(rng, c, m, data_index)

        def note(name, box):
            peaks[name] = max(peaks[name], len(box))

        for t in range(sched.ticks):
            # ---------- fwd slot ----------
            fc, fm = int(sched.fwd_chunk[t, s]), int(sched.fwd_micro[t, s])
            y = None
            if fc >= 0:
                r = fc // n
                x_in = None if fc == 0 else fwd_box.pop((fc, fm))
                with torch.no_grad():
                    y = _stage_forward(model, [r], x_in, tokens_mb[fm],
                                       seed(fc, fm))
                stash[(r, fm)] = x_in
                note("stash", stash)
            # ---------- head (vocab-parallel, every stage) ----------
            hm = int(sched.head_micro[t])
            if hm >= 0:
                loss_m, dy = _head_slot(
                    model, y if s == last_dev else None, like,
                    labels_mb[hm], group, 1.0 / m_total, last_dev)
                loss_sum = loss_sum + loss_m / m_total
                if s == last_dev:
                    dy_box[hm] = dy.to(dtype)
                    note("dy_store", dy_box)
            # ---------- bwd slot ----------
            bc, bm = int(sched.bwd_chunk[t, s]), int(sched.bwd_micro[t, s])
            dx = None
            if bc >= 0:
                r = bc // n
                g = (dy_box.pop(bm) if bc == total - 1
                     else bwd_box.pop((bc, bm)))
                dx = _stage_backward(model, [r], stash.pop((r, bm)),
                                     tokens_mb[bm], seed(bc, bm), g)
            # ---------- neighbour hops (message + tag) ----------
            sends, recvs, keys = [], [], []
            if 0 <= fc < total - 1:
                sends.append((y, nxt, _tag(0, fc + 1, fm, m_total)))
            if bc > 0:
                sends.append((dx.to(dtype), prev,
                              _tag(1, bc - 1, bm, m_total)))
            pfc, pfm = (int(sched.fwd_chunk[t, prev]),
                        int(sched.fwd_micro[t, prev]))
            if 0 <= pfc < total - 1:
                recvs.append((like, prev, _tag(0, pfc + 1, pfm, m_total)))
                keys.append((fwd_box, (pfc + 1, pfm)))
            nbc, nbm = (int(sched.bwd_chunk[t, nxt]),
                        int(sched.bwd_micro[t, nxt]))
            if nbc > 0:
                recvs.append((like, nxt, _tag(1, nbc - 1, nbm, m_total)))
                keys.append((bwd_box, (nbc - 1, nbm)))
            for (box, key), value in zip(keys, group.p2p(sends, recvs)):
                box[key] = value
            note("fwd_mailbox", fwd_box)
            note("bwd_mailbox", bwd_box)
        sizes = {"fwd_mailbox": sched.fwd_mailbox,
                 "bwd_mailbox": sched.bwd_mailbox,
                 "stash": v * sched.stash_depth, "dy_store": sched.dy_store}
        over = {k: (peaks[k], sizes[k]) for k in peaks
                if peaks[k] > sizes[k]}
        if over:
            raise RuntimeError(f"interleaved schedule buffers over their "
                               f"sizing (peak, size): {over}")
        if stats is not None:
            stats.update(peaks=peaks, sizes=sizes)
        return loss_sum

    return init_fn, loss_and_grads_fn, stage_rows_fn
