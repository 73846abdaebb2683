"""Static schedule tables for interleaved 1F1B pipeline parallelism (a copy
of elasticdl_tpu/parallel/pipeline_schedule.py: numpy only, the same
tables and buffer sizes; the port keeps its own copy).

Megatron-style interleaving (virtual pipeline stages): the layer stack is
split into n_stages * v chunks, device d hosting chunks {d, d+N, d+2N, ...}
— so a microbatch's chunk-to-chunk hops are ALWAYS to the next device in
the ring, and the warmup/drain bubble shrinks by ~v because a device can
start chunk r+1 work while chunk r's later microbatches are still
upstream.

Everything is decided ahead of the step: a greedy list-scheduler walks the
F(c,m)/B(c,m) dependency DAG (fwd needs the previous chunk's output from
an earlier tick; bwd needs the next chunk's gradient from an earlier tick
plus its own stashed input; the last chunk's bwd may share its fwd's
tick) and emits per-(tick, device) slot tables that the interleaved
schedule (pipeline_interleaved.py) reads. Ticks are PAIRED slots — one
fwd + one bwd per device per tick — matching the 1F1B steady state where
a device alternates F and B at full utilization.

The scheduler also sizes the runtime buffers exactly: mailbox slots for
in-flight messages (tagged by global slot id modulo capacity, collision-
checked here) and the per-chunk input stash depth.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule:
    n_stages: int
    v: int  # chunks per device
    num_micro: int
    ticks: int
    # [ticks, n_stages] int32 tables; -1 = idle slot. Chunk indices are
    # GLOBAL (0..n*v-1); the kernel derives the local param row c // n.
    fwd_chunk: np.ndarray
    fwd_micro: np.ndarray
    bwd_chunk: np.ndarray
    bwd_micro: np.ndarray
    # [ticks] int32: microbatch whose LAST-chunk forward completes this
    # tick (-1 = none) — drives the vocab-parallel head on every device.
    head_micro: np.ndarray
    # Exact runtime buffer sizes derived from the committed schedule.
    fwd_mailbox: int
    bwd_mailbox: int
    stash_depth: int
    dy_store: int  # last-chunk dy slots (head tick -> its bwd tick)

    @property
    def total_chunks(self):
        return self.n_stages * self.v


def build_interleaved_schedule(n_stages, v, num_micro):
    """Greedy paired-slot schedule. Deterministic; O(ticks * chunks)."""
    n, m_total = n_stages, num_micro
    total = n * v
    f_done = -np.ones((total, m_total), np.int64)  # tick fwd completed
    b_done = -np.ones((total, m_total), np.int64)

    def device_of(c):
        return c % n

    fwd_rows, bwd_rows = [], []
    fm_rows, bm_rows = [], []
    t = 0
    # Safety valve well above any legal schedule length.
    max_ticks = 4 * v * (m_total + 2 * n)
    while (f_done < 0).any() or (b_done < 0).any():
        if t >= max_ticks:
            raise RuntimeError(
                f"interleaved scheduler did not converge "
                f"(N={n}, v={v}, M={m_total})"
            )
        fwd_row = -np.ones(n, np.int64)
        fm_row = -np.ones(n, np.int64)
        bwd_row = -np.ones(n, np.int64)
        bm_row = -np.ones(n, np.int64)
        # ---- fwd slots: ready = prev chunk done at an EARLIER tick ----
        for d in range(n):
            best = None
            for c in range(d, total, n):
                for m in range(m_total):
                    if f_done[c, m] >= 0:
                        continue
                    if c > 0 and not (0 <= f_done[c - 1, m] < t):
                        continue
                    # Megatron interleaved order: cycle chunks in
                    # microbatch GROUPS of N (device d runs chunk r for N
                    # microbatches, then chunk r+1 for the same group...)
                    # — this is what lets later chunks start while the
                    # group's peers are still upstream, shrinking warmup
                    # by ~v.
                    key = (m // n, c, m)
                    if best is None or key < best[0]:
                        best = (key, c, m)
                    break  # first undone m for this chunk is the candidate
            if best is not None:
                _, c, m = best
                fwd_row[d] = c
                fm_row[d] = m
        # ---- bwd slots: ready = next chunk's bwd done earlier AND own
        # fwd done (same tick allowed only for the LAST chunk, whose dy
        # is produced by the fwd slot just above it) ----
        for d in range(n):
            best = None
            for c in range(d, total, n):
                for m in range(m_total):
                    if b_done[c, m] >= 0:
                        continue
                    if c == total - 1:
                        own_f = f_done[c, m]
                        # Set this tick by the fwd row above?
                        if own_f < 0 and fwd_row[d] == c and fm_row[d] == m:
                            own_f = t
                        if not (0 <= own_f <= t):
                            continue
                    else:
                        if not (0 <= f_done[c, m] < t):
                            continue
                        if not (0 <= b_done[c + 1, m] < t):
                            continue
                    # Mirror of the fwd order: drain deepest chunks of
                    # the oldest microbatch group first.
                    key = (m // n, -c, m)
                    if best is None or key < best[0]:
                        best = (key, c, m)
                    break
            if best is not None:
                _, c, m = best
                bwd_row[d] = c
                bm_row[d] = m
        # Commit the tick.
        for d in range(n):
            if fwd_row[d] >= 0:
                f_done[fwd_row[d], fm_row[d]] = t
            if bwd_row[d] >= 0:
                b_done[bwd_row[d], bm_row[d]] = t
        fwd_rows.append(fwd_row)
        fm_rows.append(fm_row)
        bwd_rows.append(bwd_row)
        bm_rows.append(bm_row)
        t += 1

    ticks = t
    fwd_chunk = np.stack(fwd_rows)
    fwd_micro = np.stack(fm_rows)
    bwd_chunk = np.stack(bwd_rows)
    bwd_micro = np.stack(bm_rows)
    last_dev = device_of(total - 1)
    head_micro = np.where(
        fwd_chunk[:, last_dev] == total - 1,
        fwd_micro[:, last_dev],
        -1,
    )

    # ---- buffer sizing (exact, from the committed schedule) ----
    # fwd message for F(c,m) (c>0): sent end of f_done[c-1,m], consumed
    # at f_done[c,m]; in the mailbox during (send, consume]. Tag id =
    # c*m_total + m; capacity must avoid two LIVE messages sharing
    # id % capacity at the same receiving device.
    def size_mailbox(producer_done, consumer_done, pairs):
        cap = 1
        while True:
            ok = True
            live = {}
            for (c, m) in pairs:
                send = producer_done(c, m)
                recv = consumer_done(c, m)
                tag = (c * m_total + m) % cap
                dev = device_of(c)
                live.setdefault((dev, tag), []).append((send, recv))
            for intervals in live.values():
                intervals.sort()
                for (s1, r1), (s2, r2) in zip(intervals, intervals[1:]):
                    if s2 < r1:  # overlapping lifetimes share a slot
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                return cap
            cap += 1

    fwd_pairs = [
        (c, m) for c in range(1, total) for m in range(m_total)
    ]
    bwd_pairs = [
        (c, m) for c in range(0, total - 1) for m in range(m_total)
    ]
    fwd_mailbox = size_mailbox(
        lambda c, m: f_done[c - 1, m], lambda c, m: f_done[c, m],
        fwd_pairs,
    )
    bwd_mailbox = size_mailbox(
        lambda c, m: b_done[c + 1, m], lambda c, m: b_done[c, m],
        bwd_pairs,
    )
    # Stash: input of F(c,m) lives until B(c,m); per local chunk, keyed by
    # m % depth. Sized by the same exact modulo-collision check as the
    # mailboxes/dy_store — not a max-overlap heuristic, whose sufficiency
    # would silently depend on the scheduler processing each chunk's
    # microbatches strictly in order. Inclusive same-tick rule: the fwd
    # write of one microbatch and the bwd read of another land mid-tick,
    # so a shared slot on the same tick is a collision.
    def _stash_collides(depth):
        for c in range(total):
            by_slot = {}
            for m in range(m_total):
                by_slot.setdefault(m % depth, []).append(
                    (f_done[c, m], b_done[c, m])
                )
            for intervals in by_slot.values():
                intervals.sort()
                for (s1, r1), (s2, r2) in zip(intervals, intervals[1:]):
                    if s2 <= r1:
                        return True
        return False

    depth = 1
    while _stash_collides(depth):
        depth += 1
    # dy for the last chunk's bwd: produced by the head at the last
    # chunk's fwd tick, consumed at its bwd tick (same tick allowed);
    # keyed m % dy_store.
    dy_cap = 1
    c_last = total - 1
    while True:
        ok = True
        by_slot = {}
        for m in range(m_total):
            by_slot.setdefault(m % dy_cap, []).append(
                (f_done[c_last, m], b_done[c_last, m])
            )
        for intervals in by_slot.values():
            intervals.sort()
            for (s1, r1), (s2, r2) in zip(intervals, intervals[1:]):
                # The kernel writes dy MID-tick (head slot) before the
                # bwd read, so a same-tick produce/consume pair on one
                # slot would overwrite first: inclusive overlap, unlike
                # the end-of-tick mailbox writes above.
                if s2 <= r1:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            break
        dy_cap += 1
    return InterleavedSchedule(
        n_stages=n,
        v=v,
        num_micro=m_total,
        ticks=ticks,
        fwd_chunk=fwd_chunk.astype(np.int32),
        fwd_micro=fwd_micro.astype(np.int32),
        bwd_chunk=bwd_chunk.astype(np.int32),
        bwd_micro=bwd_micro.astype(np.int32),
        head_micro=head_micro.astype(np.int32),
        fwd_mailbox=int(fwd_mailbox),
        bwd_mailbox=int(bwd_mailbox),
        stash_depth=int(depth),
        dy_store=int(dy_cap),
    )
