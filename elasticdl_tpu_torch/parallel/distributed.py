"""One process group per membership epoch (counterpart of
elasticdl_tpu/parallel/distributed.py).

The JAX package re-initializes jax.distributed, a process-wide world,
whenever the membership epoch moves. The port keeps the world in an object
the trainer owns instead: `World.ensure_world` builds a
`torch.distributed.ProcessGroupGloo` over a `PrefixStore("epoch<e>/",
TCPStore(...))` whose server rank 0 hosts at the epoch's rotated
coordinator port, and drops it again on the next regroup. Nothing calls
`init_process_group`, so there is no global default group: an elastic
teardown needs no `destroy_process_group`, and several worlds can live in
one process (the tests run a world of ranks as threads).

The collectives run on gloo (`collective_backend`): the card's machine has
one GPU, and NCCL does not put two ranks on one GPU. A CUDA tensor is
staged explicitly through a pinned host buffer around the gloo call
(device-to-host, gloo, host-to-device), and the world counts the seconds
and bytes of each leg. NCCL with one GPU per rank is later work (ROADMAP).

The shards of one process (parallel/shards.py) talk over AxisGroups: one
gloo group per model or seq group of the world's layout, over an
in-process HashStore, built with the world and dropped with it
(`join_axis_group`), staged and counted as above.

Timeouts are the JAX module's: the rendezvous store waits at most
INITIALIZATION_TIMEOUT_SECONDS, and the group's connection and every
collective at most HEARTBEAT_TIMEOUT_SECONDS, so a survivor whose peer
died mid-collective gets a RuntimeError (at once when the peer's socket
closes, as a SIGKILL closes it) instead of gloo's default 30 minutes.
Leaving a world waits on nobody, so the JAX module's shutdown-barrier
timeout has no counterpart.
"""

import datetime
import threading
import time

import torch

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("parallel.distributed")

INITIALIZATION_TIMEOUT_SECONDS = 120
HEARTBEAT_TIMEOUT_SECONDS = 60

# Collectives move flat buffers of at most this many bytes.
BUCKET_BYTES = 256 << 20


def collective_backend():
    """The process-group backend: gloo for every device for now (the
    card's machine has one GPU, and NCCL refuses two ranks on one GPU).
    NCCL with one GPU per rank is ROADMAP work."""
    return "gloo"


def _buckets(tensors, max_bytes=BUCKET_BYTES):
    """Consecutive runs of same-dtype tensors of at most max_bytes each (a
    tensor larger than that is a bucket of its own)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype
                       or size + nbytes > max_bytes):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


class CommStats:
    """Seconds and bytes of the collectives since the last reset, split
    into device-to-host, gloo and host-to-device legs. The shards of one
    process add to one instance per axis from their threads (`add`).
    `bytes` is what the calls hand to gloo; `wire` what one member sends
    under the ring model (`wire_bytes`), the measure on which an int8
    reduction and an f32 all-reduce compare."""

    __slots__ = ("d2h_s", "gloo_s", "h2d_s", "bytes", "wire", "calls",
                 "_lock")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.d2h_s = self.gloo_s = self.h2d_s = 0.0
            self.bytes = self.wire = self.calls = 0

    def add(self, d2h_s, gloo_s, h2d_s, nbytes, wire=0):
        with self._lock:
            self.d2h_s += d2h_s
            self.gloo_s += gloo_s
            self.h2d_s += h2d_s
            self.bytes += nbytes
            self.wire += wire
            self.calls += 1

    def as_dict(self):
        return {name: getattr(self, name) for name in self.__slots__
                if not name.startswith("_")}


def wire_bytes(kind, nbytes, size):
    """Bytes one member of `size` sends for a collective over `nbytes` of
    its input, by the ring model: an all-reduce moves each byte out twice
    (reduce-scatter, then all-gather: 2(n-1)/n), an all-to-all keeps 1/n
    at home, an all-gather sends its input to n-1 members (ring-relayed),
    a reduce-scatter (n-1)/n, a broadcast or a send its input once."""
    n = max(1, int(size))
    share = {"all_reduce": 2 * (n - 1) / n, "all_to_all": (n - 1) / n,
             "reduce_scatter": (n - 1) / n, "all_gather": n - 1}.get(
        kind, 1)
    return int(nbytes * share)


class World:
    """The process group of this rank's current membership epoch."""

    def __init__(self, local_host="127.0.0.1"):
        self._local_host = local_host
        self._store = None
        self._group = None
        self._lock = threading.Lock()
        self.coordinator = None
        self.size = 1
        self.rank = 0
        self.epoch = -1
        # Set when a collective of the current group failed (a peer died,
        # or timed out): the group can no longer run one.
        self.broken = False
        self.stats = CommStats()
        self._pinned = {}  # (dtype, numel) -> pinned host buffer

    def is_live(self):
        """True while this rank is a member of a live multi-rank group: a
        world change then tears the group down (the fast regroup keys on
        the negation)."""
        return self._group is not None

    def ensure_world(self, coordinator_addr, world_size, rank, epoch=None):
        """(Re)join the world of the triple. A no-op only when already a
        member of it AT THIS epoch: a survivor's (coordinator, size, rank)
        can be unchanged across a swap (B dies, C joins) while the
        newcomer still needs a fresh rendezvous. world_size <= 1 leaves
        any group and runs alone."""
        same = (
            self.is_live()
            and self.coordinator == coordinator_addr
            and self.size == world_size
            and self.rank == rank
            and epoch is not None
            and self.epoch == epoch
        )
        if same:
            return
        self.leave_world()
        if world_size <= 1:
            self.coordinator, self.size, self.rank = None, 1, 0
            self.epoch = epoch
            return
        host, port = coordinator_addr.rsplit(":", 1)
        logger.info(
            "Joining world coordinator=%s size=%d rank=%d epoch=%s "
            "backend=%s", coordinator_addr, world_size, rank, epoch,
            collective_backend())
        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=INITIALIZATION_TIMEOUT_SECONDS)
        # Rank 0 serves the store; the others connect to it, retrying
        # until the rendezvous timeout.
        store = dist.TCPStore(host, int(port), world_size, rank == 0,
                              timeout, wait_for_workers=False)
        options = dist.ProcessGroupGloo._Options()
        options._devices = [
            dist.ProcessGroupGloo.create_device(hostname=self._local_host)]
        # The store waits for the rendezvous; the group's own timeout
        # bounds its connection and every collective.
        options._timeout = datetime.timedelta(
            seconds=HEARTBEAT_TIMEOUT_SECONDS)
        group = dist.ProcessGroupGloo(
            dist.PrefixStore(f"epoch{epoch}/", store), rank, world_size,
            options)
        with self._lock:
            self._store, self._group = store, group
            self.coordinator, self.size, self.rank = (
                coordinator_addr, world_size, rank)
            self.epoch = epoch

    def leave_world(self):
        """Drops the group (and, on rank 0, the store it serves). Nothing
        waits on the peers: after a peer's death no shutdown barrier could
        complete."""
        with self._lock:
            group, self._group, self._store = self._group, None, None
            self.broken = False
        if group is not None:
            logger.info("Leaving world epoch %s (rank %d of %d)",
                        self.epoch, self.rank, self.size)
            del group

    # ---------- collectives ----------

    def _host_buffer(self, flat):
        if flat.device.type != "cuda":
            return flat
        key = (flat.dtype, flat.numel())
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(flat.numel(), dtype=flat.dtype,
                              pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _run(self, tensors, collective, kind):
        """Runs `collective(host_flat)` over every bucket of `tensors`,
        staging CUDA buckets through pinned host buffers, and writes the
        results back into the tensors."""
        for bucket in _buckets(tensors):
            flat = torch.cat([t.reshape(-1) for t in bucket]) \
                if len(bucket) > 1 else bucket[0].reshape(-1)
            host = self._host_buffer(flat)
            staged = host is not flat
            if staged:
                t0 = time.perf_counter()
                host.copy_(flat)
                self.stats.d2h_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                collective(host)
            except RuntimeError:
                self.broken = True
                raise
            self.stats.gloo_s += time.perf_counter() - t0
            nbytes = host.numel() * host.element_size()
            self.stats.bytes += nbytes
            self.stats.wire += wire_bytes(kind, nbytes, self.size)
            self.stats.calls += 1
            t0 = time.perf_counter()
            if staged:
                flat.copy_(host)
            offset = 0
            for t in bucket:
                n = t.numel()
                src = flat[offset:offset + n].view_as(t)
                if src.data_ptr() != t.data_ptr():
                    t.copy_(src)
                offset += n
            if staged:
                torch.cuda.current_stream(flat.device).synchronize()
                self.stats.h2d_s += time.perf_counter() - t0

    def all_reduce_sum_(self, tensors):
        """Sums `tensors` across the world in place (every rank receives
        the same bits)."""
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._run(tensors,
                  lambda host: self._group.allreduce([host], opts).wait(),
                  "all_reduce")

    def broadcast_(self, tensors, src=0):
        """Overwrites `tensors` with rank `src`'s, in place."""
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        self._run(tensors,
                  lambda host: self._group.broadcast([host], opts).wait(),
                  "broadcast")

    def axis_group(self):
        """The world's process group as an AxisGroup over the data axis:
        this rank's member for the collectives that run once per process
        (the quantized reduction, BatchNorm's statistics without shards),
        staged and counted into the world's stats. A world of one gives a
        group of one, whose collectives return their input."""
        return AxisGroup("data", self.rank if self.is_live() else 0,
                         self.size if self.is_live() else 1, self._group,
                         self.stats, on_error=self._mark_broken)

    def _mark_broken(self):
        self.broken = True

    def shard_store(self):
        """A client of the epoch's rendezvous store, under the epoch's
        prefix, for groups among the shards of every process (one client
        per caller: each shard thread connects its own). None outside a
        live world."""
        if not self.is_live():
            return None
        import torch.distributed as dist

        host, port = self.coordinator.rsplit(":", 1)
        store = dist.TCPStore(
            host, int(port), self.size, False,
            datetime.timedelta(seconds=INITIALIZATION_TIMEOUT_SECONDS),
            wait_for_workers=False)
        return dist.PrefixStore(f"epoch{self.epoch}/", store)


# ---------- the intra-process axes: groups among one process's shards ----------


def _op(name):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[name]


class AxisGroup:
    """One shard's member of a group along an intra-process axis (model or
    seq): the shards of this process that differ only in their coordinate
    on the axis, joined by a gloo group over the world's in-process
    HashStore (`join_axis_group`). `rank` is the shard's coordinate on the
    axis. A CUDA tensor is staged through pinned host buffers as `World`
    stages it, and each call adds its legs to the axis's CommStats. A size-1
    axis has no group, and its collectives return their input."""

    def __init__(self, axis, rank, size, group=None, stats=None,
                 on_error=None):
        self.axis = axis
        self.rank = int(rank)
        self.size = int(size)
        self._group = group
        self.stats = stats if stats is not None else CommStats()
        self._pinned = {}
        # Called when a collective fails (the world marks itself broken).
        self._on_error = on_error

    def _host(self, t, slot):
        """`t` on the host: itself on the CPU, else a copy in a pinned
        buffer (one per shape, dtype and argument slot, reused)."""
        if t.device.type != "cuda":
            return t.contiguous()
        key = (t.dtype, tuple(t.shape), slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t)
        return buf

    def _recv(self, like, slot, staged):
        """A host buffer to receive into: pinned and reused (keyed by
        shape, dtype and slot) when the result goes back to the card, a
        fresh tensor on the CPU, where it is the result."""
        if not staged:
            return torch.empty_like(like)
        key = (like.dtype, tuple(like.shape), "recv", slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _timed(self, inputs, run, outputs_like, kind):
        """Stages `inputs` to the host, runs `run(host_inputs)` (the gloo
        call, returning host outputs) and brings the outputs back to the
        device of `outputs_like`, timing each leg."""
        device = outputs_like.device
        t0 = time.perf_counter()
        host_in = [self._host(t, j) for j, t in enumerate(inputs)]
        t1 = time.perf_counter()
        try:
            host_out = run(host_in)
        except RuntimeError:
            if self._on_error is not None:
                self._on_error()
            raise
        t2 = time.perf_counter()
        out = [h.to(device) if device.type == "cuda" else h
               for h in host_out]
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        t3 = time.perf_counter()
        nbytes = sum(h.numel() * h.element_size() for h in host_in)
        self.stats.add(t1 - t0, t2 - t1, t3 - t2, nbytes,
                       wire_bytes(kind, nbytes, self.size))
        return out

    def all_reduce(self, t, op="sum"):
        """The sum (or max) of `t` over the group, a new tensor."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = _op(op)

        def run(host):
            # On the CPU the host tensor is the caller's: reduce a copy.
            buf = host[0].clone() if t.device.type != "cuda" else host[0]
            self._group.allreduce([buf], opts).wait()
            return [buf]

        return self._timed([t], run, t, "all_reduce")[0]

    def all_gather(self, t, dim):
        """The group's tensors concatenated along `dim`, in rank order."""
        if self.size == 1:
            return t

        def run(host):
            outs = [self._recv(host[0], j, t.device.type == "cuda")
                    for j in range(self.size)]
            self._group.allgather([outs], host).wait()
            return outs

        parts = self._timed([t.contiguous()], run, t, "all_gather")
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, t, dim):
        """This member's chunk along `dim` of the group's sum of `t` (gloo's
        reduce-scatter: (n-1)/n of t on the wire, where an all-reduce and a
        slice move twice that)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        # On the CPU gloo gets copies, not views of the caller's tensor.
        chunks = [c.contiguous() if t.device.type == "cuda"
                  else c.clone(memory_format=torch.contiguous_format)
                  for c in t.chunk(self.size, dim=dim)]

        def run(host):
            out = self._recv(host[0], 0, t.device.type == "cuda")
            self._group.reduce_scatter(
                [out], [list(host)], dist.ReduceScatterOptions()).wait()
            return [out]

        return self._timed(chunks, run, t, "reduce_scatter")[0]

    def all_to_all(self, t, split_dim, concat_dim):
        """Chunk j of `t` along split_dim goes to rank j; the chunks
        received are concatenated along concat_dim in rank order."""
        if self.size == 1:
            return t
        chunks = torch.stack(t.chunk(self.size, dim=split_dim)).contiguous()

        def run(host):
            out = self._recv(host[0], 0, t.device.type == "cuda")
            self._group.alltoall_base(out, host[0], [], []).wait()
            return [out]

        out = self._timed([chunks], run, t, "all_to_all")[0]
        return torch.cat(out.unbind(0), dim=concat_dim)

    def exchange(self, tensors, dst, src, tag=0):
        """Sends `tensors` to rank dst and returns those rank src sent
        (a permutation step: every rank calls it with its own dst and
        src). Sending to itself is a copy."""
        if dst == self.rank:
            if src != self.rank:
                raise ValueError("exchange: send to self, receive from "
                                 f"{src}")
            return [t.clone(memory_format=torch.contiguous_format)
                    for t in tensors]

        def run(host):
            staged = tensors[0].device.type == "cuda"
            recv = [self._recv(h, j, staged) for j, h in enumerate(host)]
            works = []
            for j, (h, r) in enumerate(zip(host, recv)):
                works.append(self._group.send([h], dst, tag * 16 + j))
                works.append(self._group.recv([r], src, tag * 16 + j))
            for w in works:
                w.wait()
            return recv

        return self._timed([t.contiguous() for t in tensors], run,
                           tensors[0], "exchange")

    def p2p(self, sends=(), recvs=()):
        """Point-to-point transfers, posted together and then waited on (a
        pipeline's hop): `sends` [(tensor, dst, tag)], `recvs` [(like, src,
        tag)], `like` a tensor of the shape, dtype and device to receive.
        Returns the received tensors in order. Both sides post from the
        same schedule, and the tags pair them whatever each side's order.
        The bytes counted are those this member sends."""
        if not sends and not recvs:
            return []
        like = sends[0][0] if sends else recvs[0][0]
        staged = like.device.type == "cuda"

        def run(host):
            works = [self._group.send([h], dst, tag)
                     for h, (_, dst, tag) in zip(host, sends)]
            out = []
            for j, (r, src, tag) in enumerate(recvs):
                buf = self._recv(r, ("p2p", j), staged)
                works.append(self._group.recv([buf], src, tag))
                out.append(buf)
            for w in works:
                w.wait()
            return out

        return self._timed([t.contiguous() for t, _, _ in sends], run,
                           like, "send")

    def broadcast(self, t, src):
        """Member src's `t` on every member (the others pass a tensor of
        its shape and dtype, whose values are not read)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        root = self.rank == src
        staged = t.device.type == "cuda"

        def run(host):
            if root:
                buf = host[0]
            else:
                buf = self._recv(t, "broadcast", staged)
            self._group.broadcast([buf], opts).wait()
            return [buf]

        return self._timed([t.contiguous()] if root else [], run, t,
                           "broadcast")[0]

    def close(self):
        """Drops the gloo group: members blocked in a collective with this
        one fail at once (its sockets close)."""
        self._group = None

    def shift(self, tensors, tag=0):
        """Ring step: send to rank + 1, receive from rank - 1."""
        return self.exchange(tensors, (self.rank + 1) % self.size,
                             (self.rank - 1) % self.size, tag)


def join_axis_group(store, epoch, axis, key, rank, size, stats=None,
                    local_host="127.0.0.1"):
    """This shard's AxisGroup on `axis`: a ProcessGroupGloo over
    PrefixStore("epoch<e>/<axis><key>/", store). Every member calls it at
    once, from its own thread (gloo connects the members to each other).
    Never the global default group: several worlds and groups live in one
    process."""
    if size <= 1:
        return AxisGroup(axis, 0, 1, None, stats)
    import torch.distributed as dist

    options = dist.ProcessGroupGloo._Options()
    options._devices = [
        dist.ProcessGroupGloo.create_device(hostname=local_host)]
    options._timeout = datetime.timedelta(seconds=HEARTBEAT_TIMEOUT_SECONDS)
    prefix = f"epoch{epoch}/{axis}{'.'.join(map(str, key))}/"
    group = dist.ProcessGroupGloo(
        dist.PrefixStore(prefix, store), int(rank), int(size), options)
    return AxisGroup(axis, rank, size, group, stats)
