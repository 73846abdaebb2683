"""Step-synchronized task leases: dynamic data sharding for worlds that
step in lockstep (counterpart of elasticdl_tpu/master/step_lease.py, a
copy).

A world of ranks that all-reduce every step cannot take ragged step
counts: every rank runs the same number of steps, or a collective waits
forever for a rank that stopped. This manager reconciles dynamic sharding
with that constraint by leasing work to the WHOLE world at once:

- A lease pops TRAINING tasks from the dispatcher (attributed to a
  synthetic owner id), splits their record space into contiguous per-rank
  sub-ranges, and fixes one shared `n_steps` — every rank runs exactly
  n_steps minibatches, cycling its own records to fill the tail.
- The underlying tasks complete only when EVERY rank of the lease's world
  reports success; a failure report or a membership-epoch bump aborts the
  lease and requeues its tasks (`TaskDispatcher.recover_tasks` on the
  synthetic owner), as a dead worker's tasks recover. Re-running a
  partially-trained lease matches the semantics for interrupted tasks.

Epoch observation is lazy: every lease_steps/report_lease call compares the
membership's current group_id with the active lease's epoch — no extra
threads, no callbacks.
"""

import threading

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("master.step_lease")

_LEASES = default_registry().counter(
    "edl_leases_total",
    "Step-lease lifecycle transitions",
    labelnames=("event",),
)

# Dispatcher owner ids for leases live far below real worker ids so the
# watchdog/instance-manager recovery paths can tell them apart.
_OWNER_BASE = -1000


def lease_owner_id(lease_id):
    return _OWNER_BASE - lease_id


def is_lease_owner(worker_id):
    return worker_id <= _OWNER_BASE


class _Lease:
    def __init__(self, lease_id, epoch, world, batch_size):
        self.id = lease_id
        self.epoch = epoch
        self.world = world
        self.batch_size = batch_size
        self.n_steps = 0
        self.rank_ranges = [[] for _ in range(world)]
        self.task_ids = []
        self.reported = set()  # ranks that reported success


class StepLeaseManager:
    def __init__(self, task_dispatcher, membership, target_steps=8):
        """target_steps: aim for this many steps per lease per rank — the
        granularity of elasticity (membership changes apply at lease
        boundaries, or mid-lease via collective failure)."""
        self._task_d = task_dispatcher
        self._membership = membership
        self._target_steps = max(1, target_steps)
        self._lock = threading.Lock()
        self._active = None
        self._next_lease_id = 1

    # ---------- RPC entry points ----------

    def lease_steps(self, worker_id, worker_host, batch_size):
        """Returns a pb.LeaseStepsResponse for this worker."""
        rank, world, epoch, _, _ = self._membership.get_comm_rank(
            worker_host
        )
        with self._lock:
            self._abort_if_stale_locked(epoch)
            if rank < 0 or world <= 0:
                # Not registered in the group yet: the caller registers via
                # report_worker_liveness and retries.
                return pb.LeaseStepsResponse(
                    status=pb.LeaseStepsResponse.WAIT
                )
            if self._active is None:
                self._mint_locked(epoch, world, max(1, batch_size))
            if self._active is None:
                # FINISHED only when no training work can ever reappear;
                # evaluation/train-end tasks drain through the regular
                # task loop after the lease loop exits.
                status = (
                    pb.LeaseStepsResponse.FINISHED
                    if self._task_d.training_exhausted()
                    else pb.LeaseStepsResponse.WAIT
                )
                return pb.LeaseStepsResponse(status=status)
            lease = self._active
            if rank in lease.reported:
                # This rank already ran the active lease; peers are still
                # working. Handing the same lease back would double-run it.
                return pb.LeaseStepsResponse(
                    status=pb.LeaseStepsResponse.WAIT
                )
            res = pb.LeaseStepsResponse(
                status=pb.LeaseStepsResponse.OK,
                lease_id=lease.id,
                epoch=lease.epoch,
                rank=rank,
                world_size=lease.world,
                n_steps=lease.n_steps,
            )
            for shard, start, end in lease.rank_ranges[rank]:
                res.ranges.append(
                    pb.LeaseRange(shard_name=shard, start=start, end=end)
                )
            _LEASES.labels(event="grant").inc()
            emit_event(
                "lease_grant",
                lease_id=lease.id,
                epoch=lease.epoch,
                rank=rank,
                worker=worker_id,
                n_steps=lease.n_steps,
            )
            return res

    def report_lease(self, lease_id, rank, success, err_message=""):
        complete = False
        with self._lock:
            self._abort_if_stale_locked(self._membership.group_id)
            lease = self._active
            if lease is None or lease.id != lease_id:
                # A stale report for an aborted/completed lease: its tasks
                # were already requeued (or completed); nothing to do.
                logger.info(
                    "Ignoring report for non-active lease %d (rank %d)",
                    lease_id,
                    rank,
                )
                return
            _LEASES.labels(event="report").inc()
            emit_event(
                "lease_report",
                lease_id=lease_id,
                rank=rank,
                success=success,
            )
            if not success:
                logger.warning(
                    "Lease %d failed on rank %d (%s); requeueing its tasks",
                    lease_id,
                    rank,
                    err_message,
                )
                # Fault-attributed abort: tasks pass through the retry
                # ladder so a deterministic failure (corrupt range, bad
                # feed) fails the job after max retries instead of
                # re-minting the same doomed lease forever. Epoch-change
                # aborts stay free (a worker death is not the data's
                # fault).
                self._abort_locked(penalize=True, err_message=err_message)
                return
            lease.reported.add(rank)
            if len(lease.reported) >= lease.world:
                for tid in lease.task_ids:
                    self._task_d.report(tid, True)
                logger.info(
                    "Lease %d complete (%d ranks, %d tasks)",
                    lease.id,
                    lease.world,
                    len(lease.task_ids),
                )
                _LEASES.labels(event="complete").inc()
                emit_event(
                    "lease_complete",
                    lease_id=lease.id,
                    world=lease.world,
                    tasks=len(lease.task_ids),
                )
                self._active = None
                complete = True
        return complete

    # ---------- internals ----------

    def _abort_if_stale_locked(self, epoch):
        if self._active is not None and self._active.epoch != epoch:
            logger.info(
                "Membership epoch %d != lease epoch %d; aborting lease %d",
                epoch,
                self._active.epoch,
                self._active.id,
            )
            self._abort_locked()

    def _abort_locked(self, penalize=False, err_message=""):
        lease = self._active
        self._active = None
        if lease is None:
            return
        _LEASES.labels(event="abort").inc()
        emit_event(
            "lease_abort",
            lease_id=lease.id,
            epoch=lease.epoch,
            penalized=penalize,
            error=err_message[:200],
        )
        owner = lease_owner_id(lease.id)
        if penalize:
            self._task_d.fail_owner_tasks(owner, err_message)
        else:
            self._task_d.recover_tasks(owner)

    def _mint_locked(self, epoch, world, batch_size):
        """Pop training tasks covering ~target_steps * world * batch
        records and split them into per-rank contiguous sub-ranges."""
        lease_id = self._next_lease_id
        owner = lease_owner_id(lease_id)
        want = self._target_steps * world * batch_size
        tasks = []  # (task_id, _Task)
        got = 0
        while got < want:
            task_id, task = self._task_d.get_typed(owner, pb.TRAINING)
            if task is None:
                break
            tasks.append((task_id, task))
            got += task.end - task.start
        if not tasks:
            return
        self._next_lease_id += 1
        lease = _Lease(lease_id, epoch, world, batch_size)
        lease.task_ids = [tid for tid, _ in tasks]

        # Split the concatenated record space into `world` contiguous
        # chunks (first `extra` ranks get one more record).
        base, extra = divmod(got, world)
        quotas = [base + (1 if r < extra else 0) for r in range(world)]
        rank = 0
        for _, task in tasks:
            pos = task.start
            while pos < task.end:
                while rank < world and quotas[rank] == 0:
                    rank += 1
                if rank >= world:  # only when got < world left ranks empty
                    break
                take = min(task.end - pos, quotas[rank])
                lease.rank_ranges[rank].append(
                    (task.shard_name, pos, pos + take)
                )
                quotas[rank] -= take
                pos += take
        # Fewer records than ranks: empty ranks re-train the head of the
        # lease (cyclic duplication — the same reweighting the batch
        # padder applies, so every rank still holds real data).
        first = lease.rank_ranges[0] or [
            (tasks[0][1].shard_name, tasks[0][1].start,
             tasks[0][1].start + 1)
        ]
        for r in range(world):
            if not lease.rank_ranges[r]:
                lease.rank_ranges[r] = [first[0]]
        per_rank = max(
            sum(e - s for _, s, e in ranges)
            for ranges in lease.rank_ranges
        )
        lease.n_steps = max(1, -(-per_rank // batch_size))
        self._active = lease
        _LEASES.labels(event="mint").inc()
        emit_event(
            "lease_mint",
            lease_id=lease.id,
            epoch=epoch,
            world=world,
            tasks=len(tasks),
            records=got,
            n_steps=lease.n_steps,
        )
        logger.info(
            "Minted lease %d: epoch %d, world %d, %d tasks (%d records), "
            "%d steps x batch %d per rank",
            lease.id,
            epoch,
            world,
            len(tasks),
            got,
            lease.n_steps,
            batch_size,
        )
