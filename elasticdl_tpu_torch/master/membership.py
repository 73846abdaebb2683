"""Elastic membership epochs for the AllReduce path (counterpart of
elasticdl_tpu/master/membership.py, a copy).

The master tracks the set of alive worker hosts; any change bumps
`group_id` (the rendezvous id). Workers poll `get_comm_rank` between steps:
a changed group_id tells them to leave their process group and form the
new one over the new host set (parallel/distributed.py), with rank 0's
state broadcast to the others. Ranks are positions in the time-sorted host
list, so they are stable for survivors.
"""

import threading
import time

from elasticdl_tpu_torch.common.constants import (
    COORDINATOR_PORT_ROTATION as PORT_ROTATION,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import emit_event
from elasticdl_tpu_torch.observability.metrics import default_registry

logger = get_logger("master.membership")

_EPOCH = default_registry().gauge(
    "edl_membership_epoch", "Current AllReduce membership epoch"
)
_WORLD = default_registry().gauge(
    "edl_membership_world_size", "Workers in the current comm group"
)
# Epoch-bookkeeping cost (gauge updates + event emission, under the
# membership lock): at fleet churn rates this is per-event control-plane
# work the master must keep sub-millisecond.
_EPOCH_SECONDS = default_registry().histogram(
    "edl_master_membership_update_seconds",
    "Time spent on membership-epoch bookkeeping per epoch change",
    buckets=(
        0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
        0.1, 0.5, 1.0,
    ),
)


class MembershipManager:
    def __init__(self, coordinator_port=51000):
        self._lock = threading.RLock()
        self._hosts = []  # sorted by join order (pod start time analog)
        self._id_to_host = {}  # worker_id -> registered host
        self._group_id = 0
        self._coordinator_port = coordinator_port
        self._arrivals = {}  # epoch -> set of hosts at the join gate
        self._journal = None  # epoch bumps are journaled

    def attach_journal(self, journal):
        with self._lock:
            self._journal = journal

    def restore_state(self, state):
        """Resume the epoch counter past the journaled high-water mark so
        a relaunched master never re-issues an already-used group_id (the
        coordinator-port rotation and the arrive() gate both key on it)."""
        with self._lock:
            self._group_id = max(
                self._group_id, int(state.get("membership_epoch", 0))
            )
            _EPOCH.set(self._group_id)

    def export_state(self):
        with self._lock:
            return {"membership_epoch": self._group_id}

    def set_worker_hosts(self, hosts):
        """Replace the alive-host set (called by the instance manager on pod
        events). Bumps the group epoch iff membership changed."""
        with self._lock:
            if list(hosts) != self._hosts:
                self._hosts = list(hosts)
                self._group_id += 1
                self._epoch_changed_locked("replace")
                logger.info(
                    "Membership epoch %d: %d workers",
                    self._group_id,
                    len(self._hosts),
                )
            return self._group_id

    def _epoch_changed_locked(self, cause):
        t0 = time.perf_counter()
        if self._journal is not None:
            self._journal.record({
                "op": "membership_epoch",
                "group_id": self._group_id,
            })
        _EPOCH.set(self._group_id)
        _WORLD.set(len(self._hosts))
        emit_event(
            "membership_epoch",
            epoch=self._group_id,
            world=len(self._hosts),
            cause=cause,
        )
        _EPOCH_SECONDS.observe(time.perf_counter() - t0)

    def add_worker_host(self, host):
        with self._lock:
            if host not in self._hosts:
                self._hosts = self._hosts + [host]
                self._group_id += 1
                self._epoch_changed_locked("join")
                logger.info(
                    "Worker %s joined; membership epoch %d (%d workers)",
                    host,
                    self._group_id,
                    len(self._hosts),
                )
            return self._group_id

    def register(self, worker_id, host):
        """Join + remember worker_id -> host, so the instance manager can
        evict by id on failure (hosts alone are ambiguous: every local
        worker shares one IP and only differs in ephemeral port)."""
        with self._lock:
            old = self._id_to_host.get(worker_id)
            if old == host:
                return self._group_id
            self._id_to_host[worker_id] = host
        if old is not None:
            self.remove_worker_host(old)
        return self.add_worker_host(host)

    def remove_worker(self, worker_id):
        with self._lock:
            host = self._id_to_host.pop(worker_id, None)
        if host is not None:
            return self.remove_worker_host(host)
        return self.group_id

    def remove_worker_host(self, host):
        with self._lock:
            if host in self._hosts:
                self._hosts = [h for h in self._hosts if h != host]
                self._group_id += 1
                self._epoch_changed_locked("leave")
                logger.info(
                    "Worker %s left; membership epoch %d (%d workers)",
                    host,
                    self._group_id,
                    len(self._hosts),
                )
            return self._group_id

    def get_comm_rank(self, host):
        """(rank, world_size, group_id, coordinator_addr, coordinator_port).
        rank -1 means the host is not (yet) in the group — it should keep
        polling. coordinator_addr is the rank-0 worker's registered
        "ip:port" service address (state-broadcast pulls go there);
        coordinator_port is the port of the epoch's process-group store
        (the rendezvous) on that same machine."""
        with self._lock:
            rank = self._hosts.index(host) if host in self._hosts else -1
            coordinator = self._hosts[0] if self._hosts else ""
            # Rotate the coordination-service port across epochs: the new
            # rank-0 process re-binds immediately after a teardown, and a
            # fixed port can linger in TIME_WAIT (or still be held by a
            # dying former coordinator). The rotation claims the block
            # [coordinator_port, coordinator_port + PORT_ROTATION - 1];
            # firewalls/NetworkPolicies must open the whole block, and
            # validate_args rejects a master_port inside it.
            port = self._coordinator_port + (self._group_id % PORT_ROTATION)
            return (
                rank,
                len(self._hosts),
                self._group_id,
                coordinator,
                port,
            )

    def arrive(self, host, epoch):
        """Two-phase join gate: record that `host` is about to enter the
        process-group rendezvous for membership epoch `epoch`. Returns
        True once EVERY current member has arrived for the CURRENT epoch —
        the go signal that makes all members call initialize together,
        instead of each blocking at its own (possibly stale) epoch's
        rotated port until the rendezvous' deadline.
        Arrivals for superseded epochs are discarded (the caller re-polls
        get_comm_rank and re-arrives at the new epoch).

        A filled epoch's set deliberately persists until the epoch moves:
        every member polls until it OBSERVES ready=True, so clearing on
        first observation would deadlock the rest. The lone-rejoiner
        corner this leaves open (a worker restarting with a bitwise
        IDENTICAL host string inside an unchanged epoch gets an instant
        green light) is unreachable in practice — host strings embed the
        broadcast server's ephemeral port, so a restarted process always
        registers a new host and bumps the epoch — and if it ever did
        happen, that rendezvous can never complete anyway (survivors'
        ensure_world no-ops at an unchanged epoch), gate or no gate."""
        with self._lock:
            if epoch != self._group_id or host not in self._hosts:
                return False
            self._arrivals.setdefault(epoch, set()).add(host)
            # Prune superseded epochs' arrival sets.
            for stale in [e for e in self._arrivals if e != epoch]:
                del self._arrivals[stale]
            return self._arrivals[epoch] >= set(self._hosts)

    @property
    def group_id(self):
        with self._lock:
            return self._group_id

    @property
    def worker_hosts(self):
        with self._lock:
            return list(self._hosts)
