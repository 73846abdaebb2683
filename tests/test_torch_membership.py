"""The port's elastic AllReduce control plane against the JAX package's:
membership epochs and the join gate (master/membership.py), step leases
(master/step_lease.py) on the dispatcher, the world fingerprint and
batch padding (parallel/mesh.py), the servicer's comm-rank, liveness,
lease and world-hint methods, and the master's wiring (membership and
leases built, journaled and restored, the watchdog's membership drop).
The same scripted sequences run through both packages and must give the
same transcript."""

import random

import numpy as np
import pytest

from elasticdl_tpu.master import membership as jax_membership
from elasticdl_tpu.master import step_lease as jax_step_lease
from elasticdl_tpu.master import task_dispatcher as jax_task_dispatcher
from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.master import membership, step_lease, task_dispatcher
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.policy import WorldHintBoard
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.parallel import mesh
from elasticdl_tpu_torch.proto import messages as pb

PORT = (membership, step_lease, task_dispatcher, pb)
JAX = (jax_membership, jax_step_lease, jax_task_dispatcher, pb2)


def _lease(r):
    return (r.status, r.lease_id, r.epoch, r.rank, r.world_size, r.n_steps,
            [(x.shard_name, x.start, x.end) for x in r.ranges])


class _Job:
    """One package's dispatcher, membership and lease manager."""

    def __init__(self, pkg, records=256, per_task=64, epochs=1,
                 target_steps=8, shuffle=False, coordinator_port=51000):
        mem, lease, disp, self.pb = pkg
        self.task_d = disp.TaskDispatcher(
            {"shard": (0, records)}, records_per_task=per_task,
            num_epochs=epochs, shuffle=shuffle, seed=0)
        self.m = mem.MembershipManager(coordinator_port=coordinator_port)
        self.leases = lease.StepLeaseManager(self.task_d, self.m,
                                             target_steps=target_steps)

    def do(self, op, *a):
        if op == "register":
            return self.m.register(*a)
        if op == "remove":
            return self.m.remove_worker(*a)
        if op == "replace":
            return self.m.set_worker_hosts(*a)
        if op == "rank":
            return self.m.get_comm_rank(*a)
        if op == "arrive":
            return self.m.arrive(*a)
        if op == "lease":
            return _lease(self.leases.lease_steps(*a))
        if op == "report":
            return self.leases.report_lease(*a)
        if op == "stats":
            s = self.task_d.stats()
            return (s["records_done"], s["todo"], s["doing"],
                    s["tasks_recovered"], self.task_d.finished(),
                    self.task_d.job_failed)
        raise ValueError(op)


_TWO = [("register", 0, "h0:1"), ("register", 1, "h1:1")]
SCRIPTS = {
    "split_and_complete": _TWO + [
        ("lease", 0, "h0:1", 16), ("lease", 1, "h1:1", 16),
        ("lease", 0, "h0:1", 16), ("report", 1, 0, True),
        ("lease", 0, "h0:1", 16), ("stats",), ("report", 1, 1, True),
        ("stats",), ("lease", 0, "h0:1", 16), ("lease", 1, "h1:1", 16)],
    "epoch_change_aborts_and_requeues": _TWO + [
        ("lease", 0, "h0:1", 16), ("stats",), ("remove", 1),
        ("lease", 0, "h0:1", 16), ("report", 1, 1, True),
        ("report", 2, 0, True), ("stats",), ("lease", 0, "h0:1", 16),
        ("report", 3, 0, True), ("stats",)],
    "failure_report_aborts": _TWO + [
        ("lease", 0, "h0:1", 16), ("report", 1, 0, False, "comm failure"),
        ("stats",), ("lease", 1, "h1:1", 16), ("stats",)],
    "unregistered_host_waits": [
        ("register", 0, "h0:1"), ("lease", 9, "stranger:9", 16),
        ("rank", "stranger:9")],
    "fewer_records_than_ranks": _TWO + [
        ("register", 2, "h2:1"), ("lease", 0, "h0:1", 4),
        ("lease", 1, "h1:1", 4), ("lease", 2, "h2:1", 4)],
    "host_swap_and_rotated_port": _TWO + [
        ("rank", "h0:1"), ("rank", "h1:1"), ("register", 0, "h0:9"),
        ("rank", "h0:1"), ("rank", "h0:9"), ("rank", "h1:1"),
        ("register", 1, "h1:1"), ("remove", 42),
        ("replace", ["a:1", "b:1", "c:1"]), ("rank", "c:1"),
        ("replace", ["a:1", "b:1", "c:1"])] + [
        ("register", 10 + i, f"x{i}:1") for i in range(17)] + [
        ("rank", "x16:1")],
    "join_gate": _TWO + [
        ("arrive", "h0:1", 2), ("arrive", "h1:1", 2), ("arrive", "h0:1", 2),
        ("arrive", "h0:1", 1), ("arrive", "nobody:9", 2),
        ("register", 2, "h2:1"), ("arrive", "h0:1", 2),
        ("arrive", "h0:1", 3), ("arrive", "h1:1", 3),
        ("arrive", "h2:1", 3)],
    "epoch_rollover": _TWO + [
        ("lease", 0, "h0:1", 8), ("lease", 1, "h1:1", 8),
        ("report", 1, 0, True), ("report", 1, 1, True),
        ("lease", 0, "h0:1", 8), ("lease", 1, "h1:1", 8),
        ("report", 2, 0, True), ("report", 2, 1, True), ("stats",),
        ("lease", 0, "h0:1", 8), ("stats",)],
}
_SETUPS = {"fewer_records_than_ranks": dict(records=1),
           "epoch_rollover": dict(records=128, epochs=2)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_sequences_equal_jax(name):
    kw = _SETUPS.get(name, {})
    ours, theirs = _Job(PORT, **kw), _Job(JAX, **kw)
    got = [ours.do(*op) for op in SCRIPTS[name]]
    want = [theirs.do(*op) for op in SCRIPTS[name]]
    assert got == want
    assert ours.m.worker_hosts == theirs.m.worker_hosts
    assert ours.m.export_state() == theirs.m.export_state()


def _chaos_transcript(pkg, trial):
    """tests/test_step_lease.py's random-membership drill, recorded."""
    rng = random.Random(1234 + trial)
    job = _Job(pkg, records=512, per_task=rng.choice([32, 64, 96]),
               target_steps=rng.choice([2, 4]), shuffle=bool(trial % 2))
    workers, next_wid, log = {}, 0, []

    def join():
        nonlocal next_wid
        wid, next_wid = next_wid, next_wid + 1
        workers[wid] = f"h{wid}:1"
        log.append(("join", job.m.register(wid, workers[wid])))

    join()
    join()
    for _ in range(2000):
        if job.task_d.finished():
            break
        event = rng.random()
        if event < 0.08:
            join()
            continue
        if event < 0.14:
            if len(workers) > 1:
                wid = rng.choice(sorted(workers))
                log.append(("leave", job.m.remove_worker(wid)))
                del workers[wid]
            continue
        responses = {}
        for wid, host in sorted(workers.items()):
            r = job.leases.lease_steps(wid, host, batch_size=16)
            log.append(_lease(r))
            if r.status == job.pb.LeaseStepsResponse.OK:
                responses[wid] = r
        if not responses:
            continue
        if rng.random() < 0.1:
            _, r = rng.choice(sorted(responses.items()))
            job.leases.report_lease(r.lease_id, r.rank, False, "chaos")
            continue
        for _, r in sorted(responses.items()):
            log.append(("report", job.leases.report_lease(
                r.lease_id, r.rank, True)))
    return log, job.do("stats")


@pytest.mark.parametrize("trial", range(4))
def test_random_membership_never_loses_records_as_jax(trial):
    log, stats = _chaos_transcript(PORT, trial)
    assert (log, stats) == _chaos_transcript(JAX, trial)
    records_done, todo, doing, _, finished, failed = stats
    assert finished and not failed and doing == 0 and records_done >= 512


def test_lease_owner_ids_equal_jax():
    for i in (1, 2, 500):
        assert step_lease.lease_owner_id(i) == \
            jax_step_lease.lease_owner_id(i)
    for wid in (-2000, -1001, -1000, -999, -1, 0, 7):
        assert step_lease.is_lease_owner(wid) == \
            jax_step_lease.is_lease_owner(wid)


class _Journal:
    def __init__(self):
        self.ops = []

    def record(self, op):
        self.ops.append(op)


def test_membership_journal_and_restore_equal_jax():
    ours, theirs = membership.MembershipManager(), \
        jax_membership.MembershipManager()
    for m in (ours, theirs):
        m.attach_journal(_Journal())
        m.register(0, "a:1")
        m.register(1, "b:1")
        m.remove_worker(0)
    assert ours._journal.ops == theirs._journal.ops
    for m in (ours, theirs):
        m.restore_state({"membership_epoch": 9})
        m.register(2, "c:1")
    assert ours.export_state() == theirs.export_state() == {
        "membership_epoch": 10}


# ---------- the world fingerprint and batch padding ----------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16])
def test_world_fingerprint_equals_jax(n):
    """A world of n one-rank processes is the JAX resolver's pure
    data-parallel world of n one-device processes."""
    want = jax_mesh.resolve_world_spec(
        jax_mesh.ParallelConfig(), jax_mesh.WorldTopology(n, 1, n))
    assert want.axis_sizes() == {jax_mesh.DATA_AXIS: n}
    assert mesh.world_fingerprint(n) == want.fingerprint()


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    ids = rng.integers(0, 9, (n, 2))
    return {"array": x, "dict": {"dense": x, "ids": ids},
            "tuple": (x, ids)}


@pytest.mark.parametrize("n,multiple", [(13, 8), (16, 8), (5, 2), (1, 3),
                                        (7, 1)])
def test_pad_batch_to_multiple_equals_jax(n, multiple):
    for kind, batch in _batches(n, n * multiple).items():
        got, real_n = mesh.pad_batch_to_multiple(batch, multiple)
        want, want_n = jax_mesh.pad_batch_to_multiple(batch, multiple)
        assert real_n == want_n == n, kind
        got_leaves, want_leaves = _leaves(got), _leaves(want)
        assert len(got_leaves) == len(want_leaves), kind
        for a, b in zip(got_leaves, want_leaves):
            assert a.shape[0] % multiple == 0
            np.testing.assert_array_equal(a, b, err_msg=kind)


def _leaves(batch):
    if isinstance(batch, dict):
        return [leaf for k in sorted(batch) for leaf in _leaves(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [leaf for v in batch for leaf in _leaves(v)]
    return [np.asarray(batch)]


# ---------- the servicer ----------


def _servicers():
    out = []
    for mem, lease, disp, msgs, svc in (
            (membership, step_lease, task_dispatcher, pb, MasterServicer),
            (jax_membership, jax_step_lease, jax_task_dispatcher, pb2,
             JaxServicer)):
        task_d = disp.TaskDispatcher({"s": (0, 64)}, records_per_task=16,
                                     num_epochs=1, shuffle=False)
        m = mem.MembershipManager(coordinator_port=52000)
        servicer = svc(task_d, None, m,
                       step_lease_manager=lease.StepLeaseManager(task_d, m))
        out.append((servicer, msgs))
    return out


_CALLS = [
    ("report_worker_liveness", "ReportWorkerLivenessRequest",
     dict(worker_id=0, host="a:1")),
    ("get_comm_rank", "GetCommRankRequest", dict(worker_host="a:1")),
    ("get_comm_rank", "GetCommRankRequest", dict(worker_host="zz:1")),
    ("report_worker_liveness", "ReportWorkerLivenessRequest",
     dict(worker_id=1, host="b:1")),
    ("get_comm_rank", "GetCommRankRequest",
     dict(worker_host="a:1", ready_epoch_plus_one=3)),
    ("get_comm_rank", "GetCommRankRequest",
     dict(worker_host="b:1", ready_epoch_plus_one=3)),
    ("lease_steps", "LeaseStepsRequest",
     dict(worker_id=0, worker_host="a:1", batch_size=4)),
    ("lease_steps", "LeaseStepsRequest",
     dict(worker_id=1, worker_host="b:1", batch_size=4)),
    ("report_lease", "ReportLeaseRequest",
     dict(lease_id=1, worker_id=0, rank=0, success=True)),
    ("report_lease", "ReportLeaseRequest",
     dict(lease_id=1, worker_id=1, rank=1, success=True)),
    ("lease_steps", "LeaseStepsRequest",
     dict(worker_id=0, worker_host="a:1", batch_size=4)),
    ("get_world_hint", "GetWorldHintRequest", dict(worker_id=0)),
]


def test_servicer_answers_equal_jax_bytes():
    (ours, opb), (theirs, tpb) = _servicers()
    for method, req, values in _CALLS:
        got = getattr(ours, method)(getattr(opb, req)(**values), None)
        want = getattr(theirs, method)(getattr(tpb, req)(**values), None)
        assert got.SerializeToString() == want.SerializeToString(), method
    board = WorldHintBoard()
    board.announce(3, "scale up")
    ours.bind_job_context(world_hints=board)
    hint = ours.get_world_hint(pb.GetWorldHintRequest(worker_id=0), None)
    assert (hint.hint_seq, hint.target_world_size, hint.reason) == (
        1, 3, "scale up")
    status = ours.get_job_status(pb.GetJobStatusRequest(), None)
    assert status.membership_epoch == ours._membership.group_id == 2
    assert status.records_done == 64


# ---------- the master ----------


def _master(tmp_path, *extra):
    train = tmp_path / "train.edlr"
    if not train.exists():
        from elasticdl_tpu_torch.data.recordfile import RecordFileWriter

        with RecordFileWriter(str(train)) as writer:
            for i in range(64):
                writer.write(b"%d" % i)
    args = edl_args.master_parser().parse_args([
        "--model_def", "elasticdl_tpu_torch.models.iris.iris_dnn",
        "--distribution_strategy", "AllreduceStrategy",
        "--training_data", str(train), "--records_per_task", "16",
        "--instance_backend", "none", "--coordinator_port", "53000",
        "--num_epochs", "1", *extra])
    edl_args.validate_args(args)
    return Master(args)


@pytest.fixture
def quiet_master(monkeypatch):
    monkeypatch.setenv("ELASTICDL_METRICS_PORT", "-1")
    monkeypatch.setenv("ELASTICDL_HEARTBEAT_SECONDS", "0")
    monkeypatch.delenv("ELASTICDL_OBS_DIR", raising=False)


def test_master_builds_membership_and_leases(tmp_path, quiet_master):
    master = _master(tmp_path)
    try:
        assert master.membership is not None and master.step_leases is None
        assert master.membership.get_comm_rank("a:1")[4] == 53000
    finally:
        master.stop()
    master = _master(tmp_path, "--multi_host")
    try:
        stub = master.stub()
        stub.report_worker_liveness(
            pb.ReportWorkerLivenessRequest(worker_id=0, host="a:1"))
        lease = stub.lease_steps(pb.LeaseStepsRequest(
            worker_id=0, worker_host="a:1", batch_size=4))
        assert lease.status == pb.LeaseStepsResponse.OK
        assert lease.n_steps == 8 and lease.world_size == 1
        status = stub.get_job_status(pb.GetJobStatusRequest())
        assert status.membership_epoch == 1
    finally:
        master.stop()


def test_master_journals_membership_and_leases(tmp_path, quiet_master,
                                               monkeypatch):
    """A successor master replays the membership epoch and the step
    lease's in-flight tasks; the watchdog sweeps a silent worker out of
    the membership but never a lease's synthetic owner for being slow."""
    monkeypatch.setenv("ELASTICDL_MASTER_JOURNAL_DIR",
                       str(tmp_path / "journal"))
    first = _master(tmp_path, "--multi_host")
    stub = first.stub()
    for wid, host in ((0, "a:1"), (1, "b:1")):
        stub.report_worker_liveness(
            pb.ReportWorkerLivenessRequest(worker_id=wid, host=host))
    lease = stub.lease_steps(pb.LeaseStepsRequest(
        worker_id=0, worker_host="a:1", batch_size=4))
    assert lease.status == pb.LeaseStepsResponse.OK
    epoch = first.membership.group_id
    first.journal.close()
    first.journal = None
    first.stop()

    second = _master(tmp_path, "--multi_host")
    try:
        assert second.master_incarnation == 2
        assert second.membership.group_id == epoch == 2
        owners = {wid for _, wid, _ in second._recovered_leases}
        assert owners == {step_lease.lease_owner_id(lease.lease_id)}
        second.membership.register(5, "c:1")
        second.servicer._touch(5)
        second.args.worker_liveness_timeout_seconds = -1.0
        second._run_watchdog()
        assert second.membership.worker_hosts == []
        assert second.task_d.stats()["doing"] == 0
    finally:
        second.stop()
