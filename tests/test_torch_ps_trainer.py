"""The port's parameter-server path (worker/ps_trainer.py, ps_client.py,
row_cache.py, layers/embedding.py, models/dac_ctr, the master's in-process
shards) against the JAX package's: DeepFM-PS's first step at imported
weights, three steps through each package's own two shards, then the port's
jobs through its Master (records exact, a shard relaunched mid-job), the
pipelined path's invariants, the bfloat16 and int8 wires, and automatic
table placement."""

import functools
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from elasticdl_tpu.common.model_utils import get_model_spec as jax_spec
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu.ps.parameter_server import (
    ParameterServer as JaxParameterServer,
)
from elasticdl_tpu.worker.ps_client import PSClient as JaxPSClient
from elasticdl_tpu.worker.ps_trainer import (
    ParameterServerTrainer as JaxPSTrainer,
)
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common import rpc, save_utils, tensor_utils
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.data.gen.criteo import iter_criteo_records
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models.dac_ctr import deepfm_ps
from elasticdl_tpu_torch.models.dac_ctr.transform import feed
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
from elasticdl_tpu_torch.worker import task_data_service
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer

torch.set_num_threads(1)

SPEC = "elasticdl_tpu_torch.models.dac_ctr.deepfm_ps"
JAX_SPEC = "elasticdl_tpu.models.dac_ctr.deepfm_ps"
BATCH = 64
# Loss of the same weights and rows in the two frameworks (float32 sums in
# another order), and gradients and weights after Adam steps, as a share of
# the largest magnitude compared.
LOSS_ATOL = 1e-6
GRAD_RTOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def _short_waits(monkeypatch):
    monkeypatch.setattr(task_data_service, "_WAIT_SLEEP_SECONDS", 0.001)


def _batches(n, seed=0):
    records = list(iter_criteo_records(n * BATCH, seed=seed, chunk=BATCH))
    return [feed(records[i * BATCH:(i + 1) * BATCH], "training", None)
            for i in range(n)]


def _close(got, want, rtol=GRAD_RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


def _capture_pushes(client):
    pushes = []
    inner = client.push_gradients

    def push(dense, sparse, version, **kw):
        pushes.append((
            {k: np.array(v) for k, v in dense.items()},
            {t: (np.array(v), np.array(i)) for t, (v, i) in sparse.items()},
        ))
        return inner(dense, sparse, version, **kw)

    client.push_gradients = push
    return pushes


@pytest.fixture(scope="module")
def three_steps():
    """Three inline steps of DeepFM-PS through each package's own two
    shards, from the same weights: the JAX side on localhost gRPC servers
    in threads, the port's on in-process shards."""
    batches = _batches(3)
    spec, j_spec = get_model_spec(SPEC), jax_spec(JAX_SPEC)
    servers = [JaxParameterServer(i, 2,
                                  optimizer_spec=j_spec.build_optimizer_spec())
               for i in range(2)]
    try:
        j_client = JaxPSClient([s.addr for s in servers], worker_id=0,
                               wire_dtype="float32")
        j_trainer = JaxPSTrainer(
            j_spec.build_model(), j_spec.loss, j_spec.build_optimizer_spec(),
            j_client, embedding_inputs=j_spec.module.embedding_inputs,
            pipeline_pushes=False, prefetch_overlap=False)
        j_pushes = _capture_pushes(j_client)
        j_pulls = []
        _jp = j_client.pull_dense_parameters
        def _jpull(*a, **k):
            r = _jp(*a, **k); j_pulls.append({n: np.array(v) for n, v in r[2].items()}); return r
        j_client.pull_dense_parameters = _jpull
        j_trainer.init_variables_if_needed(batches[0][0])
        named, _ = flatten_params(jax.device_get(
            j_trainer._variables["params"]))
        named = {k: np.asarray(v) for k, v in named.items()}
        j_losses = [float(j_trainer.train_minibatch(f, l)[2])
                    for f, l in batches]
        j_state = [(dict(s.parameters.dense),
                    {t: tab.export_rows()
                     for t, tab in s.parameters.embedding_tables.items()})
                   for s in servers]
        j_client.close()
    finally:
        for s in servers:
            s.stop()

    shards = [ParameterServer(i, 2, optimizer_spec=spec.build_optimizer_spec())
              for i in range(2)]
    client = PSClient([s.stub() for s in shards], worker_id=0,
                      wire_dtype="float32")
    trainer = ParameterServerTrainer(
        spec.build_model(), spec.loss, spec.build_optimizer_spec(), client,
        embedding_inputs=spec.module.embedding_inputs, pipeline_pushes=False,
        prefetch_overlap=False, device="cpu")
    pushes = _capture_pushes(client)
    trainer.load_flax_params(named)
    losses = [float(trainer.train_minibatch(f, l)[2]) for f, l in batches]
    client.close()

    # The same steps over the port's socket transport: shards serving on
    # ports, the client on their addresses.
    served = [ParameterServer(i, 2, port=0,
                              optimizer_spec=spec.build_optimizer_spec())
              for i in range(2)]
    try:
        client = PSClient([s.addr for s in served], worker_id=0,
                          wire_dtype="float32")
        trainer = ParameterServerTrainer(
            spec.build_model(), spec.loss, spec.build_optimizer_spec(),
            client, embedding_inputs=spec.module.embedding_inputs,
            pipeline_pushes=False, prefetch_overlap=False, device="cpu")
        socket_pushes = _capture_pushes(client)
        trainer.load_flax_params(named)
        socket_losses = [float(trainer.train_minibatch(f, l)[2])
                         for f, l in batches]
        client.close()
    finally:
        for s in served:
            s.stop()
    return dict(named=named, j_losses=j_losses, losses=losses,
                j_pushes=j_pushes, pushes=pushes, j_state=j_state,
                shards=shards, socket_losses=socket_losses,
                socket_pushes=socket_pushes, socket_shards=served)


def test_three_steps_over_sockets_equal_in_process(three_steps):
    """PSClient on addresses, shards serving over the socket transport: the
    same losses, pushes and shard state, bitwise, as on in-process stubs."""
    r = three_steps
    assert r["socket_losses"] == r["losses"]
    for (dense, sparse), (s_dense, s_sparse) in zip(r["pushes"],
                                                    r["socket_pushes"]):
        assert sorted(dense) == sorted(s_dense)
        for name in dense:
            np.testing.assert_array_equal(dense[name], s_dense[name])
        for table in sparse:
            for a, b in zip(sparse[table], s_sparse[table]):
                np.testing.assert_array_equal(a, b)
    for shard, served in zip(r["shards"], r["socket_shards"]):
        assert shard.parameters.version == served.parameters.version
        for name, value in shard.parameters.dense.items():
            np.testing.assert_array_equal(value,
                                          served.parameters.dense[name])


def test_first_step_loss_and_gradients_match_jax(three_steps):
    r = three_steps
    # The port names its modules as flax does: the same wire names.
    assert sorted(r["pushes"][0][0]) == sorted(r["j_pushes"][0][0]) == sorted(
        r["named"])
    assert abs(r["losses"][0] - r["j_losses"][0]) <= LOSS_ATOL
    dense, sparse = r["pushes"][0]
    j_dense, j_sparse = r["j_pushes"][0]
    for name in dense:
        _close(dense[name], j_dense[name], what=name)
    assert sorted(sparse) == sorted(j_sparse) == ["deep", "wide"]
    for table in sparse:
        np.testing.assert_array_equal(sparse[table][1], j_sparse[table][1])
        values, ids = tensor_utils.deduplicate_indexed_slices(*sparse[table])
        j_values, j_ids = tensor_utils.deduplicate_indexed_slices(
            *j_sparse[table])
        np.testing.assert_array_equal(ids, j_ids)
        _close(values, j_values, what=table)


def test_three_steps_leave_the_same_ps_state_as_jax(three_steps):
    r = three_steps
    np.testing.assert_allclose(r["losses"], r["j_losses"], rtol=0,
                               atol=LOSS_ATOL * 10)
    for shard, (j_dense, j_tables) in zip(r["shards"], r["j_state"]):
        params = shard.parameters
        assert params.version == 3
        assert sorted(params.dense) == sorted(j_dense)
        for name, value in params.dense.items():
            _close(value, j_dense[name], what=name)
        for table, (j_ids, j_rows) in j_tables.items():
            ids, rows = params.embedding_tables[table].export_rows()
            np.testing.assert_array_equal(ids, j_ids)
            _close(rows, j_rows, what=table)


# ---------- the port's jobs through its Master ----------


def _job(tmp_path, n_train=128, n_valid=32, extra=()):
    paths = {}
    for name, n, seed in (("train", n_train, 0), ("valid", n_valid, 1)):
        paths[name] = os.path.join(tmp_path, f"{name}.edlr")
        with RecordFileWriter(paths[name]) as writer:
            for record in iter_criteo_records(n, seed=seed):
                writer.write(record)
    common = [
        "--model_def", SPEC,
        "--distribution_strategy", "ParameterServerStrategy",
        "--training_data", paths["train"],
        "--validation_data", paths["valid"],
        "--records_per_task", "32", "--num_epochs", "1",
        "--minibatch_size", "16", "--evaluation_steps", "4", "--seed", "0",
        *extra,
    ]
    master_args = edl_args.master_parser().parse_args(
        common + ["--instance_backend", "none", "--num_ps", "2"])
    edl_args.validate_args(master_args)
    master = Master(master_args)
    worker_args = edl_args.worker_parser().parse_args(common + [
        "--worker_id", "0", "--master_addr", "in-process",
        "--job_type", "training_with_evaluation", "--log_loss_steps", "4",
    ])
    worker = build_worker(worker_args, MasterClient(master.stub(), 0),
                          ps_stubs=master.ps_stubs(), device="cpu")
    return master, worker


def test_ps_job_through_master_keeps_records_exact(tmp_path):
    master, worker = _job(tmp_path, extra=[
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--checkpoint_steps",
        "8"])
    worker.run()
    worker.trainer.close()
    stats = master.task_d.stats()
    assert master.task_d.finished() and not master.task_d.job_failed
    assert stats["records_done"] == 128 and worker.steps == 8
    # Every push reaches both shards (each holds dense names and ids).
    assert [s.parameters.version for s in master.ps_servers] == [8, 8]
    assert [s.parameters.total_records for s in master.ps_servers] == [
        128, 128]
    evals = master.evaluation_service.completed_results
    assert evals and all({"auc", "accuracy"} <= set(m) for _, m in evals)
    # The shards checkpointed at version 8; a master resuming from it
    # dispatches nothing more to train.
    resumed, _ = _job(tmp_path, extra=[
        "--checkpoint_dir_for_init", str(tmp_path / "ckpt")])
    assert resumed.ps_servers[0].parameters.version == 8
    assert not [t for t in resumed.task_d._todo if t.type == 0]


def test_ps_shard_relaunched_mid_job_is_reseeded(tmp_path):
    master, worker = _job(tmp_path)
    trainer = worker.trainer
    inner = trainer.train_minibatch
    calls = []

    def train(features, labels):
        calls.append(1)
        if len(calls) == 5:  # after step 4, shard 0 comes back empty
            trainer.close()  # its last push landed on the old shard
            fresh = master.relaunch_ps(0)
            assert not fresh.parameters.initialized
        return inner(features, labels)

    trainer.train_minibatch = train
    worker.run()
    trainer.close()
    assert master.task_d.stats()["records_done"] == 128
    assert worker.steps == 8 and not master.task_d.job_failed
    fresh = master.ps_servers[0].parameters
    assert fresh.initialized and fresh.version == 8
    assert master.ps_servers[1].parameters.version == 8


# ---------- the pipelined default path and the bfloat16 wire ----------


def _trainer(wire="float32", **kw):
    spec = get_model_spec(SPEC)
    shards = [ParameterServer(i, 2, optimizer_spec=spec.build_optimizer_spec())
              for i in range(2)]
    client = PSClient([s.stub() for s in shards], worker_id=0,
                      wire_dtype=wire)
    trainer = ParameterServerTrainer(
        spec.build_model(), spec.loss, spec.build_optimizer_spec(), client,
        embedding_inputs=spec.module.embedding_inputs, seed=0,
        device="cpu", **kw)
    return trainer, client, shards


def test_pipelined_path_invariants():
    trainer, client, shards = _trainer()
    assert trainer._pipeline_pushes and trainer._row_cache is not None
    in_flight, most = [0], [0]
    inner = client.push_gradients

    def push(*args, **kw):
        in_flight[0] += 1
        most[0] = max(most[0], in_flight[0])
        try:
            return inner(*args, **kw)
        finally:
            in_flight[0] -= 1

    client.push_gradients = push
    batches = _batches(2)
    for i in range(6):
        features, labels = batches[i % 2]
        accepted, _, loss = trainer.train_minibatch(
            features, labels, next_features=batches[(i + 1) % 2][0])
        assert accepted and loss.dim() == 0
    trainer.close()
    assert most[0] == 1  # one push in flight
    assert [s.parameters.version for s in shards] == [6, 6]
    assert trainer.get_model_version() == 6
    # Steps 2-6 took the lookahead issued the step before (one issue for
    # step 1, then one lookahead per step), and the repeated batches hit
    # the row cache within its staleness budget.
    assert trainer.timing.summary()["prefetch_issue"]["count"] == 1 + 6
    assert trainer._row_cache.stats()["hit_ratio"] > 0
    # Evaluation flushes and reads the freshest rows: twice the same.
    first = trainer.evaluate_minibatch(batches[0][0])
    np.testing.assert_array_equal(first,
                                  trainer.evaluate_minibatch(batches[0][0]))
    client.close()


def test_bfloat16_wire_rounds_rows_and_row_gradients():
    batches = _batches(1)
    pushes = {}
    for wire in ("float32", "bfloat16"):
        trainer, client, shards = _trainer(wire, pipeline_pushes=False)
        pushes[wire] = _capture_pushes(client)
        trainer.train_minibatch(*batches[0])
        client.close()
    dense, sparse = pushes["bfloat16"][0]
    f_dense, f_sparse = pushes["float32"][0]
    for table, (values, ids) in sparse.items():
        # Row gradients came down as bfloat16 values.
        np.testing.assert_array_equal(
            tensor_utils.bfloat16_bits_to_float32(
                tensor_utils.float32_to_bfloat16_bits(values)), values)
        np.testing.assert_array_equal(ids, f_sparse[table][1])
        # bfloat16 rows and gradients: 8 bits of mantissa.
        _close(values, f_sparse[table][0], rtol=2e-2, what=table)
    for name in dense:
        _close(dense[name], f_dense[name], rtol=2e-2, what=name)


def test_unported_options_and_missing_device_raise():
    """The int8 wire and a derived ids feed, which raised before they were
    ported, now work; an unknown wire and a missing device still raise."""
    client = PSClient([None], wire_dtype="int8")
    assert client.int8_dense and client.bf16_wire
    with pytest.raises(ValueError, match="wire_dtype"):
        PSClient([None], wire_dtype="int4")
    if not torch.cuda.is_available():  # device=None means CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            ParameterServerTrainer(
                deepfm_ps.custom_model(), deepfm_ps.loss,
                deepfm_ps.optimizer(), PSClient([None]))
    # DeepFM-PS without its embedding_inputs: the feed is derived from a
    # capture forward, both tables off the ids feature.
    shards = [ParameterServer(i, 2, optimizer_spec=deepfm_ps.optimizer())
              for i in range(2)]
    client = PSClient([s.stub() for s in shards])
    trainer = ParameterServerTrainer(
        deepfm_ps.custom_model(), deepfm_ps.loss, deepfm_ps.optimizer(),
        client, pipeline_pushes=False, device="cpu")
    features, labels = _batches(1)[0]
    assert trainer.train_minibatch(features, labels)[0]
    derived = trainer._embedding_inputs(features)
    assert sorted(derived) == ["deep", "wide"]
    for table, ids in deepfm_ps.embedding_inputs(features).items():
        np.testing.assert_array_equal(derived[table], ids)
    client.close()


def _record_calls(client):
    """Wraps the client: the list it returns gets every model push, row
    pull and gradient push, with copies of their arrays."""
    calls = []
    push_model, pull = client.push_model, client.pull_embedding_vectors_async
    push = client.push_gradients

    def record_push_model(dense, infos=None, version=0, only_shards=None):
        calls.append(("push_model", {k: np.array(v) for k, v in
                                     dense.items()}, list(infos), version))
        return push_model(dense, infos, version, only_shards)

    def record_pull(name, ids, keep_wire_dtype=False):
        calls.append(("pull", name, np.array(ids)))
        return pull(name, ids, keep_wire_dtype)

    def record_push(dense, sparse, version, **kw):
        calls.append(("push", {k: np.array(v) for k, v in dense.items()},
                      {t: (np.array(v), np.array(i))
                       for t, (v, i) in sparse.items()}, version, kw))
        return push(dense, sparse, version, **kw)

    client.push_model = record_push_model
    client.pull_embedding_vectors_async = record_pull
    client.push_gradients = record_push
    return calls


def test_three_int8_steps_leave_the_same_ps_state_as_jax():
    """Three steps of DeepFM-PS on the int8 wire (dense gradients in int8
    blocks with error feedback, rows and row gradients in bfloat16); the
    same calls through the JAX package's PSClient(wire_dtype="int8") into
    its own shards leave the same PS state."""
    trainer, client, shards = _trainer("int8", pipeline_pushes=False,
                                       prefetch_overlap=False)
    calls = _record_calls(client)
    for features, labels in _batches(3):
        assert trainer.train_minibatch(features, labels)[0]
    client.close()
    assert [c[0] for c in calls].count("push") == 3
    j_spec = jax_spec(JAX_SPEC)
    servers = [JaxParameterServer(i, 2,
                                  optimizer_spec=j_spec.build_optimizer_spec())
               for i in range(2)]
    try:
        j_client = JaxPSClient([s.addr for s in servers], worker_id=0,
                               wire_dtype="int8")
        for call in calls:
            if call[0] == "push_model":
                _, dense, infos, version = call
                j_client.push_model(dense, [
                    pb2.EmbeddingTableInfo.FromString(i.SerializeToString())
                    for i in infos], version=version)
            elif call[0] == "pull":
                j_client.pull_embedding_vectors(call[1], call[2])
            else:
                _, dense, sparse, version, kw = call
                assert j_client.push_gradients(dense, sparse, version,
                                               **kw)[0]
        j_client.close()
        for shard, server in zip(shards, servers):
            ours, theirs = shard.parameters, server.parameters
            assert ours.version == theirs.version == 3
            assert sorted(ours.dense) == sorted(theirs.dense)
            for name, value in ours.dense.items():
                _close(value, theirs.dense[name], what=name)
            for table, tab in theirs.embedding_tables.items():
                j_ids, j_rows = tab.export_rows()
                ids, rows = ours.embedding_tables[table].export_rows()
                np.testing.assert_array_equal(ids, j_ids)
                _close(rows, j_rows, what=table)
    finally:
        for s in servers:
            s.stop()


class _DownStub:
    """A shard that does not answer."""

    def __getattr__(self, method):
        def call(request):
            raise rpc.RpcError(rpc.StatusCode.UNAVAILABLE, "down")
        call.future = lambda request: _Failed()
        return call


class _Failed:
    def result(self):
        raise rpc.RpcError(rpc.StatusCode.UNAVAILABLE, "down")


def test_degraded_shard_is_marked_and_reseeded_when_back():
    trainer, client, shards = _trainer(pipeline_pushes=False)
    features, labels = _batches(1)[0]
    trainer.train_minibatch(features, labels)
    live = client._stubs[1]
    client._stubs[1] = _DownStub()
    initialized, _, _ = client.pull_dense_parameters(trainer._param_names)
    assert not initialized and client.degraded_shards == {1}
    assert client.unseeded_shards == {1}
    # A push reaches the healthy shard and drops the down one's slice.
    dense = {leaf.name: np.zeros(leaf.to_flax(leaf.param).shape, np.float32)
             for leaf in trainer._leaves}
    version = shards[0].parameters.version
    accepted, _ = client.push_gradients(dense, {}, version)
    assert accepted and shards[0].parameters.version == version + 1
    client._stubs[1] = ParameterServer(
        1, 2, optimizer_spec=optimizers.adam(0.001)).stub()
    trainer.train_minibatch(features, labels)  # re-seeds shard 1
    assert client.degraded_shards == set() and not client.unseeded_shards
    client._stubs[1].close()
    live.close()
    client.close()


class _Linear(nn.Module):
    """A dense-only model: no PS tables."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(13, 1)

    def forward(self, features):
        return self.Dense_0(features["dense"]).reshape(-1)


def _mse(labels, outputs):
    return torch.mean((outputs - torch.as_tensor(labels).to(outputs)) ** 2)


def test_dense_only_model_with_local_steps_and_export():
    """No tables: dense pulls and pushes only. model_steps=2 pulls every
    other step and applies the local optimizer in between; export pulls
    the final weights."""
    shards = [ParameterServer(i, 2, optimizer_spec=optimizers.sgd(0.1))
              for i in range(2)]
    client = PSClient([s.stub() for s in shards], worker_id=0)
    trainer = ParameterServerTrainer(
        _Linear(), _mse, optimizers.sgd(0.1), client, model_steps=2,
        pipeline_pushes=False, device="cpu")
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(64, 13)).astype(np.float32)
    labels = dense @ np.linspace(-1, 1, 13).astype(np.float32)
    pulls = []
    inner = client.pull_dense_parameters
    client.pull_dense_parameters = lambda *a, **k: (pulls.append(1),
                                                    inner(*a, **k))[1]
    losses = [float(trainer.train_minibatch({"dense": dense}, labels)[2])
              for _ in range(20)]
    assert losses[-1] < 0.5 * losses[0]
    assert len(pulls) == 10  # every other step
    # Every shard that holds a parameter took all 20 pushes.
    assert all(s.parameters.version == 20 for s in shards
               if s.parameters.dense)
    exported = trainer.export_variables()
    assert sorted(exported["variables"]) == ["Dense_0/bias", "Dense_0/kernel"]
    ps_kernel = next(s.parameters.dense["Dense_0/kernel"] for s in shards
                     if "Dense_0/kernel" in s.parameters.dense)
    np.testing.assert_array_equal(exported["variables"]["Dense_0/kernel"],
                                  ps_kernel)
    client.close()


def test_oversized_nn_embedding_needs_the_unported_auto_swap():
    """A stock nn.Embedding over the 2 MiB threshold moves to the PS
    automatically (no embedding_inputs): its rows are pulled and its row
    gradients pushed under its module path, and the export brings it
    back; a table under the threshold stays a dense parameter."""
    class Big(nn.Module):
        def __init__(self):
            super().__init__()
            self.Embed_0 = nn.Embedding(1 << 20, 1)  # 4 MiB
            self.Embed_1 = nn.Embedding(64, 2)  # 512 B
            self.Dense_0 = nn.Linear(13 + 2, 1)

        def forward(self, features):
            ids = features["ids"].long()
            small = self.Embed_1(ids[:, 0] % 64)
            dense = self.Dense_0(torch.cat([features["dense"], small], 1))
            return self.Embed_0(ids).sum((1, 2)) + dense[:, 0]

    shards = [ParameterServer(i, 2, optimizer_spec=optimizers.sgd(0.1))
              for i in range(2)]
    client = PSClient([s.stub() for s in shards], worker_id=0)
    trainer = ParameterServerTrainer(Big(), _mse, optimizers.sgd(0.1),
                                     client, pipeline_pushes=False,
                                     device="cpu")
    pushes = _capture_pushes(client)
    features, _ = _batches(1)[0]
    labels = np.ones(BATCH, np.float32)
    assert trainer.train_minibatch(features, labels)[0]
    assert trainer._embedding_dims == {"Embed_0": 1}
    dense, sparse = pushes[0]
    assert sorted(dense) == ["inner/Dense_0/bias", "inner/Dense_0/kernel",
                             "inner/Embed_1/embedding"]
    np.testing.assert_array_equal(sparse["Embed_0"][1],
                                  features["ids"].reshape(-1))
    exported = trainer.export_variables()["variables"]
    assert exported["Embed_0/embedding"].shape == (1 << 20, 1)
    assert "Embed_1/embedding" in exported
    client.close()


def test_sync_mode_stale_push_is_rejected_then_recomputed():
    """Sync SGD (grads_to_wait 1): a worker training on its local model
    (model_steps 2) pushes behind the PS version; the push is rejected,
    the worker re-pulls and recomputes, the retry is accepted."""
    spec = get_model_spec(SPEC)
    shards = [ParameterServer(i, 2, optimizer_spec=spec.build_optimizer_spec(),
                              use_async=False)
              for i in range(2)]
    trainers, outcomes = [], []
    for worker_id, model_steps in ((0, 2), (1, 1)):
        client = PSClient([s.stub() for s in shards], worker_id=worker_id)
        inner = client.push_gradients

        def push(*args, inner=inner, **kw):
            accepted, version = inner(*args, **kw)
            outcomes.append(accepted)
            return accepted, version

        client.push_gradients = push
        trainers.append(ParameterServerTrainer(
            spec.build_model(), spec.loss, spec.build_optimizer_spec(),
            client, embedding_inputs=spec.module.embedding_inputs,
            use_async=False, model_steps=model_steps, device="cpu"))
    a, b = trainers
    features, labels = _batches(1)[0]
    assert not a._pipeline_pushes and a._row_cache is None
    assert a.train_minibatch(features, labels)[0]  # v0 -> 1
    assert b.train_minibatch(features, labels)[0]  # v1 -> 2
    accepted, version, _ = a.train_minibatch(features, labels)
    assert accepted and version == 3
    assert outcomes == [True, True, False, True]
    assert [s.parameters.version for s in shards] == [3, 3]


# ---------- BatchNorm state under the PS trainer ----------


def _nest_flax(named):
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(value)
    return tree


class _JittedInit:
    """A flax module whose init runs as one jitted call (eagerly it
    compiles every initializer on its own, seconds on the CPU)."""

    def __init__(self, module):
        self._module = module

    def init(self, rngs, features, training=False):
        return jax.jit(functools.partial(
            self._module.init, training=training))(rngs, features)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _float64_gradients(model_cls, state, named, loss, features, labels):
    """The training-mode gradients of a float64 copy of the model at the
    given buffers (`state`, a state_dict) and flax-named weights, in flax
    layout."""
    from elasticdl_tpu_torch.common.params import flax_leaves, load_flax

    model = model_cls()
    model.load_state_dict(state)
    load_flax(model, named)
    model = model.double().train()
    loss(torch.from_numpy(labels),
         model(torch.from_numpy(features).double())).backward()
    return {leaf.name: leaf.to_flax(leaf.param.grad).numpy()
            for leaf in flax_leaves(model)}


def test_mnist_batch_stats_under_ps_match_jax(tmp_path, monkeypatch):
    """MNIST (BatchNorm after the convs) through each package's PS trainer
    on two shards, from the same weights, three inline steps. The worker's
    batch_stats after each step agree with the JAX trainer's within 1e-5,
    and the first push's dense gradients within 1e-5 of its largest value.
    Later pushes start from each package's own PS weights (one float32
    rounding apart), where XLA's CPU gradients lie up to 3e-5 of the push's
    largest value from a float64 evaluation: there the port is held to
    1e-5 of that float64 evaluation at its own weights, and to 1e-4 of the
    JAX push. The port's PS export carries batch_stats and, loaded into the
    JAX model, gives the port's eval logits."""
    from elasticdl_tpu.models.mnist import mnist_model as jmnist
    from elasticdl_tpu_torch.common.params import state_to_flax
    from elasticdl_tpu_torch.models.mnist import mnist_model

    rng = np.random.default_rng(7)
    batches = [(rng.random((4, 28, 28), dtype=np.float32),
                rng.integers(0, 10, size=4).astype(np.int64))
               for _ in range(3)]
    # The JAX trainer's steps compile with XLA's backend at optimization
    # level 0: the same IEEE arithmetic, compiled in a fraction of the time.
    monkeypatch.setattr(jax, "jit", functools.partial(
        jax.jit, compiler_options=FAST_COMPILE))
    opt = jmnist.optimizer()
    servers = [JaxParameterServer(i, 2, optimizer_spec=opt)
               for i in range(2)]
    try:
        j_client = JaxPSClient([s.addr for s in servers], worker_id=0,
                               wire_dtype="float32")
        j_trainer = JaxPSTrainer(
            _JittedInit(jmnist.custom_model()), jmnist.loss, opt, j_client,
            embedding_inputs=lambda features: {}, pipeline_pushes=False,
            prefetch_overlap=False)
        j_pushes = _capture_pushes(j_client)
        j_trainer.init_variables_if_needed(batches[0][0])
        named = {k: np.asarray(v) for k, v in flatten_params(
            jax.device_get(j_trainer._variables["params"]))[0].items()}
        j_stats = []
        for f, lab in batches:
            j_trainer.train_minibatch(f, lab)
            j_stats.append({f"batch_stats/{k}": np.asarray(v) for k, v in
                            flatten_params(jax.device_get(
                                j_trainer._variables["batch_stats"]))[0]
                            .items()})
        j_client.close()
    finally:
        for s in servers:
            s.stop()

    shards = [ParameterServer(i, 2, optimizer_spec=mnist_model.optimizer())
              for i in range(2)]
    client = PSClient([s.stub() for s in shards], worker_id=0,
                      wire_dtype="float32")
    trainer = ParameterServerTrainer(
        mnist_model.custom_model(), mnist_model.loss,
        mnist_model.optimizer(), client, pipeline_pushes=False,
        prefetch_overlap=False, device="cpu")
    pushes = _capture_pushes(client)
    pulls = []
    pull = client.pull_dense_parameters

    def capture_pull(*args, **kw):
        result = pull(*args, **kw)
        pulls.append({k: np.array(v) for k, v in result[2].items()})
        return result

    client.pull_dense_parameters = capture_pull
    trainer.load_flax_params(named)
    for step, (f, lab) in enumerate(batches):
        before = {k: v.clone() for k, v in
                  trainer._model.state_dict().items()}
        assert trainer.train_minibatch(f, lab)[0]
        stats = state_to_flax(trainer._model)
        assert sorted(stats) == sorted(j_stats[step]) == [
            "batch_stats/BatchNorm_0/mean", "batch_stats/BatchNorm_0/var"]
        for name, value in stats.items():
            _close(value, j_stats[step][name], what=f"{name} step {step}")
        dense, j_dense = pushes[step][0], j_pushes[step][0]
        assert sorted(dense) == sorted(j_dense) == sorted(named)
        # Relative to the push's largest gradient: a BatchNorm scale's
        # gradient sums thousands of products that cancel, so its float32
        # rounding is relative to the push, not to itself.
        scale = max(float(np.abs(g).max()) for g in j_dense.values())
        if step == 0:
            refs = [(j_dense, GRAD_RTOL)]
        else:
            exact = _float64_gradients(
                mnist_model.MnistCNN, before, pulls[-1], mnist_model.loss,
                f, lab)
            refs = [(exact, GRAD_RTOL), (j_dense, 10 * GRAD_RTOL)]
        for ref, rtol in refs:
            for name in dense:
                err = float(np.abs(dense[name] - ref[name]).max())
                assert err <= rtol * scale, (name, step, err, scale)
    exported = trainer.export_variables()
    assert exported["state"].keys() == j_stats[-1].keys()
    for name, value in exported["state"].items():
        np.testing.assert_array_equal(value, stats[name])
    # A worker checkpoint of the PS trainer carries them as well.
    save_utils.save_trainer_checkpoint(trainer, str(tmp_path / "ckpt"))
    with np.load(tmp_path / "ckpt.npz") as data:
        for name, value in stats.items():
            np.testing.assert_array_equal(data[name], value)
    want = trainer.evaluate_minibatch(batches[0][0])
    variables = {
        "params": _nest_flax(exported["variables"]),
        "batch_stats": _nest_flax({k[len("batch_stats/"):]: v for k, v in
                                   exported["state"].items()})}
    got = jax.jit(jmnist.custom_model().apply)(variables, batches[0][0])
    _close(got, want, what="eval logits of the export in the JAX model")
    client.close()
