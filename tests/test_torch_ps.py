"""The port's parameter-server stack (elasticdl_tpu_torch/native, ps/,
common/hash_utils.py, the PS codec of common/tensor_utils.py, the Criteo
feed) against the JAX package's: the host library's applies against their
numpy reference and the JAX optimizer, table rows, servicer answers for the
same request bytes, checkpoints across the two packages, the feed."""

import time

import numpy as np
import pytest

from elasticdl_tpu.common import hash_utils as jax_hash_utils
from elasticdl_tpu.data.gen import criteo as jax_criteo
from elasticdl_tpu.models.dac_ctr import transform as jax_transform
from elasticdl_tpu.ops import optimizers as jax_optimizers
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb2
from elasticdl_tpu.ps import checkpoint as jax_ckpt
from elasticdl_tpu.ps.embedding_table import (
    EmbeddingTable as JaxEmbeddingTable,
)
from elasticdl_tpu.ps.optimizer import PSOptimizer as JaxPSOptimizer
from elasticdl_tpu.ps.parameters import Parameters as JaxParameters
from elasticdl_tpu.ps.servicer import PserverServicer as JaxServicer
from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.common import hash_utils, rpc, tensor_utils
from elasticdl_tpu_torch.data.gen import criteo
from elasticdl_tpu_torch.models.dac_ctr import transform
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.ps import checkpoint as ckpt
from elasticdl_tpu_torch.ps.embedding_table import EmbeddingTable
from elasticdl_tpu_torch.ps.optimizer import PSOptimizer, numpy_rule
from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
from elasticdl_tpu_torch.ps.parameters import Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.worker.ps_client import PSClient

# The library against its numpy reference: the same float32 arithmetic, in
# another order where numpy evaluates whole expressions.
REFERENCE_TOL = 1e-6

SPECS = {
    "sgd": ("sgd", dict(learning_rate=0.1)),
    "momentum": ("momentum", dict(learning_rate=0.1, momentum=0.9)),
    "nesterov": ("momentum", dict(learning_rate=0.1, momentum=0.9,
                                  nesterov=True)),
    "adam": ("adam", dict(learning_rate=0.01)),
    "amsgrad": ("adam", dict(learning_rate=0.01, amsgrad=True)),
    "adagrad": ("adagrad", dict(learning_rate=0.1)),
}


def _specs(key):
    name, hyper = SPECS[key]
    return (optimizers.OptimizerSpec(name, **hyper),
            jax_optimizers.OptimizerSpec(name, **hyper))


def _apply_steps(opt_cls, table_cls, spec, steps=3):
    """Three pushes of dense and indexed gradients (duplicate ids within a
    push, as the servicer's sync merge can never send but the kernels
    allow) -> (param, table rows, table ids)."""
    rng = np.random.default_rng(0)
    opt = opt_cls(spec)
    param = rng.normal(size=(5, 7)).astype(np.float32)
    table = table_cls("t", 4, seed=1)
    for _ in range(steps):
        opt.begin_apply()
        opt.apply_dense("p", param, rng.normal(size=(5, 7)).astype(
            np.float32))
        ids = rng.integers(0, 9, size=6)
        opt.apply_sparse(table, ids, rng.normal(size=(6, 4)).astype(
            np.float32))
        opt.end_apply()
    ids, rows = table.export_rows()
    return param, rows, ids


@pytest.mark.parametrize("key", sorted(SPECS))
def test_native_applies_match_numpy_reference_and_jax(key):
    spec, jax_spec = _specs(key)
    param, rows, ids = _apply_steps(PSOptimizer, EmbeddingTable, spec)
    # Bitwise against the JAX package's optimizer on its own library.
    j_param, j_rows, j_ids = _apply_steps(JaxPSOptimizer, JaxEmbeddingTable,
                                          jax_spec)
    np.testing.assert_array_equal(param, j_param)
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(ids, j_ids)

    # The numpy reference, row by row, from the same initial rows.
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(5, 7)).astype(np.float32)
    init = EmbeddingTable("t", 4, seed=1)
    dense_slots, row_slots = {}, {}

    def slots_of(store, key_):
        def slot_of(name, init_value):
            k = (key_, name)
            if k not in store:
                store[k] = np.full(4 if key_ is not None else ref.shape,
                                   init_value, np.float32)
            return store[k]
        return slot_of

    ref_rows = {}
    lr = spec.hyperparams["learning_rate"]
    for step in range(1, 4):
        numpy_rule(spec, ref, rng.normal(size=(5, 7)).astype(np.float32),
                   lr, step, slots_of(dense_slots, None))
        step_ids = rng.integers(0, 9, size=6)
        grads = rng.normal(size=(6, 4)).astype(np.float32)
        for j, id_ in enumerate(step_ids):
            if id_ not in ref_rows:
                ref_rows[id_] = init.lookup(np.array([id_]))[0].copy()
            numpy_rule(spec, ref_rows[id_], grads[j], lr, step,
                       slots_of(row_slots, id_))
    np.testing.assert_allclose(param, ref, rtol=0, atol=REFERENCE_TOL)
    np.testing.assert_allclose(rows, np.stack([ref_rows[i] for i in ids]),
                               rtol=0, atol=REFERENCE_TOL)


@pytest.mark.parametrize("spec", [
    "uniform", "uniform(-0.2,0.3)", "normal(0,0.01)", "truncated_normal",
    "constant(0.25)", "zeros",
])
def test_embedding_table_rows_bitwise_as_jax(spec):
    ours = EmbeddingTable("t", 8, initializer=spec, seed=7)
    theirs = JaxEmbeddingTable("t", 8, initializer=spec, seed=7)
    # Enough ids to grow both slabs past their initial capacity.
    ids = np.random.default_rng(0).integers(0, 10**9, size=3000)
    np.testing.assert_array_equal(ours.lookup(ids), theirs.lookup(ids))
    for a, b in zip(ours.export_rows(100, 500), theirs.export_rows(100, 500)):
        np.testing.assert_array_equal(a, b)
    assert len(ours) == len(theirs)
    with pytest.raises(ValueError, match="unknown initializer"):
        EmbeddingTable("t", 8, initializer="glorot")


def test_hash_partitioning_as_jax():
    names = [f"DNN_0/Dense_{i}/kernel" for i in range(20)] + ["w", "é"]
    for n in (1, 2, 3, 7):
        assert ([hash_utils.string_to_id(x, n) for x in names]
                == [jax_hash_utils.string_to_id(x, n) for x in names])
        ids = np.random.default_rng(n).integers(-50, 10**7, size=200)
        ours = hash_utils.scatter_embedding_ids(ids, n)
        theirs = jax_hash_utils.scatter_embedding_ids(ids, n)
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            for a, b in zip(ours[k], theirs[k]):
                np.testing.assert_array_equal(a, b)


def test_dedup_matches_numpy_reference():
    rng = np.random.default_rng(3)
    ids = rng.integers(-5, 40, size=300)
    values = rng.normal(size=(300, 3)).astype(np.float32)
    got_values, got_ids = tensor_utils.deduplicate_indexed_slices(values, ids)
    want_ids, inverse = np.unique(ids, return_inverse=True)
    want = np.zeros((len(want_ids), 3), np.float32)
    np.add.at(want, inverse, values)
    np.testing.assert_array_equal(got_ids, want_ids)
    # Sums of the same rows in another order.
    np.testing.assert_allclose(got_values, want, rtol=0, atol=1e-5)
    empty_values, empty_ids = tensor_utils.deduplicate_indexed_slices(
        np.empty((0, 3), np.float32), np.empty(0, np.int64))
    assert empty_values.shape == (0, 3) and empty_ids.shape == (0,)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a library that cannot be built raises."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        native.build()


# ---------- the servicer: the same request bytes into both packages ----------

DIM = 4


def _model_bytes():
    rng = np.random.default_rng(5)
    model = pb.Model(version=0)
    for name, shape in (("a/kernel", (3, 2)), ("b/bias", (2,))):
        model.dense_parameters.append(tensor_utils.ndarray_to_tensor_pb(
            rng.normal(size=shape).astype(np.float32), name))
    model.embedding_table_infos.append(pb.EmbeddingTableInfo(
        name="emb", dim=DIM, initializer="uniform", dtype=pb.DT_FLOAT32))
    return model.SerializeToString()


def _packed_push_bytes(version, seed, wire="float32", max_push_bytes=None,
                       worker_id=0, monkeypatch=None):
    """The port's client's packed push for one shard, as bytes (several
    chunks when max_push_bytes is set)."""
    if max_push_bytes is not None:
        monkeypatch.setenv("ELASTICDL_PS_MAX_PUSH_BYTES", str(max_push_bytes))
    client = PSClient([None], worker_id=worker_id, wire_dtype=wire)
    rng = np.random.default_rng(seed)
    dense = {"a/kernel": rng.normal(size=(3, 2)).astype(np.float32),
             "b/bias": rng.normal(size=(2,)).astype(np.float32)}
    ids = rng.integers(0, 30, size=12)
    sparse = {"emb": (rng.normal(size=(12, DIM)).astype(np.float32), ids)}
    reqs = client._build_packed_requests(dense, sparse, version, 0.0, 8)[0]
    return [r.SerializeToString() for r in reqs]


class _Pair:
    """A JAX and a port servicer over fresh stores; `call` feeds both the
    same request bytes and returns both responses' bytes."""

    def __init__(self, **kw):
        spec, jax_spec = _specs("adam")
        self.ours = Parameters()
        self.theirs = JaxParameters()
        self.port = PserverServicer(self.ours, PSOptimizer(spec), **kw)
        self.jax = JaxServicer(self.theirs, JaxPSOptimizer(jax_spec), **kw)

    def call(self, method, data):
        req_cls, resp_cls = rpc.PSERVER_SERVICE.methods[method]
        ours = getattr(self.port, method)(req_cls.FromString(data), None)
        theirs = getattr(self.jax, method)(
            getattr(pb2, req_cls.__name__).FromString(data), None)
        if resp_cls is pb.PushGradientsResponse:
            # apply_seconds is each side's own clock.
            ours.apply_seconds = 0.0
            theirs.apply_seconds = 0.0
        return ours.SerializeToString(), theirs.SerializeToString()

    def assert_same_store(self):
        assert self.ours.version == self.theirs.version
        assert self.ours.total_records == self.theirs.total_records
        assert sorted(self.ours.dense) == sorted(self.theirs.dense)
        for name in self.ours.dense:
            np.testing.assert_array_equal(self.ours.dense[name],
                                          self.theirs.dense[name])
        for name, table in self.ours.embedding_tables.items():
            for a, b in zip(table.export_rows(),
                            self.theirs.embedding_tables[name].export_rows()):
                np.testing.assert_array_equal(a, b)


def _pull_vectors_bytes(ids, bf16=False):
    return pb.PullEmbeddingVectorsRequest(
        name="emb", ids_bytes=tensor_utils.ids_to_bytes(ids),
        value_dtype=pb.DT_BFLOAT16 if bf16 else pb.DT_INVALID,
    ).SerializeToString()


def test_servicer_async_answers_as_jax(monkeypatch):
    pair = _Pair()
    uninit = pb.PullDenseParametersRequest(version=0).SerializeToString()
    ours, theirs = pair.call("pull_dense_parameters", uninit)
    assert ours == theirs
    ours, theirs = pair.call("push_model", _model_bytes())
    assert ours == theirs
    ids = np.array([3, 17, 3, 29, 0], np.int64)
    for bf16 in (False, True):
        ours, theirs = pair.call("pull_embedding_vectors",
                                 _pull_vectors_bytes(ids, bf16))
        assert ours == theirs
    # The last push is split into chunks, delivered out of order.
    chunks = _packed_push_bytes(2, 3, max_push_bytes=96,
                                monkeypatch=monkeypatch)
    assert len(chunks) >= 3
    pushes = (_packed_push_bytes(0, 1)
              + _packed_push_bytes(1, 2, wire="bfloat16") + chunks[::-1])
    for data in pushes:
        ours, theirs = pair.call("push_gradients_packed", data)
        assert ours == theirs
    # The per-tensor (unpacked) push.
    rng = np.random.default_rng(9)
    model = pb.Model(version=3)
    model.dense_parameters.append(tensor_utils.ndarray_to_tensor_pb(
        rng.normal(size=(2,)).astype(np.float32), "b/bias"))
    model.embedding_tables["emb"] = tensor_utils.ndarray_to_indexed_slices_pb(
        rng.normal(size=(2, DIM)).astype(np.float32), np.array([4, 5]))
    ours, theirs = pair.call("push_gradients", pb.PushGradientsRequest(
        gradients=model, batch_size=3).SerializeToString())
    assert ours == theirs
    for version in (0, 4):
        ours, theirs = pair.call(
            "pull_dense_parameters",
            pb.PullDenseParametersRequest(version=version).SerializeToString())
        assert ours == theirs
    ours, theirs = pair.call(
        "pull_embedding_table", pb.PullEmbeddingTableRequest(
            name="emb", start_row=1, max_rows=4).SerializeToString())
    assert ours == theirs
    assert pair.ours.version == 4
    pair.assert_same_store()


def test_servicer_sync_rejects_stale_as_jax():
    pair = _Pair(use_async=False, grads_to_wait=2)
    pair.call("push_model", _model_bytes())
    # Two workers fill the quorum at version 0; the window applies once.
    for worker_id, seed in ((0, 1), (1, 2)):
        ours, theirs = pair.call(
            "push_gradients_packed",
            _packed_push_bytes(0, seed, worker_id=worker_id)[0])
        assert ours == theirs
    assert pair.ours.version == 1
    # A push computed at version 0 is now stale: rejected by both.
    ours, theirs = pair.call("push_gradients_packed",
                             _packed_push_bytes(0, 3, worker_id=0)[0])
    assert ours == theirs
    assert not pb.PushGradientsResponse.FromString(ours).accepted
    pair.assert_same_store()


def test_in_process_stub_futures_and_errors():
    ps = ParameterServer(0, 1, optimizer_spec=optimizers.sgd(0.1))
    stub = ps.stub()
    try:
        stub.push_model(pb.Model.FromString(_model_bytes()))
        futures = [stub.pull_dense_parameters.future(
            pb.PullDenseParametersRequest()) for _ in range(6)]
        assert all(f.result().initialized for f in futures)
        with pytest.raises(rpc.RpcError) as err:
            stub.pull_embedding_vectors.future(pb.PullEmbeddingVectorsRequest(
                name="nope", ids_bytes=b"\0" * 8)).result()
        assert err.value.code() == rpc.StatusCode.UNKNOWN
    finally:
        stub.close()


def test_served_shard_futures_and_errors_over_the_socket():
    ps = ParameterServer(0, 1, port=0, optimizer_spec=optimizers.sgd(0.1))
    channel = rpc.build_channel(ps.addr, ready_timeout=0)
    stub = rpc.Stub(channel, rpc.PSERVER_SERVICE)
    try:
        stub.push_model(pb.Model.FromString(_model_bytes()))
        futures = [stub.pull_dense_parameters.future(
            pb.PullDenseParametersRequest()) for _ in range(6)]
        assert all(f.result().initialized for f in futures)
        with pytest.raises(rpc.RpcError) as err:
            stub.pull_embedding_vectors.future(pb.PullEmbeddingVectorsRequest(
                name="nope", ids_bytes=b"\0" * 8)).result()
        assert err.value.code() == rpc.StatusCode.UNKNOWN
    finally:
        channel.close()
        ps.stop()


def test_ps_main_exits_when_the_master_stops_answering(monkeypatch):
    """ps/main.py serves its shard and leaves once report_version to the
    master fails."""
    import threading

    from elasticdl_tpu_torch.ps import main as ps_main

    for name, value in (("ELASTICDL_RPC_MAX_ATTEMPTS", "1"),
                        ("ELASTICDL_RPC_READY_TIMEOUT", "0"),
                        ("ELASTICDL_METRICS_PORT", "-1"),
                        ("ELASTICDL_OBS_DIR", ""),
                        ("ELASTICDL_FLIGHTREC", "0")):
        monkeypatch.setenv(name, value)
    rpc.reload_config()
    versions = []

    class Master:
        def __getattr__(self, method):
            def handler(request, context):
                versions.append(request.model_version)
                return pb.Empty()
            return handler

    master, master_port = rpc.serve(Master(), rpc.MASTER_SERVICE)
    probe = __import__("socket").socket()
    probe.bind(("127.0.0.1", 0))
    ps_port = probe.getsockname()[1]
    probe.close()
    out = {}
    thread = threading.Thread(target=lambda: out.update(rc=ps_main.main([
        "--ps_id", "0", "--num_ps", "1", "--port", str(ps_port),
        "--master_addr", f"127.0.0.1:{master_port}",
        "--model_def", "elasticdl_tpu_torch.models.dac_ctr.deepfm_ps",
    ], poll_seconds=0.05)))
    thread.start()
    try:
        assert rpc.wait_channel_ready(f"127.0.0.1:{ps_port}", 10)
        deadline = time.time() + 10
        while not versions and time.time() < deadline:
            time.sleep(0.02)
        assert versions and versions[0] == 0
        master.stop(0)
        thread.join(timeout=20)
        assert not thread.is_alive() and out["rc"] == 0
        assert not rpc.wait_channel_ready(f"127.0.0.1:{ps_port}", 0.3)
    finally:
        master.stop(0)
        thread.join(timeout=20)
        monkeypatch.undo()
        rpc.reload_config()


# ---------- checkpoints across the two packages ----------


def _fill(params_cls, ps_id, num_ps):
    """Shard `ps_id` of `num_ps`: its embedding ids are those = ps_id mod
    num_ps, as a real shard's."""
    ids = np.random.default_rng(ps_id).integers(0, 100, size=30)
    params = params_cls()
    message = pb2.Model.FromString(_model_bytes()) if (
        params_cls is JaxParameters) else pb.Model.FromString(_model_bytes())
    params.init_from_model_pb(message)
    params.embedding_tables["emb"].lookup(ids[ids % num_ps == ps_id])
    params.version, params.total_records = 7, 112
    return params


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_ps_checkpoint_restores_across_packages(tmp_path, direction):
    saver_mod, restore_mod, src_cls, dst_cls = (
        (ckpt, jax_ckpt, Parameters, JaxParameters)
        if direction == "port_to_jax"
        else (jax_ckpt, ckpt, JaxParameters, Parameters))
    # Two shards saved, restored into ONE shard (reshard on load) and into
    # shard 1 of 2.
    sources = []
    for ps_id in range(2):
        src = _fill(src_cls, ps_id, 2)
        saver_mod.CheckpointSaver(str(tmp_path), ps_id, 2).save(7, src)
        sources.append(src)
    assert restore_mod.latest_complete_version(str(tmp_path)) == 7
    assert restore_mod.read_total_records(str(tmp_path), 7) == 112
    whole = dst_cls()
    restore_mod.restore_shard(str(tmp_path), 7, whole, 0, 1)
    assert whole.version == 7 and whole.initialized
    want_ids = np.concatenate([s.embedding_tables["emb"].export_rows()[0]
                               for s in sources])
    want_rows = np.concatenate([s.embedding_tables["emb"].export_rows()[1]
                                for s in sources])
    got = whole.embedding_tables["emb"]
    np.testing.assert_array_equal(
        got.lookup(want_ids), want_rows)
    half = dst_cls()
    restore_mod.restore_shard(str(tmp_path), 7, half, 1, 2)
    ids = half.embedding_tables["emb"].export_rows()[0]
    assert len(ids) and (ids % 2 == 1).all()
    for name in half.dense:
        assert hash_utils.string_to_id(name, 2) == 1


# ---------- the Criteo feed ----------


def test_criteo_feed_bitwise_as_jax():
    records = list(criteo.iter_criteo_records(96, seed=4, chunk=64))
    jax_records = list(jax_criteo.iter_criteo_records(96, seed=4, chunk=64))
    features, labels = transform.feed(records, "training", None)
    jax_features, jax_labels = jax_transform.feed(jax_records, "training",
                                                  None)
    for key in ("dense", "ids"):
        assert features[key].dtype == jax_features[key].dtype
        np.testing.assert_array_equal(features[key], jax_features[key])
    np.testing.assert_array_equal(labels, jax_labels)
    assert transform.TOTAL_IDS == jax_transform.TOTAL_IDS == 5_546_673
    # Each package reads the other's records.
    cross, _ = transform.feed(jax_records, "training", None)
    np.testing.assert_array_equal(cross["ids"], features["ids"])
