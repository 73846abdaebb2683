"""The port's ODPS reader and writer against the JAX package's, over the
injected fake clients of tests/test_odps_reader.py and
tests/test_odps_writer.py: shards, metadata, records (ordered parallel
pages, retries, exhaustion), the origin URI, the vendor SDK gate, the
writer's rows and partitions (create, reuse, chunks, retries, the create
race, the processor's buffering), and a prediction job in one process
that reads an `odps://` origin and writes its predictions to an ODPS
table, held against the JAX model's forward on the same weights."""

import sys

import numpy as np
import pytest

from elasticdl_tpu.data import odps_reader as jax_reader
from elasticdl_tpu.data import odps_writer as jax_writer
from elasticdl_tpu_torch.data import odps_reader as port_reader
from elasticdl_tpu_torch.data import odps_writer as port_writer
from elasticdl_tpu_torch.data.reader import create_data_reader

from test_odps_reader import _FakeOdps, _rows, _Task
from test_odps_writer import _FakeOdpsW, _FakeWritableTable


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the error's type is the result
        return "error", type(e).__name__


# (reader kwargs, fake client kwargs, task range)
READER_CASES = [
    ({}, {}, (0, 100)),
    ({"partition": "dt=20260731"}, {}, (10, 90)),
    ({"page_records": 64, "num_parallel": 4}, {}, (10, 905)),
    ({"page_records": 128, "num_parallel": 2, "max_retries": 3,
      "retry_base_seconds": 0.001}, {"fail_plan": {0: 2}}, (0, 200)),
    ({"page_records": 128, "max_retries": 2, "retry_base_seconds": 0.001},
     {"fail_plan": {0: 99}}, (0, 200)),
    ({"columns": ["a", "b", "c"], "page_records": 7}, {}, (3, 50)),
]


@pytest.mark.parametrize("kwargs,fake,span", READER_CASES)
def test_reader_matches_jax(kwargs, fake, span):
    rows = _rows(1000)
    outcomes = {}
    for name, module in (("jax", jax_reader), ("port", port_reader)):
        client = _FakeOdps(rows, **fake)
        reader = module.OdpsReader(table="t", client=client, **kwargs)
        outcomes[name] = (
            reader.create_shards(),
            reader.metadata.column_names,
            _outcome(lambda: list(reader.read_records(_Task(*span)))),
            client.calls,
        )
    assert outcomes["port"] == outcomes["jax"]


@pytest.mark.parametrize("origin", [
    "odps://proj/tables/clicks/dt=1", "odps://p/tables/t",
    "odps://p/tables/t/a=1/b=2", "odps://p/t", "odps://p/tables/"])
def test_parse_odps_origin_matches_jax(monkeypatch, origin):
    monkeypatch.setenv("ODPS_ACCESS_ID", "id")
    monkeypatch.setenv("ODPS_ACCESS_KEY", "key")
    monkeypatch.setenv("ODPS_ENDPOINT", "http://odps.example")
    assert (_outcome(lambda: port_reader.parse_odps_origin(origin))
            == _outcome(lambda: jax_reader.parse_odps_origin(origin)))


def test_vendor_sdk_gate_and_origin_routing(monkeypatch):
    monkeypatch.setitem(sys.modules, "odps", None)
    for module in (port_reader, jax_reader):
        with pytest.raises(ImportError, match="pyodps"):
            module.OdpsReader(table="t")
    for module in (port_writer, jax_writer):
        with pytest.raises(ImportError, match="pyodps"):
            module.OdpsWriter(table="t")
    with pytest.raises(ImportError, match="pyodps"):
        create_data_reader("odps://proj/tables/t")
    reader = create_data_reader("odps://proj/tables/t/dt=1",
                                client=_FakeOdps(_rows(5)))
    assert isinstance(reader, port_reader.OdpsReader)
    assert reader.create_shards() == {"t/dt=1": (0, 5)}


class _RacyOdps(_FakeOdpsW):
    """A peer creates the table between exist_table and create_table."""

    def create_table(self, name, schema):
        self.created.append((name, schema))
        self.tables[name] = _FakeWritableTable(self._fail_plan)
        raise RuntimeError(f"Table {name} already exists")


def _write_rows(module, client, writer_kwargs, batches):
    w = module.OdpsWriter(table="preds", client=client,
                          retry_base_seconds=0.001, **writer_kwargs)
    return [w.from_iterator(iter(rows), worker_index=wid)
            for wid, rows in batches]


def _process(module, client, writer_kwargs, batches):
    p = module.OdpsPredictionOutputsProcessor(
        table="preds", client=client, retry_base_seconds=0.001,
        **writer_kwargs)
    for wid, rows in batches:
        p.process(np.asarray(rows), worker_id=wid)
    return [p.close(), p.close()]


_ROWS = [[float(i), float(i) * 2] for i in range(100)]
# (client factory, writer kwargs, (worker, rows) batches, writer or
# processor)
WRITER_CASES = [
    (lambda: _FakeOdpsW(), {"columns": ["f0", "f1"],
                            "column_types": ["double", "double"]},
     [(2, _ROWS[:2])], _write_rows),
    (lambda: _FakeOdpsW(existing=["preds"]), {}, [(0, [[3.0]])],
     _write_rows),
    (lambda: _FakeOdpsW(), {}, [(0, [[1.0]])], _write_rows),
    (lambda: _FakeOdpsW(existing=["preds"]), {"chunk_rows": 16},
     [(0, _ROWS), (1, _ROWS[:5])], _write_rows),
    (lambda: _FakeOdpsW(existing=["preds"], fail_plan={"worker=0": 2}),
     {"max_retries": 3}, [(0, [[1.0]])], _write_rows),
    (lambda: _FakeOdpsW(existing=["preds"], fail_plan={"worker=0": 99}),
     {"max_retries": 2}, [(0, [[1.0]])], _write_rows),
    (lambda: _RacyOdps(), {"columns": ["f0"], "column_types": ["double"]},
     [(0, [[1.0]])], _write_rows),
    (lambda: _FakeOdpsW(existing=["preds"]), {"chunk_rows": 64},
     [(1, [[float(i)]] * 16) for i in range(10)], _process),
    (lambda: _FakeOdpsW(), {"chunk_rows": 8},
     [(3, [[float(i), -float(i)]] * 4) for i in range(5)], _process),
]


@pytest.mark.parametrize("make_client,writer_kwargs,batches,run",
                         WRITER_CASES)
def test_writer_matches_jax(make_client, writer_kwargs, batches, run):
    outcomes = {}
    for name, module in (("jax", jax_writer), ("port", port_writer)):
        client = make_client()
        result = _outcome(lambda: run(module, client, writer_kwargs,
                                      batches))
        outcomes[name] = (
            result, client.created,
            {t: (table.partitions, table.open_writer_calls)
             for t, table in client.tables.items()},
        )
    assert outcomes["port"] == outcomes["jax"]


_LINEAR_DEF = """\
import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.odps_reader import OdpsReader
from elasticdl_tpu_torch.data.odps_writer import (
    OdpsPredictionOutputsProcessor,
)
from elasticdl_tpu_torch.ops import optimizers

import test_torch_odps as _t


class LinearModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(2, 1)

    def forward(self, x):
        return self.Dense_0(x.float())


def custom_model():
    return LinearModel()


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return torch.mean((predictions.reshape(-1) - labels.reshape(-1)) ** 2)


def optimizer(lr=0.1):
    return optimizers.sgd(learning_rate=lr)


def feed(records, mode, metadata):
    arr = np.asarray(records, dtype=np.float32)
    return arr[:, :2], (arr[:, 2] if mode != Modes.PREDICTION else None)


def create_data_reader(origin, **kwargs):
    from elasticdl_tpu_torch.data.odps_reader import parse_odps_origin

    return OdpsReader(**parse_odps_origin(origin), client=_t.SOURCE,
                      page_records=16)


prediction_outputs_processor = OdpsPredictionOutputsProcessor(
    table="preds", client=_t.SINK, chunk_rows=24)
"""

SOURCE = SINK = None


def test_prediction_job_reads_and_writes_odps(tmp_path, monkeypatch):
    """An `odps://` origin through the port's master and worker in one
    process, the predictions into the table's worker=3 partition; the
    rows equal the JAX linear model's forward on the worker's weights."""
    import flax.linen as nn
    import jax.numpy as jnp

    from elasticdl_tpu_torch.common.args import master_parser, worker_parser
    from elasticdl_tpu_torch.common.params import params_to_flax
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.worker.main import build_worker
    from elasticdl_tpu_torch.worker.master_client import MasterClient

    rng = np.random.default_rng(1)
    rows = [[float(a), float(b), 0.0] for a, b in rng.normal(size=(64, 2))]
    monkeypatch.setattr(sys.modules[__name__], "SOURCE", _FakeOdps(rows))
    monkeypatch.setattr(sys.modules[__name__], "SINK", _FakeOdpsW())
    for var, value in (("ELASTICDL_HEARTBEAT_SECONDS", "0"),
                       ("ELASTICDL_TELEMETRY_PUSH_INTERVAL", "0")):
        monkeypatch.setenv(var, value)
    for var in ("ELASTICDL_METRICS_PORT", "ELASTICDL_OBS_DIR",
                "ELASTICDL_MASTER_JOURNAL_DIR"):
        monkeypatch.delenv(var, raising=False)
    model_def = tmp_path / "odps_linear_def.py"
    model_def.write_text(_LINEAR_DEF)
    common = ["--model_def", str(model_def), "--prediction_data",
              "odps://proj/tables/in", "--records_per_task", "16",
              "--minibatch_size", "16", "--distribution_strategy", "Local"]
    master = Master(master_parser().parse_args(
        common + ["--instance_backend", "none"]))
    try:
        worker = build_worker(
            worker_parser().parse_args(common + [
                "--worker_id", "3", "--master_addr", "in-process",
                "--job_type", "prediction_only"]),
            MasterClient(master.stub(), 3), device="cpu")
        worker.run()
        assert master.task_d.finished() and not master.task_d.job_failed
    finally:
        master.stop()
    table = SINK.tables["preds"]
    got = np.asarray(table.partitions["worker=3"], np.float64).reshape(-1)
    assert len(got) == 64
    assert SINK.created == [("preds", ("f0 double", "worker string"))]
    # Minibatches of 16 rows against chunks of 24: every second minibatch
    # flushes 32 buffered rows as two writes (24 + 8); close finds none.
    assert len(table.open_writer_calls) == 4
    params = params_to_flax(worker.trainer._model)
    want = nn.Dense(1).apply(
        {"params": {k.split("/")[1]: jnp.asarray(v)
                    for k, v in params.items()}},
        jnp.asarray(np.asarray(rows, np.float32)[:, :2]))
    np.testing.assert_allclose(got, np.asarray(want).reshape(-1),
                               rtol=1e-5, atol=1e-6)
