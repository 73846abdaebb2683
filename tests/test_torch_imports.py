"""The port stands alone: every module of elasticdl_tpu_torch (and
chip_smoke.py) imports with jax, flax, optax, grpc, google.protobuf and
ml_dtypes blocked (none is on the card's machine), and with the vendor
SDKs kubernetes and odps blocked (the k8s backend and the ODPS reader and
writer import them only where they are used), and loads nothing of the
JAX package; the control-plane modules among them (the journal, the policy
engine, the telemetry plane, the chaos seams, the socket transport, the
process entry points, the instance managers, the `edl` client, the
elastic AllReduce modules, the model, seq and stage axes and the data
axis) import without grpc."""

import os
import pkgutil
import re
import subprocess
import sys

import elasticdl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "elasticdl_tpu_torch")

_GUARD = """
import importlib, sys
for name in ("jax", "flax", "optax", "grpc", "google.protobuf",
             "ml_dtypes", "kubernetes", "odps"):
    sys.modules[name] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m == "elasticdl_tpu"
                or m.startswith("elasticdl_tpu."))
assert not loaded, loaded
print("ok", len(sys.argv) - 1)
"""


def _port_modules():
    names = ["elasticdl_tpu_torch"]
    for info in pkgutil.walk_packages([PACKAGE], "elasticdl_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_with_jax_blocked():
    modules = _port_modules()
    assert "elasticdl_tpu_torch.ops.flash_attention" in modules
    assert "elasticdl_tpu_torch.worker.trainer" in modules
    assert "elasticdl_tpu_torch.worker.worker" in modules
    assert "elasticdl_tpu_torch.master.servicer" in modules
    assert "elasticdl_tpu_torch.proto.messages" in modules
    for name in ("native", "common.hash_utils", "ps.servicer",
                 "ps.checkpoint", "ps.parameter_server", "worker.ps_client",
                 "worker.ps_trainer", "worker.row_cache", "layers.embedding",
                 "preprocessing.layers", "models.dac_ctr.deepfm_ps",
                 "data.gen.criteo", "common.model_handler",
                 "models.dac_ctr.deepfm", "models.dac_ctr.wide_deep",
                 "models.dac_ctr.dcn", "models.dac_ctr.xdeepfm",
                 "data.example", "layers.moe", "models.transformer.moe_lm",
                 "preprocessing.analyzer_utils",
                 "preprocessing.feature_column",
                 "models.census_fc.wide_deep_fc", "models.deepctr.wdl",
                 "data.gen.criteo_tsv", "master.journal",
                 "master.metrics_service", "master.policy",
                 "common.heartbeat", "chaos", "chaos.injection",
                 "observability.promtext", "observability.exporter",
                 "observability.push", "observability.alerts",
                 "observability.aggregator", "observability.flightrec",
                 "observability.dashboard",
                 "worker.prediction_outputs_processor", "common.rpc",
                 "master.instance_manager", "master.main", "ps.main",
                 "worker.main", "chaos.process", "data.recordfile",
                 "common.k8s_resource", "common.k8s_rest",
                 "common.k8s_client", "master.k8s_instance_manager",
                 "client", "client.main", "data.odps_reader",
                 "data.odps_writer", "master.membership",
                 "master.step_lease", "parallel", "parallel.mesh",
                 "parallel.distributed", "parallel.broadcast",
                 "worker.allreduce_trainer", "parallel.collectives",
                 "parallel.tensor_parallel", "parallel.ring_attention",
                 "parallel.ulysses", "parallel.shards", "parallel.zero1",
                 "parallel.quantized", "parallel.sharded_embedding",
                 "parallel.pipeline", "parallel.pipeline_interleaved",
                 "parallel.pipeline_schedule", "layers.remat"):
        assert f"elasticdl_tpu_torch.{name}" in modules
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, *modules, "chip_smoke"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(modules) + 1)]


_NO_DYNAMO = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "torch._dynamo":
            raise ImportError("torch._dynamo imported")
sys.meta_path.insert(0, Refuse())
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.worker.trainer import LocalTrainer
cfg = tlm.LMConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, max_len=16)
tokens = synthetic_lm_tokens(4, 16, vocab=64, branching=4, seed=0)
for spec in (optimizers.adam(), optimizers.momentum(), optimizers.sgd(),
             optimizers.adagrad(), optimizers.adam(amsgrad=True)):
    trainer = LocalTrainer(tlm.custom_model(cfg), tlm.loss, spec,
                           device="cpu")
    trainer.train_minibatch(tokens[:, :-1], tokens[:, 1:])
for policy in tlm.REMAT_POLICIES:
    rcfg = tlm.LMConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                        max_len=16, remat=True, remat_policy=policy)
    trainer = LocalTrainer(tlm.custom_model(rcfg), tlm.loss,
                           optimizers.adam(), device="cpu")
    trainer.train_minibatch(tokens[:, :-1], tokens[:, 1:])
# A 1F1B step of two stage shards through the AllReduce trainer.
from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.master.membership import MembershipManager
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient
pcfg = tlm.LMConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                    max_len=16)
servicer = MasterServicer(TaskDispatcher({}), None,
                          MembershipManager(coordinator_port=0))
client = MasterClient(rpc.InProcessStub(servicer, rpc.MASTER_SERVICE), 0,
                      worker_host="127.0.0.1")
trainer = AllReduceTrainer(
    tlm.custom_model(pcfg), tlm.loss, optimizers.adam(), client,
    device="cpu", pipeline_stages=2, pipeline_schedule="1f1b",
    pipeline_spec_fn=lambda **kw: tlm.pipeline_spec(config=pcfg, **kw))
trainer._local_devices = 2
trainer.train_minibatch(tokens[:, :-1], tokens[:, 1:])
assert trainer.world_fingerprint == "data=1,stage=2"
trainer.close()
print("ok")
"""


def test_a_training_step_imports_no_dynamo():
    """Building the LM on the meta device, materializing it and a step of
    every optimizer, a step under every remat policy and a 1F1B step of two
    stage shards import no torch._dynamo: the import held a worker
    process's start 8.8 s on an H100 host (PERF.md), for a compiler the
    port never runs."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_DYNAMO], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_no_jax_package_import_strings():
    pattern = re.compile(
        r"^\s*(from|import)\s+(elasticdl_tpu|jax|flax|optax)(\.|\s|$)",
        re.M,
    )
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(
            elasticdl_tpu_torch.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            offenders += [(path, m.group(0)) for m in pattern.finditer(f.read())]
    assert not offenders, offenders
