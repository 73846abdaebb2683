"""The master's job assembly (counterpart of elasticdl_tpu/master/master.py:
75-149, 241-247, 374-405): from master args, the model spec, the dataset
shards, the task dispatcher, the evaluation service and the servicer; under
ParameterServerStrategy also `--num_ps` parameter-server shards, built in
this process with the arguments the JAX master hands its PS processes, and
the resume from a PS checkpoint (`--checkpoint_dir_for_init`: records the
checkpoint already trained on are not dispatched again).

A worker in the same process reaches the master through `stub()` and the
shards through `ps_stubs()`, in-process stubs that cross the wire format on
every call. `relaunch_ps(i)` replaces shard i with a fresh one behind the
same stubs, as a relaunched PS pod comes back on the same address. Serving
over gRPC, the poll loop and its watchdogs, the instance managers, the
journal, the policy engine, the metrics service and observability setup
come with the transport; the arguments that ask for them raise
NotImplementedError.
"""

import sys

from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.common.constants import DistributionStrategy
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.ps import checkpoint as ps_checkpoint
from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
from elasticdl_tpu_torch.worker.master_client import MasterClient

logger = get_logger("master.master")


def _reject_unported(args):
    if args.distribution_strategy not in (
            DistributionStrategy.LOCAL,
            DistributionStrategy.PARAMETER_SERVER):
        raise NotImplementedError(
            f"--distribution_strategy {args.distribution_strategy} is not "
            "ported to elasticdl_tpu_torch yet; use "
            f"{DistributionStrategy.LOCAL} or "
            f"{DistributionStrategy.PARAMETER_SERVER}"
        )
    if args.instance_backend != "none":
        raise NotImplementedError(
            "instance managers are not ported to elasticdl_tpu_torch yet; "
            "use --instance_backend none and build workers in process"
        )
    if args.metrics_dir:
        raise NotImplementedError(
            "the metrics service (--metrics_dir) is not ported yet"
        )


class Master:
    def __init__(self, args):
        _reject_unported(args)
        self.args = args
        if args.model_zoo:
            sys.path.insert(0, args.model_zoo)
        self.spec = get_model_spec(args.model_def)

        # --- data shards -> task dispatcher ---
        reader_factory = self.spec.create_data_reader or create_data_reader
        training_shards = (
            reader_factory(args.training_data).create_shards()
            if args.training_data
            else {}
        )
        evaluation_shards = (
            reader_factory(args.validation_data).create_shards()
            if args.validation_data
            else {}
        )
        prediction_shards = (
            reader_factory(args.prediction_data).create_shards()
            if args.prediction_data
            else {}
        )
        self.task_d = TaskDispatcher(
            training_shards,
            evaluation_shards,
            prediction_shards,
            records_per_task=args.records_per_task,
            num_epochs=args.num_epochs,
            shuffle=args.shuffle_shards,
            seed=args.seed,
        )

        if args.checkpoint_dir_for_init and training_shards:
            self._resume_from_ps_checkpoint(args)

        self.evaluation_service = None
        if evaluation_shards:
            self.evaluation_service = EvaluationService(
                self.task_d,
                self.spec.build_metrics
                if self.spec.eval_metrics_fn
                else dict,
                eval_steps=args.evaluation_steps,
            )
        if args.output and training_shards:
            # Arm the final export task (a train-end callback task).
            self.task_d.enable_train_end_task()
        self.servicer = MasterServicer(
            self.task_d,
            self.evaluation_service,
            worker_liveness_timeout=args.worker_liveness_timeout_seconds,
        )

        self.ps_servers = []
        if args.distribution_strategy == DistributionStrategy.PARAMETER_SERVER:
            if args.num_ps < 1:
                raise ValueError(
                    "ParameterServerStrategy requires --num_ps >= 1")
            self.ps_servers = [self._build_ps(i) for i in range(args.num_ps)]

    def _resume_from_ps_checkpoint(self, args):
        """Skip the records a PS checkpoint already trained on: the
        checkpoint carries their exact count (a version alone is ambiguous:
        a sync window merges a variable number of pushes, tasks end in
        partial batches); checkpoints without it fall back to an estimate
        from the version."""
        version = ps_checkpoint.latest_complete_version(
            args.checkpoint_dir_for_init)
        if not version:
            return
        records = ps_checkpoint.read_total_records(
            args.checkpoint_dir_for_init, version)
        if not records:
            records = (version
                       * (1 if args.use_async else max(args.grads_to_wait, 1))
                       * args.minibatch_size)
        self.task_d.set_completed_records(records)

    def _build_ps(self, ps_id):
        args = self.args
        return ParameterServer(
            ps_id,
            args.num_ps,
            optimizer_spec=self.spec.build_optimizer_spec(),
            use_async=args.use_async,
            grads_to_wait=args.grads_to_wait,
            sync_version_tolerance=args.sync_version_tolerance,
            sync_window_timeout=args.sync_window_timeout,
            lr_staleness_modulation=args.lr_staleness_modulation,
            checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_steps=args.checkpoint_steps,
            keep_checkpoint_max=args.keep_checkpoint_max,
            checkpoint_dir_for_init=args.checkpoint_dir_for_init or None,
            master_client=MasterClient(self.stub(), -1),
        )

    def stub(self):
        """A client stub of this master's service, for a worker in this
        process."""
        return rpc.InProcessStub(self.servicer, rpc.MASTER_SERVICE)

    def ps_stubs(self):
        """One client stub per PS shard, index = shard id. A stub keeps
        reaching its shard's place across relaunch_ps."""
        return [rpc.InProcessStub(_ShardPlace(self.ps_servers, i),
                                  rpc.PSERVER_SERVICE)
                for i in range(len(self.ps_servers))]

    def relaunch_ps(self, ps_id):
        """Replaces shard `ps_id` with a fresh ParameterServer built from the
        same arguments (empty unless --checkpoint_dir_for_init restores it);
        workers re-seed it on their next pull."""
        self.ps_servers[ps_id] = self._build_ps(ps_id)
        logger.info("Relaunched PS shard %d", ps_id)
        return self.ps_servers[ps_id]


class _ShardPlace:
    """The servicer at one shard's place: hands each call to whichever
    ParameterServer currently holds it."""

    def __init__(self, servers, ps_id):
        self._servers = servers
        self._ps_id = ps_id

    def __getattr__(self, method):
        return getattr(self._servers[self._ps_id].servicer, method)
