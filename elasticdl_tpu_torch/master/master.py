"""The master's job assembly (counterpart of elasticdl_tpu/master/master.py:
75-130, 241-247): from master args, the model spec, the dataset shards, the
task dispatcher, the evaluation service and the servicer.

A worker in the same process reaches it through `stub()`, an in-process
stub that crosses the wire format on every call. Serving it over gRPC, the
poll loop and its watchdogs, the instance managers, the journal, the policy
engine, the metrics service and observability setup come with the
transport; the arguments that ask for them raise NotImplementedError.
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

logger = get_logger("master.master")


def _reject_unported(args):
    if args.distribution_strategy != DistributionStrategy.LOCAL:
        raise NotImplementedError(
            f"--distribution_strategy {args.distribution_strategy} is not "
            "ported to elasticdl_tpu_torch yet; use "
            f"{DistributionStrategy.LOCAL}"
        )
    if args.instance_backend != "none":
        raise NotImplementedError(
            "instance managers are not ported to elasticdl_tpu_torch yet; "
            "use --instance_backend none and build workers in process"
        )
    if args.checkpoint_dir_for_init:
        raise NotImplementedError(
            "master-side resume from a parameter-server checkpoint "
            "(--checkpoint_dir_for_init) is not ported yet"
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

    def stub(self):
        """A client stub of this master's service, for a worker in this
        process."""
        return rpc.InProcessStub(self.servicer, rpc.MASTER_SERVICE)
