"""One parameter-server shard in this process (counterpart of
elasticdl_tpu/ps/parameter_server.py:23-125).

It builds the store, the optimizer, the optional checkpoint saver and the
restore from a checkpoint (resharding to this shard's id and count), and
the servicer, with the JAX class's arguments minus `port`. A client reaches
it through `stub()`, an in-process stub that crosses the wire format on
every call. Serving it over gRPC (`ps/main.py`) comes with the transport.
"""

from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.ops.optimizers import OptimizerSpec
from elasticdl_tpu_torch.ps import checkpoint as ckpt
from elasticdl_tpu_torch.ps.optimizer import PSOptimizer
from elasticdl_tpu_torch.ps.parameters import Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer

logger = get_logger("ps.parameter_server")


class ParameterServer:
    def __init__(
        self,
        ps_id,
        num_ps,
        optimizer_spec=None,
        use_async=True,
        grads_to_wait=1,
        sync_version_tolerance=0,
        sync_window_timeout=30.0,
        lr_staleness_modulation=False,
        checkpoint_dir=None,
        checkpoint_steps=0,
        keep_checkpoint_max=3,
        checkpoint_dir_for_init=None,
        master_client=None,
    ):
        self.ps_id = ps_id
        self.num_ps = num_ps
        self.parameters = Parameters()
        self.optimizer = PSOptimizer(optimizer_spec or OptimizerSpec("sgd"))
        saver = None
        if checkpoint_dir and checkpoint_steps:
            saver = ckpt.CheckpointSaver(
                checkpoint_dir, ps_id, num_ps, keep_checkpoint_max
            )
        if checkpoint_dir_for_init:
            version = ckpt.latest_complete_version(checkpoint_dir_for_init)
            if version is None:
                raise ValueError(
                    f"no complete checkpoint under {checkpoint_dir_for_init}"
                )
            ckpt.restore_shard(checkpoint_dir_for_init, version,
                               self.parameters, ps_id, num_ps)
        self.servicer = PserverServicer(
            self.parameters,
            self.optimizer,
            use_async=use_async,
            grads_to_wait=grads_to_wait,
            sync_version_tolerance=sync_version_tolerance,
            sync_window_timeout=sync_window_timeout,
            lr_staleness_modulation=lr_staleness_modulation,
            checkpoint_saver=saver,
            checkpoint_steps=checkpoint_steps,
            master_client=master_client,
            shard_id=ps_id,
        )
        logger.info("PS %d/%d ready in process", ps_id, num_ps)

    def stub(self):
        """A client stub of this shard's service, for a worker in this
        process."""
        return rpc.InProcessStub(self.servicer, rpc.PSERVER_SERVICE)
