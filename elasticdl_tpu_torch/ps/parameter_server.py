"""One parameter-server shard (counterpart of
elasticdl_tpu/ps/parameter_server.py).

It builds the store, the optimizer, the optional checkpoint saver and the
restore from a checkpoint (resharding to this shard's id and count), and
the servicer, with the JAX class's arguments. With `port` (0 binds any) it
serves the servicer over the transport of common/rpc.py at `addr`, as the
shard process of ps/main.py does, and `wait()` blocks until `stop()` or
until the master stops answering; without one, a client in this process
reaches it through `stub()`, an in-process stub that crosses the wire
format on every call.
"""

import threading

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
        port=None,
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
        self._stop_event = threading.Event()
        self._server = None
        self.port = None
        if port is None:
            logger.info("PS %d/%d ready in process", ps_id, num_ps)
            return
        self._server, self.port = rpc.serve(
            self.servicer, rpc.PSERVER_SERVICE, port=port)
        logger.info("PS %d/%d serving on port %d", ps_id, num_ps, self.port)

    @property
    def addr(self):
        return f"localhost:{self.port}"

    def wait(self, master_liveness_check=None, poll_seconds=30):
        """Block until stopped; with a liveness callable, exit when the
        master is gone (the reference PS watches the master pod)."""
        while not self._stop_event.is_set():
            if master_liveness_check is not None:
                try:
                    alive = master_liveness_check()
                except Exception:
                    alive = False
                if not alive:
                    logger.info("Master gone; PS %d exiting", self.ps_id)
                    break
            self._stop_event.wait(poll_seconds)

    def stop(self):
        self._stop_event.set()
        if self._server is not None:
            self._server.stop(0)

    def stub(self):
        """A client stub of this shard's service, for a worker in this
        process."""
        return rpc.InProcessStub(self.servicer, rpc.PSERVER_SERVICE)
