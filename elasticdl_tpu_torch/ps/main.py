"""`python -m elasticdl_tpu_torch.ps.main` — the parameter-server process
(counterpart of elasticdl_tpu/ps/main.py). Serves one shard on `--port` and
exits when the master stops answering `report_version`."""

import sys

from elasticdl_tpu_torch import observability
from elasticdl_tpu_torch.common.args import ps_parser, validate_args
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.common.rpc import RpcError
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.observability.push import TelemetryReporter
from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
from elasticdl_tpu_torch.worker.master_client import MasterClient

logger = get_logger("ps.main")


def main(argv=None, poll_seconds=10):
    args = ps_parser().parse_args(argv)
    validate_args(args)
    obs = observability.setup(role=f"ps-{args.ps_id}", job=args.job_name)
    if args.model_zoo:
        sys.path.insert(0, args.model_zoo)
    # The optimizer spec comes from the model zoo module; here the spec IS
    # the serialized form the master would relay.
    spec = get_model_spec(args.model_def)
    mc = (
        MasterClient(args.master_addr, worker_id=-1)
        if args.master_addr
        else None
    )
    ps = ParameterServer(
        args.ps_id,
        args.num_ps,
        port=args.port,
        optimizer_spec=spec.build_optimizer_spec(),
        use_async=args.use_async,
        grads_to_wait=args.grads_to_wait,
        sync_version_tolerance=args.sync_version_tolerance,
        sync_window_timeout=args.sync_window_timeout,
        lr_staleness_modulation=args.lr_staleness_modulation,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_steps=args.checkpoint_steps,
        keep_checkpoint_max=args.keep_checkpoint_max,
        checkpoint_dir_for_init=args.checkpoint_dir_for_init or None,
        master_client=mc,
    )

    def master_alive():
        if mc is None:
            return True
        try:
            mc.report_version(ps.parameters.version)
            return True
        except RpcError:
            return False

    # Push-based telemetry every ELASTICDL_TELEMETRY_PUSH_INTERVAL seconds
    # (0 turns it off).
    reporter = None
    if mc is not None:
        reporter = TelemetryReporter(
            mc.report_telemetry,
            default_registry(),
            role=f"ps-{args.ps_id}",
            seed=args.ps_id,
        ).start()

    ps.wait(master_liveness_check=master_alive, poll_seconds=poll_seconds)
    ps.stop()
    if reporter is not None:
        reporter.close()
    if mc is not None:
        mc.close()
    obs.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
