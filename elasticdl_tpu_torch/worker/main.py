"""`python -m elasticdl_tpu_torch.worker.main` — the worker process, and the
worker's assembly (counterpart of elasticdl_tpu/worker/main.py).

`build_worker` assembles, from worker args and a master client, the reader,
the model spec, the trainer, the callbacks and the Worker. `main` is the
process: observability as role worker-<id>, a MasterClient on
`--master_addr`, the PS shards on `--ps_addrs`, the Worker, the telemetry
reporter, then the run, the close and an exit line with the process's
steps, kernel launches and pushes (under AllReduce also its model version,
the sha256 digest of its weights, equal on every rank of a world, and its
lease steps that raised, whose kernels ran), and the split of its start:
seconds from the process's exec to its imports done, its CUDA context,
the master's first answer and its model built. It
trains on the device
ELASTICDL_TORCH_DEVICE names (unset: the CUDA device, and a host without
one ends the process with the device rule's error). A worker in the
master's process uses build_worker on an in-process stub
(master/master.py:Master.stub) and, under ParameterServerStrategy, the
shards' in-process stubs (Master.ps_stubs). Under AllreduceStrategy the
trainer is AllReduceTrainer (with the model spec's param_specs and
context_parallel_model hooks for --model_parallel_size and
--context_parallel_size), and --multi_host trains through step leases.
Arguments that ask for what is not ported raise NotImplementedError.
"""

import json
import os
import sys
import time

import torch

from elasticdl_tpu_torch import observability
from elasticdl_tpu_torch.common import knobs
from elasticdl_tpu_torch.common.args import validate_args, worker_parser
from elasticdl_tpu_torch.common.constants import DistributionStrategy, JobType
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.common.save_utils import ExportModelCallback
from elasticdl_tpu_torch.data.prefetch import PrefetchReader
from elasticdl_tpu_torch.data.reader import CompositeReader, create_data_reader
from elasticdl_tpu_torch.observability.metrics import default_registry
from elasticdl_tpu_torch.observability.push import TelemetryReporter
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer
from elasticdl_tpu_torch.worker.trainer import LocalTrainer
from elasticdl_tpu_torch.worker.worker import Worker

logger = get_logger("worker.main")

_JOB_TYPES = {
    "training_only": JobType.TRAINING_ONLY,
    "training_with_evaluation": JobType.TRAINING_WITH_EVALUATION,
    "evaluation_only": JobType.EVALUATION_ONLY,
    "prediction_only": JobType.PREDICTION_ONLY,
}


def build_trainer(args, spec, ps_stubs=None, device=None,
                  master_client=None):
    strategy = args.distribution_strategy
    if strategy == DistributionStrategy.PARAMETER_SERVER:
        if not ps_stubs:
            raise ValueError(
                "ParameterServerStrategy needs the PS shards' addresses or "
                "stubs (ps_stubs, e.g. --ps_addrs or Master.ps_stubs())"
            )
        return ParameterServerTrainer(
            spec.build_model(),
            spec.loss,
            spec.build_optimizer_spec(),
            PSClient(ps_stubs, worker_id=args.worker_id,
                     wire_dtype=args.ps_wire_dtype),
            embedding_inputs=getattr(spec.module, "embedding_inputs", None),
            embedding_threshold_bytes=getattr(
                spec.module, "embedding_threshold_bytes", None),
            embedding_device_capacity_bytes=getattr(
                spec.module, "embedding_device_capacity_bytes", 0),
            seed=args.seed,
            model_steps=args.get_model_steps,
            device=device,
        )
    if strategy == DistributionStrategy.ALLREDUCE:
        if master_client is None:
            raise ValueError("AllreduceStrategy needs the master client")
        return AllReduceTrainer(
            spec.build_model(),
            spec.loss,
            spec.build_optimizer_spec(),
            master_client,
            multi_host=args.multi_host,
            seed=args.seed,
            model_parallel_size=args.model_parallel_size,
            param_specs_fn=getattr(spec.module, "param_specs", None),
            zero1=args.zero1,
            quantized_grads=args.quantized_grads,
            pipeline_stages=args.pipeline_stages,
            pipeline_schedule=args.pipeline_schedule,
            pipeline_microbatches=args.pipeline_microbatches,
            pipeline_virtual_stages=args.pipeline_virtual_stages,
            pipeline_spec_fn=getattr(spec.module, "pipeline_spec", None),
            context_parallel_size=args.context_parallel_size,
            context_parallel_impl=args.context_parallel_impl,
            context_parallel_model_fn=getattr(
                spec.module, "context_parallel_model", None),
            device=device,
        )
    return LocalTrainer(
        spec.build_model(), spec.loss, spec.build_optimizer_spec(),
        seed=args.seed, device=device,
    )


def build_worker(args, master_client, ps_stubs=None, device=None):
    """The Worker that `main` runs, on the given MasterClient and, under
    ParameterServerStrategy, the PS shards (one address or stub per shard);
    `device=None` trains on the CUDA device."""
    if args.profile_dir:
        raise NotImplementedError(
            "--profile_dir (the worker's device trace) is not ported yet"
        )
    if args.model_zoo:
        sys.path.insert(0, args.model_zoo)
    spec = get_model_spec(args.model_def)
    job_type = _JOB_TYPES[args.job_type]
    reader_factory = spec.create_data_reader or create_data_reader
    if job_type == JobType.PREDICTION_ONLY:
        origins = [args.prediction_data]
    else:
        origins = [
            o for o in (args.training_data, args.validation_data) if o
        ]
    if len(origins) == 1:
        reader = reader_factory(origins[0])
    else:
        # Training + validation are distinct origins: route each task to
        # the reader owning its shard (see CompositeReader).
        reader = CompositeReader([reader_factory(o) for o in origins])
    if args.prefetch_records > 0:
        reader = PrefetchReader(reader, buffer_records=args.prefetch_records)
    trainer = build_trainer(args, spec, ps_stubs=ps_stubs, device=device,
                            master_client=master_client)
    extra_callbacks = []
    if args.output:
        extra_callbacks.append(ExportModelCallback(args.output))
    if args.checkpoint_dir_for_init and args.distribution_strategy != (
            DistributionStrategy.PARAMETER_SERVER):
        # Worker-side restore, applied right after the trainer's lazy init
        # on the first batch; the PS strategy restores on the PS side.
        trainer.restore_on_init = args.checkpoint_dir_for_init
    return Worker(
        args.worker_id,
        master_client,
        reader,
        spec,
        trainer,
        minibatch_size=args.minibatch_size,
        job_type=job_type,
        log_loss_steps=args.log_loss_steps,
        extra_callbacks=extra_callbacks,
        # Multi-host AllReduce trains through step-synchronized leases:
        # every rank of a world must run the same number of steps.
        lease_mode=(
            args.distribution_strategy == DistributionStrategy.ALLREDUCE
            and args.multi_host
        ),
    )


def _exec_time():
    """time.time() at this process's exec: its start time in /proc (Linux;
    clock ticks since boot) against the boot clock, else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.time() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time()


def main(argv=None):
    imported = time.time()
    args = worker_parser().parse_args(argv)
    validate_args(args)
    role = f"worker-{args.worker_id}"
    obs = observability.setup(role=role, job=args.job_name)
    device = knobs.get_str("ELASTICDL_TORCH_DEVICE") or None
    resolved = resolve_device(device)
    if resolved.type == "cuda":
        # The CUDA context now, so that the start split tells it apart
        # from the model's build.
        torch.zeros((), device=resolved).item()
    cuda_ready = time.time()
    mc = MasterClient(args.master_addr, args.worker_id,
                      worker_host=args.worker_host)
    ps = args.ps_addrs.split(",") if args.ps_addrs else None
    worker = build_worker(args, mc, ps_stubs=ps, device=device)
    # Push-based telemetry every ELASTICDL_TELEMETRY_PUSH_INTERVAL seconds
    # (0 turns it off); while the pushes stay fresh the master's aggregator
    # does not pull-scrape this worker.
    reporter = TelemetryReporter(
        mc.report_telemetry, default_registry(), role=role,
        seed=args.worker_id,
    ).start()
    try:
        worker.run()
    finally:
        close = getattr(worker.trainer, "close", None)
        if close is not None:
            close()
        reporter.close()
        mc.close()
        obs.close()
        # The exit line, also on the way out of a failure, carries what
        # only this process can count: its steps, its flash-attention
        # kernel launches and its telemetry pushes; an AllReduce worker
        # adds its model version, weights' digest, world spec and each
        # shard's launches.
        exec_at = _exec_time()

        def since_exec(t):
            return None if t is None else round(t - exec_at, 3)

        record = {"steps": worker.steps, "kernel_launches": dict(fa.launches),
                  "telemetry": reporter.stats(),
                  "start": {"exec": round(exec_at, 3),
                            "imports_s": since_exec(imported),
                            "cuda_s": since_exec(cuda_ready),
                            "first_answer_s": since_exec(
                                mc.first_answer_at),
                            "model_s": since_exec(getattr(
                                worker.trainer, "built_at", None))}}
        if isinstance(worker.trainer, AllReduceTrainer):
            trainer = worker.trainer
            record.update(version=trainer.get_model_version(),
                          digest=trainer.state_digest(),
                          failed_steps=worker.failed_steps,
                          spec=trainer.world_fingerprint,
                          shard_launches=[dict(c) for c in
                                          trainer.shard_launches])
        logger.info("Worker %d exiting: %s", args.worker_id,
                    json.dumps(record, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
