"""Argument definitions for the master, worker and parameter-server
processes (counterpart of elasticdl_tpu/common/args.py: the same flags,
defaults and cross-flag validation, so one command line means the same to
both packages). Three-stage relay kept: master argv -> worker/PS argv
(build_arguments_from_parsed_result)."""

import argparse
import os

from elasticdl_tpu_torch.common.constants import (
    COORDINATOR_PORT_ROTATION,
    DistributionStrategy,
)


def add_common_arguments(parser):
    parser.add_argument("--job_name", default="edl-job")
    parser.add_argument(
        "--model_zoo",
        default="",
        help="directory prepended to sys.path before importing model_def",
    )
    parser.add_argument(
        "--model_def",
        required=True,
        help="dotted module path or .py file exporting the model spec "
        "(custom_model/loss/optimizer/feed[/eval_metrics_fn])",
    )
    parser.add_argument(
        "--distribution_strategy",
        default=DistributionStrategy.ALLREDUCE,
        choices=[
            DistributionStrategy.LOCAL,
            DistributionStrategy.ALLREDUCE,
            DistributionStrategy.PARAMETER_SERVER,
        ],
    )
    parser.add_argument("--minibatch_size", type=int, default=64)
    parser.add_argument(
        "--get_model_steps",
        type=int,
        default=1,
        help="PS strategy: pull fresh params every N minibatches, train "
        "with the locally-updated model in between (gradients still "
        "push every step)",
    )
    parser.add_argument("--log_loss_steps", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--ps_wire_dtype",
        default=None,
        choices=["float32", "bfloat16", "int8"],
        help="PS strategy wire codec: bfloat16 halves sparse pull/push "
        "bandwidth; int8 additionally block-quantizes dense gradients "
        "with error feedback (embedding legs stay bf16). Unset reads "
        "ELASTICDL_WIRE_DTYPE (default float32); dense params and "
        "optimizer state stay float32 on the PS either way.",
    )
    parser.add_argument(
        "--model_parallel_size",
        type=int,
        default=1,
        help="tensor-parallel width for the AllReduce strategy: the device "
        "mesh gains a 'model' axis of this size and params are laid out by "
        "the model spec's param_specs(variables) hook (pure DP when 1)",
    )
    parser.add_argument(
        "--pipeline_stages",
        type=int,
        default=1,
        help="pipeline-parallel depth for the AllReduce strategy: the "
        "device mesh gains a 'stage' axis of this size and the model "
        "spec's pipeline_spec(...) hook builds the staged step "
        "(parallel/pipeline.py). In multi-host worlds the stage axis "
        "stays inside each process, like the model axis (no pipelining "
        "when 1)",
    )
    parser.add_argument(
        "--pipeline_schedule",
        default="1f1b",
        choices=["gpipe", "1f1b", "interleaved"],
        help="microbatch schedule when --pipeline_stages > 1: gpipe "
        "(scan autodiff, O(microbatches) activation memory), 1f1b "
        "(O(stages) memory, vocab-parallel head), or interleaved 1F1B "
        "(virtual chunks, smaller bubble)",
    )
    parser.add_argument(
        "--pipeline_microbatches",
        type=int,
        default=0,
        help="microbatches per minibatch for the pipeline schedules "
        "(0: auto = 2 * pipeline_stages; more microbatches amortize the "
        "pipeline bubble at the cost of smaller per-stage matmuls)",
    )
    parser.add_argument(
        "--pipeline_virtual_stages",
        type=int,
        default=2,
        help="virtual chunks per device for "
        "--pipeline_schedule interleaved (ignored by other schedules)",
    )
    parser.add_argument(
        "--context_parallel_size",
        type=int,
        default=1,
        help="sequence/context-parallel width for the AllReduce strategy: "
        "the device mesh gains a 'seq' axis of this size and the model "
        "spec's context_parallel_model(...) hook rebinds attention to it "
        "(ring attention / Ulysses, parallel/ring_attention.py). "
        "Composes with --model_parallel_size into a 3-D DPxTPxSP mesh. "
        "Sequence length must divide by 2x this size (zigzag halves)",
    )
    parser.add_argument(
        "--context_parallel_impl",
        default="zigzag",
        choices=["zigzag", "ring", "ulysses"],
        help="sequence-parallel attention: zigzag (balanced causal ring, "
        "default), ring (plain causal ring), or ulysses (all-to-all "
        "head re-sharding; needs heads divisible by the seq axis and "
        "does not compose with --model_parallel_size)",
    )


def add_data_arguments(parser):
    parser.add_argument("--training_data", default="")
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--prediction_data", default="")
    parser.add_argument("--records_per_task", type=int, default=1024)
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument(
        "--shuffle_shards", action="store_true", default=True
    )
    parser.add_argument(
        "--no_shuffle_shards", dest="shuffle_shards", action="store_false"
    )
    parser.add_argument(
        "--prefetch_records",
        type=int,
        default=1024,
        help="read records on a background thread, this many ahead of the "
        "training loop (0 disables prefetching)",
    )


def add_train_arguments(parser):
    parser.add_argument(
        "--evaluation_steps",
        type=int,
        default=0,
        help="evaluate every N model versions (0: once per epoch-ish "
        "report)",
    )
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument(
        "--checkpoint_dir_for_init",
        default="",
        help="restore PS state from this checkpoint dir at boot",
    )
    parser.add_argument("--output", default="", help="model export path")
    parser.add_argument(
        "--metrics_dir",
        default="",
        help="publish eval/throughput scalars here as metrics.jsonl + "
        "TensorBoard event files (point tensorboard --logdir at it)",
    )
    parser.add_argument(
        "--profile_dir",
        default="",
        help="capture one XLA device trace of steady-state training steps "
        "per worker under <profile_dir>/worker<id>/ (TensorBoard "
        "trace-viewer format)",
    )
    parser.add_argument(
        "--profile_start_step",
        type=int,
        default=10,
        help="first profiled step (skip compile + warmup)",
    )
    parser.add_argument(
        "--profile_steps", type=int, default=5,
        help="number of steps in the trace window",
    )


def add_cluster_arguments(parser):
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--num_ps", type=int, default=0)
    parser.add_argument(
        "--instance_backend",
        default="local_process",
        choices=["local_process", "k8s", "none"],
        help="none: workers/PS are launched externally and dial in",
    )
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--image_name", default="")
    parser.add_argument(
        "--worker_resources",
        default="",
        help="per-worker pod resources, e.g. cpu=4,memory=8Gi,tpu=4",
    )
    parser.add_argument("--ps_resources", default="")
    parser.add_argument(
        "--worker_pod_priority",
        default="",
        help="priority class for worker pods; 'high=0.5' gives the first "
        "half the 'high' class and the rest 'low'",
    )
    parser.add_argument(
        "--volume",
        default="",
        help="pod volumes: host_path=/d,mount_path=/d;"
        "claim_name=c,mount_path=/m[,sub_path=s]",
    )
    parser.add_argument("--max_relaunches", type=int, default=3)
    parser.add_argument("--master_port", type=int, default=50001)
    parser.add_argument(
        "--multi_host",
        action="store_true",
        default=False,
        help="AllReduce workers are separate processes/hosts forming one "
        "jax.distributed SPMD world; training is driven by "
        "step-synchronized task leases",
    )
    parser.add_argument(
        "--zero1",
        action="store_true",
        default=False,
        help="shard optimizer state over the data axis (cross-replica "
        "weight-update sharding): per-chip optimizer memory drops by "
        "the DP degree, update compiles as reduce-scatter -> "
        "shard-local math -> all-gather. In multi-host worlds the shard "
        "axis is the intra-process device slice (memory drops by the "
        "local chip count) so elastic regroups keep a full copy per "
        "process",
    )
    parser.add_argument(
        "--quantized_grads",
        action="store_true",
        default=False,
        help="AllReduce strategy: reduce DP gradients with int8 wire "
        "payloads (EQuARX-style reduce-scatter + all-gather, ~4x less "
        "collective bandwidth); on multi-host meshes only the "
        "cross-process leg quantizes, intra-host stays exact f32",
    )
    parser.add_argument(
        "--coordinator_port",
        type=int,
        default=51000,
        help="jax.distributed coordination-service port on rank 0. The "
        "port ROTATES across membership epochs: the job reserves the "
        "16-port block [port, port+15], which firewalls/NetworkPolicies "
        "must open and no other service (master_port, PS ports) may "
        "occupy",
    )
    parser.add_argument(
        "--task_timeout_check_seconds", type=float, default=30.0
    )
    parser.add_argument(
        "--worker_liveness_timeout_seconds", type=float, default=180.0
    )


def add_ps_arguments(parser):
    parser.add_argument("--ps_id", type=int, default=0)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--use_async", action="store_true", default=True)
    parser.add_argument(
        "--use_sync", dest="use_async", action="store_false"
    )
    parser.add_argument("--grads_to_wait", type=int, default=1)
    parser.add_argument("--sync_version_tolerance", type=int, default=0)
    parser.add_argument(
        "--sync_window_timeout",
        type=float,
        default=30.0,
        help="seconds before an unfilled sync quorum window applies what "
        "it has (liveness under elastic shrink); raise for jobs whose "
        "steps legitimately exceed it",
    )
    parser.add_argument(
        "--lr_staleness_modulation", action="store_true", default=False
    )


def validate_args(args):
    """Cross-flag validation."""
    if getattr(args, "use_async", True) and getattr(
        args, "grads_to_wait", 1
    ) > 1:
        raise ValueError("async SGD requires grads_to_wait == 1")
    # Master-side only checks (worker/PS parsers have no num_ps /
    # instance_backend; workers enforce --ps_addrs instead).
    num_ps = getattr(args, "num_ps", None)
    if (
        getattr(args, "distribution_strategy", None)
        == DistributionStrategy.PARAMETER_SERVER
        and num_ps is not None
        and hasattr(args, "instance_backend")
        and num_ps < 1
        and args.instance_backend != "none"
    ):
        raise ValueError("ParameterServerStrategy requires --num_ps >= 1")
    # A master that manages instances but has no workers to spawn would
    # poll forever: require explicit --instance_backend none for externally
    # launched workers.
    if (
        getattr(args, "instance_backend", None)
        in ("local_process", "k8s")
        and getattr(args, "num_workers", None) is not None
        and args.num_workers < 1
    ):
        raise ValueError(
            "--num_workers >= 1 is required (or --instance_backend none "
            "when workers are launched externally)"
        )
    # Pipeline parallelism composes with DP (the stage axis pairs with the
    # data axis) but not yet with TP — both claim the intra-process device
    # slice, and no model spec lays params out over both at once. Fail
    # loudly instead of silently picking one.
    pipeline_stages = getattr(args, "pipeline_stages", 1) or 1
    if pipeline_stages > 1:
        if (
            getattr(args, "distribution_strategy", None)
            not in (None, DistributionStrategy.ALLREDUCE)
        ):
            raise ValueError(
                "--pipeline_stages > 1 requires the AllReduce strategy"
            )
        if getattr(args, "model_parallel_size", 1) > 1:
            raise ValueError(
                "--pipeline_stages and --model_parallel_size cannot be "
                "combined (both lay out the intra-process device slice); "
                "pick one"
            )
    if getattr(args, "pipeline_microbatches", 0) < 0:
        raise ValueError(
            "--pipeline_microbatches must be >= 0 (0 = auto)"
        )
    context_parallel = getattr(args, "context_parallel_size", 1) or 1
    if context_parallel > 1:
        if (
            getattr(args, "distribution_strategy", None)
            not in (None, DistributionStrategy.ALLREDUCE)
        ):
            raise ValueError(
                "--context_parallel_size > 1 requires the AllReduce "
                "strategy"
            )
        if pipeline_stages > 1:
            raise ValueError(
                "--context_parallel_size and --pipeline_stages cannot "
                "be combined (no model spec stages a sequence-parallel "
                "attention); pick one"
            )
        if (
            getattr(args, "context_parallel_impl", "zigzag") == "ulysses"
            and getattr(args, "model_parallel_size", 1) > 1
        ):
            raise ValueError(
                "--context_parallel_impl ulysses does not compose with "
                "--model_parallel_size (it re-shards heads itself); use "
                "zigzag"
            )
    # The coordination port rotates over a 16-port block across membership
    # epochs (master/membership.py): a master_port inside the block would
    # collide with a re-rendezvous after some elastic event.
    coordinator_port = getattr(args, "coordinator_port", None)
    master_port = getattr(args, "master_port", None)
    width = COORDINATOR_PORT_ROTATION
    if (
        coordinator_port is not None
        and master_port is not None
        and master_port != 0
        and coordinator_port <= master_port < coordinator_port + width
    ):
        raise ValueError(
            f"--master_port {master_port} falls inside the reserved "
            f"coordination-port rotation block [{coordinator_port}, "
            f"{coordinator_port + width - 1}]; move one of them"
        )


def build_arguments_from_parsed_result(args, filter_args=None):
    """argparse Namespace -> argv list, for relaying flags into spawned
    processes."""
    items = vars(args)
    argv = []
    for key, value in items.items():
        if filter_args and key not in filter_args:
            continue
        if value is None or value == "":
            continue
        if isinstance(value, bool):
            if key == "use_async":
                argv.append("--use_async" if value else "--use_sync")
            elif value:
                argv.append(f"--{key}")
            continue
        argv.extend([f"--{key}", str(value)])
    return argv


def master_parser():
    p = argparse.ArgumentParser("elasticdl_tpu master")
    add_common_arguments(p)
    add_data_arguments(p)
    add_train_arguments(p)
    add_cluster_arguments(p)
    add_ps_arguments(p)
    return p


def worker_parser():
    p = argparse.ArgumentParser("elasticdl_tpu worker")
    add_common_arguments(p)
    add_data_arguments(p)
    add_train_arguments(p)
    p.add_argument("--worker_id", type=int, required=True)
    p.add_argument("--master_addr", required=True)
    p.add_argument("--ps_addrs", default="", help="comma-separated")
    p.add_argument(
        "--worker_host",
        default=os.environ.get("MY_POD_IP", "127.0.0.1"),
        help="address other workers can reach this worker on (defaults to "
        "$MY_POD_IP, injected into every k8s replica pod)",
    )
    p.add_argument(
        "--job_type",
        default="training_only",
        choices=[
            "training_only",
            "training_with_evaluation",
            "evaluation_only",
            "prediction_only",
        ],
    )
    p.add_argument("--multi_host", action="store_true", default=False)
    p.add_argument("--zero1", action="store_true", default=False)
    p.add_argument(
        "--quantized_grads", action="store_true", default=False
    )
    return p


def ps_parser():
    p = argparse.ArgumentParser("elasticdl_tpu pserver")
    add_common_arguments(p)
    add_train_arguments(p)
    add_ps_arguments(p)
    p.add_argument("--num_ps", type=int, default=1)
    p.add_argument("--master_addr", default="")
    return p
