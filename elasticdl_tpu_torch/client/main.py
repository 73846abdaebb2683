"""`python -m elasticdl_tpu_torch.client.main`: the port's `edl` client
(counterpart of elasticdl_tpu/client/main.py, with the same subcommands,
flags and exit codes):

  train    --model_def ... --training_data ...
  evaluate --model_def ... --validation_data ... --checkpoint_dir_for_init ...
  predict  --model_def ... --prediction_data ... --checkpoint_dir_for_init ...
  zoo init | list | build | push
  top, dash      the job's status over the master's status RPC (the port's
                 transport) and the telemetry plane's /api/summary
  tensorboard    TensorBoard over a job's metrics directory
  profile        raises NotImplementedError: device profiling is not
                 ported yet

Submission:
  --instance_backend local_process (default): the master runs IN THIS
      process (master/main.py) and starts the worker and PS processes on
      this host.
  --instance_backend k8s: the master pod (`python -m
      elasticdl_tpu_torch.master.main` with the job's flags) is created
      over the Kubernetes API (common/k8s_client.py: EDL_K8S_API_SERVER,
      e.g. `kubectl proxy` from outside the cluster, or the in-cluster
      service account); --yaml writes its manifest to a file instead.

`zoo init` writes a PyTorch model definition that the port's spec loader
(common/model_utils.py) takes; the JAX package's template is a flax
module.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

from elasticdl_tpu_torch.common import args as args_mod
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("client.main")


def _job_parser(name):
    p = argparse.ArgumentParser(f"edl {name}", add_help=True)
    args_mod.add_common_arguments(p)
    args_mod.add_data_arguments(p)
    args_mod.add_train_arguments(p)
    args_mod.add_cluster_arguments(p)
    args_mod.add_ps_arguments(p)
    p.add_argument(
        "--yaml",
        default="",
        help="(k8s) write the master pod manifest to this file instead of "
        "creating it",
    )
    return p


def _run_master_in_process(argv):
    from elasticdl_tpu_torch.master.main import main as master_main

    return master_main(argv)


def _submit(job_args, raw_argv):
    args_mod.validate_args(job_args)
    if job_args.instance_backend == "k8s":
        return _submit_k8s(job_args, raw_argv)
    return _run_master_in_process(raw_argv)


def _strip_flag(argv, flag):
    """Drops the '--flag value' and '--flag=value' forms from an argv."""
    out = []
    skip_next = False
    for a in argv:
        if skip_next:
            skip_next = False
            continue
        if a == flag:
            skip_next = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def _master_pod_manifest(job_args, raw_argv):
    from elasticdl_tpu_torch.common.k8s_resource import (
        group_volume_manifests,
        parse_volume_spec,
    )

    command = ["python", "-m", "elasticdl_tpu_torch.master.main"] + (
        _strip_flag(raw_argv, "--yaml"))
    # The master reads the training data itself (shard creation), so it
    # needs the --volume mounts the worker and PS pods get.
    volumes, mounts = group_volume_manifests(
        parse_volume_spec(getattr(job_args, "volume", "")))
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"elasticdl-{job_args.job_name}-master",
            "labels": {
                "app": "elasticdl",
                "elasticdl-job-name": job_args.job_name,
                "elasticdl-replica-type": "master",
            },
        },
        "spec": {
            "serviceAccountName": "elasticdl-master",
            "restartPolicy": "Never",
            **({"volumes": volumes} if volumes else {}),
            "containers": [
                {
                    "name": "master",
                    "image": job_args.image_name,
                    "command": command,
                    **({"volumeMounts": mounts} if mounts else {}),
                    "env": [
                        {
                            "name": "MY_POD_IP",
                            "valueFrom": {
                                "fieldRef": {"fieldPath": "status.podIP"}
                            },
                        }
                    ],
                }
            ],
        },
    }


def _submit_k8s(job_args, raw_argv):
    manifest = _master_pod_manifest(job_args, raw_argv)
    if job_args.yaml:
        with open(job_args.yaml, "w") as f:
            json.dump(manifest, f, indent=2)
        logger.info("Wrote master pod manifest to %s", job_args.yaml)
        return 0
    from elasticdl_tpu_torch.common import k8s_client

    k8s_client.require_k8s()
    client = k8s_client.Client(
        job_args.namespace, job_args.job_name, job_args.image_name)
    # The manifest goes up as it is: serviceAccountName (the RBAC to create
    # worker and PS pods) and the MY_POD_IP fieldRef must survive.
    client.create_pod_from_manifest(manifest)
    logger.info("Submitted master pod for job %s", job_args.job_name)
    return 0


# ---------- zoo ----------

_ZOO_TEMPLATE = '''"""Model definition for elasticdl_tpu_torch.

The spec contract: custom_model / loss / optimizer / feed
(+ optional eval_metrics_fn / callbacks / prediction_outputs_processor /
create_data_reader).
"""

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.example import batch_examples
from elasticdl_tpu_torch.ops import optimizers

# The width of each record's "x" feature.
IN_FEATURES = 4


class Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(IN_FEATURES, 64)
        self.Dense_1 = nn.Linear(64, 1)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x.float())))


def custom_model():
    return Model()


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return torch.mean(
        (predictions.reshape(-1) - labels.reshape(-1).float()) ** 2)


def optimizer():
    return optimizers.sgd(learning_rate=0.1)


def feed(records, mode, metadata):
    batch = batch_examples(records)
    return batch["x"], batch.get("y")
'''


def _zoo_init(args):
    os.makedirs(args.path, exist_ok=True)
    target = os.path.join(args.path, f"{args.name}.py")
    if os.path.exists(target) and not args.force:
        logger.error("%s already exists (use --force)", target)
        return 1
    with open(target, "w") as f:
        f.write(_ZOO_TEMPLATE)
    logger.info("Created model definition scaffold at %s", target)
    return 0


def _zoo_list(args):
    import elasticdl_tpu_torch.models as zoo

    zoo_dir = os.path.dirname(zoo.__file__)
    for entry in sorted(os.listdir(zoo_dir)):
        path = os.path.join(zoo_dir, entry)
        if os.path.isdir(path) and not entry.startswith("__"):
            print(entry)
    return 0


def _zoo_build(args):
    """Copies a model zoo directory beside a Dockerfile for an image build
    and prints the build command (no docker SDK)."""
    os.makedirs(args.build_dir, exist_ok=True)
    dest = os.path.join(
        args.build_dir, os.path.basename(os.path.normpath(args.path)))
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(args.path, dest)
    with open(os.path.join(args.build_dir, "Dockerfile"), "w") as f:
        f.write(
            f"FROM {args.base_image}\n"
            f"COPY {os.path.basename(dest)} /model_zoo/"
            f"{os.path.basename(dest)}\n"
            "ENV PYTHONPATH=/model_zoo\n"
        )
    print(f"docker build -t {args.image} {args.build_dir}")
    return 0


def _zoo_push(args):
    """Pushes a built model-zoo image with the docker CLI when there is
    one; otherwise prints the command to run where docker is."""
    cmd = ["docker", "push", args.image]
    if args.dry_run:
        print(" ".join(cmd))
        return 0
    if shutil.which("docker") is None:
        # Without docker this command cannot do its job: failing loudly
        # keeps CI from submitting jobs whose image never shipped.
        print(" ".join(cmd))
        logger.error(
            "docker CLI not found; run the printed command where docker "
            "is available (or use --dry_run to silence this error)"
        )
        return 1
    return subprocess.run(cmd).returncode


def _top_summary_line(status, first_records, first_ts, now):
    """The job-end summary: the edl_job_* aggregates a CI log should
    keep — average throughput, straggler flags, abandoned tasks."""
    rate = ""
    if first_ts is not None and now > first_ts:
        avg = (status.records_done - first_records) / (now - first_ts)
        rate = f" avg={avg:.1f} rec/s"
    stragglers = ",".join(status.stragglers) or "none"
    policy = f"policy: actions={status.policy_actions}"
    if status.policy_blacklisted:
        policy += f" blacklist={','.join(status.policy_blacklisted)}"
    if status.backup_wins:
        policy += f" backup_wins={status.backup_wins}"
    if status.backup_tasks_inflight:
        policy += f" backups_inflight={status.backup_tasks_inflight}"
    return (
        f"summary: records={status.records_done}{rate} "
        f"stragglers={stragglers} "
        f"abandoned={status.tasks_abandoned} "
        f"recovered={status.tasks_recovered} "
        f"alerts={status.alerts_fired}"
        + (" FAILED" if status.job_failed else "")
        + "\n"
        + policy
    )


def _dash(args):
    """Live terminal dashboard: job status from the master's RPC plus the
    aggregator's /api/summary (throughput sparkline, per-worker step-time
    bars, straggler flags, PS shard load, active alerts). --once renders
    exactly one frame and exits — the non-interactive/test mode."""
    import time

    from elasticdl_tpu_torch.common import knobs, rpc
    from elasticdl_tpu_torch.observability import dashboard
    from elasticdl_tpu_torch.proto import messages as pb

    channel = rpc.build_channel(args.master_addr)
    stub = rpc.Stub(channel, rpc.MASTER_SERVICE)
    host = args.master_addr.rsplit(":", 1)[0]
    patience = knobs.get_float("ELASTICDL_MASTER_PATIENCE_SECONDS")
    unreachable_since = None
    retry_delay = 0.0
    incarnation = 0
    banner = ""
    last_status = None
    polls = 0
    iterations = getattr(args, "iterations", 0)

    def _bounded_exit():
        # Bounded probe (same --iterations contract as edl top): a
        # wedged-but-serving master must not hang CI forever — and a
        # master never reached at all is still exit 2, not success.
        if last_status is None:
            print(
                f"master {args.master_addr} unreachable", flush=True
            )
            return 2
        return 1 if last_status.job_failed else 0

    while True:
        if iterations and polls >= iterations:
            return _bounded_exit()
        polls += 1
        try:
            status = stub.get_job_status(pb.GetJobStatusRequest())
            unreachable_since = None
        except rpc.RpcError as e:
            # The master stops serving right after the job ends (same
            # race _top rides): a job last seen FINISHED must exit 0/1,
            # not read as a master crash. Mid-job, an unreachable master
            # is most likely RESTARTING (journal replay takes a moment),
            # so a watch session rides the same patience window the
            # workers do instead of exiting 1 three polls in. --once
            # keeps the strict single-probe contract.
            now = time.time()
            if args.once or (
                last_status is not None and last_status.finished
            ):
                if last_status is not None and last_status.finished:
                    return 1 if last_status.job_failed else 0
                print(
                    f"master {args.master_addr} unreachable "
                    f"({e.code().name})",
                    flush=True,
                )
                return 2
            if unreachable_since is None:
                unreachable_since = now
                retry_delay = min(args.interval, 1.0)
                banner = "master unreachable; reconnecting..."
                print(banner, flush=True)
            if now - unreachable_since > patience:
                print(
                    f"master {args.master_addr} unreachable "
                    f"({e.code().name})",
                    flush=True,
                )
                return 2
            time.sleep(retry_delay)
            retry_delay = min(retry_delay * 1.5, 10.0)
            # A channel that connect-attempted the unbound port of a
            # restarting master can stay wedged in UNAVAILABLE after the
            # port returns — probe, and greet the new master on a FRESH
            # channel (same recovery the workers use).
            if rpc.wait_channel_ready(
                args.master_addr, min(retry_delay, 1.0)
            ):
                channel.close()
                channel = rpc.build_channel(
                    args.master_addr, ready_timeout=0
                )
                stub = rpc.Stub(channel, rpc.MASTER_SERVICE)
            continue
        inc = getattr(status, "master_incarnation", 0)
        if incarnation and inc > incarnation:
            banner = (
                f"master restarting (incarnation {incarnation}->{inc})"
            )
        elif unreachable_since is None:
            banner = ""
        if inc:
            incarnation = inc
        last_status = status
        summary = {}
        if status.metrics_port:
            try:
                summary = dashboard.fetch_summary(
                    host, status.metrics_port
                )
            except (OSError, ValueError):
                summary = {}  # aggregator still warming up
        if getattr(args, "json", False) and args.once:
            # Machine-readable once-mode: the raw /api/summary snapshot
            # (datapath block included) as one JSON object — the CI
            # artifact form of the frame below.
            print(json.dumps(summary, sort_keys=True), flush=True)
            return 1 if status.job_failed else 0
        frame = dashboard.render(
            summary, status, top=getattr(args, "top", 0)
        )
        if banner:
            frame = banner + "\n" + frame
        if args.once:
            print(frame, flush=True)
            return 1 if status.job_failed else 0
        print(dashboard.CLEAR + frame, flush=True)
        if status.finished or status.job_failed:
            return 1 if status.job_failed else 0
        if iterations and polls >= iterations:
            return _bounded_exit()  # no dead sleep after the last frame
        time.sleep(args.interval)


def _top(args):
    """Live job monitor: poll the master's job-status RPC and print one
    status line per interval (the in-job analog of ElasticDL's
    pod-polling job monitor; throughput is derived by diffing
    records_done between polls). --watch renders the
    full dashboard instead of one-line updates."""
    import time

    from elasticdl_tpu_torch.common import knobs, rpc
    from elasticdl_tpu_torch.proto import messages as pb

    if getattr(args, "watch", False):
        args.once = False
        return _dash(args)
    channel = rpc.build_channel(args.master_addr)
    stub = rpc.Stub(channel, rpc.MASTER_SERVICE)
    prev_records, prev_ts = None, None
    first_records, first_ts = None, None
    last_status = None
    patience = knobs.get_float("ELASTICDL_MASTER_PATIENCE_SECONDS")
    unreachable_since = None
    retry_delay = 0.0
    incarnation = 0
    for _ in range(args.iterations) if args.iterations else iter(int, 1):
        try:
            status = stub.get_job_status(pb.GetJobStatusRequest())
        except rpc.RpcError as e:
            # The master stops its server as soon as the job ends, so an
            # UNAVAILABLE between polls against a FINISHED job means
            # "over", not an error. Mid-job it usually means the master
            # is restarting (journal replay): ride the same patience
            # window the workers do, with backoff, instead of giving up
            # three polls in.
            now = time.time()
            if last_status is not None and last_status.finished:
                print(
                    _top_summary_line(
                        last_status, first_records, first_ts, now
                    ),
                    flush=True,
                )
                return 1 if last_status.job_failed else 0
            if unreachable_since is None:
                unreachable_since = now
                retry_delay = min(args.interval, 1.0)
                print(
                    f"master {args.master_addr} unreachable "
                    f"({e.code().name}); retrying for up to "
                    f"{patience:.0f}s",
                    flush=True,
                )
            if now - unreachable_since > patience:
                if last_status is not None:
                    # Lost the master mid-job for good: distinct exit
                    # code — a dead master and a finished job must not
                    # look alike to CI.
                    print(
                        f"master {args.master_addr} gone mid-job "
                        f"(last: epoch {last_status.epoch}, "
                        f"v{last_status.model_version}, "
                        f"records={last_status.records_done})",
                        flush=True,
                    )
                else:
                    print(
                        f"master {args.master_addr} unreachable "
                        f"({e.code().name})",
                        flush=True,
                    )
                return 2
            time.sleep(retry_delay)
            retry_delay = min(retry_delay * 1.5, 10.0)
            # Same wedged-channel recovery as _dash: a restarted master
            # needs a fresh channel, built only once it accepts TCP.
            if rpc.wait_channel_ready(
                args.master_addr, min(retry_delay, 1.0)
            ):
                channel.close()
                channel = rpc.build_channel(
                    args.master_addr, ready_timeout=0
                )
                stub = rpc.Stub(channel, rpc.MASTER_SERVICE)
            continue
        unreachable_since = None
        inc = getattr(status, "master_incarnation", 0)
        if incarnation and inc > incarnation:
            print(
                f"master restarting (incarnation {incarnation}->{inc})",
                flush=True,
            )
        if inc:
            incarnation = inc
        if first_ts is None:
            first_records, first_ts = status.records_done, time.time()
        if last_status is None and status.metrics_port:
            # One-time pointer at the master's Prometheus endpoint (same
            # host as the master's address, another port).
            host = args.master_addr.rsplit(":", 1)[0]
            print(
                f"metrics: http://{host}:{status.metrics_port}/metrics",
                flush=True,
            )
        last_status = status
        now = time.time()
        rate = ""
        if prev_records is not None and now > prev_ts:
            rps = (status.records_done - prev_records) / (now - prev_ts)
            rate = f" {rps:8.1f} rec/s"
        prev_records, prev_ts = status.records_done, now
        evals = ""
        if status.last_eval_metrics:
            shown = ", ".join(
                f"{k}={v:.4f}"
                for k, v in sorted(status.last_eval_metrics.items())
            )
            evals = f" eval@v{status.last_eval_version}[{shown}]"
        # Elasticity counters from the observability plane: shown only
        # once nonzero so a healthy job's line stays short.
        elastic = ""
        if status.relaunches:
            elastic += f" relaunches={status.relaunches}"
        if status.tasks_recovered:
            elastic += f" recovered={status.tasks_recovered}"
        if status.tasks_abandoned:
            elastic += f" abandoned={status.tasks_abandoned}"
        if status.membership_epoch:
            elastic += f" mepoch={status.membership_epoch}"
        if status.stragglers:
            elastic += f" stragglers={','.join(status.stragglers)}"
        if status.alerts_fired:
            elastic += f" alerts={status.alerts_fired}"
        if status.policy_actions:
            elastic += f" policy={status.policy_actions}"
        if status.policy_blacklisted:
            elastic += (
                f" blacklist={','.join(status.policy_blacklisted)}"
            )
        if status.backup_tasks_inflight:
            elastic += f" backups={status.backup_tasks_inflight}"
        if status.backup_wins:
            elastic += f" backup_wins={status.backup_wins}"
        print(
            f"epoch {status.epoch}/{status.num_epochs} "
            f"v{status.model_version} "
            f"tasks todo={status.todo_tasks} doing={status.doing_tasks} "
            f"workers={status.alive_workers} "
            f"records={status.records_done}{rate}{elastic}{evals}"
            + (" FAILED" if status.job_failed else "")
            + (" FINISHED" if status.finished else ""),
            flush=True,
        )
        if status.finished or status.job_failed:
            print(
                _top_summary_line(
                    status, first_records, first_ts, time.time()
                ),
                flush=True,
            )
            return 1 if status.job_failed else 0
        time.sleep(args.interval)
    # Iterations exhausted mid-job: a job last seen FAILED must still
    # exit nonzero (CI wires `edl top` as the job's oracle).
    if last_status is not None and last_status.job_failed:
        return 1
    return 0


def _profile(args):
    """`edl profile` needs the device profiler of the observability plane
    (observability/profiling.py) and the master's start_profile RPC,
    which are not ported yet."""
    raise NotImplementedError(
        "edl profile is not ported to elasticdl_tpu_torch yet: it waits "
        "for observability/profiling.py and the start_profile RPC "
        "(ROADMAP Queue 1 item 5)"
    )


def _tensorboard(args):
    """Spawns TensorBoard over a job's metrics directory (the master only
    writes the event files; serving them is this separate process)."""
    if shutil.which("tensorboard") is None:
        logger.error(
            "tensorboard CLI not found; install tensorboard or point any "
            "TensorBoard at --logdir %s",
            args.metrics_dir,
        )
        return 1
    cmd = ["tensorboard", "--logdir", args.metrics_dir,
           "--port", str(args.port), "--bind_all"]
    return subprocess.run(cmd).returncode


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    top = argparse.ArgumentParser(
        "edl", description="elastic deep learning on PyTorch")
    top.add_argument(
        "command",
        choices=["train", "evaluate", "predict", "zoo", "top", "dash",
                 "tensorboard", "profile"],
    )
    ns, rest = top.parse_known_args(argv)

    if ns.command == "profile":
        return _profile(rest)

    if ns.command == "tensorboard":
        tb = argparse.ArgumentParser("edl tensorboard")
        tb.add_argument("--metrics_dir", required=True)
        tb.add_argument("--port", type=int, default=6006)
        return _tensorboard(tb.parse_args(rest))

    if ns.command == "dash":
        dash = argparse.ArgumentParser("edl dash")
        dash.add_argument("--master_addr", required=True)
        dash.add_argument("--interval", type=float, default=2.0)
        dash.add_argument(
            "--once",
            action="store_true",
            help="render one frame and exit (non-interactive/CI mode)",
        )
        dash.add_argument(
            "--json",
            action="store_true",
            help="with --once: print the raw /api/summary JSON instead "
            "of the rendered frame (CI artifact capture)",
        )
        dash.add_argument(
            "--iterations",
            type=int,
            default=0,
            help="stop after N frames (0 = until the job ends)",
        )
        dash.add_argument(
            "--top",
            type=int,
            default=10,
            help="cap worker/PS sections to the K worst rows "
            "(slowest workers, busiest shards); 0 shows every row",
        )
        return _dash(dash.parse_args(rest))

    if ns.command == "top":
        monitor = argparse.ArgumentParser("edl top")
        monitor.add_argument("--master_addr", required=True)
        monitor.add_argument("--interval", type=float, default=5.0)
        monitor.add_argument(
            "--iterations",
            type=int,
            default=0,
            help="stop after N polls (0 = until the job ends)",
        )
        monitor.add_argument(
            "--watch",
            action="store_true",
            help="render the live dashboard instead of one-line updates",
        )
        return _top(monitor.parse_args(rest))

    if ns.command == "zoo":
        zoo = argparse.ArgumentParser("edl zoo")
        sub = zoo.add_subparsers(dest="zoo_command", required=True)
        init_p = sub.add_parser("init")
        init_p.add_argument("--path", default=".")
        init_p.add_argument("--name", default="my_model")
        init_p.add_argument("--force", action="store_true")
        init_p.set_defaults(func=_zoo_init)
        list_p = sub.add_parser("list")
        list_p.set_defaults(func=_zoo_list)
        build_p = sub.add_parser("build")
        build_p.add_argument("--path", required=True)
        build_p.add_argument("--build_dir", default="./build")
        build_p.add_argument("--image", default="elasticdl_tpu:latest")
        build_p.add_argument("--base_image", default="python:3.12-slim")
        build_p.set_defaults(func=_zoo_build)
        push_p = sub.add_parser("push")
        push_p.add_argument("--image", required=True)
        push_p.add_argument(
            "--dry_run",
            action="store_true",
            help="print the push command instead of running it",
        )
        push_p.set_defaults(func=_zoo_push)
        zargs = zoo.parse_args(rest)
        return zargs.func(zargs)

    parser = _job_parser(ns.command)
    job_args = parser.parse_args(rest)
    # evaluate and predict are the train command with the matching data
    # flags.
    if ns.command == "evaluate" and not job_args.validation_data:
        parser.error("evaluate requires --validation_data")
    if ns.command == "predict" and not job_args.prediction_data:
        parser.error("predict requires --prediction_data")
    if ns.command in ("evaluate", "predict"):
        job_args.training_data = ""
    return _submit(job_args, rest)


if __name__ == "__main__":
    sys.exit(main())
