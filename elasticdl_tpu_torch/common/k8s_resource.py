"""Pod resource, volume and priority spec parsing for the k8s backend
(counterpart of elasticdl_tpu/common/k8s_resource.py: the same grammar,
dicts and errors).

"cpu=250m,memory=32Mi,gpu=1" -> a resource dict (`gpu=N` becomes
nvidia.com/gpu, `tpu=N` google.com/tpu); "host_path=...,mount_path=...;
claim_name=...,mount_path=..." -> volume dicts; "high=0.5" -> the first
half of the workers get the high priority class.

Everything here is plain dict and string handling, with no kubernetes
import, so manifests can be built and checked anywhere (tests, --yaml
dumps); only the k8s client turns them into API calls.
"""

import re

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.k8s_resource")

# Kubernetes quantities allow decimals ("1.5Gi", "0.5G").
_MEM_RE = re.compile(
    r"^(0|[1-9][0-9]*)(\.[0-9]+)?(E|P|T|G|M|K|Ei|Pi|Ti|Gi|Mi|Ki)?$"
)
_CPU_MILLI_RE = re.compile(r"^[1-9][0-9]*m$")
_DEVICE_DOMAIN_RE = re.compile(
    r"^[a-zA-Z\d-]{1,63}(\.[a-zA-Z\d-]{1,63})*/(gpu|tpu)$"
)

_MEMORY_KINDS = ("memory", "disk", "ephemeral-storage")


def _numeric(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def parse_resource_spec(spec):
    """'cpu=250m,memory=32Mi,gpu=1,tpu=4' -> k8s resource dict.

    gpu/tpu shorthands expand to their canonical device-plugin resource
    names; full vendor names (amd.com/gpu=1) pass through validated."""
    resources = {}
    if not spec:
        return resources
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"malformed resource entry {part!r}")
        name, value = (x.strip() for x in part.split("=", 1))
        if name in _MEMORY_KINDS:
            if not _MEM_RE.match(value):
                raise ValueError(
                    f"invalid {name} quantity {value!r} "
                    "(expected e.g. 4096Mi, 2Gi)"
                )
            # 'disk' is ElasticDL's CLI shorthand; the API server only
            # knows ephemeral-storage.
            key = "ephemeral-storage" if name == "disk" else name
        elif name == "cpu":
            if not (_CPU_MILLI_RE.match(value) or _numeric(value)):
                raise ValueError(f"invalid cpu quantity {value!r}")
            key = "cpu"
        elif name == "gpu":
            if not value.isdigit():
                raise ValueError(f"invalid gpu count {value!r}")
            key = "nvidia.com/gpu"
        elif name == "tpu":
            if not value.isdigit():
                raise ValueError(f"invalid tpu count {value!r}")
            key = "google.com/tpu"
        elif _DEVICE_DOMAIN_RE.match(name):
            if not value.isdigit():
                raise ValueError(f"invalid device count {value!r}")
            key = name
        else:
            raise ValueError(f"unknown resource type {name!r}")
        resources[key] = value
    return resources


def parse_volume_spec(spec):
    """'host_path=/data,mount_path=/data;claim_name=c1,mount_path=/m1'
    -> list of {"kind": "host_path"|"pvc", "source": ..., "mount_path":
    ..., "sub_path": optional}. Volumes sharing a source are deduplicated
    by the manifest builder (one volume, many mounts)."""
    volumes = []
    if not spec:
        return volumes
    for group in spec.split(";"):
        group = group.strip()
        if not group:
            continue
        fields = {}
        for part in group.split(","):
            if "=" not in part:
                raise ValueError(f"malformed volume entry {part!r}")
            k, v = (x.strip() for x in part.split("=", 1))
            fields[k] = v
        if "mount_path" not in fields:
            raise ValueError(f"volume spec {group!r} missing mount_path")
        if "claim_name" in fields:
            volumes.append(
                {
                    "kind": "pvc",
                    "source": fields["claim_name"],
                    "mount_path": fields["mount_path"],
                    **(
                        {"sub_path": fields["sub_path"]}
                        if "sub_path" in fields
                        else {}
                    ),
                }
            )
        elif "host_path" in fields:
            volumes.append(
                {
                    "kind": "host_path",
                    "source": fields["host_path"],
                    "mount_path": fields["mount_path"],
                }
            )
        else:
            raise ValueError(
                f"volume spec {group!r} needs host_path or claim_name"
            )
    return volumes


def group_volume_manifests(volume_dicts):
    """Parsed volume dicts -> (pod volume manifests, container mount
    manifests) in plain k8s JSON form, deduplicated by source (one volume,
    many mounts). The ONLY place the grouping/branching lives: the master
    manifest uses these dicts verbatim and the kubernetes client converts
    them to V1 objects."""
    volumes, mounts, by_source = [], [], {}
    for vd in volume_dicts:
        key = (vd["kind"], vd["source"])
        name = by_source.get(key)
        if name is None:
            name = f"edl-vol-{len(volumes)}"
            by_source[key] = name
            if vd["kind"] == "pvc":
                volumes.append(
                    {
                        "name": name,
                        "persistentVolumeClaim": {
                            "claimName": vd["source"],
                            "readOnly": False,
                        },
                    }
                )
            else:
                volumes.append(
                    {"name": name, "hostPath": {"path": vd["source"]}}
                )
        mount = {"name": name, "mountPath": vd["mount_path"]}
        if "sub_path" in vd:
            mount["subPath"] = vd["sub_path"]
        mounts.append(mount)
    return volumes, mounts


def parse_worker_priority(spec, num_workers):
    """Per-worker priority classes. 'high=0.5' gives the first half of the
    workers the 'high' class and the rest 'low' (ElasticDL's fraction
    syntax); any other non-empty string applies to every worker."""
    if not spec:
        return {i: None for i in range(num_workers)}
    if spec.startswith("high="):
        try:
            fraction = float(spec.split("=", 1)[1])
        except ValueError:
            raise ValueError(
                f"bad worker priority spec {spec!r}: the fraction form "
                "is 'high=<fraction>', e.g. high=0.5"
            )
        high = int(num_workers * fraction)
        return {
            i: ("high" if i < high else "low")
            for i in range(num_workers)
        }
    if "=" in spec:
        # Anything else containing '=' is a malformed fraction spec, NOT
        # a literal class name ('low=0.3' is never a valid k8s
        # priorityClassName) — fail at parse time, not pod creation.
        raise ValueError(
            f"bad worker priority spec {spec!r}: the fraction form is "
            "'high=<fraction>'; otherwise give a plain priority class "
            "name"
        )
    return {i: spec for i in range(num_workers)}
