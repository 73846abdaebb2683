"""Kubernetes client for the pods and services of one job (counterpart of
elasticdl_tpu/common/k8s_client.py: the same manifests, names and labels).

One transport: the standard-library REST client (common/k8s_rest.py)
against EDL_K8S_API_SERVER or the in-cluster service account. The JAX
module prefers the official `kubernetes` package where it is installed;
the port never imports it. From outside the cluster, `kubectl proxy`
serves the API on loopback for EDL_K8S_API_SERVER to name, with the
kubeconfig's credentials; tests/fake_k8s_server.py plays the API server in
the tests.

Pod and service bodies are plain manifest dicts, sent as they are, so
what the tests check is what a cluster receives.
"""

import threading

from elasticdl_tpu_torch.common import k8s_rest
from elasticdl_tpu_torch.common.k8s_resource import group_volume_manifests
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.k8s_client")

ELASTICDL_JOB_KEY = "elasticdl-job-name"
ELASTICDL_REPLICA_TYPE_KEY = "elasticdl-replica-type"
ELASTICDL_REPLICA_INDEX_KEY = "elasticdl-replica-index"


def require_k8s():
    if k8s_rest.default_rest_api() is None:
        raise RuntimeError(
            "no Kubernetes access: neither EDL_K8S_API_SERVER nor an "
            "in-cluster service account is present (use the local-process "
            "backend, or point EDL_K8S_API_SERVER at an API server, e.g. "
            "`kubectl proxy`'s http://127.0.0.1:8001)"
        )


def build_pod_manifest(
    name,
    labels,
    image,
    command,
    resource_requests=None,
    resource_limits=None,
    priority_class=None,
    envs=None,
    volumes=None,
    restart_policy="Never",
):
    """One replica pod as a manifest dict (both transports send it as it
    is)."""
    env = [{"name": k, "value": v} for k, v in (envs or {}).items()]
    # Every replica learns its own routable address (workers advertise it
    # as their host; the master binds on it).
    env.append(
        {
            "name": "MY_POD_IP",
            "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}},
        }
    )
    vol_manifests, mount_manifests = group_volume_manifests(volumes or [])
    container = {
        "name": "main",
        "image": image,
        "command": list(command),
        "env": env,
        "resources": {
            **({"requests": resource_requests} if resource_requests else {}),
            **({"limits": resource_limits} if resource_limits else {}),
        },
        **({"volumeMounts": mount_manifests} if mount_manifests else {}),
    }
    spec = {
        "containers": [container],
        "restartPolicy": restart_policy,
        **({"volumes": vol_manifests} if vol_manifests else {}),
        **({"priorityClassName": priority_class} if priority_class else {}),
    }
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "labels": labels},
        "spec": spec,
    }


class Client:
    """Pod lifecycle for one job's master, worker and PS replicas."""

    def __init__(self, namespace, job_name, image_name, event_callback=None):
        self.namespace = namespace
        self.job_name = job_name
        self.image_name = image_name
        self._event_cb = event_callback
        self._stop_watch = threading.Event()
        self._rest = k8s_rest.default_rest_api()
        if self._rest is None:
            require_k8s()
        if event_callback:
            threading.Thread(target=self._watch, daemon=True).start()

    def stop(self):
        self._stop_watch.set()

    # ---------- watch ----------

    def _watch(self):
        self._rest.watch_pods(
            self.namespace,
            f"{ELASTICDL_JOB_KEY}={self.job_name}",
            self._event_cb,
            stop_event=self._stop_watch,
        )

    # ---------- pods and services ----------

    def pod_name(self, replica_type, replica_index, incarnation=0):
        """A relaunch gets a fresh name (-r<N>): a Failed pod keeps its name
        on the API server, so creating the same name again is a 409."""
        base = f"elasticdl-{self.job_name}-{replica_type}-{replica_index}"
        return base if not incarnation else f"{base}-r{incarnation}"

    def create_pod(
        self,
        replica_type,
        replica_index,
        command,
        resource_requests=None,
        resource_limits=None,
        priority_class=None,
        envs=None,
        volumes=None,
        restart_policy="Never",
        incarnation=0,
    ):
        manifest = build_pod_manifest(
            self.pod_name(replica_type, replica_index, incarnation),
            {
                ELASTICDL_JOB_KEY: self.job_name,
                ELASTICDL_REPLICA_TYPE_KEY: replica_type,
                ELASTICDL_REPLICA_INDEX_KEY: str(replica_index),
            },
            self.image_name,
            command,
            resource_requests=resource_requests,
            resource_limits=resource_limits,
            priority_class=priority_class,
            envs=envs,
            volumes=volumes,
            restart_policy=restart_policy,
        )
        return self.create_pod_from_manifest(manifest)

    def create_pod_from_manifest(self, manifest):
        """Creates a pod from a raw manifest dict (the master pod keeps its
        serviceAccountName and env fieldRefs as they are)."""
        return self._rest.create_pod(self.namespace, manifest)

    def _create_service(self, manifest):
        return self._rest.create_service(self.namespace, manifest)

    def create_service(self, name, port, replica_type, replica_index):
        """A stable DNS name for a replica (one per PS pod)."""
        return self._create_service({
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": name,
                "labels": {ELASTICDL_JOB_KEY: self.job_name},
            },
            "spec": {
                "selector": {
                    ELASTICDL_JOB_KEY: self.job_name,
                    ELASTICDL_REPLICA_TYPE_KEY: replica_type,
                    ELASTICDL_REPLICA_INDEX_KEY: str(replica_index),
                },
                "ports": [{"port": port}],
            },
        })

    def create_tensorboard_service(self, port=6006):
        """A LoadBalancer service in front of the master pod's TensorBoard:
        an in-cluster job gets an external address for `edl
        tensorboard`'s server."""
        return self._create_service({
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": f"tensorboard-{self.job_name}",
                "labels": {ELASTICDL_JOB_KEY: self.job_name},
            },
            "spec": {
                "type": "LoadBalancer",
                "selector": {
                    ELASTICDL_JOB_KEY: self.job_name,
                    ELASTICDL_REPLICA_TYPE_KEY: "master",
                },
                "ports": [{"port": port, "targetPort": port}],
            },
        })

    def delete_pod(self, replica_type, replica_index, incarnation=0):
        name = self.pod_name(replica_type, replica_index, incarnation)
        return self._rest.delete_pod(self.namespace, name)
