"""Minimal Kubernetes REST transport, standard library only (counterpart
of elasticdl_tpu/common/k8s_rest.py).

The pod lifecycle the k8s backend needs (create, read and delete pods,
create and read services, list and watch with a label selector) spoken
directly to the Kubernetes HTTP API: JSON bodies over http.client, the
watch as the API's chunked line-delimited event stream.
It is `common/k8s_client.Client`'s only transport (the JAX package's
prefers the official `kubernetes` client where it is installed);
tests/fake_k8s_server.py plays the API server.

Auth: the in-cluster service-account token and CA when present
(/var/run/secrets/kubernetes.io/serviceaccount), or a plain endpoint from
EDL_K8S_API_SERVER (stub servers, kubectl proxy).
"""

import json
import os
import ssl
import threading
from http import client as http_client
from urllib.parse import quote, urlsplit

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.k8s_rest")

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sApiError(RuntimeError):
    def __init__(self, status, body):
        super().__init__(f"kubernetes API error {status}: {body[:300]}")
        self.status = status
        self.body = body


class ObjView:
    """Attribute-style view over a k8s JSON object, so watch callbacks
    written for the official client's models (pod.status.phase,
    cs.state.terminated.exit_code) read REST dicts unchanged. Missing
    fields resolve to None, snake_case maps to the API's camelCase."""

    def __init__(self, data):
        self._data = data

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict):
            return ObjView(value)
        if isinstance(value, list):
            return [ObjView._wrap(v) for v in value]
        return value

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        data = object.__getattribute__(self, "_data")
        if name in data:
            return self._wrap(data[name])
        parts = name.split("_")
        camel = parts[0] + "".join(p.title() for p in parts[1:])
        return self._wrap(data.get(camel))

    def get(self, key, default=None):
        """Dict-style access: label/annotation maps are consumed with
        .get() (the official client models them as plain dicts)."""
        data = object.__getattribute__(self, "_data")
        return self._wrap(data.get(key, default))

    def to_dict(self):
        return self._data

    def __repr__(self):
        return f"ObjView({self._data!r})"


class RestApi:
    """The four pod/service operations + watch, over one API server."""

    def __init__(self, base_url, token=None, ca_file=None,
                 insecure_skip_verify=False):
        parts = urlsplit(base_url)
        self._scheme = parts.scheme or "http"
        self._host = parts.hostname
        self._port = parts.port or (443 if self._scheme == "https" else 80)
        self._token = token
        if self._scheme == "https":
            if ca_file:
                self._ssl = ssl.create_default_context(cafile=ca_file)
            else:
                self._ssl = ssl.create_default_context()
            if insecure_skip_verify:
                self._ssl.check_hostname = False
                self._ssl.verify_mode = ssl.CERT_NONE
        else:
            self._ssl = None

    # ---------- plumbing ----------

    def _connect(self, timeout=30):
        if self._scheme == "https":
            return http_client.HTTPSConnection(
                self._host, self._port, timeout=timeout, context=self._ssl
            )
        return http_client.HTTPConnection(
            self._host, self._port, timeout=timeout
        )

    def _headers(self, has_body=False):
        headers = {"Accept": "application/json"}
        if has_body:
            headers["Content-Type"] = "application/json"
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        return headers

    def _request(self, method, path, body=None):
        conn = self._connect()
        try:
            conn.request(
                method,
                path,
                body=json.dumps(body) if body is not None else None,
                headers=self._headers(body is not None),
            )
            res = conn.getresponse()
            payload = res.read().decode("utf-8", "replace")
            if res.status >= 300:
                raise K8sApiError(res.status, payload)
            return json.loads(payload) if payload else {}
        finally:
            conn.close()

    # ---------- operations ----------

    def create_pod(self, namespace, manifest):
        return self._request(
            "POST", f"/api/v1/namespaces/{namespace}/pods", manifest
        )

    def read_pod(self, namespace, name):
        return self._request(
            "GET", f"/api/v1/namespaces/{namespace}/pods/{name}"
        )

    def delete_pod(self, namespace, name):
        return self._request(
            "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}"
        )

    def list_pods(self, namespace, label_selector):
        return self._request(
            "GET",
            f"/api/v1/namespaces/{namespace}/pods"
            f"?labelSelector={quote(label_selector)}",
        )

    def create_service(self, namespace, manifest):
        return self._request(
            "POST", f"/api/v1/namespaces/{namespace}/services", manifest
        )

    def read_service(self, namespace, name):
        return self._request(
            "GET", f"/api/v1/namespaces/{namespace}/services/{name}"
        )

    def watch_pods(self, namespace, label_selector, event_callback,
                   stop_event=None):
        """Blocking watch loop: stream ADDED/MODIFIED/DELETED pod events
        (each a JSON line of the chunked response) into `event_callback`
        as {"type": ..., "object": ObjView} until stop_event is set. The
        stream is re-established on any error, matching the official
        watch's reconnect behavior.

        Every REconnect is a LIST+WATCH (the official client's Reflector
        pattern): a bare watch starts from "now", so pod transitions that
        happened while the stream was down would be lost forever — a
        worker that died in that window would never be relaunched. The
        re-list (a) synthesizes a MODIFIED event per currently matching
        pod (consumers treat repeated same-phase MODIFIEDs as no-ops),
        (b) diffs against the pods seen so far to synthesize DELETED for
        any that vanished during the outage, and (c) anchors the new
        watch at the list's resourceVersion so transitions between the
        LIST response and the WATCH being accepted are replayed, not
        skipped. An expired anchor (410 Gone) just resets the stream:
        the next iteration re-lists and gets a fresh one."""
        stop_event = stop_event or threading.Event()
        base = (
            f"/api/v1/namespaces/{namespace}/pods"
            f"?watch=true&labelSelector={quote(label_selector)}"
        )
        known = {}  # pod name -> last seen raw object
        first_connect = True
        resource_version = None
        while not stop_event.is_set():
            conn = None
            try:
                if not first_connect:
                    # Re-list to cover the blind window. (On the first
                    # connect there is nothing to have missed yet — the
                    # watch starts before any pod is created.)
                    listing = self.list_pods(namespace, label_selector)
                    resource_version = (
                        listing.get("metadata", {}).get("resourceVersion")
                    )
                    current = {}
                    for item in listing.get("items", []):
                        name = (item.get("metadata") or {}).get("name")
                        if name:
                            current[name] = item
                    vanished = [
                        known[n] for n in known if n not in current
                    ]
                    known = current
                    for item in vanished:
                        if stop_event.is_set():
                            return
                        event_callback(
                            {"type": "DELETED", "object": ObjView(item)}
                        )
                    for item in current.values():
                        if stop_event.is_set():
                            return
                        event_callback(
                            {"type": "MODIFIED", "object": ObjView(item)}
                        )
                path = base
                if resource_version:
                    path += f"&resourceVersion={quote(resource_version)}"
                conn = self._connect(timeout=300)
                conn.request("GET", path, headers=self._headers())
                res = conn.getresponse()
                if res.status >= 300:
                    raise K8sApiError(
                        res.status, res.read().decode("utf-8", "replace")
                    )
                first_connect = False
                while not stop_event.is_set():
                    line = res.readline()
                    if not line:
                        break  # server closed the stream: reconnect
                    line = line.strip()
                    if not line:
                        continue
                    event = json.loads(line)
                    obj = event.get("object") or {}
                    name = (obj.get("metadata") or {}).get("name")
                    if name:
                        if event.get("type") == "DELETED":
                            known.pop(name, None)
                        else:
                            known[name] = obj
                    event_callback(
                        {"type": event.get("type"), "object": ObjView(obj)}
                    )
            except Exception:
                if stop_event.is_set():
                    return
                logger.warning("k8s watch stream reset", exc_info=True)
                # A 410-expired anchor must not wedge the loop on the same
                # stale version; the re-list above refreshes it anyway.
                resource_version = None
                stop_event.wait(1.0)
            finally:
                if conn is not None:
                    conn.close()


def in_cluster_available():
    return bool(os.environ.get("KUBERNETES_SERVICE_HOST")) and os.path.exists(
        os.path.join(_SA_DIR, "token")
    )


def default_rest_api():
    """RestApi from the environment: EDL_K8S_API_SERVER (stub servers,
    kubectl proxy) or the in-cluster service account. None if neither."""
    endpoint = os.environ.get("EDL_K8S_API_SERVER")
    if endpoint:
        return RestApi(endpoint)
    if in_cluster_available():
        with open(os.path.join(_SA_DIR, "token")) as f:
            token = f.read().strip()
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return RestApi(
            f"https://{host}:{port}",
            token=token,
            ca_file=os.path.join(_SA_DIR, "ca.crt"),
        )
    return None
