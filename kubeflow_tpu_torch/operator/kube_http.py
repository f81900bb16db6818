"""Zero-dependency Kubernetes API backend: stdlib HTTP against the REST
contract (the port's copy of kubeflow_tpu/operator/kube_http.py).

It implements the control plane's kube surface (operator/kube.py
FakeKube) with nothing but ``urllib`` + ``ssl``: the half-dozen REST
verbs map directly onto the API server's JSON endpoints, and in-cluster
credentials are the standard service-account token + CA files.  Because
it is plain HTTP, the tests run it against a real server
(kubeflow_tpu_torch/testing/fake_apiserver.py speaks the same REST
contract over a localhost socket): request construction, label
selectors, the status PATCH content type, Retry-After and the 404/409 ->
NotFound/Conflict mapping all run over real sockets.
"""

from __future__ import annotations

import json
import os
import random
import ssl
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from kubeflow_tpu_torch.operator import crd
from kubeflow_tpu_torch.operator.kube import Conflict, NotFound, ObjectDict
from kubeflow_tpu_torch.testing import faults

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def _retry_after(headers) -> Optional[float]:
    """Parse a Retry-After header into seconds (None when absent or in
    the HTTP-date form — the delta-seconds form is what the serving
    stack and the apiserver emit)."""
    value = headers.get("Retry-After") if headers is not None else None
    if value is None:
        return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


class HttpKube:
    """Reconciler kube backend over the raw Kubernetes REST API.

    Transient apiserver weather — 5xx (leader elections, webhook blips)
    and connection resets — is retried with capped, jittered
    exponential backoff, so one blip does not fail a whole reconcile
    pass.  Two hard limits on the retry policy: semantic statuses
    (404/409 and other 4xx) are NEVER retried — they are answers, not
    weather — and only IDEMPOTENT verbs (GET/PUT/PATCH) retry at all.
    A POST or DELETE whose response was lost may have landed
    server-side; replaying it would double-apply (duplicate create ->
    spurious Conflict, re-delete -> spurious NotFound), so mutations
    fail fast and lean on the reconciler's level-triggered resweep as
    their natural retry."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        timeout_s: float = 30.0,
        retries: int = 3,
        retry_backoff_s: float = 0.05,
        retry_backoff_cap_s: float = 2.0,
    ):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in-cluster (KUBERNETES_SERVICE_HOST unset) and "
                    "no base_url given")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        if token is None and os.path.exists(f"{SA_DIR}/token"):
            with open(f"{SA_DIR}/token") as f:
                token = f.read().strip()
        self._token = token
        if ca_cert is None and os.path.exists(f"{SA_DIR}/ca.crt"):
            ca_cert = f"{SA_DIR}/ca.crt"
        self._timeout_s = timeout_s
        self._retries = max(0, int(retries))
        self._retry_backoff_s = retry_backoff_s
        self._retry_backoff_cap_s = retry_backoff_cap_s
        if self.base_url.startswith("https"):
            self._ssl = ssl.create_default_context(cafile=ca_cert)
        else:
            self._ssl = None

    # -- transport --------------------------------------------------------

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[ObjectDict] = None,
        params: Optional[Dict[str, str]] = None,
        content_type: str = "application/json",
    ) -> ObjectDict:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        # See the class docstring: replaying a mutation whose response
        # was lost can double-apply it, so only idempotent verbs retry.
        retries = self._retries if method in ("GET", "PUT", "PATCH") \
            else 0
        attempt = 0
        while True:
            # Rebuilt per attempt: a urllib Request is not guaranteed
            # reusable after a failed send.
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Accept", "application/json")
            if data is not None:
                req.add_header("Content-Type", content_type)
            if self._token:
                req.add_header("Authorization", f"Bearer {self._token}")
            try:
                # Chaos hook: scripted connection failures land here,
                # BEFORE the socket — the retry layer sees them exactly
                # as it would a refused connect.
                faults.fire("kube.request")
                with urllib.request.urlopen(
                        req, timeout=self._timeout_s,
                        context=self._ssl) as r:
                    payload = r.read()
                break
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")[:500]
                if e.code == 404:
                    raise NotFound(f"{method} {path}: {detail}") from None
                if e.code == 409:
                    raise Conflict(f"{method} {path}: {detail}") from None
                # 429 is weather too (apiserver flow control), and like
                # 5xx it may carry the server's own backoff hint — a
                # Retry-After header overrides the local jittered
                # schedule (capped): the server knows when it will have
                # room, the client's exponential guess does not.
                if e.code in (429,) or e.code >= 500:
                    if attempt < retries:
                        self._backoff(attempt,
                                      hint_s=_retry_after(e.headers))
                        attempt += 1
                        continue
                raise RuntimeError(
                    f"{method} {path} -> {e.code}: {detail}") from None
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError, faults.FaultInjected) as e:
                if attempt < retries:
                    self._backoff(attempt)
                    attempt += 1
                    continue
                raise RuntimeError(
                    f"{method} {path} failed after "
                    f"{attempt + 1} attempts: {e}") from e
        return json.loads(payload) if payload else {}

    def _backoff(self, attempt: int,
                 hint_s: Optional[float] = None) -> None:
        if hint_s is not None:
            # Server-supplied hint wins over the local schedule; still
            # capped (a hostile/confused server must not park the
            # reconciler) and lightly jittered so a herd told the same
            # number does not return in phase.
            delay = min(self._retry_backoff_cap_s, max(0.0, hint_s))
            time.sleep(delay * (1.0 + 0.1 * random.random()))
            return
        delay = min(self._retry_backoff_cap_s,
                    self._retry_backoff_s * (2 ** attempt))
        # Full jitter: concurrent reconcilers must not retry in phase.
        time.sleep(delay * (0.5 + 0.5 * random.random()))

    @staticmethod
    def _selector(labels: Optional[Dict[str, str]]) -> Dict[str, str]:
        if not labels:
            return {}
        return {"labelSelector":
                ",".join(f"{k}={v}" for k, v in sorted(labels.items()))}

    # -- pods -------------------------------------------------------------

    def create_pod(self, pod: ObjectDict) -> ObjectDict:
        ns = pod["metadata"]["namespace"]
        return self._request("POST", f"/api/v1/namespaces/{ns}/pods", pod)

    def get_pod(self, namespace: str, name: str) -> ObjectDict:
        return self._request(
            "GET", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def list_pods(self, namespace: str,
                  labels: Optional[Dict[str, str]] = None) -> List[ObjectDict]:
        out = self._request(
            "GET", f"/api/v1/namespaces/{namespace}/pods",
            params=self._selector(labels))
        return out.get("items", [])

    def delete_pod(self, namespace: str, name: str) -> None:
        self._request(
            "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def list_nodes(self) -> List[ObjectDict]:
        return self._request("GET", "/api/v1/nodes").get("items", [])

    # -- services ---------------------------------------------------------

    def create_service(self, svc: ObjectDict) -> ObjectDict:
        ns = svc["metadata"]["namespace"]
        return self._request(
            "POST", f"/api/v1/namespaces/{ns}/services", svc)

    def delete_service(self, namespace: str, name: str) -> None:
        try:
            self._request(
                "DELETE",
                f"/api/v1/namespaces/{namespace}/services/{name}")
        except NotFound:
            pass  # FakeKube semantics: service delete is idempotent

    # -- deployments ------------------------------------------------------

    def create_deployment(self, dep: ObjectDict) -> ObjectDict:
        ns = dep["metadata"]["namespace"]
        return self._request(
            "POST", f"/apis/apps/v1/namespaces/{ns}/deployments", dep)

    def get_deployment(self, namespace: str, name: str) -> ObjectDict:
        return self._request(
            "GET",
            f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}")

    def list_deployments(
            self, namespace: str,
            labels: Optional[Dict[str, str]] = None) -> List[ObjectDict]:
        out = self._request(
            "GET", f"/apis/apps/v1/namespaces/{namespace}/deployments",
            params=self._selector(labels))
        return out.get("items", [])

    def patch_deployment_scale(self, namespace: str, name: str,
                               replicas: int) -> ObjectDict:
        """The autoscaler's one write verb: merge-patch spec.replicas.
        PATCH is idempotent, so it rides the transient-retry policy —
        replaying a lost scale-to-N lands on N either way."""
        return self._request(
            "PATCH",
            f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}",
            {"spec": {"replicas": int(replicas)}},
            content_type="application/merge-patch+json")

    # -- custom resources -------------------------------------------------

    def _custom_path(self, namespace: Optional[str], name: str = "") -> str:
        base = f"/apis/{crd.GROUP}/{crd.VERSION}"
        if namespace:
            base += f"/namespaces/{namespace}"
        base += f"/{crd.PLURAL}"
        return base + (f"/{name}" if name else "")

    def create_custom(self, cr: ObjectDict) -> ObjectDict:
        ns = cr["metadata"].get("namespace", "default")
        return self._request("POST", self._custom_path(ns), cr)

    def list_custom(self, namespace: Optional[str] = None) -> List[ObjectDict]:
        return self._request(
            "GET", self._custom_path(namespace)).get("items", [])

    def get_custom(self, namespace: str, name: str) -> ObjectDict:
        return self._request("GET", self._custom_path(namespace, name))

    def update_custom_status(self, namespace: str, name: str,
                             status: ObjectDict) -> None:
        self._request(
            "PATCH", self._custom_path(namespace, name) + "/status",
            {"status": status},
            content_type="application/merge-patch+json")

    def delete_custom(self, namespace: str, name: str) -> None:
        try:
            self._request(
                "DELETE", self._custom_path(namespace, name))
        except NotFound:
            pass  # FakeKube semantics: CR delete is idempotent

    # -- events -----------------------------------------------------------

    def record_event(self, namespace: str, involved: str, reason: str,
                     message: str, type_: str = "Normal") -> None:
        # Best-effort, like every backend: never fail a reconcile over
        # event bookkeeping.
        try:
            import datetime
            import uuid

            self._request(
                "POST", f"/api/v1/namespaces/{namespace}/events", {
                    "metadata": {
                        "name": f"tpujob-{uuid.uuid4().hex[:12]}",
                        "namespace": namespace,
                    },
                    "involvedObject": {
                        "kind": involved.split("/")[0],
                        "name": involved.split("/")[-1],
                        "namespace": namespace,
                    },
                    "reason": reason,
                    "message": message,
                    "type": type_,
                    "firstTimestamp":
                        datetime.datetime.now(datetime.timezone.utc)
                        .strftime("%Y-%m-%dT%H:%M:%SZ"),
                })
        except Exception:
            pass
