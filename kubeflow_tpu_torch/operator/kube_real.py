"""Real-cluster backend for the control plane's kube interface (the
port's copy of kubeflow_tpu/operator/kube_real.py).

Thin adapter over the official ``kubernetes`` python client exposing the
same method surface as FakeKube (operator/kube.py).  The client is
imported when a RealKube is built, so the package has no hard
dependency on it or on cluster credentials; every call maps 1:1 onto
core/v1, apps/v1 or the TPUJob CRD group (kubeflow-tpu.org/v1alpha1,
see operator/crd.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubeflow_tpu_torch.operator import crd
from kubeflow_tpu_torch.operator.kube import Conflict, NotFound, ObjectDict


class RealKube:
    def __init__(self, kubeconfig: Optional[str] = None):
        import kubernetes  # type: ignore[import-not-found]

        try:
            kubernetes.config.load_incluster_config()
        except Exception:
            kubernetes.config.load_kube_config(config_file=kubeconfig)
        self._core = kubernetes.client.CoreV1Api()
        self._apps = kubernetes.client.AppsV1Api()
        self._custom = kubernetes.client.CustomObjectsApi()
        self._api_exc = kubernetes.client.rest.ApiException

    def _wrap(self, call, *a, **kw):
        try:
            return call(*a, **kw)
        except self._api_exc as e:
            if e.status == 404:
                raise NotFound(str(e)) from None
            if e.status == 409:
                raise Conflict(str(e)) from None
            raise

    # -- pods -------------------------------------------------------------

    def create_pod(self, pod: ObjectDict) -> ObjectDict:
        return self._wrap(
            self._core.create_namespaced_pod,
            pod["metadata"]["namespace"], pod,
        )

    def get_pod(self, namespace: str, name: str) -> ObjectDict:
        out = self._wrap(self._core.read_namespaced_pod, name, namespace)
        return self._core.api_client.sanitize_for_serialization(out)

    def list_pods(self, namespace: str,
                  labels: Optional[Dict[str, str]] = None) -> List[ObjectDict]:
        selector = ",".join(f"{k}={v}" for k, v in (labels or {}).items())
        out = self._wrap(self._core.list_namespaced_pod, namespace,
                         label_selector=selector or None)
        return [self._core.api_client.sanitize_for_serialization(p)
                for p in out.items]

    def delete_pod(self, namespace: str, name: str) -> None:
        self._wrap(self._core.delete_namespaced_pod, name, namespace)

    def list_nodes(self) -> List[ObjectDict]:
        out = self._wrap(self._core.list_node)
        return [self._core.api_client.sanitize_for_serialization(n)
                for n in out.items]

    # -- services ---------------------------------------------------------

    def create_service(self, svc: ObjectDict) -> ObjectDict:
        return self._wrap(self._core.create_namespaced_service,
                          svc["metadata"]["namespace"], svc)

    def delete_service(self, namespace: str, name: str) -> None:
        self._wrap(self._core.delete_namespaced_service, name, namespace)

    # -- deployments ------------------------------------------------------

    def create_deployment(self, dep: ObjectDict) -> ObjectDict:
        return self._wrap(self._apps.create_namespaced_deployment,
                          dep["metadata"]["namespace"], dep)

    def get_deployment(self, namespace: str, name: str) -> ObjectDict:
        out = self._wrap(self._apps.read_namespaced_deployment,
                         name, namespace)
        return self._core.api_client.sanitize_for_serialization(out)

    def list_deployments(
            self, namespace: str,
            labels: Optional[Dict[str, str]] = None) -> List[ObjectDict]:
        selector = ",".join(f"{k}={v}" for k, v in (labels or {}).items())
        out = self._wrap(self._apps.list_namespaced_deployment,
                         namespace, label_selector=selector or None)
        return [self._core.api_client.sanitize_for_serialization(d)
                for d in out.items]

    def patch_deployment_scale(self, namespace: str, name: str,
                               replicas: int) -> ObjectDict:
        out = self._wrap(self._apps.patch_namespaced_deployment,
                         name, namespace,
                         {"spec": {"replicas": int(replicas)}})
        return self._core.api_client.sanitize_for_serialization(out)

    # -- custom resources -------------------------------------------------

    def list_custom(self, namespace: Optional[str] = None) -> List[ObjectDict]:
        if namespace:
            out = self._wrap(
                self._custom.list_namespaced_custom_object,
                crd.GROUP, crd.VERSION, namespace, crd.PLURAL,
            )
        else:
            out = self._wrap(
                self._custom.list_cluster_custom_object,
                crd.GROUP, crd.VERSION, crd.PLURAL,
            )
        return out.get("items", [])

    def get_custom(self, namespace: str, name: str) -> ObjectDict:
        return self._wrap(
            self._custom.get_namespaced_custom_object,
            crd.GROUP, crd.VERSION, namespace, crd.PLURAL, name,
        )

    def update_custom_status(self, namespace: str, name: str,
                             status: ObjectDict) -> None:
        self._wrap(
            self._custom.patch_namespaced_custom_object_status,
            crd.GROUP, crd.VERSION, namespace, crd.PLURAL, name,
            {"status": status},
        )

    def delete_custom(self, namespace: str, name: str) -> None:
        self._wrap(
            self._custom.delete_namespaced_custom_object,
            crd.GROUP, crd.VERSION, namespace, crd.PLURAL, name,
        )

    # -- events -----------------------------------------------------------

    def record_event(self, namespace: str, involved: str, reason: str,
                     message: str, type_: str = "Normal") -> None:
        # Events are best-effort; never fail reconciliation over one.
        try:
            import datetime
            import uuid

            self._core.create_namespaced_event(namespace, {
                "metadata": {"name": f"tpujob-{uuid.uuid4().hex[:12]}",
                             "namespace": namespace},
                "involvedObject": {"kind": involved.split("/")[0],
                                   "name": involved.split("/")[-1],
                                   "namespace": namespace},
                "reason": reason,
                "message": message,
                "type": type_,
                "firstTimestamp":
                    datetime.datetime.now(datetime.timezone.utc)
                    .strftime("%Y-%m-%dT%H:%M:%SZ"),
            })
        except Exception:
            pass
