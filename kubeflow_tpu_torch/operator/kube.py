"""Kubernetes API abstraction + in-memory fake: the port's copy of
kubeflow_tpu/operator/kube.py (stdlib only; the port imports nothing of
the JAX package).

The control plane is written against this minimal interface, and
FakeKube gives tests a complete in-memory cluster: pods with
controllable phases, events, deployments, CR status updates.  A
deployment backs the same interface with the stdlib REST client
(operator/kube_http.py) or the official ``kubernetes`` python client
(operator/kube_real.py, imported lazily so the package never depends on
cluster credentials).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

ObjectDict = Dict[str, Any]

# Pod phases (k8s core/v1 semantics).
PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"


class Conflict(Exception):
    """Create of an object that already exists."""


class NotFound(Exception):
    """Get/delete of a missing object."""


def _key(namespace: str, name: str) -> Tuple[str, str]:
    return (namespace, name)


class FakeKube:
    """In-memory cluster state. Thread-safe; no watches — the reconciler
    polls (level-triggered reconciliation, the controller-runtime model)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.pods: Dict[Tuple[str, str], ObjectDict] = {}
        self.services: Dict[Tuple[str, str], ObjectDict] = {}
        self.custom: Dict[Tuple[str, str], ObjectDict] = {}
        self.deployments: Dict[Tuple[str, str], ObjectDict] = {}
        self.events: List[ObjectDict] = []
        self.deleted_pods: List[str] = []
        self.nodes: List[ObjectDict] = []

    def list_nodes(self) -> List[ObjectDict]:
        with self._lock:
            return copy.deepcopy(self.nodes)

    # -- pods -------------------------------------------------------------

    def create_pod(self, pod: ObjectDict) -> ObjectDict:
        with self._lock:
            key = _key(pod["metadata"]["namespace"], pod["metadata"]["name"])
            if key in self.pods:
                raise Conflict(f"pod {key} exists")
            pod = copy.deepcopy(pod)
            pod.setdefault("status", {})["phase"] = PENDING
            self.pods[key] = pod
            return copy.deepcopy(pod)

    def get_pod(self, namespace: str, name: str) -> ObjectDict:
        with self._lock:
            try:
                return copy.deepcopy(self.pods[_key(namespace, name)])
            except KeyError:
                raise NotFound(f"pod {namespace}/{name}") from None

    def list_pods(self, namespace: str,
                  labels: Optional[Dict[str, str]] = None) -> List[ObjectDict]:
        with self._lock:
            out = []
            for (ns, _), pod in self.pods.items():
                if ns != namespace:
                    continue
                pod_labels = pod["metadata"].get("labels", {})
                if labels and any(pod_labels.get(k) != v
                                  for k, v in labels.items()):
                    continue
                out.append(copy.deepcopy(pod))
            return out

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            if _key(namespace, name) not in self.pods:
                raise NotFound(f"pod {namespace}/{name}")
            del self.pods[_key(namespace, name)]
            self.deleted_pods.append(f"{namespace}/{name}")

    def set_pod_phase(self, namespace: str, name: str, phase: str) -> None:
        """Test hook: simulate kubelet/scheduler state transitions."""
        with self._lock:
            self.pods[_key(namespace, name)]["status"]["phase"] = phase

    def set_pod_node(self, namespace: str, name: str, node: str) -> None:
        """Test hook: simulate the k8s scheduler binding a pod to a
        node (spec.nodeName) — what the reconciler's bad-node
        quarantine attributes worker failures to."""
        with self._lock:
            pod = self.pods[_key(namespace, name)]
            pod.setdefault("spec", {})["nodeName"] = node

    # -- services ---------------------------------------------------------

    def create_service(self, svc: ObjectDict) -> ObjectDict:
        with self._lock:
            key = _key(svc["metadata"]["namespace"], svc["metadata"]["name"])
            if key in self.services:
                raise Conflict(f"service {key} exists")
            self.services[key] = copy.deepcopy(svc)
            return copy.deepcopy(svc)

    def delete_service(self, namespace: str, name: str) -> None:
        with self._lock:
            self.services.pop(_key(namespace, name), None)

    # -- deployments ------------------------------------------------------
    # apps/v1 slice for the fleet autoscaler: it scales a serving
    # Deployment by patching spec.replicas (fleet/autoscaler.py), so the
    # fake cluster needs just create/get/scale — status.replicas tracks
    # the spec (the fake has no deployment controller; tests flip
    # readiness themselves where they need a lag).

    def create_deployment(self, dep: ObjectDict) -> ObjectDict:
        with self._lock:
            key = _key(dep["metadata"]["namespace"],
                       dep["metadata"]["name"])
            if key in self.deployments:
                raise Conflict(f"deployment {key} exists")
            dep = copy.deepcopy(dep)
            replicas = dep.get("spec", {}).get("replicas", 1)
            dep.setdefault("status", {})["replicas"] = replicas
            self.deployments[key] = dep
            return copy.deepcopy(dep)

    def get_deployment(self, namespace: str, name: str) -> ObjectDict:
        with self._lock:
            try:
                return copy.deepcopy(
                    self.deployments[_key(namespace, name)])
            except KeyError:
                raise NotFound(
                    f"deployment {namespace}/{name}") from None

    def list_deployments(
            self, namespace: str,
            labels: Optional[Dict[str, str]] = None) -> List[ObjectDict]:
        with self._lock:
            out = []
            for (ns, _), dep in self.deployments.items():
                if ns != namespace:
                    continue
                dep_labels = dep["metadata"].get("labels", {})
                if labels and any(dep_labels.get(k) != v
                                  for k, v in labels.items()):
                    continue
                out.append(copy.deepcopy(dep))
            return out

    def patch_deployment_scale(self, namespace: str, name: str,
                               replicas: int) -> ObjectDict:
        """Set spec.replicas — the autoscaler's one write verb.
        Idempotent (PATCH semantics): re-applying the same count is a
        no-op, which is what lets the level-triggered reconcile loop
        repeat itself safely."""
        with self._lock:
            key = _key(namespace, name)
            if key not in self.deployments:
                raise NotFound(f"deployment {namespace}/{name}")
            dep = self.deployments[key]
            dep.setdefault("spec", {})["replicas"] = int(replicas)
            dep.setdefault("status", {})["replicas"] = int(replicas)
            return copy.deepcopy(dep)

    # -- custom resources -------------------------------------------------

    def create_custom(self, cr: ObjectDict) -> ObjectDict:
        with self._lock:
            key = _key(cr["metadata"].get("namespace", "default"),
                       cr["metadata"]["name"])
            if key in self.custom:
                raise Conflict(f"cr {key} exists")
            self.custom[key] = copy.deepcopy(cr)
            return copy.deepcopy(cr)

    def list_custom(self, namespace: Optional[str] = None) -> List[ObjectDict]:
        with self._lock:
            return [copy.deepcopy(cr) for (ns, _), cr in self.custom.items()
                    if namespace is None or ns == namespace]

    def get_custom(self, namespace: str, name: str) -> ObjectDict:
        with self._lock:
            try:
                return copy.deepcopy(self.custom[_key(namespace, name)])
            except KeyError:
                raise NotFound(f"cr {namespace}/{name}") from None

    def update_custom_status(self, namespace: str, name: str,
                             status: ObjectDict) -> None:
        with self._lock:
            if _key(namespace, name) not in self.custom:
                raise NotFound(f"cr {namespace}/{name}")
            self.custom[_key(namespace, name)]["status"] = copy.deepcopy(status)

    def delete_custom(self, namespace: str, name: str) -> None:
        with self._lock:
            self.custom.pop(_key(namespace, name), None)

    # -- events -----------------------------------------------------------

    def record_event(self, namespace: str, involved: str, reason: str,
                     message: str, type_: str = "Normal") -> None:
        with self._lock:
            self.events.append({
                "namespace": namespace, "involvedObject": involved,
                "reason": reason, "message": message, "type": type_,
                # Wall-clock event timestamp leaving the process (the
                # apiserver convention) — not a policy decision.
                # kft: allow=clock-discipline
                "ts": time.time(),
            })
