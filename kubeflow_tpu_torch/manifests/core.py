"""kubeflow-tpu-core: the aggregate deployable unit.

The port's copy of kubeflow_tpu/manifests/core.py, importing nothing of the JAX
package.

Heir of kubeflow/core/all.libsonnet:2-19, which summed jupyterhub +
tf-job-operator + ambassador + nfs + spartakus + central dashboard +
version into one `ks generate kubeflow-core` prototype
(kubeflow/core/prototypes/all.jsonnet:1-31).  Same aggregation here, with
the TPUJob operator in place of tf-operator and opt-in telemetry in place
of Spartakus.
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Dict, List

from kubeflow_tpu_torch.config import Prototype, default_registry, param
from kubeflow_tpu_torch.manifests import base, jupyterhub, tpujob
from kubeflow_tpu_torch.version import version_info

AMBASSADOR_IMAGE = "quay.io/datawire/ambassador:0.30.1"


def ambassador_manifests(namespace: str,
                         service_type: str = "ClusterIP") -> List[dict]:
    """API gateway — same envoy-based Ambassador pattern as
    kubeflow/core/ambassador.libsonnet:1-60; routes are declared as
    annotations on each component's Service, so the gateway itself is
    generic."""
    labels = {"service": "ambassador"}
    sa = base.service_account("ambassador", namespace, labels)
    role = base.cluster_role("ambassador", rules=[
        {"apiGroups": [""],
         "resources": ["services", "configmaps", "secrets", "endpoints"],
         "verbs": ["get", "list", "watch", "create", "update"]},
    ], labels=labels)
    binding = base.cluster_role_binding(
        "ambassador", "ambassador", "ambassador", namespace, labels)
    deploy = base.deployment(
        "ambassador", namespace, labels,
        base.pod_spec(
            containers=[
                base.container(
                    "ambassador", AMBASSADOR_IMAGE,
                    env={"AMBASSADOR_NAMESPACE": namespace,
                         "AMBASSADOR_SINGLE_NAMESPACE": "true"},
                    ports=[80, 443, 8877],
                    resources={"requests": {"cpu": "200m", "memory": "100Mi"},
                               "limits": {"cpu": "1", "memory": "400Mi"}},
                ),
            ],
            service_account="ambassador",
        ),
        replicas=3,
    )
    svc = base.service("ambassador", namespace, labels,
                       [base.port(80, "ambassador")],
                       service_type=service_type)
    admin = base.service("ambassador-admin", namespace, labels,
                         [base.port(8877, "ambassador-admin")])
    return [sa, role, binding, deploy, svc, admin]


def central_dashboard_manifests(namespace: str, image: str) -> List[dict]:
    """Landing-page UI — heir of kubeflow/core/centraldashboard.libsonnet."""
    labels = {"app": "centraldashboard"}
    sa = base.service_account("centraldashboard", namespace, labels)
    role = base.cluster_role("centraldashboard", rules=[
        {"apiGroups": [""], "resources": ["pods"],
         "verbs": ["get", "list"]},
        {"apiGroups": [tpujob.crd.GROUP], "resources": ["tpujobs"],
         "verbs": ["get", "list"]},
    ], labels=labels)
    binding = base.cluster_role_binding(
        "centraldashboard", "centraldashboard", "centraldashboard",
        namespace, labels)
    deploy = base.deployment(
        "centraldashboard", namespace, labels,
        base.pod_spec(
            containers=[base.container(
                "centraldashboard", image,
                command=["python", "-m", "kubeflow_tpu_torch.tools.dashboard"],
                args=["--mode=central", "--port=8082"],
                ports=[8082],
            )],
            service_account="centraldashboard",
        ),
    )
    svc = base.service(
        "centraldashboard", namespace, labels,
        [base.port(80, "http", 8082)],
        annotations={"getambassador.io/config": base.ambassador_route(
            "centraldashboard", "/", "centraldashboard", 80)},
    )
    return [sa, role, binding, deploy, svc]


def nfs_manifests(namespace: str, capacity_gi: int = 10) -> List[dict]:
    """In-cluster NFS provisioner for notebook/model storage — heir of
    kubeflow/core/nfs.libsonnet:41-295 (StorageClass :82, Deployment :129)."""
    labels = {"app": "nfs-provisioner"}
    sa = base.service_account("nfs-provisioner", namespace, labels)
    deploy = base.deployment(
        "nfs-provisioner", namespace, labels,
        base.pod_spec(
            containers=[base.container(
                "nfs-provisioner",
                "quay.io/kubernetes_incubator/nfs-provisioner:v1.0.8",
                args=["-provisioner=kubeflow-tpu/nfs"],
                env={"POD_NAMESPACE": namespace},
                ports=[2049, 20048, 111],
                security_context={"capabilities": {
                    "add": ["DAC_READ_SEARCH", "SYS_RESOURCE"]}},
            )],
            service_account="nfs-provisioner",
        ),
    )
    svc = base.service("nfs-provisioner", namespace, labels, [
        base.port(2049, "nfs"), base.port(20048, "mountd"),
        base.port(111, "rpcbind"),
    ])
    storage_class = {
        "apiVersion": "storage.k8s.io/v1",
        "kind": "StorageClass",
        "metadata": {"name": "nfs"},
        "provisioner": "kubeflow-tpu/nfs",
    }
    pvc = {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": base.metadata("nfs", namespace),
        "spec": {
            "accessModes": ["ReadWriteMany"],
            "storageClassName": "nfs",
            "resources": {"requests": {"storage": f"{capacity_gi}Gi"}},
        },
    }
    return [sa, deploy, svc, storage_class, pvc]


def telemetry_manifests(namespace: str, usage_id: str) -> List[dict]:
    """Opt-in anonymous usage reporting — heir of Spartakus
    (kubeflow/core/spartakus.libsonnet:4-14; opt-out documented in
    user_guide.md:158-186).  Only rendered when report_usage=True."""
    labels = {"app": "usage-telemetry"}
    return [base.deployment(
        "usage-telemetry", namespace, labels,
        base.pod_spec(containers=[base.container(
            "telemetry", "ghcr.io/kubeflow-tpu-torch/telemetry:latest",
            command=["python", "-m", "kubeflow_tpu_torch.tools.telemetry"],
            args=[f"--usage-id={usage_id}", "--interval-hours=24"],
        )]),
    )]


def version_configmap(namespace: str) -> dict:
    """Deployed-version introspection — heir of kubeflow/core/version.libsonnet:1-15."""
    return base.config_map(
        "kubeflow-version", namespace,
        {"version-info.json": json.dumps(version_info(), indent=2)},
    )


def _generate_core(component_name: str, **p: Any) -> List[dict]:
    namespace = p["namespace"]
    objects: List[dict] = []
    # Cloud hint (heir of the reference's `cloud` param,
    # kubeflow/core/prototypes/all.jsonnet:4): gke exposes the gateway via
    # LoadBalancer and iap-ready auth defaults; minikube keeps ClusterIP.
    if p["cloud"] == "gke" and p["ambassador_service_type"] == "ClusterIP":
        p = {**p, "ambassador_service_type": "LoadBalancer"}
    # When the in-cluster NFS stack is deployed, user notebook PVCs bind to
    # its StorageClass (the reference wired jupyterHubNotebookPVCMount to the
    # disks feature the same way, kubeflow/core/prototypes/all.jsonnet:14-16).
    storage_class = "nfs" if p["disks"] else ""
    objects += jupyterhub.hub_manifests(
        "tpu-hub", namespace, jupyterhub.DEFAULT_HUB_IMAGE,
        p["notebook_image"], p["jupyter_hub_authenticator"], storage_class,
        "/home/jovyan")
    objects += tpujob.operator_manifests(namespace=namespace)
    objects += tpujob.dashboard_manifests(namespace=namespace)
    objects += ambassador_manifests(namespace, p["ambassador_service_type"])
    objects += central_dashboard_manifests(namespace, p["dashboard_image"])
    if p["disks"]:
        objects += nfs_manifests(namespace)
    if p["report_usage"]:
        objects += telemetry_manifests(namespace, p["usage_id"])
    objects.append(version_configmap(namespace))
    return objects


core_prototype = default_registry.register(Prototype(
    name="kubeflow-core",
    doc="Everything needed for a GPU ML cluster: hub + operator + gateway + "
        "dashboards (heir of kubeflow/core/prototypes/all.jsonnet:1-31).",
    params=[
        param("namespace", str, "kubeflow", "deployment namespace"),
        param("cloud", str, "", "cloud provider hint",
              choices=["", "gke", "aks", "minikube"]),
        param("notebook_image", str, jupyterhub.DEFAULT_NOTEBOOK_IMAGE,
              "default notebook image"),
        param("jupyter_hub_authenticator", str, "dummy",
              "hub authenticator", choices=["dummy", "iap"]),
        param("ambassador_service_type", str, "ClusterIP",
              "gateway service type",
              choices=["ClusterIP", "NodePort", "LoadBalancer"]),
        param("dashboard_image", str,
              "ghcr.io/kubeflow-tpu-torch/centraldashboard:latest",
              "central dashboard image"),
        param("disks", bool, False, "deploy in-cluster NFS"),
        param("report_usage", bool, False, "enable opt-in usage telemetry"),
        param("usage_id", str, "unknown_cluster", "anonymous usage id"),
    ],
    generate=_generate_core,
))


def new_usage_id() -> str:
    return str(uuid.uuid4())
