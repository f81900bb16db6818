"""Off-the-shelf addon packages: Argo, Seldon, Pachyderm, credentials preset.

The port's copy of kubeflow_tpu/manifests/addons.py, importing nothing of the JAX
package.

Parity with the reference's third-party integration packages — these were
always external images orchestrated by config (SURVEY.md: "the repo's own
code is the control plane, packaging, and glue"):

  - argo: workflow-controller + UI + Workflow CRD + RBAC
    (kubeflow/argo/argo.libsonnet:24-99) — also the engine our E2E test
    DAGs target (testing/workflow.py).
  - seldon-core: apife + operator + redis (kubeflow/seldon/core.libsonnet)
  - pachyderm: pachd + etcd (kubeflow/pachyderm/all.libsonnet)
  - gcp-credentials-pod-preset (kubeflow/credentials-pod-preset/)
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry
from kubeflow_tpu_torch.manifests import base


# ---------------------------------------------------------------------------
# Argo
# ---------------------------------------------------------------------------

def _generate_argo(component_name: str, **p: Any) -> List[dict]:
    ns = p["namespace"]
    workflow_crd = {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "workflows.argoproj.io"},
        "spec": {
            "group": "argoproj.io",
            "names": {"kind": "Workflow", "plural": "workflows",
                      "shortNames": ["wf"]},
            "scope": "Namespaced",
            "versions": [{
                "name": "v1alpha1", "served": True, "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object", "x-kubernetes-preserve-unknown-fields":
                        True}},
            }],
        },
    }
    sa = base.service_account("argo", ns)
    role = base.cluster_role("argo-cluster-role", [
        {"apiGroups": [""],
         "resources": ["pods", "pods/exec", "pods/log", "events",
                       "configmaps", "secrets"],
         "verbs": ["*"]},
        {"apiGroups": ["argoproj.io"], "resources": ["workflows"],
         "verbs": ["*"]},
    ])
    binding = base.cluster_role_binding(
        "argo-binding", "argo-cluster-role", "argo", ns)
    controller = base.deployment(
        name="workflow-controller", namespace=ns,
        labels={"app": "workflow-controller"},
        spec=base.pod_spec(
            [base.container(
                "workflow-controller", p["controller_image"],
                command=["workflow-controller"],
                args=["--configmap", "workflow-controller-configmap",
                      "--executor-image", p["executor_image"]],
            )],
            service_account="argo",
        ),
    )
    configmap = base.config_map(
        "workflow-controller-configmap", ns,
        {"config": f"executorImage: {p['executor_image']}\n"},
    )
    ui = base.deployment(
        name="argo-ui", namespace=ns, labels={"app": "argo-ui"},
        spec=base.pod_spec(
            [base.container(
                "argo-ui", p["ui_image"],
                env={"ARGO_NAMESPACE": ns, "IN_CLUSTER": "true",
                     "BASE_HREF": "/argo/"},
                ports=[8001],
            )],
            service_account="argo",
        ),
    )
    ui_svc = base.service(
        name="argo-ui", namespace=ns, selector={"app": "argo-ui"},
        ports=[base.port(80, "http", 8001)],
        annotations={"getambassador.io/config": base.ambassador_route(
            "argo-ui", "/argo/", "argo-ui", 80)},
    )
    return [workflow_crd, sa, role, binding, configmap, controller, ui,
            ui_svc]


argo_prototype = default_registry.register(Prototype(
    name="argo",
    doc="Argo workflow engine (heir of kubeflow/argo): pipeline "
                "CRD + controller + UI; also runs the E2E test DAGs",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("controller_image", str,
              "argoproj/workflow-controller:v2.2.0", "controller image"),
        param("executor_image", str, "argoproj/argoexec:v2.2.0",
              "step executor image"),
        param("ui_image", str, "argoproj/argoui:v2.2.0", "UI image"),
    ],
    generate=_generate_argo,
))


# ---------------------------------------------------------------------------
# Seldon
# ---------------------------------------------------------------------------

def _generate_seldon(component_name: str, **p: Any) -> List[dict]:
    ns = p["namespace"]
    crd = {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "seldondeployments.machinelearning.seldon.io"},
        "spec": {
            "group": "machinelearning.seldon.io",
            "names": {"kind": "SeldonDeployment", "plural":
                      "seldondeployments", "shortNames": ["sdep"]},
            "scope": "Namespaced",
            "versions": [{
                "name": "v1alpha2", "served": True, "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "x-kubernetes-preserve-unknown-fields": True}},
            }],
        },
    }
    operator = base.deployment(
        name="seldon-cluster-manager", namespace=ns,
        labels={"app": "seldon-cluster-manager"},
        spec=base.pod_spec([base.container(
            "seldon-cluster-manager", p["operator_image"],
            env={"JAVA_OPTS": "-Dlogging.level.org.springframework=INFO",
                 "SELDON_CLUSTER_MANAGER_REDIS_HOST": "redis"},
            ports=[8080],
        )]),
    )
    apife = base.deployment(
        name="seldon-apiserver", namespace=ns,
        labels={"app": "seldon-apiserver"},
        spec=base.pod_spec([base.container(
            "seldon-apiserver", p["apife_image"],
            env={"SELDON_CLUSTER_MANAGER_REDIS_HOST": "redis"},
            ports=[8080, 5000],
        )]),
    )
    apife_svc = base.service(
        name="seldon-apiserver", namespace=ns,
        selector={"app": "seldon-apiserver"},
        ports=[base.port(8080, "http"), base.port(5000, "grpc")],
    )
    redis = base.deployment(
        name="redis", namespace=ns, labels={"app": "redis"},
        spec=base.pod_spec([base.container(
            "redis", "redis:4.0.1", ports=[6379])]),
    )
    redis_svc = base.service(
        name="redis", namespace=ns, selector={"app": "redis"},
        ports=[base.port(6379)],
    )
    return [crd, operator, apife, apife_svc, redis, redis_svc]


seldon_prototype = default_registry.register(Prototype(
    name="seldon",
    doc="Seldon-core model serving stack "
                "(heir of kubeflow/seldon)",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("operator_image", str,
              "seldonio/cluster-manager:0.1.6", "operator image"),
        param("apife_image", str, "seldonio/apife:0.1.6",
              "API front-end image"),
    ],
    generate=_generate_seldon,
))


# ---------------------------------------------------------------------------
# Pachyderm
# ---------------------------------------------------------------------------

def _generate_pachyderm(component_name: str, **p: Any) -> List[dict]:
    ns = p["namespace"]
    etcd = base.deployment(
        name="etcd", namespace=ns, labels={"app": "etcd"},
        spec=base.pod_spec([base.container(
            "etcd", "quay.io/coreos/etcd:v3.3.5",
            command=["/usr/local/bin/etcd", "--listen-client-urls",
                     "http://0.0.0.0:2379", "--advertise-client-urls",
                     "http://0.0.0.0:2379"],
            ports=[2379])]),
    )
    etcd_svc = base.service(
        name="etcd", namespace=ns, selector={"app": "etcd"},
        ports=[base.port(2379)],
    )
    pachd = base.deployment(
        name="pachd", namespace=ns, labels={"app": "pachd"},
        spec=base.pod_spec([base.container(
            "pachd", p["pachd_image"],
            env={"PACH_ROOT": "/pach", "ETCD_SERVICE_HOST": "etcd",
                 "ETCD_SERVICE_PORT": "2379",
                 "STORAGE_BACKEND": p["storage_backend"]},
            ports=[650, 651],
        )], service_account="pachyderm"),
    )
    sa = base.service_account("pachyderm", ns)
    pachd_svc = base.service(
        name="pachd", namespace=ns, selector={"app": "pachd"},
        ports=[base.port(650, "api"), base.port(651, "trace")],
    )
    return [sa, etcd, etcd_svc, pachd, pachd_svc]


pachyderm_prototype = default_registry.register(Prototype(
    name="pachyderm",
    doc="Pachyderm data versioning (heir of kubeflow/pachyderm)",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("pachd_image", str, "pachyderm/pachd:1.7.3", "pachd image"),
        param("storage_backend", str, "LOCAL",
              "LOCAL | GOOGLE | AMAZON | MICROSOFT"),
    ],
    generate=_generate_pachyderm,
))


# ---------------------------------------------------------------------------
# GCP credentials PodPreset
# ---------------------------------------------------------------------------

def _generate_credentials_preset(component_name: str, **p: Any) -> List[dict]:
    preset = {
        "apiVersion": "settings.k8s.io/v1alpha1",
        "kind": "PodPreset",
        "metadata": base.metadata(component_name, p["namespace"]),
        "spec": {
            "selector": {"matchLabels": {p["match_label"]: "true"}},
            "env": [{"name": "GOOGLE_APPLICATION_CREDENTIALS",
                     "value": "/secret/gcp-credentials/key.json"}],
            "volumeMounts": [{"name": "gcp-credentials",
                              "mountPath": "/secret/gcp-credentials",
                              "readOnly": True}],
            "volumes": [{"name": "gcp-credentials",
                         "secret": {"secretName": p["secret_name"]}}],
        },
    }
    return [preset]


credentials_preset_prototype = default_registry.register(Prototype(
    name="gcp-credentials-pod-preset",
    doc="PodPreset injecting GCP credentials into labelled pods "
                "(heir of kubeflow/credentials-pod-preset)",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("secret_name", str, "user-gcp-sa", "SA key secret"),
        param("match_label", str, "inject-gcp-credentials",
              "pods with this label=true get credentials"),
    ],
    generate=_generate_credentials_preset,
))
