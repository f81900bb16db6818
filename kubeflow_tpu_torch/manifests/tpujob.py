"""TPUJob package: operator manifests + job CR prototypes.

Heir of two reference packages:
* kubeflow/core/tf-job-operator.libsonnet (CRD :27-59, operator Deployment
  :61-125, controller ConfigMap :193-249, RBAC, dashboard :417-450)
* kubeflow/tf-job (CR builder tf-job.libsonnet:6-57, prototypes
  tf-job.jsonnet + tf-cnn-benchmarks.jsonnet)

The port's copy of kubeflow_tpu/manifests/tpujob.py: the same prototypes
and params, rendering the port's operator (``kubeflow_tpu_torch.operator.
main``) and jobs on the port's GPU gang shapes (``h100-N``, ``a3-highgpu-
Ng``, ``cpu-N``; ``runtime/topology.py``), whose pods ask for
``nvidia.com/gpu``.  The operator reconciles whole gangs (no per-replica
GPU counts, no default-PS machinery: SPMD has no parameter servers), and
the benchmark prototype launches the port's ResNet-50 trainer.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.config import Prototype, default_registry, param
from kubeflow_tpu_torch.manifests import base
from kubeflow_tpu_torch.operator import crd
from kubeflow_tpu_torch.operator.crd import (
    MeshSpec,
    RestartPolicy,
    StorageSpec,
    TPUJobSpec,
    WorkerSpec,
)

DEFAULT_OPERATOR_IMAGE = "ghcr.io/kubeflow-tpu-torch/operator:latest"
DEFAULT_WORKER_IMAGE = "ghcr.io/kubeflow-tpu-torch/worker:latest"
DEFAULT_DASHBOARD_IMAGE = "ghcr.io/kubeflow-tpu-torch/tpujob-dashboard:latest"


def tpujob_crd() -> dict:
    return base.crd(
        plural=crd.PLURAL, group=crd.GROUP, kind=crd.KIND,
        versions=[crd.VERSION], short_names=["tj"],
    )


def controller_config(namespace: str) -> dict:
    """Operator ConfigMap.

    Heir of the reference's controller_config_file.yaml
    (kubeflow/core/tf-job-operator.libsonnet:193-249) which carried
    grpcServerFilePath + per-cloud nvidia hostPath mounts.  This one
    carries the default worker image and gang-scheduling knobs; the GPUs
    and their driver mounts come from the GKE NVIDIA device plugin, not
    hostPath surgery.
    """
    config = {
        "defaultWorkerImage": DEFAULT_WORKER_IMAGE,
        "gang": {
            "admissionTimeoutSeconds": 300,
            "scheduleToRunningP50TargetSeconds": 60,
        },
        "coordinatorPort": 8476,
        # Slice capacity the deployed operator schedules against
        # (operator/main.py reads this key); cpu-1 slots make CPU gangs
        # work on GPU-less clusters out of the box.
        "inventory": {"h100-8": 4, "cpu-1": 4},
    }
    return base.config_map(
        "tpujob-operator-config", namespace,
        {"controller_config_file.yaml": json.dumps(config, indent=2)},
    )


def operator_manifests(name: str = "tpujob-operator",
                       namespace: str = "kubeflow",
                       image: str = DEFAULT_OPERATOR_IMAGE) -> List[dict]:
    labels = {"app": name}
    sa = base.service_account(name, namespace, labels)
    role = base.cluster_role(name, rules=[
        {"apiGroups": [crd.GROUP], "resources": ["tpujobs", "tpujobs/status"],
         "verbs": ["*"]},
        {"apiGroups": [""], "resources": ["pods", "services", "events",
                                          "configmaps"],
         "verbs": ["*"]},
        {"apiGroups": ["apiextensions.k8s.io"],
         "resources": ["customresourcedefinitions"], "verbs": ["get", "create"]},
    ], labels=labels)
    binding = base.cluster_role_binding(name, name, name, namespace, labels)
    deploy = base.deployment(
        name, namespace, labels,
        base.pod_spec(
            containers=[base.container(
                name, image,
                command=["python", "-m", "kubeflow_tpu_torch.operator.main"],
                args=["--namespace", namespace,
                      "--controller-config-file",
                      "/etc/config/controller_config_file.yaml",
                      "--metrics-port", "9090"],
                ports=[9090],
                volume_mounts=[{"name": "config-volume",
                                "mountPath": "/etc/config"}],
            )],
            volumes=[{"name": "config-volume",
                      "configMap": {"name": "tpujob-operator-config"}}],
            service_account=name,
        ),
    )
    # Scrape annotations on the pod template: the operator has no
    # Service of its own, so Prometheus pod discovery finds :9090.
    deploy["spec"]["template"]["metadata"]["annotations"] = {
        "prometheus.io/scrape": "true",
        "prometheus.io/port": "9090",
        "prometheus.io/path": "/metrics",
    }
    return [tpujob_crd(), controller_config(namespace), sa, role, binding, deploy]


def dashboard_manifests(name: str = "tpujob-dashboard",
                        namespace: str = "kubeflow",
                        image: str = DEFAULT_DASHBOARD_IMAGE
                        ) -> List[dict]:
    """TPUJob dashboard UI — heir of the tf-job dashboard
    (kubeflow/core/tf-job-operator.libsonnet:417-450), routed through the
    gateway with the same Service-annotation pattern."""
    labels = {"name": name}
    deploy = base.deployment(
        name, namespace, labels,
        base.pod_spec(containers=[base.container(
            name, image,
            command=["python", "-m", "kubeflow_tpu_torch.tools.dashboard"],
            args=["--mode=tpujobs", "--port=8080"],
            ports=[8080],
        )], service_account="tpujob-operator"),
    )
    svc = base.service(
        name, namespace, labels, [base.port(80, "http", 8080)],
        annotations={"getambassador.io/config": base.ambassador_route(
            name, "/tpujobs/", name, 80, rewrite="/tpujobs/")},
    )
    return [deploy, svc]


def _job_from_params(component_name: str, namespace: str, slice_type: str,
                     num_slices: int, image: str, command: List[str],
                     args: List[str], mesh: Optional[Dict[str, Any]] = None,
                     checkpoint_path: str = "",
                     max_restarts: int = 3) -> TPUJobSpec:
    return TPUJobSpec(
        name=component_name,
        namespace=namespace,
        slice_type=slice_type,
        num_slices=num_slices,
        mesh=MeshSpec.from_dict(mesh or {}),
        worker=WorkerSpec(image=image, command=list(command), args=list(args)),
        storage=(StorageSpec(kind="gcs", base_path=checkpoint_path)
                 if checkpoint_path else None),
        restart=RestartPolicy(max_restarts=max_restarts),
    )


# ---------------------------------------------------------------------------
# Prototypes (heirs of kubeflow/tf-job/prototypes/*.jsonnet)
# ---------------------------------------------------------------------------

def _generate_tpu_job(component_name: str, **p: Any) -> List[dict]:
    job = _job_from_params(
        component_name, p["namespace"], p["slice_type"], p["num_slices"],
        p["image"], p["command"], p["args"], checkpoint_path=p["checkpoint_path"],
        max_restarts=p["max_restarts"],
    )
    return [job.to_custom_resource()]


tpu_job_prototype = default_registry.register(Prototype(
    name="tpu-job",
    doc="A generic SPMD gang job on a GPU gang (heir of tf-job prototype, "
        "kubeflow/tf-job/prototypes/tf-job.jsonnet:1-40).",
    params=[
        param("namespace", str, "kubeflow", "deployment namespace"),
        param("slice_type", str, "h100-8", "GPU gang shape, e.g. h100-32"),
        param("num_slices", int, 1, "number of gangs joined over the network"),
        param("image", str, DEFAULT_WORKER_IMAGE, "worker container image"),
        param("command", list, [], "container command"),
        param("args", list, [], "container args"),
        param("checkpoint_path", str, "", "GCS path for checkpoints"),
        param("max_restarts", int, 3, "gang restarts before giving up"),
    ],
    generate=_generate_tpu_job,
))


def _generate_tpu_cnn(component_name: str, **p: Any) -> List[dict]:
    # Heir of the tf-cnn-benchmarks arg assembly
    # (kubeflow/tf-job/prototypes/tf-cnn-benchmarks.jsonnet:40-62): the
    # PS-mode flags (--variable_update=parameter_server, --num_ps) have no
    # SPMD meaning and are replaced by mesh axes; batch/model knobs remain.
    args = [
        f"--model={p['model']}",
        f"--batch-size-per-device={p['batch_size']}",
        f"--steps={p['num_batches']}",
        "--dtype=bfloat16",
    ]
    if p["data_dir"]:
        args.append(f"--data-dir={p['data_dir']}")
    job = _job_from_params(
        component_name, p["namespace"], p["slice_type"], p["num_slices"],
        p["image"], ["python", "-m", "kubeflow_tpu_torch.tools.train_cnn"], args,
        checkpoint_path=p["checkpoint_path"],
    )
    return [job.to_custom_resource()]


tpu_cnn_prototype = default_registry.register(Prototype(
    name="tpu-cnn-benchmark",
    doc="ResNet-50 benchmark TPUJob on GPUs (heir of tf-cnn-benchmarks prototype, "
        "kubeflow/tf-job/prototypes/tf-cnn-benchmarks.jsonnet:1-100).",
    params=[
        param("namespace", str, "kubeflow", "deployment namespace"),
        param("slice_type", str, "h100-8", "GPU gang shape"),
        param("num_slices", int, 1, "number of slices"),
        param("model", str, "resnet50", "model name",
              choices=["resnet50", "resnet101", "inception_v3"]),
        param("batch_size", int, 128, "per-device batch size"),
        param("num_batches", int, 100, "training steps to run"),
        param("data_dir", str, "",
              "KFTR shard directory (synthetic input data when unset)"),
        param("image", str, DEFAULT_WORKER_IMAGE, "worker image"),
        param("checkpoint_path", str, "", "GCS checkpoint path"),
    ],
    generate=_generate_tpu_cnn,
))


def _generate_operator(component_name: str, **p: Any) -> List[dict]:
    out = operator_manifests(component_name, p["namespace"], p["image"])
    if p["install_dashboard"]:
        out += dashboard_manifests(namespace=p["namespace"])
    return out


operator_prototype = default_registry.register(Prototype(
    name="tpujob-operator",
    doc="The TPUJob operator control plane (heir of tf-job-operator manifests, "
        "kubeflow/core/tf-job-operator.libsonnet:61-125).",
    params=[
        param("namespace", str, "kubeflow", "deployment namespace"),
        param("image", str, DEFAULT_OPERATOR_IMAGE, "operator image"),
        param("install_dashboard", bool, True, "deploy the TPUJob dashboard UI"),
    ],
    generate=_generate_operator,
))
