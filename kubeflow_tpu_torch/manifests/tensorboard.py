"""TensorBoard component — heir of kubeflow/core/tensorboard.libsonnet.

The port's copy of kubeflow_tpu/manifests/tensorboard.py, importing nothing of the JAX
package.

Same parameter surface (logDir + GCS/S3 credential mixins,
tensorboard.libsonnet:1-50) serving XProf/JAX profiler traces written by
runtime/profiling.py; routed through Ambassador like every reference UI.
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry
from kubeflow_tpu_torch.manifests import base
from kubeflow_tpu_torch.manifests.serving import gcp_volume_mixin, s3_env

PORT = 6006


def _generate_tensorboard(component_name: str, **p: Any) -> List[dict]:
    namespace = p["namespace"]
    name = component_name
    labels = {"app": name, "kubeflow-tpu.org/component": "tensorboard"}

    env: List[dict] = []
    volumes: List[dict] = []
    mounts: List[dict] = []
    if p["storage_type"] == "s3":
        env.extend(s3_env(p))
    elif p["storage_type"] == "gcp":
        volume, mount, genv = gcp_volume_mixin(p["gcp_secret_name"])
        volumes.append(volume)
        mounts.append(mount)
        env.extend(genv)

    container = {
        "name": name,
        "image": p["image"],
        "command": ["tensorboard", f"--logdir={p['log_dir']}",
                    "--port", str(PORT), "--bind_all"],
        "ports": [{"containerPort": PORT}],
    }
    if env:
        container["env"] = env
    if mounts:
        container["volumeMounts"] = mounts
    deploy = base.deployment(
        name=name, namespace=namespace, labels=labels,
        spec=base.pod_spec([container], volumes=volumes or None),
    )
    svc = base.service(
        name=name, namespace=namespace, selector=labels,
        ports=[base.port(80, "http", PORT)],
        annotations={"getambassador.io/config": base.ambassador_route(
            name, f"/tensorboard/{name}/", name, 80)},
        labels=labels,
    )
    return [deploy, svc]


tensorboard_prototype = default_registry.register(Prototype(
    name="tensorboard",
    doc="TensorBoard/XProf viewer for training logs and profiler "
                "traces (heir of kubeflow/core/tensorboard.libsonnet)",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("log_dir", str, "/tmp/logs", "trace/summary directory "
              "(gs://, s3://, or mounted path)"),
        param("image", str, "tensorflow/tensorflow:latest",
              "image providing the tensorboard binary"),
        param("storage_type", str, "", "credential mixin: '', 'gcp', 's3'"),
        param("gcp_secret_name", str, "user-gcp-sa", "GCP SA key secret"),
        param("s3_secret_name", str, "s3-credentials", "S3 secret name"),
        param("s3_secret_accesskeyid_key_name", str, "accessKeyID",
              "key within the S3 secret"),
        param("s3_secret_secretaccesskey_key_name", str, "secretAccessKey",
              "key within the S3 secret"),
        param("s3_aws_region", str, "us-west-1", "AWS region"),
        param("s3_use_https", str, "true", "S3 over TLS"),
        param("s3_verify_ssl", str, "true", "verify S3 TLS certs"),
        param("s3_endpoint", str, "s3.us-west-1.amazonaws.com", "S3 endpoint"),
    ],
    generate=_generate_tensorboard,
))
