"""tpu-serving manifest package — heir of kubeflow/tf-serving.

Re-provides the reference package's full parameter surface
(kubeflow/tf-serving/tf-serving.libsonnet): model server Deployment +
Service with the same two-protocol split — gRPC PredictionService :9000
(:118-132, the reference's primary protocol) and REST :8000 (:176-207)
— Ambassador route annotations (:247-267), the storage
credential mixins — GCS service-account secret mount (:342-382), S3 env
plumbing (:310-339), NFS PVC mount (:151-155) — and the optional Istio
mesh integration (sidecar inject + versioned routing, the capability of
the v1alpha2 RouteRule at tf-serving.libsonnet:287-305, re-provided on
the modern VirtualService/DestinationRule API).  The C++
tensorflow_model_server + proxy sidecar pair is replaced by the single
first-party serving container.  The port's copy of
kubeflow_tpu/manifests/serving.py: the same prototypes and params; the
server image runs ``python -m kubeflow_tpu_torch.serving.main`` on a GPU
of the gang shape ``slice_type`` names (``nvidia.com/gpu``), and the
router runs ``python -m kubeflow_tpu_torch.fleet.main``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry
from kubeflow_tpu_torch.manifests import base

SERVE_PORT = 8000
GRPC_PORT = 9000  # same port the reference's model server bound


def s3_env(params: Dict[str, Any]) -> List[dict]:
    """The reference's 7-variable S3 contract (tf-serving.libsonnet:310-339)."""
    secret = params["s3_secret_name"]
    env = [
        {"name": "AWS_ACCESS_KEY_ID", "valueFrom": {"secretKeyRef": {
            "name": secret, "key": params["s3_secret_accesskeyid_key_name"]}}},
        {"name": "AWS_SECRET_ACCESS_KEY", "valueFrom": {"secretKeyRef": {
            "name": secret,
            "key": params["s3_secret_secretaccesskey_key_name"]}}},
        {"name": "AWS_REGION", "value": params["s3_aws_region"]},
        {"name": "S3_USE_HTTPS", "value": str(params["s3_use_https"])},
        {"name": "S3_VERIFY_SSL", "value": str(params["s3_verify_ssl"])},
        {"name": "S3_ENDPOINT", "value": params["s3_endpoint"]},
    ]
    return env


def gcp_volume_mixin(secret_name: str, mount_path: str = "/secret/gcp-credentials"):
    volume = {"name": "gcp-credentials",
              "secret": {"secretName": secret_name}}
    mount = {"name": "gcp-credentials", "mountPath": mount_path,
             "readOnly": True}
    env = [{"name": "GOOGLE_APPLICATION_CREDENTIALS",
            "value": f"{mount_path}/key.json"}]
    return volume, mount, env


def istio_routing(name: str, namespace: str, version: str,
                  labels: Dict[str, str]) -> List[dict]:
    """Istio versioned-routing pair for a serving Service.

    Capability heir of the reference's RouteRule
    (kubeflow/tf-serving/tf-serving.libsonnet:287-305: route all traffic
    for the service to the pods labelled with ``version``), expressed on
    the post-v1alpha2 API surface: a DestinationRule declaring the
    version subset and a VirtualService pinning the default route to it.
    Canary rollout = generate a second subset and shift route weights.
    """
    destination_rule = {
        "apiVersion": "networking.istio.io/v1beta1",
        "kind": "DestinationRule",
        "metadata": base.metadata(name, namespace, labels),
        "spec": {
            "host": name,
            "subsets": [
                {"name": version, "labels": {"version": version}},
            ],
        },
    }
    virtual_service = {
        "apiVersion": "networking.istio.io/v1beta1",
        "kind": "VirtualService",
        "metadata": base.metadata(f"{name}-default", namespace, labels),
        "spec": {
            "hosts": [name],
            "http": [{
                "route": [{
                    "destination": {"host": name, "subset": version},
                    "weight": 100,
                }],
            }],
        },
    }
    return [destination_rule, virtual_service]


def _generate_serving(component_name: str, **p: Any) -> List[dict]:
    namespace = p["namespace"]
    name = component_name
    labels = {"app": name, "kubeflow-tpu.org/component": "model-server"}
    # Pods carry the version label the DestinationRule subset selects on;
    # the Service selector stays version-free so it spans every subset
    # (the reference's split at tf-serving.libsonnet:170 vs :282).
    pod_labels = (dict(labels, version=p["istio_version"])
                  if p["istio_enable"] else labels)

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
    elif p["storage_type"] == "nfs":
        volumes.append({"name": "nfs", "persistentVolumeClaim":
                        {"claimName": p["nfs_pvc"]}})
        mounts.append({"name": "nfs", "mountPath": "/mnt"})

    serving_container = {
        "name": name,
        "image": p["model_server_image"],
        "args": [
            f"--model_name={p['model_name']}",
            f"--model_base_path={p['model_base_path']}",
            f"--port={SERVE_PORT}",
            f"--grpc_port={GRPC_PORT}",
        ],
        "ports": [
            {"containerPort": SERVE_PORT, "name": "http"},
            {"containerPort": GRPC_PORT, "name": "grpc"},
        ],
        "env": env,  # may contain valueFrom secretKeyRef entries
        "resources": {
            "limits": base.gpu_resource_limits(p["slice_type"])["limits"]
            if p["slice_type"] else {"cpu": "4", "memory": "4Gi"},
            "requests": {"cpu": "1", "memory": "1Gi"},
        },
        "volumeMounts": mounts,
    }
    if not mounts:
        serving_container.pop("volumeMounts")
    if not env:
        serving_container.pop("env")
    deploy = base.deployment(
        name=name, namespace=namespace, labels=labels,
        replicas=p["replicas"],
        spec=base.pod_spec([serving_container], volumes=volumes),
        template_labels=pod_labels if p["istio_enable"] else None,
    )
    if p["slice_type"]:
        from kubeflow_tpu_torch.runtime.topology import parse_slice_type

        deploy["spec"]["template"]["spec"]["nodeSelector"] = \
            parse_slice_type(p["slice_type"]).k8s_node_selector()
    # The REST port doubles as the Prometheus endpoint (serving/http.py
    # /metrics); standard scrape annotations on BOTH the Service and the
    # pod template so either Prometheus discovery mode (kubernetes-
    # service-endpoints or kubernetes-pods) finds it without config.
    scrape = {
        "prometheus.io/scrape": "true",
        "prometheus.io/port": str(SERVE_PORT),
        "prometheus.io/path": "/metrics",
    }
    template_annotations = dict(scrape)
    if p["istio_enable"]:
        # Sidecar injection is requested per-pod, exactly as the reference
        # did (examples/prototypes/tf-serving-with-istio.jsonnet:106).
        template_annotations["sidecar.istio.io/inject"] = "true"
    deploy["spec"]["template"]["metadata"]["annotations"] = \
        template_annotations

    annotations = dict(scrape)
    if p["ambassador_route"]:
        # Same prefix scheme as the reference proxy route
        # (tf-serving.libsonnet:247-267): /models/NAME/ -> service:8000.
        annotations["getambassador.io/config"] = base.ambassador_route(
            name, f"/models/{p['model_name']}/", name, SERVE_PORT,
        )
    svc = base.service(
        name=name, namespace=namespace, selector=labels,
        ports=[base.port(SERVE_PORT, "http"),
               base.port(GRPC_PORT, "grpc")],
        annotations=annotations,
        labels=labels,
    )
    objs = [deploy, svc]
    if p["istio_enable"]:
        objs.extend(istio_routing(name, namespace, p["istio_version"],
                                  labels))
    return objs


ROUTER_PORT = 8080


def _generate_fleet(component_name: str, **p: Any) -> List[dict]:
    """Fleet router Deployment + Service in front of a tpu-serving
    component: kube pod discovery by the serving component's labels,
    power-of-two-choices routing, and (optionally) the metrics-driven
    autoscaler patching the serving Deployment's replica count
    (fleet/main.py)."""
    namespace = p["namespace"]
    name = component_name
    labels = {"app": name, "kubeflow-tpu.org/component": "fleet-router"}
    args = [
        f"--port={ROUTER_PORT}",
        f"--kube_namespace={namespace}",
        f"--kube_selector=app={p['serving_name']}",
        f"--replica_port={SERVE_PORT}",
        f"--max_tries={p['max_tries']}",
        f"--probe_interval_s={p['probe_interval_s']}",
    ]
    if p["autoscale"]:
        args += [
            f"--autoscale_deployment={p['serving_name']}",
            f"--autoscale_target_inflight={p['target_inflight']}",
            f"--min_replicas={p['min_replicas']}",
            f"--max_replicas={p['max_replicas']}",
        ]
    container = {
        "name": name,
        "image": p["router_image"],
        "command": ["python", "-m", "kubeflow_tpu_torch.fleet.main"],
        "args": args,
        "ports": [{"containerPort": ROUTER_PORT, "name": "http"}],
        "readinessProbe": {
            "httpGet": {"path": "/readyz", "port": ROUTER_PORT}},
        "livenessProbe": {
            "httpGet": {"path": "/healthz", "port": ROUTER_PORT}},
        "resources": {"limits": {"cpu": "2", "memory": "1Gi"},
                      "requests": {"cpu": "250m", "memory": "256Mi"}},
    }
    deploy = base.deployment(
        name=name, namespace=namespace, labels=labels,
        replicas=p["replicas"],
        spec=base.pod_spec([container]),
    )
    scrape = {
        "prometheus.io/scrape": "true",
        "prometheus.io/port": str(ROUTER_PORT),
        "prometheus.io/path": "/metrics",
    }
    deploy["spec"]["template"]["metadata"]["annotations"] = dict(scrape)
    svc = base.service(
        name=name, namespace=namespace, selector=labels,
        ports=[base.port(ROUTER_PORT, "http")],
        annotations=dict(scrape), labels=labels,
    )
    return [deploy, svc]


fleet_prototype = default_registry.register(Prototype(
    name="tpu-serving-fleet",
    doc="Fleet control plane for tpu-serving: load-aware router "
        "(P2C on scraped in-flight, retries, ejection, drain "
        "awareness) + metrics-driven replica autoscaler",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("serving_name", str, "tpu-serving",
              "the tpu-serving component to front (pod label app= "
              "selector AND the Deployment the autoscaler patches)"),
        param("router_image", str,
              "ghcr.io/kubeflow-tpu-torch/model-server:latest",
              "router container image (same image as the server; the "
              "entrypoint differs)"),
        param("replicas", int, 2, "router replicas"),
        param("max_tries", int, 3,
              "distinct replicas one request may be offered to"),
        param("probe_interval_s", float, 1.0,
              "readiness-probe/load-scrape period"),
        param("autoscale", bool, True,
              "run the replica autoscaler inside the router"),
        param("target_inflight", float, 4.0,
              "per-replica in-flight target the desired count is "
              "computed from — float-typed so a bad value fails at "
              "generation, not as a crash-looping router pod"),
        param("min_replicas", int, 1, "autoscaler floor"),
        param("max_replicas", int, 8, "autoscaler ceiling"),
    ],
    generate=_generate_fleet,
))


serving_prototype = default_registry.register(Prototype(
    name="tpu-serving",
    doc="GPU model server (heir of kubeflow/tf-serving): versioned "
                "model loading, REST predict/classify/metadata contract",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("model_name", str, "model", "served model name"),
        param("model_base_path", str, "/models/model",
              "versioned model directory (gs://, s3://, or mounted path)"),
        param("model_server_image", str,
              "ghcr.io/kubeflow-tpu-torch/model-server:latest",
              "serving container image"),
        param("replicas", int, 1, "server replicas"),
        param("slice_type", str, "",
              "GPU gang shape for inference, e.g. h100-1 ('' = CPU "
              "serving)"),
        param("ambassador_route", bool, True,
              "annotate Service with an Ambassador route"),
        param("storage_type", str, "",
              "credential mixin: '', 'gcp', 's3', or 'nfs'"),
        param("gcp_secret_name", str, "user-gcp-sa",
              "GCP SA key secret (GOOGLE_APPLICATION_CREDENTIALS mount)"),
        param("s3_secret_name", str, "s3-credentials", "S3 secret name"),
        param("s3_secret_accesskeyid_key_name", str, "accessKeyID",
              "key within the S3 secret"),
        param("s3_secret_secretaccesskey_key_name", str, "secretAccessKey",
              "key within the S3 secret"),
        param("s3_aws_region", str, "us-west-1", "AWS region"),
        param("s3_use_https", str, "true", "S3 over TLS"),
        param("s3_verify_ssl", str, "true", "verify S3 TLS certs"),
        param("s3_endpoint", str, "s3.us-west-1.amazonaws.com",
              "S3 endpoint"),
        param("nfs_pvc", str, "nfs-external", "NFS PVC to mount at /mnt"),
        param("istio_enable", bool, False,
              "join the Istio mesh: sidecar inject + versioned "
              "VirtualService/DestinationRule routing"),
        param("istio_version", str, "v1",
              "version label the Istio route subset selects on"),
    ],
    generate=_generate_serving,
))
