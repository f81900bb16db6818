"""cloud-endpoints package — Cloud Endpoints DNS for cloud.goog names.

The port's copy of kubeflow_tpu/manifests/endpoints.py, importing nothing of the JAX
package.

Heir of kubeflow/core/cloud-endpoints.libsonnet:1-332.  The reference
registered NAME.endpoints.PROJECT.cloud.goog DNS records by deploying a
metacontroller + a lambda-hook "cloud-endpoints-controller" that synced
a CloudEndpoint CR to the Google Service Management API, pointing the
name at the platform ingress IP.  The capability is re-provided without
the metacontroller indirection: the controller Deployment watches the
CloudEndpoint CRD directly (one controller, one CRD — the same shape as
our TPUJob operator), with the GCP service-account key mounted exactly
as the reference did (cloud-endpoints.libsonnet:295-321).

``iap-ingress`` detects these hostnames (iap.is_cloud_endpoint); this
package is the machinery that makes them resolve.
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry
from kubeflow_tpu_torch.manifests import base

GROUP = "ctl.kubeflow-tpu.org"


def cloud_endpoint(name: str, namespace: str, project: str,
                   target_ingress: str) -> dict:
    """A CloudEndpoint CR: register ``name.endpoints.project.cloud.goog``
    pointing at the IP of ``target_ingress`` (the reference's CR shape,
    cloud-endpoints.libsonnet:193-218)."""
    return {
        "apiVersion": f"{GROUP}/v1",
        "kind": "CloudEndpoint",
        "metadata": base.metadata(name, namespace),
        "spec": {
            "project": project,
            "targetIngress": {
                "name": target_ingress,
                "namespace": namespace,
            },
        },
    }


def _generate_cloud_endpoints(component_name: str, **p: Any) -> List[dict]:
    namespace = p["namespace"]
    labels = {"app": "cloud-endpoints-controller"}

    crd = base.crd("cloudendpoints", GROUP, "CloudEndpoint", ["v1"],
                   short_names=["cloudep", "ce"])
    sa = base.service_account("cloud-endpoints-controller", namespace,
                              labels)
    role = base.cluster_role("cloud-endpoints-controller", rules=[
        {"apiGroups": [GROUP],
         "resources": ["cloudendpoints", "cloudendpoints/status"],
         "verbs": ["*"]},
        # The controller reads Ingress/Service state to learn the IP the
        # endpoint should point at (cloud-endpoints.libsonnet:230-249).
        {"apiGroups": ["networking.k8s.io"],
         "resources": ["ingresses"], "verbs": ["get", "list", "watch"]},
        {"apiGroups": [""],
         "resources": ["services", "events"],
         "verbs": ["get", "list", "watch", "create", "patch"]},
    ], labels=labels)
    binding = base.cluster_role_binding(
        "cloud-endpoints-controller", "cloud-endpoints-controller",
        "cloud-endpoints-controller", namespace, labels)

    volume = {"name": "sa-key",
              "secret": {"secretName": p["secret_name"]}}
    mount = {"name": "sa-key", "mountPath": "/var/run/secrets/sa",
             "readOnly": True}
    controller = base.container(
        "cloud-endpoints-controller", p["controller_image"],
        ports=[8080],
        env={"GOOGLE_APPLICATION_CREDENTIALS":
             "/var/run/secrets/sa/" + p["secret_key"]},
        volume_mounts=[mount],
    )
    deploy = base.deployment(
        name="cloud-endpoints-controller", namespace=namespace,
        labels=labels,
        spec=base.pod_spec([controller], volumes=[volume],
                           service_account="cloud-endpoints-controller"),
    )
    svc = base.service(
        name="cloud-endpoints-controller", namespace=namespace,
        selector=labels, ports=[base.port(80, "http", 8080)],
        labels=labels,
    )

    objs = [crd, sa, role, binding, deploy, svc]
    if p["hostname"]:
        # Convenience: render the CR for the platform hostname itself.
        from kubeflow_tpu_torch.manifests.iap import is_cloud_endpoint

        hostname = p["hostname"]
        if not is_cloud_endpoint(hostname):
            raise ValueError(
                f"{hostname!r} is not a NAME.endpoints.PROJECT.cloud.goog "
                "hostname")
        endpoint_name, rest = hostname.split(".endpoints.", 1)
        project = rest.rsplit(".cloud.goog", 1)[0]
        objs.append(cloud_endpoint(endpoint_name, namespace, project,
                                   p["target_ingress"]))
    return objs


cloud_endpoints_prototype = default_registry.register(Prototype(
    name="cloud-endpoints",
    doc="Cloud Endpoints DNS controller (heir of "
        "kubeflow/core/cloud-endpoints.libsonnet): CloudEndpoint CRD + "
        "controller syncing cloud.goog names to the ingress IP",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        # Third-party controller consumed as an external image, exactly
        # as the reference consumed it (cloud-endpoints.libsonnet used
        # gcr.io/cloud-solutions-group/cloud-endpoints-controller) and
        # as Ambassador/envoy are consumed here.
        param("controller_image", str,
              "gcr.io/cloud-solutions-group/cloud-endpoints-controller:"
              "0.2.1", "controller image (third-party, external)"),
        param("secret_name", str, "cloudep-sa",
              "secret holding the GCP service-account key"),
        param("secret_key", str, "sa-key.json",
              "key within the secret"),
        param("hostname", str, "",
              "optionally also render the CloudEndpoint CR for this "
              "NAME.endpoints.PROJECT.cloud.goog hostname"),
        param("target_ingress", str, "iap-ingress",
              "Ingress whose IP the endpoint should resolve to"),
    ],
    generate=_generate_cloud_endpoints,
))
