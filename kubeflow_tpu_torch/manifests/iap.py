"""GCP ingress + IAP auth — heir of kubeflow/core/iap.libsonnet (the
hand-rolled envoy JWT fleet; sibling packages: ``certs`` re-provides
cert-manager.libsonnet, ``endpoints`` re-provides
cloud-endpoints.libsonnet).

The port's copy of kubeflow_tpu/manifests/iap.py, importing nothing of the JAX
package.

The capability re-provided: expose the platform behind Google
Identity-Aware Proxy on a managed TLS hostname.  The mechanism is
modernised: where the reference deployed an envoy sidecar fleet doing its
own JWT verification (iap.libsonnet:106-159,395), GKE now does IAP
natively via BackendConfig, certificates via ManagedCertificate, and DNS
via the same NAME.endpoints.PROJECT.cloud.goog convention
(cloud-endpoints detection at iap.libsonnet:5-10) — config, not daemons.
The whoami echo app used to smoke-test auth (iap.libsonnet whoami-app)
is kept.
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry
from kubeflow_tpu_torch.manifests import base


def is_cloud_endpoint(hostname: str) -> bool:
    """NAME.endpoints.PROJECT.cloud.goog detection (iap.libsonnet:5-10)."""
    return hostname.endswith(".cloud.goog") and ".endpoints." in hostname


def _generate_iap(component_name: str, **p: Any) -> List[dict]:
    namespace = p["namespace"]
    hostname = p["hostname"]
    labels = {"app": component_name}

    backend_config = {
        "apiVersion": "cloud.google.com/v1",
        "kind": "BackendConfig",
        "metadata": base.metadata("iap-config", namespace, labels),
        "spec": {
            "iap": {
                "enabled": True,
                "oauthclientCredentials": {
                    "secretName": p["oauth_secret_name"],
                },
            },
        },
    }
    if p["tls_type"] == "cert-manager":
        # Non-GKE path: a cert-manager Certificate (heir of
        # cert-manager.libsonnet's Let's-Encrypt flow; deploy the
        # `cert-manager` prototype alongside this one).
        from kubeflow_tpu_torch.manifests import certs

        certificate = certs.certificate("platform-cert", namespace,
                                        hostname)
    elif p["tls_type"] == "gke":
        certificate = {
            "apiVersion": "networking.gke.io/v1",
            "kind": "ManagedCertificate",
            "metadata": base.metadata("platform-cert", namespace, labels),
            "spec": {"domains": [hostname]},
        }
    else:
        raise ValueError(
            f"tls_type must be 'gke' or 'cert-manager', got {p['tls_type']!r}")
    # Ambassador fronts everything (same gateway as the reference); the
    # ingress targets it and carries the IAP BackendConfig.
    gateway_svc = base.service(
        name=f"{component_name}-gateway", namespace=namespace,
        selector={"service": p["gateway_selector"]},
        ports=[base.port(80, "http", 8080)],
        service_type="NodePort",
        annotations={
            "cloud.google.com/backend-config":
                '{"default": "iap-config"}',
        },
        labels=labels,
    )
    if p["tls_type"] == "gke":
        ingress_annotations = {
            "kubernetes.io/ingress.global-static-ip-name":
                p["static_ip_name"],
            "networking.gke.io/managed-certificates": "platform-cert",
        }
    else:
        # No cert-manager.io/issuer annotation here: the explicit
        # Certificate below owns platform-cert-tls; the annotation would
        # make ingress-shim mint a SECOND Certificate for the same
        # secret (renewal churn + duplicate ACME orders).
        ingress_annotations = None
    ingress = {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "Ingress",
        "metadata": base.metadata(component_name, namespace, labels,
                                  ingress_annotations),
        "spec": {
            "rules": [{
                "host": hostname,
                "http": {"paths": [{
                    "path": "/*",
                    "pathType": "ImplementationSpecific",
                    "backend": {"service": {
                        "name": f"{component_name}-gateway",
                        "port": {"number": 80},
                    }},
                }]},
            }],
        },
    }
    if p["tls_type"] == "cert-manager":
        # The Certificate writes platform-cert-tls; the Ingress serves it.
        ingress["spec"]["tls"] = [
            {"hosts": [hostname], "secretName": "platform-cert-tls"},
        ]
    whoami = base.deployment(
        name="whoami-app", namespace=namespace,
        labels={"app": "whoami"},
        spec=base.pod_spec([base.container(
            "whoami", p["whoami_image"], ports=[8081],
            env={"PORT": "8081"},
        )]),
    )
    whoami_svc = base.service(
        name="whoami-app", namespace=namespace,
        selector={"app": "whoami"},
        ports=[base.port(80, "http", 8081)],
        annotations={"getambassador.io/config": base.ambassador_route(
            "whoami-app", "/whoami/", "whoami-app", 80)},
        labels={"app": "whoami"},
    )
    return [backend_config, certificate, gateway_svc, ingress,
            whoami, whoami_svc]


iap_prototype = default_registry.register(Prototype(
    name="iap-ingress",
    doc="GCE Ingress + Identity-Aware Proxy + managed TLS "
                "(heir of kubeflow/core/iap.libsonnet + "
                "cloud-endpoints + cert-manager)",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("hostname", str, "kubeflow.endpoints.myproject.cloud.goog",
              "external hostname (NAME.endpoints.PROJECT.cloud.goog "
              "for Cloud Endpoints DNS)"),
        param("oauth_secret_name", str, "iap-oauth-client",
              "secret holding the OAuth client id/secret for IAP"),
        param("static_ip_name", str, "kubeflow-ip",
              "name of the reserved global static IP"),
        param("gateway_selector", str, "ambassador",
              "label of the gateway Deployment to expose"),
        param("tls_type", str, "gke",
              "certificate machinery: 'gke' (ManagedCertificate) or "
              "'cert-manager' (Let's Encrypt via the cert-manager "
              "prototype on any cluster)"),
        param("whoami_image", str,
              "gcr.io/cloud-solutions-group/esp-sample-app:1.0.0",
              "identity echo app for auth smoke tests"),
    ],
    generate=_generate_iap,
))
