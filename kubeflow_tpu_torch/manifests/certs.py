"""cert-manager package — Let's Encrypt TLS independent of GKE.

The port's copy of kubeflow_tpu/manifests/certs.py, importing nothing of the JAX
package.

Heir of kubeflow/core/cert-manager.libsonnet:1-182: the reference
deployed the cert-manager controller (+ ingress-shim sidecar), its three
CRDs, RBAC, and a production Let's Encrypt ACME Issuer so any cluster —
not just GKE with ManagedCertificate — could terminate TLS.  The same
capability is re-provided on the modern ``cert-manager.io/v1`` API:
CRDs for Certificate/Issuer/ClusterIssuer, controller Deployment (the
ingress-shim merged upstream long ago, so one container), RBAC, an ACME
HTTP-01 issuer, and a Certificate for the platform hostname that
``iap-ingress`` consumes when ``tls_type=cert-manager``.
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry
from kubeflow_tpu_torch.manifests import base

GROUP = "cert-manager.io"
ACME_PROD = "https://acme-v02.api.letsencrypt.org/directory"


def certificate(name: str, namespace: str, hostname: str,
                issuer: str = "letsencrypt-prod",
                issuer_kind: str = "Issuer") -> dict:
    """A cert-manager Certificate for one hostname; the secret it writes
    is what the Ingress TLS block references (the capability the GKE
    ManagedCertificate provides on GKE-only clusters)."""
    return {
        "apiVersion": f"{GROUP}/v1",
        "kind": "Certificate",
        "metadata": base.metadata(name, namespace),
        "spec": {
            "secretName": f"{name}-tls",
            "dnsNames": [hostname],
            "issuerRef": {"name": issuer, "kind": issuer_kind},
        },
    }


def _generate_cert_manager(component_name: str, **p: Any) -> List[dict]:
    namespace = p["namespace"]
    labels = {"app": "cert-manager"}

    crds = [
        base.crd(plural, GROUP, kind, ["v1"], scope=scope)
        for plural, kind, scope in (
            ("certificates", "Certificate", "Namespaced"),
            ("issuers", "Issuer", "Namespaced"),
            ("clusterissuers", "ClusterIssuer", "Cluster"),
        )
    ]
    sa = base.service_account("cert-manager", namespace, labels)
    role = base.cluster_role("cert-manager", rules=[
        {"apiGroups": [GROUP],
         "resources": ["certificates", "certificates/status", "issuers",
                       "issuers/status", "clusterissuers",
                       "clusterissuers/status"],
         "verbs": ["*"]},
        # ACME HTTP-01 solving needs secrets (keys), events, services and
        # ingresses (challenge routing) — same surface the reference
        # granted (cert-manager.libsonnet:80-102).
        {"apiGroups": [""],
         "resources": ["secrets", "events", "endpoints", "services",
                       "pods"],
         "verbs": ["*"]},
        {"apiGroups": ["networking.k8s.io"],
         "resources": ["ingresses"],
         "verbs": ["*"]},
    ], labels=labels)
    binding = base.cluster_role_binding(
        "cert-manager", "cert-manager", "cert-manager", namespace, labels)
    deploy = base.deployment(
        name="cert-manager", namespace=namespace, labels=labels,
        spec=base.pod_spec(
            [base.container("cert-manager", p["controller_image"])],
            service_account="cert-manager",
        ),
    )
    issuer = {
        "apiVersion": f"{GROUP}/v1",
        "kind": "Issuer",
        "metadata": base.metadata("letsencrypt-prod", namespace, labels),
        "spec": {
            "acme": {
                "server": p["acme_url"],
                "email": p["acme_email"],
                "privateKeySecretRef": {"name": "letsencrypt-prod-secret"},
                # HTTP-01 through the platform ingress — heir of the
                # required-empty http01 block the reference preserved
                # (cert-manager.libsonnet issuerLEProd note at :7).
                "solvers": [{"http01": {"ingress": {}}}],
            },
        },
    }
    return crds + [sa, role, binding, deploy, issuer]


cert_manager_prototype = default_registry.register(Prototype(
    name="cert-manager",
    doc="Let's Encrypt TLS on any cluster (heir of "
        "kubeflow/core/cert-manager.libsonnet): controller + CRDs + "
        "RBAC + ACME HTTP-01 Issuer",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("acme_email", str, "admin@example.com",
              "ACME registration email"),
        param("acme_url", str, ACME_PROD, "ACME directory URL"),
        param("controller_image", str,
              "quay.io/jetstack/cert-manager-controller:v1.14.4",
              "cert-manager controller image"),
    ],
    generate=_generate_cert_manager,
))
