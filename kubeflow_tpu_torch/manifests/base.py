"""Kubernetes object builders.

The reference assembles manifests by hand in jsonnet (e.g.
kubeflow/core/tf-job-operator.libsonnet:61-125,
kubeflow/core/ambassador.libsonnet:1-60).
These helpers produce the same API objects as plain dicts with consistent
labeling, so component packages read like the jsonnet did but with typed
params and no string templating.  The port's copy of
kubeflow_tpu/manifests/base.py: the same builders, with the accelerator
block in its GPU form (``gpu_resource_limits``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence


def _clean(obj: Any) -> Any:
    """Recursively drop None values so optional fields disappear from YAML."""
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items() if v is not None}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    return obj


def metadata(name: str, namespace: Optional[str] = None,
             labels: Optional[Dict[str, str]] = None,
             annotations: Optional[Dict[str, str]] = None) -> dict:
    return _clean({
        "name": name,
        "namespace": namespace,
        "labels": labels,
        "annotations": annotations,
    })


def config_map(name: str, namespace: str, data: Dict[str, str],
               labels: Optional[Dict[str, str]] = None) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": metadata(name, namespace, labels),
        "data": data,
    }


def service(name: str, namespace: str, selector: Dict[str, str],
            ports: Sequence[dict],
            service_type: Optional[str] = None,
            headless: bool = False,
            annotations: Optional[Dict[str, str]] = None,
            labels: Optional[Dict[str, str]] = None) -> dict:
    spec: Dict[str, Any] = {
        "selector": selector,
        "ports": list(ports),
    }
    if headless:
        # Headless Service => stable per-pod DNS names; this is the rendezvous
        # trick the reference's openmpi package relies on
        # (kubeflow/openmpi/service.libsonnet:29 `clusterIP: None`).
        spec["clusterIP"] = "None"
    if service_type:
        spec["type"] = service_type
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": metadata(name, namespace, labels, annotations),
        "spec": spec,
    }


def port(port_number: int, name: Optional[str] = None,
         target_port: Optional[int] = None, protocol: str = "TCP") -> dict:
    return _clean({
        "name": name,
        "port": port_number,
        "targetPort": target_port if target_port is not None else port_number,
        "protocol": protocol,
    })


def container(name: str, image: str,
              command: Optional[Sequence[str]] = None,
              args: Optional[Sequence[str]] = None,
              env: Optional[Dict[str, str]] = None,
              ports: Optional[Sequence[int]] = None,
              resources: Optional[dict] = None,
              volume_mounts: Optional[Sequence[dict]] = None,
              working_dir: Optional[str] = None,
              security_context: Optional[dict] = None) -> dict:
    return _clean({
        "name": name,
        "image": image,
        "command": list(command) if command else None,
        "args": list(args) if args else None,
        "env": [{"name": k, "value": str(v)} for k, v in (env or {}).items()] or None,
        "ports": [{"containerPort": p} for p in (ports or [])] or None,
        "resources": resources,
        "volumeMounts": list(volume_mounts) if volume_mounts else None,
        "workingDir": working_dir,
        "securityContext": security_context,
    })


def pod_spec(containers: Sequence[dict],
             init_containers: Optional[Sequence[dict]] = None,
             volumes: Optional[Sequence[dict]] = None,
             service_account: Optional[str] = None,
             restart_policy: Optional[str] = None,
             node_selector: Optional[Dict[str, str]] = None,
             scheduler_name: Optional[str] = None,
             hostname: Optional[str] = None,
             subdomain: Optional[str] = None,
             tolerations: Optional[Sequence[dict]] = None) -> dict:
    return _clean({
        "containers": list(containers),
        "initContainers": list(init_containers) if init_containers else None,
        "volumes": list(volumes) if volumes else None,
        "serviceAccountName": service_account,
        "restartPolicy": restart_policy,
        "nodeSelector": node_selector,
        "schedulerName": scheduler_name,
        "hostname": hostname,
        "subdomain": subdomain,
        "tolerations": list(tolerations) if tolerations else None,
    })


def deployment(name: str, namespace: str, labels: Dict[str, str],
               spec: dict, replicas: int = 1,
               annotations: Optional[Dict[str, str]] = None,
               template_labels: Optional[Dict[str, str]] = None) -> dict:
    """`template_labels` extend `labels` on the pod template only — the
    selector stays at `labels`, which is immutable once applied, so
    rollout-varying labels (e.g. Istio `version`) must go here."""
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": metadata(name, namespace, labels, annotations),
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": template_labels or labels},
                "spec": spec,
            },
        },
    }


def stateful_set(name: str, namespace: str, labels: Dict[str, str],
                 spec: dict, service_name: str, replicas: int = 1) -> dict:
    return {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": metadata(name, namespace, labels),
        "spec": {
            "replicas": replicas,
            "serviceName": service_name,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": spec,
            },
        },
    }


def pod(name: str, namespace: str, labels: Dict[str, str], spec: dict,
        annotations: Optional[Dict[str, str]] = None) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": metadata(name, namespace, labels, annotations),
        "spec": spec,
    }


def crd(plural: str, group: str, kind: str,
        versions: Sequence[str], scope: str = "Namespaced",
        short_names: Optional[Sequence[str]] = None) -> dict:
    return _clean({
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "scope": scope,
            "names": {
                "kind": kind,
                "plural": plural,
                "singular": kind.lower(),
                "shortNames": list(short_names) if short_names else None,
            },
            "versions": [
                {
                    "name": v,
                    "served": True,
                    "storage": i == 0,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "x-kubernetes-preserve-unknown-fields": True,
                        }
                    },
                }
                for i, v in enumerate(versions)
            ],
        },
    })


def service_account(name: str, namespace: str,
                    labels: Optional[Dict[str, str]] = None) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": metadata(name, namespace, labels),
    }


def cluster_role(name: str, rules: Sequence[dict],
                 labels: Optional[Dict[str, str]] = None) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": _clean({"name": name, "labels": labels}),
        "rules": list(rules),
    }


def cluster_role_binding(name: str, role: str, sa_name: str,
                         sa_namespace: str,
                         labels: Optional[Dict[str, str]] = None) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": _clean({"name": name, "labels": labels}),
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": role,
        },
        "subjects": [{
            "kind": "ServiceAccount",
            "name": sa_name,
            "namespace": sa_namespace,
        }],
    }


def ambassador_route(service_name: str, prefix: str, target_service: str,
                     target_port: int, rewrite: str = "/",
                     timeout_ms: Optional[int] = None) -> str:
    """Ambassador route annotation for a Service.

    Same gateway pattern as the reference (route annotations on Services,
    kubeflow/core/tf-job-operator.libsonnet:378-389,
    kubeflow/tf-serving/tf-serving.libsonnet:247-267).
    """
    mapping = {
        "apiVersion": "ambassador/v0",
        "kind": "Mapping",
        "name": f"{service_name}_mapping",
        "prefix": prefix,
        "rewrite": rewrite,
        "service": f"{target_service}:{target_port}",
    }
    if timeout_ms is not None:
        mapping["timeout_ms"] = timeout_ms
    return "---\n" + json.dumps(mapping, indent=2)


def gpu_resource_limits(slice_type: str, gpus: Optional[int] = None) -> dict:
    """GPU resource block: the ``nvidia.com/gpu`` limit of one worker pod
    of the gang shape ``slice_type`` (the JAX package's
    ``tpu_resource_limits`` asks for ``google.com/tpu`` instead).

    ``gpus`` defaults to the shape's GPUs a host; an explicit value is
    validated against the topology so a wrong request fails at render time
    instead of leaving the gang unschedulable.
    """
    from kubeflow_tpu_torch.runtime.topology import parse_slice_type

    topo = parse_slice_type(slice_type)
    if gpus is None:
        gpus = topo.chips_per_host
    elif gpus != topo.chips_per_host:
        raise ValueError(
            f"{slice_type} gangs expose {topo.chips_per_host} GPUs per host, "
            f"requested {gpus}"
        )
    return {"limits": {"nvidia.com/gpu": gpus}}


def to_yaml(objects: Sequence[dict]) -> str:
    """Render a manifest list to a multi-doc YAML string.

    Uses PyYAML when present; falls back to JSON documents (valid YAML).
    """
    try:
        import yaml  # type: ignore

        return "---\n".join(
            yaml.safe_dump(obj, sort_keys=False) for obj in objects
        )
    except ImportError:  # pragma: no cover
        return "---\n".join(json.dumps(obj, indent=2) + "\n" for obj in objects)
