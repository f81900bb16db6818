"""One-shot platform installer — heir of the reference's Go bootstrapper.

The port's copy of kubeflow_tpu/tools/bootstrap.py, rendering through the
port's prototype registry (``kubeflow_tpu_torch.manifests``).

The reference's bootstrap (bootstrap/cmd/bootstrap/app/server.go) loaded a
YAML BootConfig of {registries, packages, components, parameters}
(bootstrap/config/default.yaml:1-21), detected the cluster flavour (GKE
regex at server.go:208-213, default StorageClass :215-238), created the
namespace + admin binding (:377-396), drove the ksonnet API, and applied
via `ks show default | kubectl apply -f -` (:514-533).

This module is the same capability over the typed prototype registry:

    bootstrap:
      namespace: kubeflow
      platform: auto            # auto | gke | generic | none
      components:
        - prototype: kubeflow-core
          name: core
          params: {cloud: gke}
        - prototype: tpujob-operator
          name: operator

`python -m kubeflow_tpu_torch.tools.cli bootstrap --config cfg.yaml
[--apply]` renders everything;
--apply pipes to kubectl (plus namespace creation), mirroring the
reference's flags (--config/--apply, options.go:42-55).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import kubeflow_tpu_torch.manifests  # noqa: F401 — registers prototypes
from kubeflow_tpu_torch.config.registry import App
from kubeflow_tpu_torch.manifests.base import to_yaml

# GKE master version strings look like 1.29.1-gke.1589000
# (same discriminator idea as server.go:208-213).
GKE_VERSION_RE = re.compile(r"gke")

DEFAULT_COMPONENTS = [
    {"prototype": "kubeflow-core", "name": "core", "params": {}},
    {"prototype": "tpujob-operator", "name": "operator", "params": {}},
    {"prototype": "jupyterhub", "name": "hub", "params": {}},
]


@dataclasses.dataclass
class BootConfig:
    namespace: str = "kubeflow"
    platform: str = "auto"
    components: List[Dict[str, Any]] = dataclasses.field(
        default_factory=lambda: [dict(c) for c in DEFAULT_COMPONENTS])

    @classmethod
    def load(cls, path: str | Path) -> "BootConfig":
        import yaml

        raw = yaml.safe_load(Path(path).read_text()) or {}
        section = raw.get("bootstrap", raw)
        cfg = cls(
            namespace=section.get("namespace", "kubeflow"),
            platform=section.get("platform", "auto"),
        )
        if "components" in section:
            cfg.components = []
            for comp in section["components"]:
                cfg.components.append({
                    "prototype": comp["prototype"],
                    "name": comp.get("name", comp["prototype"]),
                    "params": comp.get("params", {}) or {},
                })
        return cfg


def detect_platform() -> str:
    """gke | generic | none — from `kubectl version` (heir of the GKE
    regex detection at server.go:208-213)."""
    try:
        out = subprocess.run(
            ["kubectl", "version", "-o", "json"],
            capture_output=True, text=True, timeout=20,
        )
        if out.returncode != 0:
            return "none"
        info = json.loads(out.stdout or "{}")
        server = info.get("serverVersion", {}).get("gitVersion", "")
        return "gke" if GKE_VERSION_RE.search(server) else "generic"
    except Exception:
        return "none"


def render(cfg: BootConfig) -> List[dict]:
    """Namespace + every configured component, platform params injected."""
    platform = cfg.platform
    if platform == "auto":
        platform = detect_platform()
    objects: List[dict] = [{
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": cfg.namespace},
    }]
    app = App(namespace=cfg.namespace)
    for comp in cfg.components:
        params = dict(comp["params"])
        proto = comp["prototype"]
        # Platform-conditional params, the cloud= switch the reference's
        # core prototype took (kubeflow/core/prototypes/all.jsonnet:4-20).
        if proto == "kubeflow-core" and platform in ("gke",) \
                and "cloud" not in params:
            params["cloud"] = platform
        app.add(proto, comp["name"], **params)
    objects.extend(app.render())
    if platform == "gke":
        # GKE admin binding so the operator SA can manage CRs
        # (heir of createClusterAdminRoleBinding, server.go:377-396).
        objects.append({
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": "kubeflow-tpu-cluster-admin"},
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole", "name": "cluster-admin"},
            "subjects": [{"kind": "ServiceAccount",
                          "name": "tpujob-operator",
                          "namespace": cfg.namespace}],
        })
    return objects


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-torch-bootstrap")
    ap.add_argument("--config", help="BootConfig YAML (default config "
                                     "deploys core+operator+hub)")
    ap.add_argument("--apply", action="store_true",
                    help="kubectl-apply the rendered manifests")
    ap.add_argument("--namespace", default=None,
                    help="override the config namespace")
    args = ap.parse_args(argv)

    cfg = BootConfig.load(args.config) if args.config else BootConfig()
    if args.namespace:
        cfg.namespace = args.namespace
    manifest = to_yaml(render(cfg))
    if not args.apply:
        sys.stdout.write(manifest)
        return 0
    proc = subprocess.run(["kubectl", "apply", "-f", "-"],
                          input=manifest.encode())
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
