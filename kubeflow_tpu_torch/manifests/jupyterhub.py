"""JupyterHub notebook environment with a GPU-aware spawner.

Heir of kubeflow/core/jupyterhub.libsonnet (StatefulSet :141-210, services
:115-138, ConfigMap assembly :13-72) and kubeflow/core/kubeform_spawner.py.
The reference built the spawner config by string-appending jsonnet blocks to
a base python file (verified line-by-line in
kubeflow/core/tests/jupyterhub_test.jsonnet:24-60); here the config is
rendered from typed options — the authenticator and storage blocks are
functions, not appended strings — and the spawner form offers
`nvidia.com/gpu` extra resources, as the reference's did
(kubeform_spawner.py:36).  The port's copy of
kubeflow_tpu/manifests/jupyterhub.py, whose form asks for
`google.com/tpu`; the spawner keeps that module's class and field names
(`TPUFormSpawner`, `tpu_resources`), so both render one config but for
the resource name and the images.
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config import Prototype, default_registry, param
from kubeflow_tpu_torch.manifests import base

DEFAULT_HUB_IMAGE = "ghcr.io/kubeflow-tpu-torch/jupyterhub:latest"
DEFAULT_NOTEBOOK_IMAGE = "ghcr.io/kubeflow-tpu-torch/notebook:latest"

SPAWNER_FORM = """\
<label for='image'>Image</label>
<input name='image' placeholder='repo/image:tag' value='{default_image}'></input>
<label for='cpu_guarantee'>CPU</label>
<input name='cpu_guarantee' placeholder='200m, 1.0, 2.5, etc'></input>
<label for='mem_guarantee'>Memory</label>
<input name='mem_guarantee' placeholder='100Mi, 1.5Gi'></input>
<label for='tpu_resources'>Extra Resource Limits</label>
<input name='tpu_resources' placeholder='{{"nvidia.com/gpu": 8}}'></input>
"""


def spawner_config(authenticator: str, notebook_image: str,
                   storage_class: str = "", notebook_pvc_mount: str = "") -> str:
    """Render jupyterhub_config.py for the hub ConfigMap.

    Capability parity with kubeform_spawner.py:8-133 — form-driven
    image/cpu/mem/extra-resource spawn options and a PVC per user
    (claim-{username}) — generated structurally rather than by appending
    strings to a base file.
    """
    lines = [
        "import json",
        "from kubespawner.spawner import KubeSpawner",
        "",
        "class TPUFormSpawner(KubeSpawner):",
        "    def _options_form_default(self):",
        f"        return '''{SPAWNER_FORM.format(default_image=notebook_image)}'''",
        "",
        "    def options_from_form(self, formdata):",
        "        options = {}",
        "        options['image'] = formdata.get('image', [''])[0].strip()",
        "        options['cpu_guarantee'] = "
        "formdata.get('cpu_guarantee', [''])[0].strip()",
        "        options['mem_guarantee'] = "
        "formdata.get('mem_guarantee', [''])[0].strip()",
        "        options['tpu_resources'] = "
        "formdata.get('tpu_resources', [''])[0].strip()",
        "        return options",
        "",
        "    @property",
        "    def singleuser_image_spec(self):",
        f"        return self.user_options.get('image') or '{notebook_image}'",
        "",
        "    @property",
        "    def singleuser_extra_resource_limits(self):",
        "        raw = self.user_options.get('tpu_resources')",
        "        return json.loads(raw) if raw else {}",
        "",
        "c.JupyterHub.spawner_class = TPUFormSpawner",
        "c.KubeSpawner.singleuser_start_timeout = 60 * 30",
        "c.KubeSpawner.http_timeout = 60 * 5",
    ]
    if notebook_pvc_mount:
        lines += [
            "c.KubeSpawner.user_storage_pvc_ensure = True",
            "c.KubeSpawner.pvc_name_template = 'claim-{username}{servername}'",
            f"c.KubeSpawner.user_storage_capacity = '10Gi'",
            f"c.KubeSpawner.volumes = [{{'name': 'volume-{{username}}{{servername}}',"
            f" 'persistentVolumeClaim': {{'claimName': "
            f"'claim-{{username}}{{servername}}'}}}}]",
            f"c.KubeSpawner.volume_mounts = [{{'mountPath': '{notebook_pvc_mount}',"
            f" 'name': 'volume-{{username}}{{servername}}'}}]",
        ]
    if storage_class:
        lines.append(f"c.KubeSpawner.user_storage_class = '{storage_class}'")
    if authenticator == "iap":
        # IAP passes identity via trusted header, like the reference's
        # remote-user authenticator branch (jupyterhub.libsonnet:27-31).
        lines += [
            "c.JupyterHub.authenticator_class = "
            "'jhub_remote_user_authenticator.remote_user_auth.RemoteUserAuthenticator'",
            "c.RemoteUserAuthenticator.header_name = "
            "'x-goog-authenticated-user-email'",
        ]
    else:
        lines += [
            "c.JupyterHub.authenticator_class = "
            "'dummyauthenticator.DummyAuthenticator'",
        ]
    return "\n".join(lines) + "\n"


def hub_manifests(name: str, namespace: str, hub_image: str,
                  notebook_image: str, authenticator: str,
                  storage_class: str, notebook_pvc_mount: str) -> List[dict]:
    labels = {"app": name}
    cm = base.config_map(
        f"{name}-config", namespace,
        {"jupyterhub_config.py": spawner_config(
            authenticator, notebook_image, storage_class, notebook_pvc_mount)},
    )
    sts = base.stateful_set(
        name, namespace, labels,
        base.pod_spec(
            containers=[base.container(
                name, hub_image,
                command=["jupyterhub", "-f",
                         "/etc/config/jupyterhub_config.py"],
                ports=[8000, 8081],
                volume_mounts=[{"name": "config-volume",
                                "mountPath": "/etc/config"}],
            )],
            volumes=[{"name": "config-volume",
                      "configMap": {"name": f"{name}-config"}}],
            service_account=name,
        ),
        service_name=name,
    )
    svc = base.service(name, namespace, labels,
                       [base.port(8000, "hub"), base.port(8081, "api")],
                       headless=True)
    lb = base.service(
        f"{name}-lb", namespace, labels, [base.port(80, "http", 8000)],
        service_type="LoadBalancer",
        annotations={"getambassador.io/config": base.ambassador_route(
            f"{name}-lb", "/hub/", name, 8000, rewrite="/hub/")},
    )
    sa = base.service_account(name, namespace, labels)
    role = base.cluster_role(name, rules=[
        {"apiGroups": [""], "resources": ["pods", "persistentvolumeclaims"],
         "verbs": ["get", "watch", "list", "create", "delete"]},
        {"apiGroups": [""], "resources": ["events"],
         "verbs": ["get", "watch", "list"]},
    ], labels=labels)
    binding = base.cluster_role_binding(name, name, name, namespace, labels)
    return [cm, sts, svc, lb, sa, role, binding]


def _generate(component_name: str, **p: Any) -> List[dict]:
    return hub_manifests(
        component_name, p["namespace"], p["hub_image"], p["notebook_image"],
        p["authenticator"], p["storage_class"], p["notebook_pvc_mount"],
    )


jupyterhub_prototype = default_registry.register(Prototype(
    name="jupyterhub",
    doc="JupyterHub with a GPU-aware spawner (heir of "
        "kubeflow/core/jupyterhub.libsonnet + kubeform_spawner.py).",
    params=[
        param("namespace", str, "kubeflow", "deployment namespace"),
        param("hub_image", str, DEFAULT_HUB_IMAGE, "hub image"),
        param("notebook_image", str, DEFAULT_NOTEBOOK_IMAGE,
              "default PyTorch CUDA notebook image"),
        param("authenticator", str, "dummy", "auth mode",
              choices=["dummy", "iap"]),
        param("storage_class", str, "", "storage class for user PVCs"),
        param("notebook_pvc_mount", str, "/home/jovyan", "PVC mount path"),
    ],
    generate=_generate,
))
