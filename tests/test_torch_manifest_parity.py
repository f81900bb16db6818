"""The port's renderers against the JAX package's.

For every prototype both registries hold, both render with the same
params, and the port's objects must equal the JAX package's after one
stated normalisation, ``TPU_TO_GPU`` (the README's table):

  * ``google.com/tpu`` -> ``nvidia.com/gpu``;
  * ``kubeflow_tpu.`` -> ``kubeflow_tpu_torch.`` in commands;
  * a TPU slice name -> its GPU default (``SLICE_MAP``);
  * a pod's node selector -> the GPU shape's own, and each image
    ``ghcr.io/kubeflow-tpu/X`` -> ``ghcr.io/kubeflow-tpu-torch/X``
    (``torch-xla`` -> ``torch-cuda``);
  * the ``torch-xla-job`` worker's torch_xla env (``PJRT_DEVICE``,
    ``XLA_USE_SPMD``) -> none: a CUDA worker needs neither.

Anything else that differs is a fault.  Every ``kubeflow_tpu_torch.*``
module a rendered object names must import, but for the modules a later
ROADMAP item brings (``LATER``).
"""

import importlib
import json
import re

import pytest
import torch

import kubeflow_tpu.manifests  # noqa: F401 — registers prototypes
import kubeflow_tpu_torch.manifests  # noqa: F401 — registers prototypes
from kubeflow_tpu.config import default_registry as jax_registry
from kubeflow_tpu_torch.config import default_registry as port_registry
from kubeflow_tpu_torch.runtime.topology import parse_slice_type

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

# Each TPU slice name the JAX prototypes default to or the cases below
# pass, and the GPU shape the port takes in its place.
SLICE_MAP = {"v5e-1": "h100-1", "v5e-8": "h100-8", "v5p-32": "h100-32"}
TPU_TO_GPU = [
    ("google.com/tpu", "nvidia.com/gpu"),
    ("kubeflow_tpu.", "kubeflow_tpu_torch."),
    ("ghcr.io/kubeflow-tpu/torch-xla:", "ghcr.io/kubeflow-tpu-torch/torch-cuda:"),
    ("ghcr.io/kubeflow-tpu/", "ghcr.io/kubeflow-tpu-torch/"),
] + [(f'"{tpu}"', f'"{gpu}"') for tpu, gpu in SLICE_MAP.items()] + [
    (f'\\"{tpu}\\"', f'\\"{gpu}\\"') for tpu, gpu in SLICE_MAP.items()]
TORCH_XLA_ENV = ("PJRT_DEVICE", "XLA_USE_SPMD")
# Modules a rendered object names that a later ROADMAP queue 1 item
# ports, with that item.
LATER = {"kubeflow_tpu_torch.tools.dashboard": "item 33"}

# Params beside the defaults: the accelerator-bearing paths.
CASES = [(name, {}) for name in sorted(
    set(jax_registry.names()) & set(port_registry.names()))] + [
    ("tpu-serving", {"slice_type": "v5e-8"}),
    ("tpu-serving", {"slice_type": "v5e-1", "storage_type": "gcp",
                     "istio_enable": True}),
    ("tpu-job", {"slice_type": "v5p-32", "command": "python,-m,x",
                 "checkpoint_path": "gs://b/ckpt"}),
    ("tpu-cnn-benchmark", {"slice_type": "v5e-8", "model": "resnet101",
                           "data_dir": "/data"}),
    ("torch-xla-job", {"slice_type": "v5p-32", "args": "--steps,5"}),
    ("tpu-job-simple", {"slice_type": "cpu-1"}),
    ("kubeflow-core", {"disks": True, "report_usage": True,
                       "usage_id": "u-1"}),
]


def _gpu_params(params):
    return {k: SLICE_MAP.get(v, v) if k == "slice_type" else v
            for k, v in params.items()}


def _normalise(jax_objs):
    text = json.dumps(jax_objs)
    for tpu, gpu in TPU_TO_GPU:
        text = text.replace(tpu, gpu)
    objs = json.loads(text)
    for obj in objs:
        _walk_pod_specs(obj)
        worker = obj.get("spec", {}).get("worker") \
            if obj.get("kind") == "TPUJob" else None
        if worker and worker.get("env"):
            for key in TORCH_XLA_ENV:
                worker["env"].pop(key, None)
            if not worker["env"]:
                worker["env"] = {}
    return objs


def _walk_pod_specs(obj):
    """Replace each TPU node selector with the mapped GPU shape's."""
    if isinstance(obj, dict):
        selector = obj.get("nodeSelector")
        if isinstance(selector, dict) and any(
                "gke-tpu" in k for k in selector):
            limits = obj["containers"][0]["resources"]["limits"]
            gpus = limits["nvidia.com/gpu"]
            obj["nodeSelector"] = parse_slice_type(
                f"h100-{gpus}").k8s_node_selector()
        for value in obj.values():
            _walk_pod_specs(value)
    elif isinstance(obj, list):
        for value in obj:
            _walk_pod_specs(value)


def _strip_uids(objs):
    """The version ConfigMap's per-render uuid is random in both."""
    text = json.dumps(objs)
    return re.sub(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}", "<uuid>", text)


def _version_neutral(objs):
    """kubeflow-core's version ConfigMap reports each package's own
    version_info(); neither is a rendering difference."""
    for obj in objs:
        if obj.get("kind") == "ConfigMap" and \
                obj["metadata"]["name"] == "kubeflow-version":
            obj["data"] = {}
    return objs


def test_every_jax_prototype_has_a_port_twin():
    assert set(jax_registry.names()) == set(port_registry.names())


@pytest.mark.parametrize("proto,params", CASES,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(CASES)])
def test_port_renders_what_jax_renders_under_the_gpu_table(proto, params):
    want = _normalise(jax_registry.generate(proto, "x", **params))
    got = port_registry.generate(proto, "x", **_gpu_params(params))
    assert _strip_uids(_version_neutral(got)) == \
        _strip_uids(_version_neutral(want))
    text = json.dumps(got)
    assert "google.com/tpu" not in text
    assert "kubeflow_tpu." not in text.replace("kubeflow_tpu_torch.", "")


def test_rendered_modules_import():
    """Every ``kubeflow_tpu_torch.*`` module a rendered object names is
    importable, but for those of later ROADMAP items."""
    named = set()
    for proto, params in CASES:
        text = json.dumps(port_registry.generate(
            proto, "x", **_gpu_params(params)))
        named |= set(re.findall(r"kubeflow_tpu_torch(?:\.\w+)+", text))
    assert "kubeflow_tpu_torch.operator.main" in named
    assert "kubeflow_tpu_torch.fleet.main" in named
    assert "kubeflow_tpu_torch.tools.train_cnn" in named
    for module in sorted(named - set(LATER)):
        importlib.import_module(module)
    for module, item in LATER.items():
        assert module in named, (module, item)
        with pytest.raises(ImportError):
            importlib.import_module(module)
