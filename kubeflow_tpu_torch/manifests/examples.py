"""Examples package — heir of kubeflow/examples prototypes
(tf-job-simple, tf-serving-simple, tf-serving-with-istio).

The port's copy of kubeflow_tpu/manifests/examples.py, importing nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry


def _generate_job_simple(component_name: str, **p: Any) -> List[dict]:
    from kubeflow_tpu_torch.operator.crd import TPUJobSpec, WorkerSpec

    job = TPUJobSpec(
        name=component_name,
        namespace=p["namespace"],
        slice_type=p["slice_type"],
        worker=WorkerSpec(
            image="ghcr.io/kubeflow-tpu-torch/worker:latest",
            command=["python", "-m", "kubeflow_tpu_torch.tools.train_cnn"],
            args=["--model=resnet18", "--steps=10"],
        ),
    )
    return [job.to_custom_resource()]


job_simple_prototype = default_registry.register(Prototype(
    name="tpu-job-simple",
    doc="Smallest runnable TPUJob (heir of examples/tf-job-simple): "
        "ResNet-18, 10 steps, one H100, synthetic data",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("slice_type", str, "h100-1",
              "gang shape to run on (cpu-1 for GPU-less E2E clusters)"),
    ],
    generate=_generate_job_simple,
))


def _generate_serving_simple(component_name: str, **p: Any) -> List[dict]:
    proto = default_registry.get("tpu-serving")
    return proto.generate(
        component_name,
        namespace=p["namespace"],
        model_name=component_name,
        model_base_path=p["model_base_path"],
    )


serving_simple_prototype = default_registry.register(Prototype(
    name="tpu-serving-simple",
    doc="Minimal model server (heir of examples/tf-serving-simple, "
        "kubeflow/examples/prototypes/tf-serving-simple.jsonnet:1-50)",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("model_base_path", str, "gs://kubeflow-examples/inception",
              "versioned model directory"),
    ],
    generate=_generate_serving_simple,
))


def _generate_serving_istio(component_name: str, **p: Any) -> List[dict]:
    proto = default_registry.get("tpu-serving")
    return proto.generate(
        component_name,
        namespace=p["namespace"],
        model_name=component_name,
        model_base_path=p["model_base_path"],
        istio_enable=True,
        istio_version=p["version"],
    )


serving_istio_prototype = default_registry.register(Prototype(
    name="tpu-serving-with-istio",
    doc="Model server joined to the Istio mesh (heir of "
        "examples/prototypes/tf-serving-with-istio.jsonnet): sidecar "
        "inject + versioned VirtualService/DestinationRule routing",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("model_base_path", str, "gs://kubeflow-examples/inception",
              "versioned model directory"),
        param("version", str, "v1",
              "deployment version label the default route targets"),
    ],
    generate=_generate_serving_istio,
))
