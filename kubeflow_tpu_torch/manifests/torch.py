"""PyTorch job profile: the port's copy of kubeflow_tpu/manifests/torch.py.

The reference ran a separate pytorch-operator binary with its own CRD
(kubeflow/pytorch-job/pytorch-operator.libsonnet:30-80).  Here PyTorch is
a *worker profile* of the same TPUJob gang: the prototype (under the JAX
package's name, ``torch-xla-job``) emits a TPUJob whose pods run a CUDA
PyTorch image on the port's GPU gang shapes.  The JAX package's profile
sets the PJRT/XLA env (``PJRT_DEVICE=TPU``) for torch_xla; a CUDA worker
needs none, and its ranks rendezvous through the same ``KFT_*`` contract
(``runtime/bootstrap.torch_dist_env``) every other job kind uses.
"""

from __future__ import annotations

from typing import Any, List

from kubeflow_tpu_torch.config.params import Prototype, param
from kubeflow_tpu_torch.config.registry import default_registry
from kubeflow_tpu_torch.operator.crd import (
    RestartPolicy,
    TPUJobSpec,
    WorkerSpec,
)


def _generate_torch_job(component_name: str, **p: Any) -> List[dict]:
    job = TPUJobSpec(
        name=component_name,
        namespace=p["namespace"],
        slice_type=p["slice_type"],
        num_slices=p["num_slices"],
        worker=WorkerSpec(
            image=p["image"],
            command=list(p["command"]) or ["python"],
            args=list(p["args"]),
        ),
        restart=RestartPolicy(max_restarts=p["max_restarts"]),
    )
    return [job.to_custom_resource()]


torch_job_prototype = default_registry.register(Prototype(
    name="torch-xla-job",
    doc="PyTorch gang job on CUDA GPUs (heir of kubeflow/pytorch-job "
        "prototypes; pytorch-job.libsonnet:4-77) — same TPUJob CR, torch "
        "worker profile",
    params=[
        param("namespace", str, "kubeflow", "target namespace"),
        param("slice_type", str, "h100-8", "GPU gang shape"),
        param("num_slices", int, 1, "number of slices"),
        param("image", str, "ghcr.io/kubeflow-tpu-torch/torch-cuda:latest",
              "image with torch built for CUDA"),
        param("command", list, [], "container command"),
        param("args", list, [], "container args"),
        param("max_restarts", int, 3, "gang restarts before giving up"),
    ],
    generate=_generate_torch_job,
))
