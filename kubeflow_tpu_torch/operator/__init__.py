"""Control plane, first half: the TPUJob spec model and the Kubernetes
transport (the port's copy of the JAX package's kubeflow_tpu/operator,
stdlib only).

  crd.py        TPUJobSpec and its wire format on the port's gang shapes
  kube.py       the kube interface's in-memory FakeKube
  kube_http.py  HttpKube, the stdlib REST client
  kube_real.py  RealKube over the official ``kubernetes`` client

The gang scheduler (``gang.py``), the reconciler (``reconciler.py``)
and the operator's entry point (``main.py``) come with the scheduler,
ROADMAP queue 1 item 18b.
"""

from kubeflow_tpu_torch.operator.crd import (
    GROUP,
    KIND,
    PLURAL,
    VERSION,
    MeshSpec,
    RestartPolicy,
    SpecError,
    StorageSpec,
    TPUJobSpec,
    WorkerSpec,
)
from kubeflow_tpu_torch.operator.kube import Conflict, FakeKube, NotFound

__all__ = [
    "GROUP",
    "KIND",
    "PLURAL",
    "VERSION",
    "MeshSpec",
    "RestartPolicy",
    "SpecError",
    "StorageSpec",
    "TPUJobSpec",
    "WorkerSpec",
    "Conflict",
    "FakeKube",
    "NotFound",
]
