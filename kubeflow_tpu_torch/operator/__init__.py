"""Control plane: the TPUJob spec model, the Kubernetes transport, the
gang scheduler and the reconciler (the port's copy of the JAX package's
kubeflow_tpu/operator, stdlib only).

  crd.py        TPUJobSpec and its wire format on the port's gang shapes
  kube.py       the kube interface's in-memory FakeKube
  kube_http.py  HttpKube, the stdlib REST client
  kube_real.py  RealKube over the official ``kubernetes`` client
  gang.py       all-or-nothing slice admission and node quarantine
  reconciler.py TPUJobController: CR -> gang -> pods -> lifecycle
  main.py       the operator daemon (``python -m
                kubeflow_tpu_torch.operator.main --fake-kube``)

The policy layer above the gang (quotas, priorities, preemption,
fusion, colocation) is ``kubeflow_tpu_torch.scheduler``.
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
from kubeflow_tpu_torch.operator.gang import (
    GangScheduler,
    NodeQuarantine,
    SliceClaim,
)
from kubeflow_tpu_torch.operator.kube import Conflict, FakeKube, NotFound
from kubeflow_tpu_torch.operator.reconciler import TPUJobController

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
    "GangScheduler",
    "NodeQuarantine",
    "SliceClaim",
    "TPUJobController",
]
