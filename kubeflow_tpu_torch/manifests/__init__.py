"""Manifest-generation layer — heir of the reference's ksonnet packages.

The port's copy of kubeflow_tpu/manifests/__init__.py, importing nothing of the JAX
package.

Importing this package registers every component prototype into
``kubeflow_tpu_torch.config.default_registry`` (the way `ks pkg install` made
prototypes available).  Sub-modules map to reference packages:

  base         k8s object builders (shared idioms of all *.libsonnet files)
  core         kubeflow-core aggregate (kubeflow/core/all.libsonnet)
  tpujob       tf-job + tf-job-operator heirs
  jupyterhub   kubeflow/core/jupyterhub.libsonnet + kubeform_spawner.py
  serving      kubeflow/tf-serving heir (tpu-serving)
  tensorboard  kubeflow/core/tensorboard.libsonnet heir
  iap          kubeflow/core/iap.libsonnet heir (GKE IAP ingress)
  certs        kubeflow/core/cert-manager.libsonnet heir (non-GKE TLS)
  endpoints    kubeflow/core/cloud-endpoints.libsonnet heir
  torch        kubeflow/pytorch-job heir (torch-xla-job)
  addons       kubeflow/argo, seldon, pachyderm, credentials-pod-preset
  examples     kubeflow/examples heirs (tpu-job-simple, tpu-serving-simple)
"""

from kubeflow_tpu_torch.manifests import base  # noqa: F401

# Import order matters only for examples (it references tpu-serving).
from kubeflow_tpu_torch.manifests import (  # noqa: F401
    addons,
    certs,
    core,
    endpoints,
    iap,
    jupyterhub,
    serving,
    tensorboard,
    torch,
    tpujob,
)
from kubeflow_tpu_torch.manifests import examples  # noqa: F401  (needs serving)
