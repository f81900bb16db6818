"""PyTorch/CUDA port of kubeflow_tpu's numerical path, for NVIDIA Hopper.

The JAX package (``kubeflow_tpu``) is the reference; this package keeps
its module layout and names so each counterpart is easy to find, and it
imports nothing of JAX or of the JAX package.  Entry points run on CUDA
unless the caller asks for the CPU (``kubeflow_tpu_torch.device``).
"""


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this port does not have yet; the
    message names the ROADMAP item that brings it."""
