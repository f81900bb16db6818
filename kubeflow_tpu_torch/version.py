"""Version introspection: the port's copy of kubeflow_tpu/version.py
(the telemetry payload reports it).  The version is the JAX package's;
the framework and accelerator name the port."""

__version__ = "0.1.0"


def version_info() -> dict:
    return {
        "version": __version__,
        "framework": "kubeflow_tpu_torch",
        "accelerator": "gpu",
    }
