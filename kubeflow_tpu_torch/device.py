"""Device resolution for every entry point of the port.

The JAX package ran wherever ``jax.default_backend()`` pointed.  Here the
rule is explicit: no device given means CUDA, and a missing GPU is an
error, never a silent CPU run.  Tests and CPU users pass ``"cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given.  Raises when CUDA is
    asked for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: kubeflow_tpu_torch runs on an NVIDIA "
            "GPU unless the caller asks for the CPU (device='cpu', or "
            "--device cpu on an entry point)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
