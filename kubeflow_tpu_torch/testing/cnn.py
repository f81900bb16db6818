"""Seeded CNN weights for checks that need every block to count.

A freshly initialised ResNet's residual branches are zero (flax zero-inits
the last BatchNorm scale of each block) and its running statistics are
0 and 1, so a check on it would skip most of the network.
``random_cnn_variables`` draws every leaf of a port CNN's flax variables
from a seeded numpy generator instead, as the JAX-side parity tests do:
kernels N(0, 1 / fan_in), BatchNorm scales U(0.5, 1) (the last of a
residual block U(0.1, 0.3), small but not zero, as training keeps it),
biases and running means 0.1 N(0, 1), running variances U(0.5, 1.5).
The result is the flax ``{"params", "batch_stats"}`` tree of float32
numpy arrays, ready for ``serving.export.export`` or
``models.convert_cnn.load_cnn_variables``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
from torch import nn

from kubeflow_tpu_torch.models.resnet import collect_stats


def _put(tree: Dict[str, Any], path: List[str], value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _is_last_norm(name: str) -> bool:
    """The last BatchNorm of a residual block: a basic block's
    BatchNorm_1, a bottleneck's BatchNorm_2."""
    last = "BatchNorm_1" if "ResNetBlock" in name else "BatchNorm_2"
    return "Block_" in name and f".{last}." in name


def random_cnn_variables(model: nn.Module, seed: int) -> Dict[str, Any]:
    """Every leaf of ``model``'s flax variables (a port ResNet or
    Inception-v3, on any device, "meta" included) drawn from numpy."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        path = name.split(".")
        shape = tuple(p.shape)
        if path[-1] == "weight":
            # flax's layout: [kh, kw, in, out] kernels, [in, out] dense.
            shape = ((shape[2], shape[3], shape[1], shape[0])
                     if len(shape) == 4 else shape[::-1])
            value = rng.standard_normal(shape) / np.sqrt(
                np.prod(shape[:-1]))
            path[-1] = "kernel"
        elif path[-1] == "scale":
            lo, hi = (0.1, 0.3) if _is_last_norm(name) else (0.5, 1.0)
            value = rng.uniform(lo, hi, shape)
        else:
            value = 0.1 * rng.standard_normal(shape)
        _put(params, path, value.astype(np.float32))

    def walk(tree: Dict[str, Any], path: List[str]) -> None:
        for key, value in tree.items():
            if "mean" not in value:
                walk(value, path + [key])
                continue
            n = value["mean"].shape[0]
            _put(stats, path + [key, "mean"],
                 (0.1 * rng.standard_normal(n)).astype(np.float32))
            _put(stats, path + [key, "var"],
                 rng.uniform(0.5, 1.5, n).astype(np.float32))

    walk(collect_stats(model), [])
    return {"params": params, "batch_stats": stats}
