"""Weight bridge between the JAX package's CNN variables and the port's
modules (models/resnet.py, models/inception.py).

The JAX tree is flax's ``{"params": ..., "batch_stats": ...}`` (what
``model.init`` returns, or what ``msgpack_restore`` gives for an exported
``params.msgpack``), nested by flax's module names.  The port's modules
carry the same names, so a parameter's torch name is its flax path joined
by dots, with the leaf renamed where torch's layout differs:

    .../Conv_i/kernel  [kh, kw, in, out] -> .../Conv_i.weight [out, in, kh, kw]
    head|logits/kernel [in, out]         -> head|logits.weight [out, in]
    head|logits/bias, */scale, */bias    -> the same name, as they are

``batch_stats`` keeps flax's nesting unchanged (``{"bn_init": {"mean",
"var"}, ...}``): it is the port's mutable collection as it is.  The
round trip is exact: a transpose moves the values and changes none.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.models.convert import _to_tensor
from kubeflow_tpu_torch.models.resnet import collect_stats

Tree = Dict[str, Any]


def _flat(tree: Tree, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _nest(flat: Dict[Tuple[str, ...], Any]) -> Tree:
    out: Tree = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def cnn_params_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """flax CNN params -> the port's ``state_dict`` (CPU tensors)."""
    state = {}
    for path, leaf in _flat(params):
        t = _to_tensor(leaf)
        if path[-1] == "kernel":
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T
            path = path[:-1] + ("weight",)
        state[".".join(path)] = t.contiguous()
    return state


def cnn_variables_from_jax(variables: Tree
                           ) -> Tuple[Dict[str, torch.Tensor], Tree]:
    """flax variables -> (the port's ``state_dict``, the ``batch_stats``
    tree with CPU tensor leaves)."""
    stats = {path: _to_tensor(leaf)
             for path, leaf in _flat(variables.get("batch_stats", {}))}
    return cnn_params_from_jax(variables["params"]), _nest(stats)


def load_cnn_variables(model: nn.Module, variables: Tree) -> Tree:
    """Install flax variables into ``model`` (a CNN, or one of its
    blocks) in place, each tensor onto the device of the parameter it
    replaces, names and shapes matching exactly; return the
    ``batch_stats`` tree on that device, checked against the model's
    BatchNorms."""
    state, stats = cnn_variables_from_jax(variables)
    expected = dict(model.named_parameters())
    if set(state) != set(expected):
        raise ValueError(
            f"parameter names differ: missing "
            f"{sorted(set(expected) - set(state))}, unexpected "
            f"{sorted(set(state) - set(expected))}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, model expects "
                             f"{tuple(expected[name].shape)}")
    device = next(model.parameters()).device
    with torch.no_grad():
        for name, t in state.items():
            expected[name].copy_(t)
    want = dict(_flat(collect_stats(model)))
    if set(want) != set(dict(_flat(stats))):
        raise ValueError("batch_stats do not match the model's BatchNorms")
    return _nest({path: t.to(device, torch.float32).reshape(want[path].shape)
                  for path, t in _flat(stats)})


def cnn_variables_to_jax(model: nn.Module, batch_stats: Tree) -> Tree:
    """The model's parameters and ``batch_stats`` as flax's nested numpy
    variables (float32)."""
    params = {}
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        t = p.detach().to("cpu", torch.float32)
        if path[-1] == "weight":
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
            path = path[:-1] + ("kernel",)
        params[path] = np.ascontiguousarray(t.numpy())
    stats = {path: t.detach().to("cpu", torch.float32).numpy()
             for path, t in _flat(batch_stats)}
    return {"params": _nest(params), "batch_stats": _nest(stats)}
