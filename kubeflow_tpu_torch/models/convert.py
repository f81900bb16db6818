"""Weight bridge between the JAX package's LM parameter tree and the port.

The JAX tree (``nn.unbox(model.init(...))["params"]``, or what
``msgpack_restore`` gives for an exported ``params.msgpack``) is a nested
dict whose per-layer leaves are stacked ``[L, ...]`` under ``layers``::

    embed [v, e]; final_norm/scale [e]; w_out [e, v] (untied only)
    layers/attn_norm/scale [L, e]; layers/mlp_norm/scale [L, e]
    layers/attn/wq [L, e, h, d]; wkv [L, 2, e, hkv, d]; wo [L, h, d, e]
    layers/mlp/wi [L, 2, e, f]; layers/mlp/wo [L, f, e]

The port's parameter dict is that same tree with torch tensors for
leaves; ``load_params`` unstacks it into a ``Transformer``'s per-layer
modules and ``params_to_jax`` stacks a module back into numpy arrays, its
parameters or (``grads=True``) their ``.grad``, so that gradients compare
leaf by leaf with ``jax.grad`` of the JAX model.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import Transformer

_LAYER_LEAVES = (
    ("attn_norm", "scale"), ("attn", "wq"), ("attn", "wkv"),
    ("attn", "wo"), ("mlp_norm", "scale"), ("mlp", "wi"), ("mlp", "wo"),
)


def _to_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX tree
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX LM params (numpy, bf16 or torch leaves) -> the port's parameter
    dict: the same nested structure with CPU torch tensor leaves.  A tree
    wrapped as ``{"params": ...}`` (exported variables) is unwrapped."""
    if set(tree) == {"params"}:
        tree = tree["params"]

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _to_tensor(node)

    return convert(tree)


def load_params(model: Transformer, params: Dict[str, Any]) -> Transformer:
    """Install a port parameter dict into ``model`` in place.  Each leaf
    keeps its own dtype and device (a model built on ``device="meta"``
    takes the tensors as they are); shapes must match exactly."""
    n = model.cfg.n_layers
    state = {"embed": params["embed"],
             "final_norm.scale": params["final_norm"]["scale"]}
    if not model.cfg.tied_embeddings:
        state["w_out"] = params["w_out"]
    layers = params["layers"]
    for outer, inner in _LAYER_LEAVES:
        stacked = layers[outer][inner]
        if stacked.shape[0] != n:
            raise ValueError(f"layers/{outer}/{inner} has {stacked.shape[0]} "
                             f"layers, config has {n}")
        for i in range(n):
            state[f"layers.{i}.{outer}.{inner}"] = stacked[i]
    expected = dict(model.named_parameters())
    if set(state) != set(expected):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(expected) - set(state))}"
            f", unexpected {sorted(set(state) - set(expected))}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, model expects "
                             f"{tuple(expected[name].shape)}")
    model.load_state_dict(state, strict=True, assign=True)
    return model


def params_to_jax(model: Transformer, *, grads: bool = False
                  ) -> Dict[str, Any]:
    """The model's parameters (or, with ``grads=True``, their gradients)
    as the JAX package's nested numpy tree (stacked ``[L, ...]`` layer
    leaves); bf16 leaves become float32, the dtype numpy can hold."""

    def host(t: torch.Tensor) -> np.ndarray:
        if grads:
            if t.grad is None:
                raise ValueError(f"parameter of shape {tuple(t.shape)} has "
                                 "no gradient")
            t = t.grad
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    out: Dict[str, Any] = {
        "embed": host(model.embed),
        "final_norm": {"scale": host(model.final_norm.scale)},
        "layers": {},
    }
    if model.w_out is not None:
        out["w_out"] = host(model.w_out)
    for outer, inner in _LAYER_LEAVES:
        leaves = [getattr(getattr(block, outer), inner)
                  for block in model.layers]
        out["layers"].setdefault(outer, {})[inner] = np.stack(
            [host(t) for t in leaves])
    return out
