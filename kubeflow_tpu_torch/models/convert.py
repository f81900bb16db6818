"""Weight bridge between the JAX package's LM parameter tree and the port.

The JAX tree (``nn.unbox(model.init(...))["params"]``, or what
``msgpack_restore`` gives for an exported ``params.msgpack``) is a nested
dict whose per-layer leaves are stacked ``[L, ...]`` under ``layers``::

    embed [v, e]; final_norm/scale [e]; w_out [e, v] (untied only)
    layers/attn_norm/scale [L, e]; layers/mlp_norm/scale [L, e]
    layers/attn/wq [L, e, h, d]; wkv [L, 2, e, hkv, d]; wo [L, h, d, e]
    layers/mlp/wi [L, 2, e, f]; layers/mlp/wo [L, f, e]
    (MoE, in place of mlp) layers/moe/router [L, e, E];
    layers/moe/wi [L, E, 2, e, f]; layers/moe/wo [L, E, f, e]

The port's parameter dict is that same tree with torch tensors for
leaves; ``load_params`` unstacks it into a ``Transformer``'s per-layer
modules and ``params_to_jax`` stacks a module back into numpy arrays, its
parameters or (``grads=True``) their ``.grad``, so that gradients compare
leaf by leaf with ``jax.grad`` of the JAX model.  A served tree's matmul
weights may be int8 ``QTensor``s (ops/quantize.py ``quantize_params``);
``load_params`` installs them as plain attributes in place of the
parameters.

A model under a mesh holds shares of the whole weights: its slices over
``tensor`` (models/transformer.py splits heads, mlp and vocab) and, once
the trainer has wrapped it, FSDP2's shards of those over ``fsdp``.
``load_params`` takes the whole tree and installs the rank's tensor
slices (FSDP2 then shards them as it wraps the model, and a checkpoint
restore places both, runtime/checkpoint.py); ``whole_parameters`` and
``params_to_jax`` gather the shares back into whole weights, a
collective that every rank of the mesh calls.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import Transformer
from kubeflow_tpu_torch.ops.quantize import QTensor
from kubeflow_tpu_torch.parallel import tensor as tp

_LAYER_LEAVES = (
    ("attn_norm", "scale"), ("attn", "wq"), ("attn", "wkv"),
    ("attn", "wo"), ("mlp_norm", "scale"),
)
_MLP_LEAVES = (("mlp", "wi"), ("mlp", "wo"))
_MOE_LEAVES = (("moe", "router"), ("moe", "wi"), ("moe", "wo"))


def _layer_leaves(model: Transformer):
    """The (module, parameter) pairs of one layer: the dense MLP's or,
    with ``moe_experts > 0``, the MoE MLP's."""
    return _LAYER_LEAVES + (_MOE_LEAVES if model.cfg.moe_experts > 0
                            else _MLP_LEAVES)


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


def params_to_device(params: Dict[str, Any], device) -> Dict[str, Any]:
    """Every leaf of a port parameter dict (tensors and ``QTensor``s) on
    ``device``, dtypes kept."""
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    return params.to(device)


def load_params(model: Transformer, params: Dict[str, Any]) -> Transformer:
    """Install a port parameter dict into ``model`` in place.  Each leaf
    keeps its own dtype and device (a model built on ``device="meta"``
    takes the tensors as they are); shapes must match exactly.  A
    ``QTensor`` leaf replaces its parameter with a plain attribute of the
    same name, which ``model.to()`` does not move: stage such a tree on
    its device first (``params_to_device``).  A model whose parameters
    are slices over ``tensor`` takes the whole leaves and keeps its own
    slices of them (an int8 ``QTensor`` with its scale)."""
    n = model.cfg.n_layers
    state = {"embed": params["embed"],
             "final_norm.scale": params["final_norm"]["scale"]}
    if not model.cfg.tied_embeddings:
        state["w_out"] = params["w_out"]
    layers = params["layers"]
    for outer, inner in _layer_leaves(model):
        stacked = layers[outer][inner]
        if stacked.shape[0] != n:
            raise ValueError(f"layers/{outer}/{inner} has {stacked.shape[0]} "
                             f"layers, config has {n}")
        for i in range(n):
            state[f"layers.{i}.{outer}.{inner}"] = stacked[i]
    expected = dict(model.named_parameters())
    slices = {name: tp.shard_of(p) for name, p in expected.items()}
    for name, shard in slices.items():
        if shard is not None and name in state:
            state[name] = shard.take(state[name]).contiguous()
    if set(state) != set(expected):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(expected) - set(state))}"
            f", unexpected {sorted(set(state) - set(expected))}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, model expects "
                             f"{tuple(expected[name].shape)}")
    for name in [n for n, t in state.items() if isinstance(t, QTensor)]:
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        delattr(module, leaf)
        setattr(module, leaf, state.pop(name))
    model.load_state_dict(state, strict=True, assign=True)
    for name, param in model.named_parameters():
        tp.mark(param, slices[name])  # assign=True made new parameters
    return model


def param_tree(model: Transformer) -> Dict[str, Any]:
    """The model's own weights (parameters, or the int8 ``QTensor``s a
    served model holds in their place) as the nested tree ``load_params``
    takes, layer leaves stacked ``[L, ...]`` on the model's device (a
    copy); this rank's slices under a mesh."""

    def stack(leaves):
        if isinstance(leaves[0], QTensor):
            return QTensor(torch.stack([q.values for q in leaves]),
                           torch.stack([q.scale for q in leaves]),
                           leaves[0].axes)
        return torch.stack([t.detach() for t in leaves])

    out: Dict[str, Any] = {
        "embed": model.embed if isinstance(model.embed, QTensor)
        else model.embed.detach(),
        "final_norm": {"scale": model.final_norm.scale.detach()},
        "layers": {},
    }
    if model.w_out is not None:
        out["w_out"] = model.w_out if isinstance(model.w_out, QTensor) \
            else model.w_out.detach()
    for outer, inner in _layer_leaves(model):
        out["layers"].setdefault(outer, {})[inner] = stack(
            [getattr(getattr(block, outer), inner) for block in model.layers])
    return out


def _whole(param: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` (``param`` or its gradient) is this
    rank's share: FSDP2's shards gathered, then the tensor slices (a
    collective under a mesh; ``t`` itself otherwise)."""
    t = t.detach()
    if callable(getattr(t, "full_tensor", None)):
        t = t.full_tensor()
    shard = tp.shard_of(param)
    return t if shard is None else shard.gather(t)


def whole_parameters(model: Transformer) -> Dict[str, torch.Tensor]:
    """Every parameter by name, whole (gathered over the mesh: every rank
    calls it), on its own device."""
    return {name: _whole(p, p) for name, p in model.named_parameters()}


def params_to_jax(model: Transformer, *, grads: bool = False
                  ) -> Dict[str, Any]:
    """The model's parameters (or, with ``grads=True``, their gradients)
    as the JAX package's nested numpy tree (stacked ``[L, ...]`` layer
    leaves), whole under a mesh (gathered: every rank calls it); bf16
    leaves become float32, the dtype numpy can hold."""

    def host(p: torch.Tensor) -> np.ndarray:
        t = p
        if grads:
            if p.grad is None:
                raise ValueError(f"parameter of shape {tuple(p.shape)} has "
                                 "no gradient")
            t = p.grad
        t = _whole(p, t).cpu()
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
    for outer, inner in _layer_leaves(model):
        leaves = [getattr(getattr(block, outer), inner)
                  for block in model.layers]
        out["layers"].setdefault(outer, {})[inner] = np.stack(
            [host(t) for t in leaves])
    return out
