"""Serving-precision weight staging: the port of kubeflow_tpu/ops/quantize.py.

``CONTRACTIONS`` names every matmul weight of the LM parameter tree with
the axes its einsum contracts (counted from the end, so stacked ``[L, ...]``
leaves and per-layer ones share entries).  ``narrow_params`` casts exactly
those leaves to the compute dtype and leaves norm scales alone.

Not ported yet (ROADMAP queue 1, item 4): ``QTensor``,
``quantize_array``/``quantize_params``, ``qeinsum`` and ``embed_lookup``
for int8 weights and the int8 KV cache.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

CONTRACTIONS: Dict[Tuple[str, ...], Tuple[int, ...]] = {
    ("embed",): (-1,),             # [v, e] contract e (head); gather rows
    ("w_out",): (-2,),             # [e, v] contract e
    ("attn", "wq"): (-3,),         # [e, h, d] contract e
    ("attn", "wkv"): (-3,),        # [2, e, h, d] contract e
    ("attn", "wo"): (-3, -2),      # [h, d, e] contract h, d
    ("mlp", "wi"): (-2,),          # [2, e, f] contract e
    ("mlp", "wo"): (-2,),          # [f, e] contract f
}


def _match(path: Tuple[str, ...]) -> Optional[Tuple[int, ...]]:
    for suffix, axes in CONTRACTIONS.items():
        if path[-len(suffix):] == suffix:
            return axes
    return None


def map_matmul_weights(params: Any, fn: Callable[[Any, Tuple[int, ...]], Any],
                       _path: Tuple[str, ...] = ()) -> Any:
    """Apply ``fn(leaf, contraction_axes)`` to every CONTRACTIONS-table
    weight of a nested-dict parameter tree; other leaves pass through."""
    if isinstance(params, dict):
        return {k: map_matmul_weights(v, fn, _path + (k,))
                for k, v in params.items()}
    axes = _match(_path)
    return params if axes is None else fn(params, axes)


def narrow_params(params: Any, dtype: torch.dtype) -> Any:
    """Cast the known matmul weights (CONTRACTIONS table) to ``dtype``.

    Checkpoints carry float32 masters; serving them as-is doubles every
    weight read to feed casts the matmuls do anyway.  Norm scales and
    anything else off the table keep their checkpoint dtype.
    """
    return map_matmul_weights(params, lambda leaf, _: leaf.to(dtype))
