"""Serving-precision weights and the int8 KV cache: the port of
kubeflow_tpu/ops/quantize.py.

``CONTRACTIONS`` names every matmul weight of the LM parameter tree with
the axes its einsum contracts (counted from the end, so stacked ``[L, ...]``
leaves and per-layer ones share entries).  ``narrow_params`` casts exactly
those leaves to the compute dtype and leaves norm scales alone;
``quantize_params`` stores them as int8 ``QTensor``s instead.

The int8 scheme is symmetric with one float32 scale per output channel:
for every weight the scale's axes are exactly the matmul's contraction
axes, so ``einsum(x, W)`` equals ``einsum(x, W_int8) * scale`` with the
scale broadcast over the einsum's output.  ``qeinsum`` applies the scale
after the dot, so the int8 copy is what lives on the device and no
dequantized weight tensor exists; the ``int8 -> dtype`` convert of the
operand is a separate kernel per call in eager PyTorch (XLA fuses it into
the dot).  The embedding table gathers int8 rows and scales them one token
at a time (``embed_lookup``).  The KV cache uses the same scheme with one
scale per (position, head) (``quantize_array`` over the head dim).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class QTensor:
    """int8 ``values`` and a float32 per-output-channel ``scale``.

    ``scale``'s shape is ``values``'s with the contraction ``axes``
    (negative) removed, so it broadcasts against the trailing dims of the
    matmul's output.  Indexing narrows both in step (a layer slice of a
    stacked leaf, a k/v side of ``wkv``, a pool's layer)."""

    values: torch.Tensor   # int8
    scale: torch.Tensor    # float32
    axes: Tuple[int, ...] = ()

    def __getitem__(self, idx) -> "QTensor":
        # Leading-axis narrowing; negative contraction axes are unaffected.
        return QTensor(self.values[idx], self.scale[idx], self.axes)

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "QTensor":
        """Both tensors on ``device`` (their dtypes kept)."""
        return QTensor(self.values.to(device), self.scale.to(device),
                       self.axes)

    @property
    def nbytes(self) -> int:
        return (self.values.numel() * self.values.element_size()
                + self.scale.numel() * self.scale.element_size())

    def scale_dim(self, dim: int) -> Optional[int]:
        """The dim of ``scale`` that follows ``values``'s ``dim``, or None
        when ``dim`` is a contraction axis (the scale has no such dim)."""
        n = self.values.dim()
        dim %= n
        if dim - n in self.axes:
            return None
        return dim - sum(1 for a in self.axes if a + n < dim)

    def chunk(self, count: int, dim: int) -> Tuple["QTensor", ...]:
        """``count`` equal slices along ``values``'s ``dim``, each scale
        sliced with its values where it keeps that dim and whole where
        ``dim`` is contracted (there the scale is the whole contraction's
        amax: weights are quantized whole, then split)."""
        sdim = self.scale_dim(dim)
        values = self.values.chunk(count, dim=dim)
        scales = (self.scale.chunk(count, dim=sdim) if sdim is not None
                  else (self.scale,) * count)
        return tuple(QTensor(v, s, self.axes)
                     for v, s in zip(values, scales))

    def contiguous(self) -> "QTensor":
        return QTensor(self.values.contiguous(), self.scale.contiguous(),
                       self.axes)


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


def quantize_array(x: torch.Tensor, axes: Tuple[int, ...],
                   eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: (values, scale) with amax/127 scales over ``axes``.

    The JAX package's arithmetic in its order, in float32: ``amax =
    max|x|`` over the axes, ``scale = max(amax, eps) / 127``, then
    ``round(x / scale)`` half to even (``torch.round``, as ``jnp.round``)
    clipped to +-127.  A multiply by ``127 / amax`` would move values at
    ties.  Weights quantize on the host with ``eps=1e-12``
    (``quantize_params``), the KV cache on the device with the default.
    """
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=axes, keepdim=True)
    scale = amax.clamp_min(eps) / 127.0
    values = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return values, scale.squeeze(axes)


def quantize_params(params: Any, bits: int = 8) -> Any:
    """Quantize the known matmul weights (CONTRACTIONS table) of an LM
    parameter tree to CPU ``QTensor``s; other leaves pass through.

    Runs before the weights are staged, so the bytes copied to the device
    are the int8 ones."""
    if bits != 8:
        raise ValueError(f"int8 is the only quantized width, got {bits}")

    def q(leaf, axes):
        values, scale = quantize_array(
            torch.as_tensor(leaf).detach().to("cpu", torch.float32), axes,
            eps=1e-12)
        return QTensor(values, scale, axes)

    return map_matmul_weights(params, q)


def narrow_params(params: Any, dtype: torch.dtype) -> Any:
    """Cast the known matmul weights (CONTRACTIONS table) to ``dtype``.

    Checkpoints carry float32 masters; serving them as-is doubles every
    weight read to feed casts the matmuls do anyway.  Norm scales and
    anything else off the table keep their checkpoint dtype.
    """
    return map_matmul_weights(params, lambda leaf, _: leaf.to(dtype))


def qeinsum(eq: str, x: torch.Tensor, w: Any,
            dtype: torch.dtype) -> torch.Tensor:
    """einsum with an optionally quantized second operand.  For a QTensor
    the per-output-channel scale multiplies the dot's output (it commutes
    out of the contraction), in ``dtype``, as in JAX."""
    if isinstance(w, QTensor):
        y = torch.einsum(eq, x, w.values.to(dtype))
        return y * w.scale.to(dtype)
    return torch.einsum(eq, x, w.to(dtype))


def embed_lookup(embed: Any, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Token-row gather from a (possibly int8) embedding table."""
    if isinstance(embed, QTensor):
        rows = embed.values[tokens].to(dtype)
        return rows * embed.scale[tokens][..., None].to(dtype)
    return F.embedding(tokens, embed).to(dtype)
