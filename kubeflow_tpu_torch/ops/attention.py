"""Plain attention: the port of kubeflow_tpu/ops/attention.py.

``dot_product_attention`` materialises the [b, h, q, k] scores.  It is the
decode-step attention over the contiguous KV cache and the path taken by
segment-masked calls; the flash forward (ops/flash.py) covers prefill.
q/k/v are [batch, seq, heads, head_dim]; GQA passes fewer kv heads.  A
per-row ``[b]`` kv offset is the serving engine's paged decode: each
slot's queries sit at its own frontier.  k and v may be int8 ``QTensor``s
(the quantized KV cache) with per-(position, head) scales.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from kubeflow_tpu_torch.ops.quantize import QTensor

NEG_INF = torch.finfo(torch.float32).min


def _repeat_kv(k: torch.Tensor, q_heads: int) -> torch.Tensor:
    """Broadcast kv heads up to q heads for grouped-query attention."""
    kv_heads = k.shape[2]
    if kv_heads == q_heads:
        return k
    if q_heads % kv_heads:
        raise ValueError(f"{q_heads} query heads, {kv_heads} kv heads")
    return k.repeat_interleave(q_heads // kv_heads, dim=2)


def dot_product_attention(
    q: torch.Tensor,
    k: Union[torch.Tensor, QTensor],
    v: Union[torch.Tensor, QTensor],
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    kv_offset: Union[int, torch.Tensor] = 0,
    kv_valid_start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[b, sq, h, d] x [b, sk, hkv, d] -> [b, sq, h, d].

    kv_offset: absolute position of k[0] relative to q[0]'s frame (decode:
    one query against the cache), an int or a per-row [b] tensor.
    kv_valid_start: per-row [b] first valid key; keys before it are
    masked for every query (left-padded prompts).  Scores and softmax
    are float32 whatever the input dtype; masked scores take the float32
    minimum, so a fully masked row gets a uniform softmax, as in the JAX
    reference.

    int8 ``QTensor`` k/v: the scales commute through both matmuls, as in
    JAX.  The key scale multiplies the float32 score columns after the
    ``d**-0.5`` scale and before the mask; the value scale multiplies the
    float32 softmax weights before their cast to the compute dtype.
    """
    orig_dtype = q.dtype
    h = q.shape[2]
    k_scale = v_scale = None
    if isinstance(k, QTensor):
        # _repeat_kv repeats dim 2, the heads of the [b, sk, hkv] scale as
        # of the values.
        k, k_scale = _repeat_kv(k.values, h), _repeat_kv(k.scale, h)
    else:
        k = _repeat_kv(k, h)
    if isinstance(v, QTensor):
        v, v_scale = _repeat_kv(v.values, h), _repeat_kv(v.scale, h)
    else:
        v = _repeat_kv(v, h)
    scale = q.shape[-1] ** -0.5
    # Products of the compute dtype are exact in float32: upcasting
    # first gives the JAX dot's float32 accumulation (int8 values are
    # exact in every compute dtype).
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if k_scale is not None:
        # [b, sk, h] -> [b, h, 1, sk] column scales.
        scores = scores * k_scale.transpose(1, 2)[:, :, None, :]
    mask = _build_mask(
        q_len=q.shape[1], k_len=k.shape[1], causal=causal,
        segment_ids=segment_ids, kv_offset=kv_offset,
        kv_valid_start=kv_valid_start, device=q.device,
    )
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        weights = weights * v_scale.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(orig_dtype).float(),
                       v.float())
    return out.to(orig_dtype)


def _build_mask(
    q_len: int,
    k_len: int,
    causal: bool,
    segment_ids: Optional[torch.Tensor],
    kv_offset: Union[int, torch.Tensor],
    kv_valid_start: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> Optional[torch.Tensor]:
    """Boolean keep-mask broadcastable to [b, h, q, k]."""
    mask = None
    k_pos = torch.arange(k_len, device=device)
    if causal:
        q_pos = torch.arange(q_len, device=device)[:, None]
        if isinstance(kv_offset, torch.Tensor) and kv_offset.ndim == 1:
            # Per-row offsets: each row's queries sit at their own
            # absolute positions (one slot per row of a decode batch).
            q_pos = q_pos[None] + kv_offset.to(device)[:, None, None]
            mask = (q_pos >= k_pos)[:, None, :, :]        # [b, 1, q, k]
        else:
            mask = (q_pos + kv_offset >= k_pos[None, :])[None, None, :, :]
    if kv_valid_start is not None:
        valid = (k_pos[None, :]
                 >= kv_valid_start.to(device)[:, None])[:, None, None, :]
        mask = valid if mask is None else mask & valid
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask
