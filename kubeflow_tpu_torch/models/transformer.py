"""Decoder-only Transformer LM: the port of kubeflow_tpu/models/transformer.py.

RoPE (split halves, float32 angles), RMSNorm (float32 math and scale),
grouped-query attention and a SwiGLU MLP, with tied or untied unembed and
float32 logits.  Parameters keep the JAX package's layout and names
(``wq [e,h,d]``, ``wkv [2,e,hkv,d]``, ``wo [h,d,e]``, ``wi [2,e,f]``,
``mlp.wo [f,e]``), one ``Block`` per layer in ``layers``; the weight bridge
(models/convert.py) maps them to and from the JAX tree, whose layer leaves
are stacked ``[L, ...]``.

Dense path only.  MoE, pipeline microbatching, ring attention, remat and
dropout raise ``NotImplementedError`` until their slices of the port land
(ROADMAP queue 1, items 4, 7 and 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.flash import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    head_dim: int = 64
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: str = "nobatch"
    save_attn_residuals: bool = True
    tied_embeddings: bool = True
    # "dot" (materialized scores) or "flash" (ops/flash.py); "ring" is
    # not ported yet.
    attention: str = "dot"
    # Kept for parity with the JAX config; the CUDA kernel picks its own
    # tiles and ignores them.
    flash_block_q: int = 512
    flash_block_k: int = 1024
    flash_block_diag: int = 0
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_group_size: int = 0
    moe_impl: str = "einsum"
    ce_dtype: str = "f32"
    ce_chunk: int = 0
    pipeline_microbatches: int = 0

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")
        if self.ce_dtype not in ("f32", "compute"):
            raise ValueError(
                f"ce_dtype={self.ce_dtype!r} not in ('f32', 'compute')")
        if self.pipeline_microbatches and self.dropout_rate:
            raise ValueError("pipeline_microbatches requires dropout_rate=0")


def _unsupported(cfg: TransformerConfig) -> Optional[str]:
    if cfg.moe_experts > 0:
        return "moe_experts > 0 (MoE, ROADMAP queue 1 item 9)"
    if cfg.pipeline_microbatches > 0:
        return "pipeline_microbatches > 0 (parallel training, ROADMAP queue 1 item 7)"
    if cfg.attention == "ring":
        return "attention='ring' (parallel training, ROADMAP queue 1 item 7)"
    if cfg.remat:
        return "remat (training slice, ROADMAP queue 1 item 4)"
    if cfg.dropout_rate > 0:
        return "dropout_rate > 0 (training slice, ROADMAP queue 1 item 4)"
    if cfg.attention not in ("dot", "flash"):
        return f"attention={cfg.attention!r}"
    return None


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding on split halves. x: [b, s, h, d]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].to(torch.float32) * freqs  # [b, s, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _lecun_normal(shape, generator, device) -> torch.Tensor:
    """flax lecun_normal: truncated normal (+-2 sd) with variance 1/fan_in,
    fan_in = prod(shape) / shape[-1] (flax's in_axis=-2, out_axis=-1)."""
    fan_in = math.prod(shape) // shape[-1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    return t


def _param(shape, generator, device, init: str = "lecun") -> nn.Parameter:
    if init == "ones":
        t = torch.ones(shape, dtype=torch.float32, device=device)
    elif init == "embed":
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if t.device.type != "meta":
            nn.init.normal_(t, std=0.02, generator=generator)
    else:
        t = _lecun_normal(shape, generator, device)
    return nn.Parameter(t)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = _param((dim,), None, device, init="ones")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        norm = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale.to(torch.float32)).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        e, h, hkv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _param((e, h, d), generator, device)
        self.wkv = _param((2, e, hkv, d), generator, device)
        self.wo = _param((h, d, e), generator, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projections of x [b, s, e] -> roped q [b,s,h,d], roped k and
        plain v [b,s,hkv,d], all in the compute dtype."""
        cfg = self.cfg
        dt = cfg.dtype
        q = torch.einsum("bse,ehd->bshd", x, self.wq.to(dt))
        k = torch.einsum("bse,ehd->bshd", x, self.wkv[0].to(dt))
        v = torch.einsum("bse,ehd->bshd", x, self.wkv[1].to(dt))
        return (rope(q, positions, cfg.rope_theta),
                rope(k, positions, cfg.rope_theta), v)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bshd,hde->bse", o, self.wo.to(self.cfg.dtype))

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        q, k, v = self.qkv(x, positions)
        if cfg.attention == "flash":
            o = flash_attention(
                q, k, v, causal=True, segment_ids=segment_ids,
                block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
                block_diag=cfg.flash_block_diag)
        else:
            o = dot_product_attention(q, k, v, causal=True,
                                      segment_ids=segment_ids)
        return self.out(o)


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.wi = _param((2, cfg.d_model, cfg.d_ff), generator, device)
        self.wo = _param((cfg.d_ff, cfg.d_model), generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        gate = torch.einsum("bse,ef->bsf", x, self.wi[0].to(dt))
        up = torch.einsum("bse,ef->bsf", x, self.wi[1].to(dt))
        return torch.einsum("bsf,fe->bse", F.silu(gate) * up,
                            self.wo.to(dt))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, generator, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.mlp = MLP(cfg, generator, device)

    def forward(self, x, positions, segment_ids=None):
        x = x + self.attn(self.attn_norm(x), positions, segment_ids)
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """LM: token ids [b, s] -> logits [b, s, vocab] (float32 unless
    ``ce_dtype="compute"``).

    Parameters are drawn with the JAX package's init scales from
    ``generator`` (lecun-normal kernels, normal(0.02) embedding, unit
    norm scales) on ``device``: CUDA when none is given (an error without
    a GPU), ``"cpu"`` when asked.  ``device="meta"`` allocates nothing,
    for a model whose weights are loaded afterwards (models/convert.py
    load_params).
    """

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        reason = _unsupported(cfg)
        if reason is not None:
            raise NotPortedError(f"not ported yet: {reason}")
        if device is None or torch.device(device).type != "meta":
            device = resolve_device(device)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), generator, device,
                            init="embed")
        self.layers = nn.ModuleList(
            Block(cfg, generator, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.w_out = None
        if not cfg.tied_embeddings:
            self.w_out = _param((cfg.d_model, cfg.vocab_size), generator,
                                device)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and unembed of hidden states [b, s, e]."""
        cfg = self.cfg
        x = self.final_norm(x)
        if cfg.tied_embeddings:
            logits = torch.einsum("bse,ve->bsv", x, self.embed.to(cfg.dtype))
        else:
            logits = torch.einsum("bse,ev->bsv", x, self.w_out.to(cfg.dtype))
        return logits.to(torch.float32) if cfg.ce_dtype == "f32" else logits

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = self.embed_tokens(tokens)
        for block in self.layers:
            x = block(x, positions, segment_ids)
        return self.logits(x)
