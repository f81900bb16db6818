"""Autoregressive decoding: the port of kubeflow_tpu/models/generate.py.

The contiguous-cache path that ``generate()`` runs: the prompt is
prefilled in one batched forward, then tokens stream one position at a
time against a preallocated ``[layers, b, max_len, hkv, d]`` KV cache,
which this port updates in place.  A flash-configured model prefills
through the flash forward (ops/flash.py) with the per-row key-start mask
for left-padded prompts; decode steps take ``dot_product_attention`` over
the cache's live columns.  Sampling draws from an explicit
``torch.Generator``.

Not ported yet (ROADMAP queue 1, item 2): the paged block
pool, per-row cache lengths, the slot programs, adapters and the int8 KV
cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models.transformer import (
    Block,
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.flash import flash_attention


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0   # 0 = greedy
    # Filters applied in this order when temperature > 0: top_k keeps the
    # k highest logits (0 = off), top_p the smallest set whose mass
    # reaches p (1.0 = off).
    top_k: int = 0
    top_p: float = 1.0
    eos_token: int = -1        # -1 = never stop early
    kv_cache_dtype: str = "model"

    def __post_init__(self):
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p} "
                "(1.0 disables nucleus filtering)")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.kv_cache_dtype != "model":
            raise NotPortedError(
                f"kv_cache_dtype={self.kv_cache_dtype!r}: the int8 KV cache "
                "is not ported yet (ROADMAP queue 1 item 2)")


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (k, v) caches, each [L, b, max_len, hkv, d], on ``device``
    (CUDA when none is given)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _layer_step(cfg: TransformerConfig, block: Block, x: torch.Tensor,
                cache_kv: Tuple[torch.Tensor, torch.Tensor], cache_len: int,
                positions: torch.Tensor,
                pad_amount: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder block against one layer's cache.

    x: [b, t, e] new activations (t = prompt width at prefill, 1 at
    decode); cache_kv: (k, v) each [b, max_len, hkv, d], written in place
    at columns [cache_len, cache_len + t); pad_amount: per-row [b]
    left-pad width, whose cache columns are masked from every attention.
    """
    ck, cv = cache_kv
    t = x.shape[1]
    q, k, v = block.attn.qkv(block.attn_norm(x), positions)
    ck[:, cache_len:cache_len + t] = k
    cv[:, cache_len:cache_len + t] = v
    if cfg.attention == "flash" and t > 1 and cache_len == 0:
        # Prefill: the cache is empty, so causal attention over the fresh
        # q/k/v is the whole computation, and the flash forward keeps the
        # [b, h, t, t] scores out of device memory.
        out = flash_attention(
            q, k, v, causal=True,
            block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
            kv_valid_start=pad_amount)
    else:
        # Columns past cache_len + t hold nothing yet and would get zero
        # weight under the causal mask; attending over the live span only
        # gives the same result.
        live = cache_len + t
        out = dot_product_attention(
            q, ck[:, :live], cv[:, :live], causal=True, kv_offset=cache_len,
            kv_valid_start=pad_amount)
    x = x + block.attn.out(out)
    return x + block.mlp(block.mlp_norm(x))


def _forward_with_cache(model: Transformer, tokens: torch.Tensor,
                        cache: Tuple[torch.Tensor, torch.Tensor],
                        cache_len: int,
                        pad_amount: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """tokens [b, t] -> float32 logits [b, t, v]; the cache is updated in
    place at columns [cache_len, cache_len + t)."""
    positions = cache_len + torch.arange(
        tokens.shape[1], device=tokens.device)[None, :]
    positions = positions.expand(tokens.shape)
    if pad_amount is not None:
        # Real token i of a left-padded row sits at column pad + i but
        # takes rope position i; pad columns clamp to 0 (their keys are
        # masked anyway).
        positions = torch.clamp(positions - pad_amount[:, None], min=0)
    x = model.embed_tokens(tokens)
    cache_k, cache_v = cache
    for i, block in enumerate(model.layers):
        x = _layer_step(model.cfg, block, x, (cache_k[i], cache_v[i]),
                        cache_len, positions, pad_amount)
    return model.logits(x).to(torch.float32)


def _filter_logits(decode: DecodeConfig, logits: torch.Tensor) -> torch.Tensor:
    """Temperature, then top_k, then top_p filtering of [..., vocab]."""
    logits = logits / decode.temperature
    if decode.top_k > 0:
        k = min(decode.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, -torch.inf))
    if decode.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # Keep every token whose PRECEDING mass is < p, so the token that
        # crosses p stays in; threshold at the smallest kept logit.
        keep = torch.cumsum(probs, dim=-1) - probs < decode.top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, torch.inf)
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits,
                             torch.full_like(logits, -torch.inf))
    return logits


def _sample(decode: DecodeConfig, logits: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if decode.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(decode, logits), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(
    model: Transformer,
    prompt: torch.Tensor,
    decode: DecodeConfig = DecodeConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    prompt_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """prompt [b, t] -> (tokens [b, t + max_new], logits_last [b, vocab]).

    Runs on the model's device.  With ``eos_token >= 0`` the step loop
    stops once every row is done; finished rows emit 0, so the tokens
    equal those of the full-length run.  Sampling (temperature > 0) draws
    from ``generator``, which must live on the model's device; the same
    seed gives the same tokens.

    prompt_len ([b], optional): real prompt lengths of LEFT-padded rows.
    Pad keys are masked from every attention and rope positions count
    from the first real token, so a padded row decodes as it would alone.
    """
    cfg = model.cfg
    device = model.embed.device
    prompt = prompt.to(device)
    b, t = prompt.shape
    cache = init_cache(cfg, b, t + decode.max_new_tokens, device=device)
    pad_amount = None
    if prompt_len is not None:
        pad_amount = t - prompt_len.to(device, torch.int64)

    last = _forward_with_cache(model, prompt, cache, 0, pad_amount)[:, -1]
    new_tokens = torch.zeros((b, decode.max_new_tokens), dtype=prompt.dtype,
                             device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    for i in range(decode.max_new_tokens):
        nxt = _sample(decode, last, generator).to(prompt.dtype)
        nxt = torch.where(done, torch.zeros_like(nxt), nxt)
        new_tokens[:, i] = nxt
        last = _forward_with_cache(model, nxt[:, None], cache, t + i,
                                   pad_amount)[:, -1]
        done = done | (nxt == decode.eos_token)
        if decode.eos_token >= 0 and bool(done.all()):
            break
    return torch.cat([prompt, new_tokens], dim=1), last
