"""Decoder-only Transformer LM: the port of kubeflow_tpu/models/transformer.py.

RoPE (split halves, float32 angles), RMSNorm (float32 math and scale),
grouped-query attention and a SwiGLU MLP, with tied or untied unembed and
float32 logits.  Parameters keep the JAX package's layout and names
(``wq [e,h,d]``, ``wkv [2,e,hkv,d]``, ``wo [h,d,e]``, ``wi [2,e,f]``,
``mlp.wo [f,e]``), one ``Block`` per layer in ``layers``; the weight bridge
(models/convert.py) maps them to and from the JAX tree, whose layer leaves
are stacked ``[L, ...]``.

Dense path only.  MoE, pipeline microbatching, ring attention and dropout
raise ``NotPortedError`` until their slices of the port land (ROADMAP
queue 1, items 10, 11 and 13).  ``flash_block_diag > 0`` selects the
two-pass causal flash forward (ops/flash.py).

Remat (``cfg.remat``) checkpoints each block with ``torch.utils.checkpoint``
under the JAX package's policies (``_remat_policy``).  With flash attention
and ``save_attn_residuals`` the attention call sits between two
checkpointed regions (norm + qkv + rope before it; the output projection
and the MLP after it), so its (o, lse) residuals are kept and the forward
kernel runs once per layer per step, as JAX's ``checkpoint_name`` tags
arrange.  ``lm_task`` is the next-token cross-entropy task for the
trainer (runtime/train.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.flash import flash_attention
from kubeflow_tpu_torch.ops.quantize import embed_lookup, qeinsum


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
    # The two-pass forward's split (flash_block_diag > 0): keys before
    # each row's boundary at (flash_block_q, flash_block_k), then the
    # diagonal band.  The single-pass kernels pick their own tiles.
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

    def flops_per_token(self) -> float:
        """Forward useful FLOPs per token (2*params matmul convention +
        attention term) - the MFU numerator, bwd counted as 2x by caller."""
        p_attn = self.d_model * self.head_dim * (
            self.n_heads + 2 * self.n_kv_heads
        ) + self.n_heads * self.head_dim * self.d_model
        p_mlp = 3 * self.d_model * self.d_ff
        if self.moe_experts > 0:
            # Useful MLP flops per token = the top_k experts it routes to
            # plus the router matmul; idle experts' weights are not work.
            p_mlp = self.moe_top_k * p_mlp \
                + self.d_model * self.moe_experts
        p_embed = self.vocab_size * self.d_model
        matmul = 2 * (self.n_layers * (p_attn + p_mlp) + p_embed)
        attn = 2 * 2 * self.n_layers * self.n_heads * self.head_dim \
            * self.max_seq_len  # qk^T + av, causal halving ignored
        return float(matmul + attn)


def _unsupported(cfg: TransformerConfig) -> Optional[str]:
    if cfg.moe_experts > 0:
        return "moe_experts > 0 (MoE, ROADMAP queue 1 item 13)"
    if cfg.pipeline_microbatches > 0:
        return "pipeline_microbatches > 0 (parallel training, ROADMAP queue 1 item 11)"
    if cfg.attention == "ring":
        return "attention='ring' (parallel training, ROADMAP queue 1 item 11)"
    if cfg.dropout_rate > 0:
        return "dropout_rate > 0 (training slice, ROADMAP queue 1 item 10)"
    return None


def _no_batch_dims(op, args) -> bool:
    """An einsum of a weight (a "bse,ehd" projection) reaches aten as mm or
    as a bmm over a batch of 1; attention scores are a bmm over b*h."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return True
    return op is torch.ops.aten.bmm.default and args[0].shape[0] == 1


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# What each policy saves; everything else is recomputed in the backward.
# The counterparts of jax.checkpoint_policies: "nobatch" =
# dots_with_no_batch_dims_saveable (the weight projections), "dots" =
# dots_saveable (every matmul), "minimal" = nothing_saveable.
_POLICIES: Dict[str, Optional[Callable]] = {
    "nobatch": _no_batch_dims,
    "dots": lambda op, args: op in _MATMULS,
    "minimal": None,
}


def _remat_policy(cfg: TransformerConfig):
    """``torch.utils.checkpoint`` keyword arguments for one decoder block
    under remat: a selective-checkpoint context that saves what the
    policy names (none for "minimal")."""
    if cfg.remat_policy not in _POLICIES:
        raise ValueError(
            f"remat_policy={cfg.remat_policy!r} not in "
            f"{sorted(_POLICIES)}")
    saves = _POLICIES[cfg.remat_policy]
    kwargs = {"use_reentrant": False}
    if saves is not None:
        def policy(ctx, op, *args, **kw):
            return (CheckpointPolicy.MUST_SAVE if saves(op, args)
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return kwargs


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

    def project(self, x: torch.Tensor):
        """Projections of x [b, s, e] before rope: q [b,s,h,d], k and v
        [b,s,hkv,d], all in the compute dtype."""
        dt = self.cfg.dtype
        return (qeinsum("bse,ehd->bshd", x, self.wq, dt),
                qeinsum("bse,ehd->bshd", x, self.wkv[0], dt),
                qeinsum("bse,ehd->bshd", x, self.wkv[1], dt))

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projections of x [b, s, e] -> roped q [b,s,h,d], roped k and
        plain v [b,s,hkv,d], all in the compute dtype."""
        q, k, v = self.project(x)
        theta = self.cfg.rope_theta
        return rope(q, positions, theta), rope(k, positions, theta), v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return qeinsum("bshd,hde->bse", o, self.wo, self.cfg.dtype)

    def attend(self, q, k, v, segment_ids=None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.attention == "flash":
            return flash_attention(
                q, k, v, causal=True, segment_ids=segment_ids,
                block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
                block_diag=cfg.flash_block_diag)
        return dot_product_attention(q, k, v, causal=True,
                                     segment_ids=segment_ids)

    def forward(self, x, positions, segment_ids=None):
        q, k, v = self.qkv(x, positions)
        return self.out(self.attend(q, k, v, segment_ids))


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.wi = _param((2, cfg.d_model, cfg.d_ff), generator, device)
        self.wo = _param((cfg.d_ff, cfg.d_model), generator, device)

    def gate_up(self, x: torch.Tensor):
        """The gate and up projections of x [b, s, e], each [b, s, f]."""
        dt = self.cfg.dtype
        return (qeinsum("bse,ef->bsf", x, self.wi[0], dt),
                qeinsum("bse,ef->bsf", x, self.wi[1], dt))

    def down(self, h: torch.Tensor) -> torch.Tensor:
        return qeinsum("bsf,fe->bse", h, self.wo, self.cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up(x)
        return self.down(F.silu(gate) * up)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, generator, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.mlp = MLP(cfg, generator, device)

    def _qkv(self, x, positions):
        return self.attn.qkv(self.attn_norm(x), positions)

    def _out_and_mlp(self, x, o):
        x = x + self.attn.out(o)
        return x + self.mlp(self.mlp_norm(x))

    def _block(self, x, positions, segment_ids):
        q, k, v = self._qkv(x, positions)
        return self._out_and_mlp(x, self.attn.attend(q, k, v, segment_ids))

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return self._block(x, positions, segment_ids)
        kwargs = _remat_policy(cfg)
        if (cfg.attention == "flash" and cfg.save_attn_residuals
                and segment_ids is None):
            # The flash call stays outside both checkpointed regions: its
            # saved (q, k, v, o, lse) are the residuals its backward
            # kernels need, so the forward kernel is not re-run.
            q, k, v = checkpoint(self._qkv, x, positions, **kwargs)
            o = self.attn.attend(q, k, v)
            return checkpoint(self._out_and_mlp, x, o, **kwargs)
        return checkpoint(self._block, x, positions, segment_ids, **kwargs)


class Transformer(nn.Module):
    """LM: token ids [b, s] -> logits [b, s, vocab] (float32 unless
    ``ce_dtype="compute"``).

    With ``return_hidden=True`` the unembed projection is skipped and the
    call returns ``(hidden [b, s, d], unembed [v, d] or [d, v])`` in the
    compute dtype instead: the chunked-CE contract (lm_task,
    ``cfg.ce_chunk > 0``).

    Parameters are drawn with the JAX package's init scales from
    ``generator`` (lecun-normal kernels, normal(0.02) embedding, unit
    norm scales) on ``device``: CUDA when none is given (an error without
    a GPU), ``"cpu"`` when asked.  ``device="meta"`` allocates nothing,
    for a model whose weights are loaded afterwards (models/convert.py
    load_params).  A served model's matmul weights may be int8
    ``QTensor``s (ops/quantize.py) in place of parameters; the forward
    takes them through ``qeinsum`` and ``embed_lookup``.
    """

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        reason = _unsupported(cfg)
        if reason is not None:
            raise NotPortedError(f"not ported yet: {reason}")
        if cfg.remat:
            _remat_policy(cfg)  # an unknown policy fails here, not mid-step
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
        return embed_lookup(self.embed, tokens, self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and unembed of hidden states [b, s, e]."""
        cfg = self.cfg
        x = self.final_norm(x)
        if cfg.tied_embeddings:
            logits = qeinsum("bse,ve->bsv", x, self.embed, cfg.dtype)
        else:
            logits = qeinsum("bse,ev->bsv", x, self.w_out, cfg.dtype)
        return logits.to(torch.float32) if cfg.ce_dtype == "f32" else logits

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                return_hidden: bool = False):
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = self.embed_tokens(tokens)
        for block in self.layers:
            x = block(x, positions, segment_ids)
        if return_hidden:
            unembed = self.embed if self.w_out is None else self.w_out
            return self.final_norm(x), unembed.to(self.cfg.dtype)
        return self.logits(x)


def fit_divisor(n: int, limit: int, label: str, consequence: str) -> int:
    """Largest divisor of ``n`` <= ``limit`` (the JAX package's
    models/moe.py ``fit_divisor``, copied: the chunked-CE tiling fit).

    Below limit//4 a warning names the ``label`` and its
    ``consequence`` so the config is fixed rather than silently paid
    every step."""
    want = min(limit, n)
    got = next(c for c in range(want, 0, -1) if n % c == 0)
    if got < want // 4:
        warnings.warn(
            f"{label} degenerated: {n} has no divisor near {limit} "
            f"(fitted {got}).  {consequence}",
            stacklevel=3,
        )
    return got


def lm_task(cfg: TransformerConfig, device=None,
            generator: Optional[torch.Generator] = None):
    """(init_fn, loss_fn) pair for the trainer: next-token cross-entropy.

    ``init_fn(generator=None) -> (model, mutable)`` builds a
    ``Transformer`` on ``device`` (CUDA when none is given) with weights
    drawn from ``generator`` (or the one given here).
    ``loss_fn(model, mutable, batch, rng) -> (loss, (metrics, mutable))``
    takes ``{"tokens": [b, s] int}`` and predicts tokens[1:]; the loss is
    the mean over the b * (s - 1) predicted positions.
    """

    def init_fn(gen: Optional[torch.Generator] = None):
        model = Transformer(cfg, device=device,
                            generator=generator if gen is None else gen)
        return model, {}

    def ce_per_position(lg: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """Per-position CE [*, n] from logits [*, n, v], honoring
        cfg.ce_dtype (shared by the unchunked and chunked paths)."""
        tgt = tgt.long()
        if cfg.ce_dtype == "f32":
            return F.cross_entropy(
                lg.float().flatten(0, -2), tgt.flatten(),
                reduction="none").view(tgt.shape)
        # max / logsumexp / gather on compute-dtype logits with float32
        # reductions, m held constant as JAX's stop_gradient does.  (Eager
        # PyTorch materializes the float32 upcast; JAX fuses it away.)
        m = lg.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(lg.float() - m.float()).sum(-1)) \
            + m[..., 0].float()
        target = lg.gather(-1, tgt[..., None])[..., 0].float()
        return lse - target

    def chunked_ce(hidden, unembed, tokens):
        """Mean next-token CE without materializing [b, s, vocab]:
        unembed + loss run `chunk` positions at a time, each chunk under
        torch.utils.checkpoint (the backward recomputes its logits).  The
        final position has no target; a zero weight masks it so chunks
        tile all s positions whatever the divisors of s - 1."""
        b, s = tokens.shape
        chunk = fit_divisor(
            s, cfg.ce_chunk, "ce_chunk",
            "The chunked CE collapses toward an s-iteration loop of "
            "single-position unembeds (looks like a hang).  Choose a "
            "sequence length with a divisor close to ce_chunk.")
        targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
        weights = torch.cat(
            [torch.ones((b, s - 1), dtype=torch.float32,
                        device=tokens.device),
             torch.zeros((b, 1), dtype=torch.float32, device=tokens.device)],
            dim=1)
        spec = "bce,ve->bcv" if cfg.tied_embeddings else "bce,ev->bcv"

        def body(hc, tc, wc, w):
            lg = torch.einsum(spec, hc, w)
            return torch.sum(ce_per_position(lg, tc) * wc)

        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(0, s, chunk):
            part = slice(i, i + chunk)
            total = total + checkpoint(
                body, hidden[:, part], targets[:, part], weights[:, part],
                unembed, use_reentrant=False)
        return total / (b * (s - 1))

    def loss_fn(model: Transformer, mutable, batch, rng
                ) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], dict]]:
        del mutable, rng  # no mutable collections; dropout is not ported
        tokens = batch["tokens"]
        if cfg.ce_chunk > 0:
            hidden, unembed = model(tokens, return_hidden=True)
            loss = chunked_ce(hidden, unembed, tokens)
        else:
            logits = model(tokens)
            loss = ce_per_position(logits[:, :-1], tokens[:, 1:]).mean()
        return loss, ({"perplexity": torch.exp(loss.detach())}, {})

    return init_fn, loss_fn
