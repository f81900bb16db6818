"""Decoder-only Transformer LM: the port of kubeflow_tpu/models/transformer.py.

RoPE (split halves, float32 angles), RMSNorm (float32 math and scale),
grouped-query attention and a SwiGLU MLP, with tied or untied unembed and
float32 logits.  Parameters keep the JAX package's layout and names
(``wq [e,h,d]``, ``wkv [2,e,hkv,d]``, ``wo [h,d,e]``, ``wi [2,e,f]``,
``mlp.wo [f,e]``), one ``Block`` per layer in ``layers``; the weight bridge
(models/convert.py) maps them to and from the JAX tree, whose layer leaves
are stacked ``[L, ...]``.

``moe_experts > 0`` puts the mixture-of-experts MLP (models/moe.py) in
each block in place of the dense one; the forward sums its per-layer aux
loss (``return_aux=True``).  ``dropout_rate > 0`` drops the attention
output and the MLP output of every block in a forward with
``deterministic=False``, with masks drawn from the forward's explicit
``generator``, two per layer, before the layer runs: the checkpointed
regions take them as inputs, so a recompute under remat applies the same
masks (``torch.utils.checkpoint`` restores only the default generators).
``flash_block_diag > 0`` selects the two-pass causal flash forward
(ops/flash.py).

Under a mesh (``Transformer(cfg, mesh=...)``, a ``DeviceMesh`` from
parallel/mesh.py) each rank runs the model on its local shard of the
batch and, with ``sequence`` above 1, of the sequence: ``attention=
"ring"`` is ring attention over the ``sequence`` group
(parallel/ring.py, which requires a mesh, as in JAX), ``"flash"`` is
``make_sharded_flash``, and RoPE positions are global (rank r of the
sequence group starts at r * s_local).  ``lm_task(cfg, mesh=...)``'s
targets and loss are the global sequence's (see its docstring).  Under
a mesh dropout draws each mask at the global ``[B, S, E]`` shape from
the step's generator, seeded alike on every rank, and each rank keeps
its rows and positions (``rank_dropout_mask``): the masks are those of
one device on the global batch, and every rank of a ``tensor`` group
keeps the same one.

With ``tensor`` above 1 (parallel/tensor.py) the model is split as the
rule table (parallel/mesh.py ``DEFAULT_RULES``) places the JAX model's
logical axes: each rank draws the whole weights from the generator, as
one device does, and keeps its slice of the ``heads`` dim of ``wq``,
``wkv`` and ``wo``, of the ``mlp`` dim of ``wi`` and the MLP's ``wo``,
and of the ``vocab`` dim of ``embed`` and ``w_out`` (marked with their
``TensorShard``).  The attention and MLP are Megatron's column/row
pairs: ``copy_to_parallel`` on the input of ``wq``/``wkv`` and of
``wi``, ``reduce_from_parallel`` at the end of ``Attention.out`` and
``MLP.down``, before dropout and the residual add.  The embedding is a
vocab-parallel lookup, and the logits are the rank's vocab slice, which
``lm_task``'s vocab-parallel cross-entropy takes without gathering them.
Every rank runs its local heads through the flash kernels (or the ring),
with ``n_heads / n_kv_heads`` kept per rank.  A served model
(``replicate_indivisible=True``, serving/sharding.py) keeps whole any
dim that does not divide ``tensor``, as JAX's serving rules replicate
it: an attention or MLP whose dim stays whole runs whole on every rank
with no reduce, and with fewer kv heads than ranks each rank's q heads
read their own kv heads (``Attention.local_kv``).  ``out_local`` and
``down_local`` are the partial sums before the reduce, to which decode
adds the row-parallel adapter deltas (models/generate.py).

With ``pipeline`` above 1 (parallel/pipeline.py, GPipe) each rank draws
the whole weights from the generator, as one device does, and keeps its
stage's ``n_layers / pipeline`` blocks: stage p holds layers [p L/S,
(p + 1) L/S) as its ``layers.0 ...``, and ``stage`` (a ``Stage``, also
marked on each of their parameters) maps them to the global stack for
``param_logical_axes``' callers, the weight bridge and checkpoints.  The
embedding, final norm and unembed are whole on every stage, as in JAX.
The forward embeds the tokens on every stage, runs ``pipelined_scan``
over the local blocks with ``cfg.pipeline_microbatches`` microbatches of
the local batch (one when it is 0: the stages run one after another),
and returns the same logits on every stage.  Remat, ring attention over
the stage's ``sequence`` group, ``tensor`` > 1 and the two-pass forward
run inside the stage's blocks as without a pipeline; under FSDP2 each
block reduces its gradient once a step, after the last microbatch's
backward.  Dropout (at 0 microbatches only, as in JAX) draws every
layer's masks in layer order, as one device does, and keeps the stage's.

The MoE LM trains under every axis (models/moe.py's module docstring has
the layer's side).  With ``expert`` above 1 each rank keeps the experts
[r E/N, (r + 1) E/N) of every ``moe.wi`` and ``moe.wo`` (and, with
``tensor`` above 1, its slice of their mlp dim), marked with a chained
``TensorShard``; the router stays whole.  The ranks of an expert group
hold the same rows, as those of a tensor group do.  The routing group is
fitted to the tokens of one routing call over the whole mesh (the
global batch; under a pipeline a microbatch over data x fsdp, each
sequence shard routing its own, as JAX's schedule is manual over
``sequence``), in JAX's order of those tokens, whichever ranks hold
them: a group that spans ranks takes its slot positions from the counts
of the ranks before (models/moe.py ``_Spanning``).  The aux loss is the
global one: its statistics are summed
over the ranks of other rows and positions, and under a pipeline the
stages' sum (``pipelined_scan``'s ``with_aux``) is divided by the
microbatches and averaged over the sequence shards, as JAX's is.

Under pipeline x data (or fsdp) with M > 1 microbatches, JAX's
microbatch m is the global rows [m B/M, (m + 1) B/M), spread over the D
= data x fsdp ranks of a stage.  ``lm_task`` therefore exchanges the
batch's rows among those ranks before the model (``microbatch_rows``,
``to_microbatch_order``: the integer tokens, all-gathered over the group
``group_over(mesh, (DATA, FSDP))``, staged through host memory on
gloo): rank r's local microbatch m is then global rows m B/M + r B/(M D)
+ [0, B/(M D)), its share of JAX's microbatch m, and the MoE aux, a
product of each microbatch's means, and its routing groups follow JAX's
microbatches on the same global batch.  The targets are taken from the
exchanged tokens, and a dropout mask keeps the rows the rank holds
(``rank_dropout_mask``'s ``n_micro``).

Remat (``cfg.remat``) checkpoints each block with ``torch.utils.checkpoint``
under the JAX package's policies (``_remat_policy``).  With flash attention
and ``save_attn_residuals`` the attention call sits between two
checkpointed regions (norm + qkv + rope before it; the output projection
and the MLP after it), so its (o, lse) residuals are kept and the forward
kernel runs once per layer per step, as JAX's ``checkpoint_name`` tags
arrange.  Every checkpointed region (and the chunked CE's) goes through
``runtime/member_map.py``'s ``checkpoint``, naming the module whose
parameters it reads: on the solo path that is ``torch.utils.checkpoint``;
under the fused trainer's member map (runtime/hfta.py) the region wraps
the map, and the dropout masks come from each member's own generator.
``lm_task`` is the next-token cross-entropy task for the trainer
(runtime/train.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.moe import (
    MoEMLP,
    Spread,
    default_group_size,
    fit_divisor,
)
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.flash import flash_attention, make_sharded_flash
from kubeflow_tpu_torch.ops.quantize import QTensor, embed_lookup, qeinsum
from kubeflow_tpu_torch.parallel.ring import (
    from_next_rank,
    make_ring_attention,
)
from kubeflow_tpu_torch.parallel import p2p
from kubeflow_tpu_torch.parallel import tensor as tp
from kubeflow_tpu_torch.parallel.mesh import (
    DATA,
    EXPERT,
    FSDP,
    PIPELINE,
    SEQUENCE,
    TENSOR,
    axis_sizes,
    batch_group,
    expert_shard,
    group_over,
    pipeline_stage,
    row_shard,
    sharded_dim,
    tensor_shard,
)
from kubeflow_tpu_torch.parallel.pipeline import (
    Stage,
    microbatch,
    pipelined_scan,
    unmicrobatch,
)
from kubeflow_tpu_torch.runtime import member_map


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
    # "dot" (materialized scores), "flash" (ops/flash.py) or "ring"
    # (parallel/ring.py; needs a mesh).
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

    def resolved_moe_group_size(self) -> int:
        """The MoE routing group: ``moe_group_size``, or the impl's
        default (models/moe.py ``default_group_size``) when it is 0."""
        return self.moe_group_size or default_group_size(self.moe_impl)

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


def _stage(cfg: TransformerConfig, mesh) -> Optional[Stage]:
    """This rank's pipeline ``Stage`` of the layer stack, or None when the
    mesh has no ``pipeline`` axis above 1."""
    index, count = pipeline_stage(mesh)
    if count == 1:
        return None
    if cfg.n_layers % count:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pipeline={count} stages")
    return Stage(index, count, cfg.n_layers // count,
                 mesh.get_group(PIPELINE))


def _sequence_shard(mesh) -> Tuple[int, int]:
    """(this rank's index, size) along the ``sequence`` axis; (0, 1)
    without a mesh."""
    if mesh is None or axis_sizes(mesh)[SEQUENCE] == 1:
        return 0, 1
    return mesh.get_local_rank(SEQUENCE), axis_sizes(mesh)[SEQUENCE]


def _vocab_split(mesh, vocab_size: int):
    """(first vocab id, ``tensor`` group) of this rank's vocab slice when
    the rule table splits ``vocab`` over ``tensor`` > 1 (and the vocab
    divides it), else None."""
    index, count = tensor_shard(mesh)
    if (count == 1 or sharded_dim(("vocab",), TENSOR) is None
            or vocab_size % count):
        return None
    return index * (vocab_size // count), mesh.get_group(TENSOR)


def _no_batch_dims(op, args, members: int = 1) -> bool:
    """An einsum of a weight (a "bse,ehd" projection) reaches aten as mm or
    as a bmm over a batch of 1; attention scores are a bmm over b*h.
    Under the fused trainer's member map (runtime/member_map.py) the
    region runs on stacked members, and a projection is a bmm over the
    ``members``: it still counts as one without batch dims, as a member's
    own dots do in JAX, where vmap lifts the step after its gradient
    (and so its remat policy) is formed."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return True
    return op is torch.ops.aten.bmm.default and args[0].shape[0] == members


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# What each policy saves; everything else is recomputed in the backward.
# The counterparts of jax.checkpoint_policies: "nobatch" =
# dots_with_no_batch_dims_saveable (the weight projections), "dots" =
# dots_saveable (every matmul), "minimal" = nothing_saveable.
_POLICIES: Dict[str, Optional[Callable]] = {
    "nobatch": _no_batch_dims,
    "dots": lambda op, args, members: op in _MATMULS,
    "minimal": None,
}


def _remat_policy(cfg: TransformerConfig, members: int = 1):
    """``torch.utils.checkpoint`` keyword arguments for one decoder block
    under remat: a selective-checkpoint context that saves what the
    policy names (none for "minimal").  ``members``: the stacked members
    the region runs on (runtime/member_map.py), 1 on the solo path."""
    if cfg.remat_policy not in _POLICIES:
        raise ValueError(
            f"remat_policy={cfg.remat_policy!r} not in "
            f"{sorted(_POLICIES)}")
    saves = _POLICIES[cfg.remat_policy]
    kwargs = {"use_reentrant": False}
    if saves is not None:
        def policy(ctx, op, *args, **kw):
            return (CheckpointPolicy.MUST_SAVE if saves(op, args, members)
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
    def __init__(self, cfg: TransformerConfig, generator=None, device=None,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        e, h, hkv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _param((e, h, d), generator, device)
        self.wkv = _param((2, e, hkv, d), generator, device)
        self.wo = _param((h, d, e), generator, device)
        # The tensor group when the heads are split over it (Transformer
        # sets it), None otherwise.
        self.group = None
        # The global kv head of each local q head when the q heads are
        # split over ``tensor`` but the kv heads, fewer than the ranks,
        # are whole on every rank (a served model; None otherwise).
        self.kv_heads: Optional[torch.Tensor] = None
        # The mesh's attention (JAX's Attention._attend under a mesh).
        self._sharded = None
        if cfg.attention == "ring":
            self._sharded = make_ring_attention(mesh, causal=True)
        elif cfg.attention == "flash" and mesh is not None:
            self._sharded = make_sharded_flash(
                mesh, causal=True, block_q=cfg.flash_block_q,
                block_k=cfg.flash_block_k, block_diag=cfg.flash_block_diag)

    def project(self, x: torch.Tensor):
        """Projections of x [b, s, e] before rope: q [b,s,h,d], k and v
        [b,s,hkv,d], all in the compute dtype (this rank's heads when they
        are split over ``tensor``)."""
        dt = self.cfg.dtype
        x = tp.copy_to_parallel(x, self.group)
        return (qeinsum("bse,ehd->bshd", x, self.wq, dt),
                qeinsum("bse,ehd->bshd", x, self.wkv[0], dt),
                qeinsum("bse,ehd->bshd", x, self.wkv[1], dt))

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projections of x [b, s, e] -> roped q [b,s,h,d], roped k and
        plain v [b,s,hkv,d], all in the compute dtype."""
        q, k, v = self.project(x)
        theta = self.cfg.rope_theta
        return rope(q, positions, theta), rope(k, positions, theta), v

    def out_local(self, o: torch.Tensor) -> torch.Tensor:
        """This rank's partial output projection (its heads' share of the
        sum that ``out`` reduces over the tensor group)."""
        return qeinsum("bshd,hde->bse", o, self.wo, self.cfg.dtype)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return tp.reduce_from_parallel(self.out_local(o), self.group)

    def local_kv(self, kv):
        """k or v ``[b, s, hkv, d]`` (a tensor or an int8 ``QTensor``) as
        the local q heads read it: itself, or, when the kv heads are whole
        and the q heads split (``kv_heads``), one kv head per local q
        head."""
        if self.kv_heads is None:
            return kv
        if isinstance(kv, QTensor):
            return QTensor(self.local_kv(kv.values), self.local_kv(kv.scale),
                           kv.axes)
        if self.kv_heads.device != kv.device:
            self.kv_heads = self.kv_heads.to(kv.device)
        return kv.index_select(2, self.kv_heads)

    def attend(self, q, k, v, segment_ids=None) -> torch.Tensor:
        cfg = self.cfg
        k, v = self.local_kv(k), self.local_kv(v)
        if self._sharded is not None and segment_ids is None:
            return self._sharded(q, k, v)
        if cfg.attention == "ring":
            raise ValueError("ring attention takes no segment_ids")
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
        # The tensor group when the hidden dim is split over it.
        self.group = None

    def gate_up(self, x: torch.Tensor):
        """The gate and up projections of x [b, s, e], each [b, s, f]
        (this rank's slice of f when it is split over ``tensor``)."""
        dt = self.cfg.dtype
        x = tp.copy_to_parallel(x, self.group)
        return (qeinsum("bse,ef->bsf", x, self.wi[0], dt),
                qeinsum("bse,ef->bsf", x, self.wi[1], dt))

    def down_local(self, h: torch.Tensor) -> torch.Tensor:
        """This rank's partial down projection (its hidden units' share
        of the sum that ``down`` reduces over the tensor group)."""
        return qeinsum("bsf,fe->bse", h, self.wo, self.cfg.dtype)

    def down(self, h: torch.Tensor) -> torch.Tensor:
        return tp.reduce_from_parallel(self.down_local(h), self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up(x)
        return self.down(F.silu(gate) * up)


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """flax ``nn.Dropout``'s keep mask: True with probability 1 - rate,
    drawn from ``generator``.  Inside the fused trainer's member map the
    generator is a ``member_map.MemberGenerators``: each member's mask is
    drawn from its own generator outside the map."""
    if isinstance(generator, member_map.MemberGenerators):
        return generator.per_member(
            lambda g: dropout_mask(shape, rate, g, device))
    return torch.rand(shape, generator=generator, device=device) \
        < 1.0 - rate


def rank_dropout_mask(shape, rate: float, generator: torch.Generator,
                      device, mesh, n_micro: int = 0) -> torch.Tensor:
    """This rank's keep mask for activations of local ``shape`` [b, s,
    e]: its rows (``microbatch_rows``: its data x fsdp shard, or under a
    pipeline of ``n_micro`` microbatches its rows of JAX's microbatches)
    and positions (its sequence shard) of the mask ``dropout_mask`` draws
    at the global shape, so the masks of a mesh are those of one device
    on the global batch, and every rank of a ``tensor`` group keeps the
    same one.  Each rank draws the whole global mask (data x fsdp x
    sequence times its own)."""
    _, n_rows = row_shard(mesh)
    pos, n_pos = _sequence_shard(mesh)
    if n_rows * n_pos == 1:
        return dropout_mask(shape, rate, generator, device)
    b, s = shape[0], shape[1]
    keep = dropout_mask((b * n_rows, s * n_pos, *shape[2:]), rate,
                        generator, device)
    rows = microbatch_rows(b, mesh, n_micro).to(keep.device)
    return keep[rows, pos * s:(pos + 1) * s].contiguous()


def _exchanges_rows(mesh, n_micro: int) -> bool:
    """Whether a pipelined stage's batch goes to JAX's microbatch order:
    under ``pipeline`` > 1 with data x fsdp and the microbatches each
    above 1."""
    return (n_micro > 1 and pipeline_stage(mesh)[1] > 1
            and row_shard(mesh)[1] > 1)


def microbatch_rows(b: int, mesh, n_micro: int = 0) -> torch.Tensor:
    """The global row of each of this rank's ``b`` rows: its data x fsdp
    shard r of D, rows [r b, (r + 1) b); under a pipeline of ``n_micro``
    > 1 microbatches (``_exchanges_rows``), its share of each of JAX's
    microbatches, local microbatch m (rows [m b/M, (m + 1) b/M)) holding
    global rows m B/M + r b/M + [0, b/M)."""
    r, count = row_shard(mesh)
    if not _exchanges_rows(mesh, n_micro):
        return torch.arange(r * b, (r + 1) * b)
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by pipeline_microbatches"
                         f"={n_micro}")
    mb = b // n_micro
    return (torch.arange(n_micro)[:, None] * (count * mb) + r * mb
            + torch.arange(mb)[None]).flatten()


def to_microbatch_order(rows: torch.Tensor, mesh, n_micro: int
                        ) -> torch.Tensor:
    """This rank's ``rows`` [b, ...] of the global batch (its contiguous
    data x fsdp shard) exchanged for its rows of JAX's microbatches
    (``microbatch_rows``): the ranks of other rows at this stage, tensor,
    expert and sequence index all-gather theirs (integers, no gradient;
    staged through host memory on gloo) and each keeps its own.  ``rows``
    itself where no exchange applies."""
    if not _exchanges_rows(mesh, n_micro):
        return rows
    every = p2p.all_gather(rows, group_over(mesh, (DATA, FSDP)))
    whole = every.reshape(-1, *rows.shape[1:])
    return whole[microbatch_rows(rows.shape[0], mesh, n_micro).to(
        whole.device)]


def _dropped(y: torch.Tensor, keep: torch.Tensor, rate: float
             ) -> torch.Tensor:
    """flax's dropout with the mask given: kept entries scaled by
    1 / (1 - rate), the rest zero."""
    return torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))


class Block(nn.Module):
    """One decoder block: ``forward(x, positions, segment_ids=None,
    masks=None) -> (x, aux)``.  ``aux`` is the MoE layer's load-balancing
    loss (None for the dense MLP); ``masks`` are the two dropout keep
    masks (attention output, MLP output) or None."""

    def __init__(self, cfg: TransformerConfig, generator=None, device=None,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, generator, device, mesh)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(
                cfg.d_model, cfg.d_ff, cfg.moe_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor,
                group_size=cfg.resolved_moe_group_size(), dtype=cfg.dtype,
                impl=cfg.moe_impl, generator=generator, device=device)
        else:
            self.mlp = MLP(cfg, generator, device)

    def _qkv(self, x, positions):
        return self.attn.qkv(self.attn_norm(x), positions)

    def _out_and_mlp(self, x, o, masks=None):
        rate = self.cfg.dropout_rate
        y = self.attn.out(o)
        if masks is not None:
            y = _dropped(y, masks[0], rate)
        x = x + y
        aux = None
        if self.cfg.moe_experts > 0:
            y, aux = self.moe(self.mlp_norm(x))
        else:
            y = self.mlp(self.mlp_norm(x))
        if masks is not None:
            y = _dropped(y, masks[1], rate)
        return x + y, aux

    def _block(self, x, positions, segment_ids, masks=None):
        q, k, v = self._qkv(x, positions)
        return self._out_and_mlp(x, self.attn.attend(q, k, v, segment_ids),
                                 masks)

    def forward(self, x, positions, segment_ids=None, masks=None):
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return self._block(x, positions, segment_ids, masks)
        # Each region names its module, whose parameters the member map
        # takes as explicit inputs (runtime/member_map.py); on the solo
        # path this is torch.utils.checkpoint.
        policy = functools.partial(_remat_policy, cfg)
        if (cfg.attention in ("flash", "ring") and cfg.save_attn_residuals
                and segment_ids is None):
            # The flash (or ring) call stays outside both checkpointed
            # regions: its saved (q, k, v, o, lse) are the residuals its
            # backward kernels need, so the forward kernels (and the
            # ring's transfers) are not re-run.
            q, k, v = member_map.checkpoint(self._qkv, x, positions,
                                            module=self, policy=policy)
            o = self.attn.attend(q, k, v)
            return member_map.checkpoint(self._out_and_mlp, x, o, masks,
                                         module=self, policy=policy)
        return member_map.checkpoint(self._block, x, positions, segment_ids,
                                     masks, module=self, policy=policy)


# The JAX model's logical axes per parameter (nn.with_logical_partitioning
# in kubeflow_tpu/models/transformer.py), by name within its block.
_LOGICAL_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "w_out": ("embed", "vocab"),
    "attn.wq": ("embed", "heads", "kv"),
    "attn.wkv": (None, "embed", "heads", "kv"),
    "attn.wo": ("heads", "kv", "embed"),
    "mlp.wi": (None, "embed", "mlp"),
    "mlp.wo": ("mlp", "embed"),
    "moe.router": ("embed", "expert"),
    "moe.wi": ("expert", None, "embed", "mlp"),
    "moe.wo": ("expert", "mlp", "embed"),
    "scale": ("norm",),
}


class Transformer(nn.Module):
    """LM: token ids [b, s] -> logits [b, s, vocab] (float32 unless
    ``ce_dtype="compute"``).

    With ``return_hidden=True`` the unembed projection is skipped and the
    call returns ``(hidden [b, s, d], unembed [v, d] or [d, v])`` in the
    compute dtype instead: the chunked-CE contract (lm_task,
    ``cfg.ce_chunk > 0``).  With ``return_aux=True`` the call returns
    ``(that, aux)``, ``aux`` the MoE layers' summed load-balancing loss
    (None without MoE).  ``deterministic=False`` (training) applies
    dropout at ``cfg.dropout_rate`` with masks drawn from ``generator``,
    which must then be given and live on the model's device; the
    default, ``deterministic=True``, draws nothing, as every serving path
    runs.  ``deterministic`` keeps the JAX package's signature and
    meaning: there a ``dropout`` rng passed with ``deterministic=True``
    is ignored, and ``deterministic=False`` without one is an error, so
    here a generator is ignored and a missing one raises ValueError.

    Parameters are drawn with the JAX package's init scales from
    ``generator`` (lecun-normal kernels, normal(0.02) embedding, unit
    norm scales) on ``device``: CUDA when none is given (an error without
    a GPU), ``"cpu"`` when asked.  ``device="meta"`` allocates nothing,
    for a model whose weights are loaded afterwards (models/convert.py
    load_params).  A served model's matmul weights may be int8
    ``QTensor``s (ops/quantize.py) in place of parameters; the forward
    takes them through ``qeinsum`` and ``embed_lookup``.

    Under a mesh with ``tensor`` above 1 the weights are split over it as
    the rule table places their logical axes (the module docstring), and the
    logits (or, with ``return_hidden``, the unembed) are this rank's
    vocab slice.  ``n_heads`` and ``n_kv_heads`` must then be multiples
    of ``tensor``, unless ``replicate_indivisible`` (a served model,
    serving/sharding.py): then a dim that does not divide ``tensor``
    stays whole on every rank, as JAX's ``_divisible`` replicates it,
    and its module runs whole with no reduce (kv heads fewer than the
    ranks: each rank's q heads read their own kv heads' group).
    """

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 replicate_indivisible: bool = False):
        super().__init__()
        _, tensor = tensor_shard(mesh)
        _, experts = expert_shard(mesh)
        if cfg.moe_experts and cfg.moe_experts % experts:
            raise ValueError(f"moe_experts={cfg.moe_experts} not divisible "
                             f"by the mesh's expert={experts}")
        if not replicate_indivisible and (cfg.n_heads % tensor
                                          or cfg.n_kv_heads % tensor):
            raise ValueError(
                f"n_heads={cfg.n_heads} and n_kv_heads={cfg.n_kv_heads} "
                f"must both be multiples of the mesh's tensor={tensor}")
        if cfg.attention == "ring" and mesh is None:
            raise ValueError("attention='ring' requires a mesh")
        if _sequence_shard(mesh)[1] > 1 and cfg.attention != "ring":
            raise ValueError(
                f"attention={cfg.attention!r} under a mesh with sequence > 1 "
                "would attend within each rank's shard only; the sharded "
                "sequence takes attention='ring'")
        if cfg.remat:
            _remat_policy(cfg)  # an unknown policy fails here, not mid-step
        if device is None or torch.device(device).type != "meta":
            device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.stage = _stage(cfg, mesh)
        self.embed = _param((cfg.vocab_size, cfg.d_model), generator, device,
                            init="embed")
        # Every block is drawn, in layer order, as one device draws them;
        # a pipeline stage keeps its own.
        blocks = [Block(cfg, generator, device, mesh)
                  for _ in range(cfg.n_layers)]
        if self.stage is not None:
            blocks = blocks[self.stage.offset:
                            self.stage.offset + self.stage.layers]
        self.layers = nn.ModuleList(blocks)
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.w_out = None
        if not cfg.tied_embeddings:
            self.w_out = _param((cfg.d_model, cfg.vocab_size), generator,
                                device)
        self._vocab = None
        if tensor > 1 or (experts > 1 and cfg.moe_experts):
            self._split_over_mesh()
        if mesh is not None and cfg.moe_experts:
            self._place_moe()
        for param in self.layers.parameters():
            tp.mark_stage(param, self.stage)

    def _split_over_mesh(self) -> None:
        """Keep this rank's slice of every parameter whose logical axes
        the rule table places on ``tensor`` or ``expert`` (drawn whole, as
        one device draws them), marked with its ``TensorShard`` (an MoE
        ``wi`` or ``wo`` under both: its experts' slice, then its slice of
        the mlp dim); set the column/row group of each attention and MLP
        whose weights were split over ``tensor``, and the vocab-parallel
        lookup's range.  The MoE router stays whole: every rank routes
        with all of its columns (JAX splits them over ``expert`` and
        gathers them for the softmax).  A dim that does not divide
        ``tensor`` (only a served model's, see the class docstring) is
        kept whole."""
        splits = [(axis, *shard_at(self.mesh))
                  for axis, shard_at in ((EXPERT, expert_shard),
                                         (TENSOR, tensor_shard))]
        axes_of = self.param_logical_axes()
        for name, param in list(self.named_parameters()):
            shard = None
            for axis, index, count in splits:
                dim = sharded_dim(axes_of[name], axis)
                if (count == 1 or dim is None or param.shape[dim] % count
                        or name.endswith("moe.router")):
                    continue
                shard = tp.TensorShard(dim, index, count,
                                       self.mesh.get_group(axis), axis,
                                       then=shard)
            if shard is None:
                continue
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner)
            setattr(module, leaf, tp.mark(nn.Parameter(
                shard.take(param.detach()).contiguous()), shard))
            dim = sharded_dim(axes_of[name], TENSOR)
            if (shard.axis == TENSOR and axes_of[name][dim] != "vocab"
                    and not isinstance(module, MoEMLP)):
                # An attention's heads, an MLP's hidden units.
                module.group = self.mesh.get_group(TENSOR)
        index, count = tensor_shard(self.mesh)
        if count == 1:
            return
        self._vocab = _vocab_split(self.mesh, self.cfg.vocab_size)
        cfg = self.cfg
        if cfg.n_heads % count == 0 and cfg.n_kv_heads % count:
            local = cfg.n_heads // count
            heads = torch.arange(index * local, (index + 1) * local)
            kv_heads = heads // (cfg.n_heads // cfg.n_kv_heads)
            for block in self.layers:
                block.attn.kv_heads = kv_heads

    def _place_moe(self) -> None:
        """Each MoE layer's place in the mesh (models/moe.py): the spread
        of the tokens it routes in one call (the batch's data x fsdp x
        sequence shards; under a pipeline a microbatch's data x fsdp
        shards, each sequence shard routing its own, as JAX's schedule
        is manual over ``sequence``), its first expert, the group over
        which its partial outputs are summed (the axes its ``wi`` is
        split over) and the groups of those axes alone.  Collectives:
        every rank builds the same groups in the same order."""
        mesh, sizes = self.mesh, axis_sizes(self.mesh)
        if self.stage is None:
            spread = Spread(sizes[DATA] * sizes[FSDP] * sizes[SEQUENCE],
                            group_over(mesh, (DATA, FSDP, SEQUENCE)),
                            shards=sizes[SEQUENCE])
        else:
            spread = Spread(sizes[DATA] * sizes[FSDP],
                            group_over(mesh, (DATA, FSDP)))
        index, count = expert_shard(mesh)
        shard = tp.shard_of(self.layers[0].moe.wi) if self.layers else None
        axes = () if shard is None else shard.axes()
        groups = [group_over(mesh, over)
                  for over in (axes, set(axes) & {EXPERT},
                               set(axes) & {TENSOR})]
        for block in self.layers:
            moe = block.moe
            moe.spread = spread
            moe.first_expert = index * (self.cfg.moe_experts // count)
            moe.group, moe.expert_group, moe.tensor_group = groups

    def _pipelined(self, x: torch.Tensor, positions: torch.Tensor,
                   drop: bool, generator):
        """The stage's blocks under the GPipe schedule: x [b, s, e] ->
        (the last stage's output [b, s, e], the MoE aux or None) on every
        stage.  The aux is JAX's: each microbatch's blocks sum their aux,
        ``pipelined_scan`` sums those over the microbatches and stages,
        and the sum is divided by the microbatches and, under the ring,
        averaged over the sequence shards (each routed its own tokens)."""
        cfg, stage = self.cfg, self.stage
        n_micro = max(cfg.pipeline_microbatches, 1)
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"pipeline_microbatches={n_micro}")
        masks = [None] * stage.layers
        if drop:
            # Every layer's pair in layer order (one microbatch: dropout
            # needs pipeline_microbatches=0), as one device draws them.
            for layer in range(cfg.n_layers):
                pair = tuple(rank_dropout_mask(x.shape, cfg.dropout_rate,
                                               generator, x.device,
                                               self.mesh, n_micro)
                             for _ in range(2))
                if 0 <= layer - stage.offset < stage.layers:
                    masks[layer - stage.offset] = pair
        pos = positions[:x.shape[0] // n_micro]
        moe = cfg.moe_experts > 0
        # The masks reach the stage as the schedule's extras, which the
        # fused trainer's member map hands in stacked (parallel/pipeline.py).
        flat = [t for pair in masks if pair is not None for t in pair]

        def stage_fn(act, *flat_masks):
            # Every layer of the stage has its pair, or none has one.
            pairs = list(zip(flat_masks[::2], flat_masks[1::2])) \
                if flat_masks else [None] * stage.layers
            aux = None
            for block, pair in zip(self.layers, pairs):
                act, part = block(act, pos, None, pair)
                if part is not None:
                    aux = part if aux is None else aux + part
            return (act, aux) if moe else act

        out = pipelined_scan(stage_fn, microbatch(x, n_micro), stage.group,
                             with_aux=moe, gradient_sync=self._gradient_sync,
                             module=self.layers, extras=flat)
        if not moe:
            return unmicrobatch(out), None
        out, aux = out
        _, shards = _sequence_shard(self.mesh)
        return unmicrobatch(out), _mean_over(aux / n_micro, shards,
                                             self.mesh.get_group(SEQUENCE))

    def _gradient_sync(self, flag: bool) -> None:
        """Turn FSDP2's gradient reduction of the stage's blocks on or off
        (``pipelined_scan``'s ``gradient_sync``; nothing without FSDP2)."""
        for block in self.layers:
            sync = getattr(block, "set_requires_gradient_sync", None)
            if sync is not None:
                sync(flag)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        if self._vocab is not None:
            return tp.vocab_parallel_embedding(
                self.embed, tokens, self.cfg.dtype, *self._vocab)
        return embed_lookup(self.embed, tokens, self.cfg.dtype)

    def _unembed_input(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm of hidden states [b, s, e], entering the
        vocab-parallel unembed through ``copy_to_parallel``."""
        group = None if self._vocab is None else self._vocab[1]
        return tp.copy_to_parallel(self.final_norm(x), group)

    def param_logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Each parameter's logical axes, as the JAX model annotates the
        same leaf (without its ``layers`` stack dim); the rule table
        (parallel/mesh.py) maps them to mesh axes."""
        out = {}
        for name, _ in self.named_parameters():
            rest = name.split(".", 2)[2] if name.startswith("layers.") \
                else name
            key = "scale" if rest.endswith("scale") else rest
            out[name] = _LOGICAL_AXES.get(key, ())
        return out

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and unembed of hidden states [b, s, e] (this rank's
        vocab slice when the vocab is split over ``tensor``)."""
        cfg = self.cfg
        x = self._unembed_input(x)
        if cfg.tied_embeddings:
            logits = qeinsum("bse,ve->bsv", x, self.embed, cfg.dtype)
        else:
            logits = qeinsum("bse,ev->bsv", x, self.w_out, cfg.dtype)
        return logits.to(torch.float32) if cfg.ce_dtype == "f32" else logits

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_hidden: bool = False,
                return_aux: bool = False):
        rate = self.cfg.dropout_rate
        drop = rate > 0 and not deterministic
        if drop and generator is None:
            raise ValueError("dropout (deterministic=False, dropout_rate "
                             f"{rate}) needs a generator")
        if self.stage is not None and (positions is not None
                                       or segment_ids is not None):
            raise ValueError("the pipelined layer stack supports only "
                             "default positions and no segment_ids")
        if positions is None:
            # Global positions: this sequence shard starts at r * s_local.
            rank, _ = _sequence_shard(self.mesh)
            s = tokens.shape[1]
            positions = torch.arange(
                rank * s, (rank + 1) * s,
                device=tokens.device).expand(tokens.shape)
        x = self.embed_tokens(tokens)
        aux = None
        if self.stage is not None:
            x, aux = self._pipelined(x, positions, drop, generator)
        else:
            for block in self.layers:
                masks = None
                if drop:
                    # Drawn here, outside the checkpointed regions (see
                    # the module docstring); each layer gets its own pair.
                    masks = tuple(rank_dropout_mask(x.shape, rate,
                                                    generator, x.device,
                                                    self.mesh)
                                  for _ in range(2))
                x, layer_aux = block(x, positions, segment_ids, masks)
                if layer_aux is not None:
                    aux = layer_aux if aux is None else aux + layer_aux
        if return_hidden:
            unembed = self.embed if self.w_out is None else self.w_out
            out = (self._unembed_input(x), unembed.to(self.cfg.dtype))
        else:
            out = self.logits(x)
        return (out, aux) if return_aux else out


def lm_task(cfg: TransformerConfig, device=None,
            generator: Optional[torch.Generator] = None, mesh=None):
    """(init_fn, loss_fn) pair for the trainer: next-token cross-entropy.

    ``init_fn(generator=None) -> (model, mutable)`` builds a
    ``Transformer`` on ``device`` (CUDA when none is given) with weights
    drawn from ``generator`` (or the one given here).
    ``loss_fn(model, mutable, batch, rng) -> (loss, (metrics, mutable))``
    takes ``{"tokens": [b, s] int}`` and predicts tokens[1:]; the loss is
    the mean over the b * (s - 1) predicted positions.  The forward runs
    in training mode: dropout (``cfg.dropout_rate``) draws its masks from
    ``rng``.  With MoE the loss adds ``moe_aux_coef`` times the summed
    aux loss, reported as ``metrics["moe_aux"]`` (``perplexity`` is of
    the cross-entropy alone), as in the JAX package.

    Under a mesh (the ``DeviceMesh`` of the trainer's ``Trainer(mesh=...)``)
    the batch is this rank's shard, rows over (data, fsdp) and, with
    ``sequence`` above 1, its sequence shard; under a pipeline of
    microbatches with data x fsdp above 1 the loss first exchanges those
    rows for the rank's share of JAX's microbatches
    (``to_microbatch_order``).  The loss is the JAX
    package's over the global batch: the targets are the global
    sequence's (each shard's last position predicts the first token of
    the next shard, taken from the next rank of the sequence group), only
    the globally last position has no target, and the loss is the sum of
    every rank's cross-entropy over the global count of predicted
    positions (not a mean of local means).  Its value is that global loss
    on every rank (an all-reduce), and its gradient on a rank is that
    rank's share of the global loss's gradient: the trainer's reduction
    sums the shares (runtime/train.py).  The chunked CE's divisibility
    check applies to the local length.  With ``tensor`` above 1 the
    logits are the rank's vocab slice, and the CE is the vocab-parallel
    one (parallel/tensor.py) on both ``ce_dtype`` values and in the
    chunked path: no rank gathers ``[b, s, vocab]``.  The ranks of a
    tensor group (and of an expert group, or the stages of a pipeline)
    compute the same share, so the global sum runs over data x fsdp x
    sequence only (parallel/mesh.py ``batch_group``).  ``moe_aux`` is the
    global aux on every rank, with the same convention for its gradient.
    """
    vocab = _vocab_split(mesh, cfg.vocab_size)
    # The global loss's group, created here, where every rank builds its
    # task, not inside the first step.
    summed_over = None if mesh is None else batch_group(mesh)

    def init_fn(gen: Optional[torch.Generator] = None):
        model = Transformer(cfg, device=device,
                            generator=generator if gen is None else gen,
                            mesh=mesh)
        return model, {}

    def ce_per_position(lg: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """Per-position CE [*, n] from logits [*, n, v], honoring
        cfg.ce_dtype (shared by the unchunked and chunked paths)."""
        tgt = tgt.long()
        if vocab is not None:
            return tp.vocab_parallel_cross_entropy(lg, tgt, *vocab)
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

    def chunked_ce(hidden, unembed, targets, weights):
        """Sum of the weighted next-token CE without materializing [b, s,
        vocab]: unembed + loss run `chunk` positions at a time, each chunk
        under torch.utils.checkpoint (the backward recomputes its logits).
        A position without a target has weight 0, so chunks tile all s
        positions whatever the divisors of s - 1."""
        s = targets.shape[1]
        chunk = fit_divisor(
            s, cfg.ce_chunk, "ce_chunk",
            "The chunked CE collapses toward an s-iteration loop of "
            "single-position unembeds (looks like a hang).  Choose a "
            "sequence length with a divisor close to ce_chunk.")
        spec = "bce,ve->bcv" if cfg.tied_embeddings else "bce,ev->bcv"

        def body(hc, tc, wc, w):
            lg = torch.einsum(spec, hc, w)
            return torch.sum(ce_per_position(lg, tc) * wc)

        total = torch.zeros((), dtype=torch.float32, device=targets.device)
        for i in range(0, s, chunk):
            part = slice(i, i + chunk)
            total = total + member_map.checkpoint(
                body, hidden[:, part], targets[:, part], weights[:, part],
                unembed)
        return total

    def shifted(tokens: torch.Tensor):
        """(targets, weights), [b, s] each: the next token of every
        position (of the global sequence under a mesh) and 1, or 0 and 0
        at the globally last position."""
        b, s = tokens.shape
        rank, n = _sequence_shard(mesh)
        if n > 1:
            nxt = from_next_rank(tokens[:, :1].contiguous(),
                                 mesh.get_group(SEQUENCE))
        else:
            nxt = tokens.new_zeros((b, 1))
        weights = torch.ones((b, s), dtype=torch.float32,
                             device=tokens.device)
        if rank == n - 1:
            nxt = torch.zeros_like(nxt)
            weights[:, -1] = 0.0
        return torch.cat([tokens[:, 1:], nxt], dim=1), weights

    def global_count(tokens: torch.Tensor) -> int:
        """Predicted positions of the global batch."""
        b, s = tokens.shape
        if mesh is None:
            return b * (s - 1)
        sizes = axis_sizes(mesh)
        return b * sizes[DATA] * sizes[FSDP] * (s * sizes[SEQUENCE] - 1)

    def mean_ce(out, tokens):
        """The rank's share of the mean CE: its positions' sum over the
        global count (on one device, the mean itself)."""
        rank, n = _sequence_shard(mesh)
        if cfg.ce_chunk > 0:
            hidden, unembed = out
            targets, weights = shifted(tokens)
            return chunked_ce(hidden, unembed, targets, weights) \
                / global_count(tokens)
        # Every rank of the sequence group takes part in the exchange.
        targets = shifted(tokens)[0] if n > 1 else None
        if rank == n - 1:
            ce = ce_per_position(out[:, :-1], tokens[:, 1:])
        else:
            ce = ce_per_position(out, targets)
        # The mean times the rank's share of the count: exactly the mean
        # when the rank holds the whole batch.
        return ce.mean() * (ce.numel() / global_count(tokens))

    def loss_fn(model: Transformer, mutable, batch, rng
                ) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], dict]]:
        del mutable  # no mutable collections
        tokens = batch["tokens"]
        if mesh is not None:
            tokens = to_microbatch_order(tokens, mesh,
                                         cfg.pipeline_microbatches)
        out, aux = model(tokens, deterministic=False, generator=rng,
                         return_hidden=cfg.ce_chunk > 0, return_aux=True)
        loss = _global_loss(mean_ce(out, tokens), summed_over)
        metrics = {"perplexity": torch.exp(loss.detach())}
        if cfg.moe_experts > 0:
            metrics["moe_aux"] = aux.detach()
            loss = loss + cfg.moe_aux_coef * aux
        return loss, (metrics, {})

    return init_fn, loss_fn


def _mean_over(share: torch.Tensor, count: int, group) -> torch.Tensor:
    """The mean of ``share`` over the ``count`` ranks of ``group`` as the
    value, with ``share / count`` as this rank's gradient (``share``
    itself when ``count`` is 1)."""
    if count == 1:
        return share
    return _global_loss(share / count, group)


def _global_loss(share: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``share`` over ``group`` (the ranks that hold the
    batch's other rows and positions) as the value, with ``share``'s own
    gradient (an all-reduce of the value; nothing to do without a group
    or in a group of one).  Inside the fused trainer's member map the
    all-reduce runs once, on the members' stacked shares
    (parallel/p2p.py)."""
    import torch.distributed as dist

    if group is None or dist.get_world_size(group) == 1:
        return share
    total = p2p.all_reduce(share, group)
    return total + (share - share.detach())
