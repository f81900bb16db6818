"""Ring attention over the ``sequence`` mesh axis: the port of
kubeflow_tpu/parallel/ring.py.

Each rank of the ``sequence`` group holds a contiguous shard of the
sequence, ``[b, s_local, h, d]``, and keeps its queries resident while
the key/value shards travel around the ring, one hop per rank.  A hop
runs the flash forward (``ops/flash.py`` ``flash_fwd_with_lse``: the
Hopper kernel on CUDA tensors, its plain version on CPU ones) and its
(o, lse) partial merges into a float32 accumulator in log space with
``merge_partials``, as the JAX package's ``_merge`` does.  Causal hops
are classified by where the kv shard sits against the resident queries:

  - strictly behind them: the whole block is visible, ``causal=False``;
  - the diagonal (the rank's own shard): ``causal=True``;
  - strictly ahead: nothing is visible, and the hop launches nothing.

So a causal ring of R ranks runs R (R + 1) / 2 live hops in all, and a
non-causal one R * R.  Skipped hops still rotate: every rank takes part
in every transfer, so the ring never waits on a rank that skipped.

The backward re-rotates the kv shards instead of saving per-hop
residuals (JAX's custom VJP): delta = rowsum(g * o) is taken once, each
live hop runs the backward kernels (``flash_bwd_block``), dq accumulates
at home, and dk / dv accumulate in float32 buffers that travel with
their kv shard and are home again after R transfers.  GQA kv heads
rotate unrepeated and are repeated to the query heads only inside a live
hop; the hop's dk / dv fold the head groups back (``_fold_heads``).

Transfers are ``batch_isend_irecv`` to the next rank of the group and
from the previous one, issued before the hop's kernel runs, so on NCCL
the next shard moves while the current one is computed (parallel/p2p.py
``Rotation``: on a gloo group a CUDA tensor is staged through host
memory, gloo's transport when several processes share one GPU; NCCL
moves device memory).

Under the fused trainer's member map (runtime/hfta.py) ``_RingFunction``'s
``vmap`` rule folds the members into the batch dim: each hop moves the
members' shards in one rotation and launches the kernels once for all.
"""

from __future__ import annotations

from typing import Callable

import torch

from kubeflow_tpu_torch.ops.attention import NEG_INF
from kubeflow_tpu_torch.ops.flash import (
    flash_bwd_block,
    flash_fwd_with_lse,
    merge_partials,
    repeat_kv,
)
from kubeflow_tpu_torch.parallel.mesh import SEQUENCE
from kubeflow_tpu_torch.parallel.p2p import Rotation, rank_and_size


def _hop_class(src: int, me: int, causal: bool) -> str:
    if not causal or src < me:
        return "full"
    return "diag" if src == me else "skip"


def from_next_rank(t: torch.Tensor, group) -> torch.Tensor:
    """The next rank's ``t`` along the ring (the first rank's on the
    last): each rank sends its own to the previous one.  lm_task takes
    the first token of the next sequence shard with it, the target of
    its shard's last position."""
    return Rotation((t,), group, step=-1).wait()[0]


def _fold_heads(dk: torch.Tensor, hkv: int) -> torch.Tensor:
    """Transpose of ``repeat_kv``: sum the gradient over each head
    group, [b, s, h, d] -> [b, s, hkv, d]."""
    b, s, h, d = dk.shape
    if h == hkv:
        return dk
    return dk.reshape(b, s, hkv, h // hkv, d).sum(dim=3)


def _merge(o_acc, lse_acc, o_p, lse_p):
    """``merge_partials`` with the ring's lse layout: o [b, s, h, d],
    lse [b, h, s]."""
    o, lse = merge_partials(o_acc, lse_acc.transpose(1, 2), o_p,
                            lse_p.transpose(1, 2))
    return o, lse.transpose(1, 2)


def _ring_fwd(q, k, v, group, causal: bool):
    """(o float32 [b, s, h, d], lse [b, h, s]) of the resident queries
    against every kv shard of the ring."""
    me, n = rank_and_size(group)
    b, s, h, d = q.shape
    o_acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                         device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        rotation = Rotation((k_cur, v_cur), group) if step < n - 1 \
            else None
        kind = _hop_class((me - step) % n, me, causal)
        if kind != "skip":
            o_p, lse_p = flash_fwd_with_lse(
                q, *repeat_kv(k_cur, v_cur, h), causal=kind == "diag")
            o_acc, lse_acc = _merge(o_acc, lse_acc, o_p.float(), lse_p)
        if rotation is not None:
            k_cur, v_cur = rotation.wait()
    return o_acc, lse_acc


def _ring_bwd(q, k, v, o, lse, g, group, causal: bool):
    """(dq, dk, dv) in the inputs' dtypes: kv re-rotated with its dk / dv
    accumulators, home after n transfers."""
    me, n = rank_and_size(group)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = g.contiguous()
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, s, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    k_cur, v_cur = k, v
    for step in range(n):
        kv_rotation = Rotation((k_cur, v_cur), group) if step < n - 1 \
            else None
        kind = _hop_class((me - step) % n, me, causal)
        if kind != "skip":
            kr, vr = repeat_kv(k_cur, v_cur, h)
            dq_p, dk_p, dv_p = flash_bwd_block(
                q, kr, vr, g, lse, delta, causal=kind == "diag")
            dq += dq_p.float()
            dk += _fold_heads(dk_p.float(), hkv)
            dv += _fold_heads(dv_p.float(), hkv)
        if n > 1:
            dk, dv = Rotation((dk, dv), group).wait()
        if kv_rotation is not None:
            k_cur, v_cur = kv_rotation.wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFunction(torch.autograd.Function):
    """Differentiable ring attention on the local shard: ``apply(q, k, v,
    group, causal) -> (o, lse)``, o in q's dtype and lse not
    differentiable; saves (q, k, v, o, lse), the counterpart of JAX's
    ``_ring_vjp_fwd`` residuals.

    Under ``torch.func.vmap`` (the fused trainer's members,
    runtime/hfta.py) the ``vmap`` rule folds the mapped axis into the
    batch dim and applies the function once: each hop's rotation moves
    the members' ``[m * b, ...]`` shards together, and each live hop's
    kernel launch folds the members as ``_FlashFunction.vmap`` does."""

    generate_vmap_rule = False

    @staticmethod
    def forward(q, k, v, group, causal: bool):
        o, lse = _ring_fwd(q, k, v, group, causal)
        return o.to(q.dtype), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, group, causal = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal

    @staticmethod
    def backward(ctx, g, g_lse):
        del g_lse  # lse is not differentiable
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, o, lse, g, ctx.group, ctx.causal)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, group, causal):
        m = info.batch_size

        def fold(t, dim):
            t = t.expand(m, *t.shape) if dim is None else t.movedim(dim, 0)
            return t.reshape(-1, *t.shape[2:])

        o, lse = _RingFunction.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                     fold(v, in_dims[2]), group, causal)
        return (o.reshape(m, -1, *o.shape[1:]),
                lse.reshape(m, -1, *lse.shape[1:])), (0, 0)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    causal: bool = True,
) -> torch.Tensor:
    """Ring attention on this rank's shard: q [b, s_local, h, d], k and v
    [b, s_local, hkv, d] (GQA welcome) -> o [b, s_local, h, d].

    ``group``: the ``sequence`` process group (None: the default group;
    without a process group, a ring of one, which is ``flash_attention``).
    The global sequence is the group's shards in rank order; the kernels
    pick their own tiles."""
    import torch.distributed as dist

    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    return _RingFunction.apply(q, k, v, group, causal)[0]


def make_ring_attention(
    mesh,
    *,
    causal: bool = True,
    axis_name: str = SEQUENCE,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Ring attention over ``mesh``'s ``axis_name`` group, on local
    shards laid out as the JAX package's ``make_ring_attention`` expects
    them: batch over (data, fsdp), sequence over ``axis_name``, heads
    over ``tensor`` (each rank's own heads, query and kv split alike).
    The ``axis_name`` group holds the ranks of this rank's tensor index
    only, so the hops rotate among the shards of the same heads."""
    group = mesh.get_group(axis_name)

    def fn(q, k, v):
        return ring_attention(q, k, v, group=group, causal=causal)

    return fn

