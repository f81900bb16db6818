"""Tensor parallelism over the mesh's ``tensor`` axis: Megatron's
conjugate operators, the vocab-parallel embedding and cross-entropy, and
the record of which share of a whole tensor a rank holds, and the
forward-only pieces of tensor-parallel decode (``reduce_from_parallel``
under ``torch.no_grad`` is a plain all-reduce; ``gather_last_dim``
gathers vocab-sliced logits).

There is no JAX counterpart of this file.  The JAX package annotates
each weight with its logical axes and lets the rule table
(kubeflow_tpu/parallel/mesh.py ``DEFAULT_RULES``: heads, mlp and vocab
over ``tensor``) place it; XLA's SPMD partitioner then inserts the
collectives these functions write out by hand.  Each rank of a
``tensor`` group holds plain local tensors: its slice of the heads of
``wq``, ``wkv`` and ``wo``, of the MLP's hidden dim and of the vocab,
and whole copies of everything else.  The activations between the
blocks are replicated over the group:

  - ``copy_to_parallel`` (identity forward, all-reduce backward) sits on
    the input of a column-parallel projection, whose output is split
    over the group: each rank's input gradient is only its columns'
    share, and the backward sums the shares;
  - ``reduce_from_parallel`` (all-reduce forward, identity backward)
    ends a row-parallel projection, whose local product is a partial
    sum over the rank's rows: the forward sums the partials, and the
    gradient of a replicated output is already whole on every rank;
  - ``vocab_parallel_embedding`` looks up the ids inside the rank's
    vocab range, zeroes the rest and reduces;
  - ``vocab_parallel_cross_entropy`` takes the per-position CE of logits
    split over the vocab without gathering them (a max all-reduce, a
    sum-of-exp all-reduce and the target's logit, each an all-reduce of
    ``[b, s]`` values); its gradient is ``softmax - onehot`` on the
    rank's own slice.

Inside the fused trainer's member map (runtime/hfta.py) each of the four
autograd functions (the pair, the ranks' sum and the vocab-parallel CE)
has a ``vmap`` rule that applies it once to the ``[members, ...]``
stack: one all-reduce of the stack a call, never one a member.

``TensorShard`` names the share of a whole tensor a rank holds (the dim,
the rank's index and the count along it, the mesh axis and its group:
``tensor``; ``expert`` for an MoE weight's experts, models/moe.py; for
adafactor's statistics of a stage's stacked layers ``pipeline``, and of
FSDP2's shards ``fsdp``, whose slices may be uneven: torch.chunk's, the
last ones shorter or empty), and a second split over another axis where
there is one (an MoE ``wi`` under expert x tensor); ``mark`` attaches it
to a tensor and ``shard_of`` reads it back.
``mark_stage`` and ``stage_of`` do the same with the pipeline ``Stage``
(parallel/pipeline.py) of a tensor that belongs to one of a stage's
layers.  The model marks the parameters it splits and its stage's
layers, the trainer marks FSDP2's parameters in their place and the
optimizers their moments (``like``), so checkpoints
(runtime/checkpoint.py) and the weight bridge (models/convert.py) gather
whole tensors and split them again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops.quantize import QTensor, embed_lookup
from kubeflow_tpu_torch.parallel.p2p import all_reduce, staged

_ATTR = "_kft_tensor_shard"
_STAGE_ATTR = "_kft_stage"


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """Share ``index`` of ``count`` equal slices along ``dim`` of a whole
    tensor, held by that rank of the process ``group`` of mesh ``axis``
    (``tensor``; ``expert`` for an MoE weight's experts; ``pipeline`` for
    a stage's rows of adafactor's statistics; ``fsdp`` for their FSDP2
    shards).  ``size`` is the whole dim's size where the slices may be
    uneven (FSDP2's torch.chunk split: slices of ceil(size / count), the
    last ones shorter or empty); None for ``count`` equal slices.
    ``then`` is a second split of the same tensor over another axis, or
    None: an MoE ``wi`` under expert x tensor holds its experts' slice of
    the expert dim and its slice of the mlp dim."""

    dim: int
    index: int
    count: int
    group: Any
    axis: str = "tensor"
    then: Optional["TensorShard"] = None
    size: Optional[int] = None

    def _span(self, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's torch.chunk slice of a dim of
        ``n``: slices of ceil(n / count), the last ones shorter or
        empty."""
        step = -(-n // self.count)
        start = min(self.index * step, n)
        return start, min(step, n - start)

    def take(self, whole):
        """This rank's slice of ``whole`` (a tensor, or an int8
        ``QTensor`` whose scale is sliced with its values)."""
        if self.size is None and whole.shape[self.dim] % self.count:
            raise ValueError(
                f"dim {self.dim} of {tuple(whole.shape)} does not split "
                f"over {self.count} {self.axis} ranks")
        if self.size is None:
            part = whole.chunk(self.count, dim=self.dim)[self.index]
        else:
            part = whole.narrow(self.dim, *self._span(whole.shape[self.dim]))
        return part if self.then is None else self.then.take(part)

    def whole_shape(self, shape) -> Tuple[int, ...]:
        out = list(shape)
        out[self.dim] = (out[self.dim] * self.count if self.size is None
                         else self.size)
        return tuple(out) if self.then is None else \
            self.then.whole_shape(out)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's ``local`` slice (a
        collective over the group, then over ``then``'s; uneven slices
        travel padded to the longest and are cut back)."""
        import torch.distributed as dist

        local = local.detach().contiguous()
        step = None if self.size is None else -(-self.size // self.count)
        if step is not None and local.shape[self.dim] < step:
            pad = list(local.shape)
            pad[self.dim] = step - local.shape[self.dim]
            local = torch.cat([local, local.new_zeros(pad)], dim=self.dim)
        parts = [torch.empty_like(local) for _ in range(self.count)]
        dist.all_gather(parts, local, group=self.group)
        whole = torch.cat(parts, dim=self.dim)
        if step is not None:
            whole = whole.narrow(self.dim, 0, self.size)
        return whole if self.then is None else self.then.gather(whole)

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the tensor is split over."""
        rest = () if self.then is None else self.then.axes()
        return (self.axis,) + rest


def mark(t: torch.Tensor, shard: Optional[TensorShard]) -> torch.Tensor:
    """Attach ``shard`` to ``t`` (None: nothing) and return ``t``."""
    if shard is not None:
        setattr(t, _ATTR, shard)
    return t


def shard_of(t: Any) -> Optional[TensorShard]:
    """The ``TensorShard`` attached to ``t``, or None for a whole tensor."""
    return getattr(t, _ATTR, None)


def mark_stage(t: torch.Tensor, stage: Any) -> torch.Tensor:
    """Attach the pipeline ``Stage`` of the layer ``t`` belongs to (None:
    nothing) and return ``t``."""
    if stage is not None:
        setattr(t, _STAGE_ATTR, stage)
    return t


def stage_of(t: Any) -> Any:
    """The pipeline ``Stage`` attached to ``t``, or None."""
    return getattr(t, _STAGE_ATTR, None)


def like(t: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``t`` marked as ``source`` is (a moment follows its parameter)."""
    return mark_stage(mark(t, shard_of(source)), stage_of(source))


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return t


def _stacked(t: torch.Tensor, dim: Optional[int], m: int) -> torch.Tensor:
    """The ``[members, ...]`` stack of a vmap rule's input: its mapped
    dim moved to the front, an unmapped one expanded to every member."""
    return t.expand(m, *t.shape) if dim is None else t.movedim(dim, 0)


class _CopyToParallel(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToParallel.apply(x, group), in_dims[0]


class _ReduceFromParallel(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ReduceFromParallel.apply(x, group), in_dims[0]


class _SumOverRanks(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, group):
        return all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _SumOverRanks.apply(x, group), in_dims[0]


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` forward, and of its gradient over
    ``group`` backward: a value every rank's loss reads (BatchNorm's
    statistics over the data ranks, models/resnet.py), whose gradient on
    each rank gathers what every rank's loss sends back; staged through
    host memory on gloo (parallel/p2p.py).  ``x`` itself when ``group``
    is None."""
    return x if group is None else _SumOverRanks.apply(x, group)


def copy_to_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``group``
    backward; ``x`` itself when ``group`` is None."""
    return x if group is None else _CopyToParallel.apply(x, group)


def reduce_from_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward, identity backward; ``x``
    itself when ``group`` is None.  With autograd off (serving) it is a
    plain all-reduce of a copy of ``x``."""
    if group is None:
        return x
    if not torch.is_grad_enabled():
        return all_reduce(x, group)
    return _ReduceFromParallel.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """The whole tensor from every rank's slice ``x`` along its last dim
    (an all-gather over ``group``, forward only: decode's vocab-sliced
    logits, gathered so that every rank samples from the whole vocab);
    ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    import torch.distributed as dist

    local = x.to("cpu", memory_format=torch.contiguous_format) \
        if staged(x.device, group) else x.contiguous()
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=-1).to(x.device)


def vocab_parallel_embedding(table, tokens: torch.Tensor,
                             dtype: torch.dtype, start: int,
                             group) -> torch.Tensor:
    """Rows of the whole embedding for ``tokens`` from each rank's slice
    ``table`` (vocab ids ``start`` to ``start + len(table)``; an int8
    ``QTensor`` slice of a served model too): the ids in
    range are looked up, the others give zero rows, and the sum over the
    group is the lookup in the whole table."""
    local = tokens.long() - start
    inside = (local >= 0) & (local < table.shape[0])
    local = torch.where(inside, local, torch.zeros_like(local))
    if isinstance(table, QTensor):
        rows = embed_lookup(table, local, dtype)
    else:
        rows = torch.nn.functional.embedding(local, table)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_parallel(rows.to(dtype), group)


class _VocabParallelCE(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(logits, targets, start, group):
        import torch.distributed as dist

        lf = logits.float()
        m = lf.amax(dim=-1)
        _all_reduce(m, group, dist.ReduceOp.MAX)
        total = torch.exp(lf - m[..., None]).sum(dim=-1)
        _all_reduce(total, group)
        lse = torch.log(total) + m
        local = targets.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(inside, local, torch.zeros_like(local))
        target = lf.gather(-1, local[..., None])[..., 0]
        target = torch.where(inside, target, torch.zeros_like(target))
        _all_reduce(target, group)
        return lse - target, lse, local, inside

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, lse, local, inside = output
        ctx.mark_non_differentiable(lse, local, inside)
        ctx.save_for_backward(inputs[0], lse, local, inside)

    @staticmethod
    def backward(ctx, g, *_):
        logits, lse, local, inside = ctx.saved_tensors
        grad = torch.exp(logits.float() - lse[..., None])
        grad.scatter_add_(-1, local[..., None],
                          -inside[..., None].to(grad.dtype))
        grad.mul_(g[..., None])
        return grad.to(logits.dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, logits, targets, start, group):
        """The members' logits and targets stacked (the positions' dims
        gain a leading one): one call, each reduction on the stack."""
        m = info.batch_size
        out = _VocabParallelCE.apply(_stacked(logits, in_dims[0], m),
                                     _stacked(targets, in_dims[1], m),
                                     start, group)
        return out, (0, 0, 0, 0)


def vocab_parallel_cross_entropy(logits: torch.Tensor,
                                 targets: torch.Tensor, start: int,
                                 group) -> torch.Tensor:
    """Per-position CE ``[*, n]`` (float32) of logits ``[*, n, v_local]``
    that hold vocab ids ``start`` to ``start + v_local`` of each row,
    against ``targets`` ``[*, n]`` ids of the whole vocab; the same value
    on every rank of ``group``.  The reductions run in float32 whatever
    the logits' dtype; the gradient is the logits' dtype."""
    return _VocabParallelCE.apply(logits, targets, start, group)[0]
