"""Point-to-point transfers, broadcasts, out-of-place all-reduces and
all-gathers between the ranks of one process group, shared by ring
attention (parallel/ring.py), the GPipe schedule (parallel/pipeline.py)
and its exchange of rows into JAX's microbatches (models/transformer.py),
the MoE layer's global statistics (models/moe.py), adafactor's
statistics under a split (runtime/optim.py), BatchNorm's global
statistics (models/resnet.py) and serving's forward-only reduce
(parallel/tensor.py).  Inside the fused trainer's member map
(runtime/member_map.py) ``all_reduce`` and ``all_gather`` of a member's
view run once on the stack of every member's (``member_map.on_stack``).

On a gloo group a CUDA tensor is staged through host memory (``staged``):
gloo's point-to-point moves host tensors (on the card's torch its CUDA
path fails with "Bad address"), and its host collectives are the faster
of its two (a [8, 1, 1024] float32 all-reduce took 2.15 ms through gloo's
CUDA path against 1.2 ms on host tensors on an H100 at 700 W, PERF.md
section 6; serving's forward-only collectives in parallel/tensor.py stage
alike).  That is gloo's transport, used when several processes share one
GPU, not a fallback; NCCL moves device memory.  Every transfer waits
under its group's timeout (the mesh's, parallel/mesh.py): a peer that
never answers raises instead of hanging the job.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from kubeflow_tpu_torch.runtime import member_map


def rank_and_size(group) -> Tuple[int, int]:
    """(this rank's index, size) in ``group``; (0, 1) without a process
    group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def staged(device: torch.device, group) -> bool:
    """Whether a tensor on ``device`` crosses ``group`` through host
    memory: a CUDA tensor over gloo."""
    import torch.distributed as dist

    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` (gloo moves contiguous tensors;
    ``.cpu()`` keeps a strided tensor's strides)."""
    return t.detach().to("cpu", memory_format=torch.contiguous_format)


class Rotation:
    """One transfer of ``tensors`` to the next rank of the ring and of
    the previous rank's into fresh buffers (``step=-1``: to the previous
    rank, from the next): constructing it issues the transfer, ``wait``
    returns the received tensors on the senders' device."""

    def __init__(self, tensors: Sequence[torch.Tensor], group,
                 step: int = 1):
        import torch.distributed as dist

        me, n = rank_and_size(group)
        self._device = tensors[0].device
        stage = staged(self._device, group)
        send = [_host(t) if stage else t.contiguous() for t in tensors]
        self._recv = [torch.empty_like(t) for t in send]
        nxt = dist.get_global_rank(group, (me + step) % n)
        prv = dist.get_global_rank(group, (me - step) % n)
        ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv, group) for t in self._recv]
        self._works = dist.batch_isend_irecv(ops)
        self._send = send  # alive until the transfer is done

    def wait(self) -> List[torch.Tensor]:
        for work in self._works:
            work.wait()
        return [t.to(self._device, non_blocking=True) for t in self._recv]


class Send:
    """``t`` on its way to rank ``dst`` (an index in ``group``) with
    ``tag``: constructing it issues the send, ``wait`` waits for it."""

    def __init__(self, t: torch.Tensor, dst: int, group, tag: int = 0):
        import torch.distributed as dist

        self._t = _host(t) if staged(t.device, group) \
            else t.detach().contiguous()
        self._work = dist.isend(self._t, dist.get_global_rank(group, dst),
                                group=group, tag=tag)

    def wait(self) -> None:
        self._work.wait()


def recv(shape, dtype: torch.dtype, device: torch.device, src: int, group,
         tag: int = 0) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from rank ``src`` (an index in
    ``group``) with ``tag``, on ``device``."""
    import torch.distributed as dist

    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged(device, group) else device)
    dist.irecv(buf, dist.get_global_rank(group, src), group=group,
               tag=tag).wait()
    return buf.to(device, non_blocking=True)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``t`` (an index in ``group``) on every rank, in a
    tensor of ``t``'s shape, dtype and device (the others' ``t`` only
    gives those)."""
    import torch.distributed as dist

    buf = _host(t) if staged(t.device, group) \
        else t.detach().contiguous()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(t.device, non_blocking=True)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, out of place and outside
    autograd."""
    import torch.distributed as dist

    if member_map.mapped(t):
        return member_map.on_stack(lambda s: all_reduce(s, group), t)

    buf = _host(t) if staged(t.device, group) \
        else t.detach().contiguous().clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) stacked in the
    group's rank order, ``[ranks, *t.shape]`` on ``t``'s device, outside
    autograd."""
    import torch.distributed as dist

    if member_map.mapped(t):
        # Each member's ``[ranks, ...]``: the stack's gather, members first.
        return member_map.on_stack(
            lambda s: all_gather(s, group).movedim(0, 1), t)

    buf = _host(t) if staged(t.device, group) \
        else t.detach().contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.stack(parts).to(t.device)
