"""GPipe pipeline parallelism over the ``pipeline`` mesh axis: the port of
kubeflow_tpu/parallel/pipeline.py.

Each rank of the ``pipeline`` group holds one stage: L/S consecutive
layers of the model's stack, stage p layers [p L/S, (p + 1) L/S).  The
batch is cut into M microbatches (``microbatch``), which stream through
the stages: stage p runs its layers on microbatch m once stage p - 1 has
sent it, and sends the result on to stage p + 1.  The last stage's
outputs are broadcast to every stage, so the code after the stack (the
final norm, the unembed, the loss) runs alike on every stage, as JAX's
trailing ``psum`` arranges.

What differs from JAX.  There the whole schedule is one ``lax.fori_loop``
of M + S - 1 steps inside a ``shard_map``, with a ``ppermute`` a step;
bubble steps compute on zeros and are masked away, and AD derives the
backward schedule.  Here each rank is a process holding only its stage,
so ``pipelined_scan`` runs only the (stage, microbatch) pairs JAX keeps:
a bubble step launches nothing, and the dead wrap link (S - 1 -> 0)
carries nothing.  The backward schedule is written out (design (b)): the
whole pipelined stack is one ``torch.autograd.Function``.  Its forward
keeps each microbatch's local graph (the stage's layers run under
``torch.enable_grad`` on an input that requires grad); its backward takes
the microbatches from M - 1 down to 0 and, for each, receives the
output's cotangent from the next stage (the last stage takes its own,
once: every stage holds the same cotangent of the broadcast outputs),
runs ``torch.autograd.backward`` on the stored graph, which accumulates
the stage's parameter gradients, and sends the input's gradient to the
previous stage.  Stage 0 then broadcasts the input gradient to every
stage, so the embedding's gradient, which autograd forms after the
stack, is whole and equal on every stage; the exchange is of the
``[B, S, E]`` activations, never of the ``[V, E]`` embedding gradient.
Every rank issues its sends and receives in one fixed order (forward: m
ascending; backward: m descending), and a rank that owns no live work at
a step simply has none: no collective sits in a branch that one rank
skips.  Design (a), one autograd node per hop, would leave the order of
the receives to autograd's traversal.

``gradient_sync(flag)``, when given, is called before each microbatch's
backward with ``flag`` true only for the last one (microbatch 0): a stage
whose layers are FSDP2 modules turns their gradient reduction off for
the others, so a layer run M times a step reduces its summed gradient
once (models/transformer.py).

Transfers go through parallel/p2p.py (host-staged on a gloo group, device
memory on NCCL) under the group's timeout.  ``Stage`` records a rank's
share of the layer stack; checkpoints (runtime/checkpoint.py) and the
weight bridge (models/convert.py) use ``whole_named``, ``stage_named``,
``whole_list`` and ``stage_list`` to gather every stage's layers into the
whole stack and to take a stage's rows of it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from kubeflow_tpu_torch.parallel import p2p


@dataclasses.dataclass(frozen=True)
class Stage:
    """Stage ``index`` of ``count`` along ``pipeline``, holding ``layers``
    consecutive layers of the stack from ``offset``, with the ``pipeline``
    process ``group``."""

    index: int
    count: int
    layers: int
    group: Any

    @property
    def offset(self) -> int:
        return self.index * self.layers


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {n_micro} microbatches")
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """[M, mb, ...] -> [B, ...]."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def pipelined_scan(stage_fn: Callable, x: torch.Tensor, group, *,
                   with_aux: bool = False,
                   gradient_sync: Optional[Callable[[bool], None]] = None):
    """Run microbatches ``x`` [M, mb, ...] through every stage of the
    ``pipeline`` ``group`` (this rank's stage is ``stage_fn``, a callable
    over its local layers: activation -> activation of the same shape and
    dtype, or, ``with_aux``, -> (activation, aux scalar)).

    Returns the last stage's outputs [M, mb, ...] on every rank of the
    group; with ``with_aux``, ``(outputs, aux)``: the float32 sum of the
    stage bodies' aux over every (stage, microbatch) pair the schedule
    runs (bubble steps run nothing, so they add nothing, gradients
    included), the same on every rank.  Differentiable in ``x`` and in
    whatever the stage reads (its parameters' ``.grad`` accumulate in the
    backward's nested ``torch.autograd.backward``, so call ``backward()``
    on the loss, not ``torch.autograd.grad``).  Without a process group
    the rank is the only stage."""
    me, n = p2p.rank_and_size(group)
    sched = _Schedule(stage_fn, group, me, n, with_aux, gradient_sync)
    if torch.is_grad_enabled():
        # The anchor makes the schedule a node of the caller's graph even
        # when ``x`` needs no gradient (the stage's parameters still do).
        anchor = torch.empty(0, device=x.device, requires_grad=True)
        ys, aux = _PipelineFunction.apply(x, anchor, sched)
    else:
        ys, aux = sched.forward(x, keep=False)
    return (ys, aux) if with_aux else ys


class _Schedule:
    """One pipelined call's stage, its place in the group and, between
    the forward and the backward, each microbatch's (input, output, aux)
    local graph."""

    def __init__(self, stage_fn, group, me: int, n: int, with_aux: bool,
                 gradient_sync):
        self.stage_fn, self.group = stage_fn, group
        self.me, self.n = me, n
        self.with_aux, self.gradient_sync = with_aux, gradient_sync
        self.saved: List[tuple] = []

    def _run(self, inp: torch.Tensor):
        res = self.stage_fn(inp)
        if self.with_aux:
            out, aux = res
            return out, aux.to(torch.float32)
        return res, None

    def forward(self, x: torch.Tensor, keep: bool):
        """(outputs [M, mb, ...], aux) on every rank; ``keep``: run each
        microbatch under autograd and keep its graph for ``backward``."""
        first, last = self.me == 0, self.me == self.n - 1
        outs, sends = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for m in range(x.shape[0]):
            inp = x[m].detach() if first else p2p.recv(
                x.shape[1:], x.dtype, x.device, self.me - 1, self.group,
                tag=m)
            if keep:
                inp.requires_grad_(True)
                with torch.enable_grad():
                    out, part = self._run(inp)
                self.saved.append((inp, out, part))
            else:
                out, part = self._run(inp)
            if part is not None:
                aux = aux + part.detach()
            if last:
                outs.append(out.detach())
            else:
                sends.append(p2p.Send(out, self.me + 1, self.group, tag=m))
        for send in sends:
            send.wait()
        ys = torch.stack(outs) if last else torch.empty_like(x)
        if self.n > 1:
            ys = p2p.broadcast(ys, self.n - 1, self.group)
            if self.with_aux:
                aux = p2p.all_reduce(aux, self.group)
        return ys, aux

    def backward(self, g_ys: torch.Tensor, g_aux: Optional[torch.Tensor]
                 ) -> torch.Tensor:
        """The input's gradient [M, mb, ...] on every rank, the stage's
        parameter gradients accumulated on the way."""
        first, last = self.me == 0, self.me == self.n - 1
        n_micro = len(self.saved)
        dxs: List[Optional[torch.Tensor]] = [None] * n_micro
        sends = []
        for m in reversed(range(n_micro)):
            inp, out, part = self.saved[m]
            g_out = g_ys[m] if last else p2p.recv(
                out.shape, out.dtype, out.device, self.me + 1, self.group,
                tag=m)
            roots, grads = [], []
            if out.requires_grad:
                roots.append(out)
                grads.append(g_out)
            if part is not None and part.requires_grad and g_aux is not None:
                roots.append(part)
                grads.append(g_aux)
            if self.gradient_sync is not None:
                self.gradient_sync(m == 0)
            if roots:
                torch.autograd.backward(roots, grads)
            dx = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            self.saved[m] = None
            if first:
                dxs[m] = dx
            else:
                sends.append(p2p.Send(dx, self.me - 1, self.group, tag=m))
        for send in sends:
            send.wait()
        self.saved = []
        dx = torch.stack(dxs) if first else torch.empty_like(g_ys)
        if self.n > 1:
            dx = p2p.broadcast(dx, 0, self.group)
        return dx


class _PipelineFunction(torch.autograd.Function):
    """The pipelined stack as one autograd node (the module docstring's
    design (b)): ``apply(x, anchor, schedule) -> (outputs, aux)``."""

    @staticmethod
    def forward(ctx, x, anchor, sched):
        ys, aux = sched.forward(x, keep=True)
        ctx.sched = sched
        return ys, aux

    @staticmethod
    def backward(ctx, g_ys, g_aux):
        return ctx.sched.backward(g_ys.contiguous(), g_aux), None, None


# ---------------------------------------------------------------------------
# A stage's share of the layer stack, as checkpoints and the weight bridge
# see it
# ---------------------------------------------------------------------------

_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def global_name(name: str, stage: Optional[Stage]) -> str:
    """The whole model's name of this stage's parameter ``name``
    (``layers.i.*`` is global layer ``offset + i``)."""
    m = _LAYER.match(name)
    if stage is None or m is None:
        return name
    return f"layers.{stage.offset + int(m.group(1))}.{m.group(2)}"


def gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each) in group order,
    on ``t``'s device (a collective; on a CPU tensor over NCCL the
    exchange runs on the current GPU)."""
    import torch.distributed as dist

    nccl = dist.get_backend(group) == "nccl"
    src = t.detach().to("cuda" if nccl else "cpu").contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def whole_named(named: Dict[str, torch.Tensor], stage: Optional[Stage]
                ) -> Dict[str, torch.Tensor]:
    """A stage's name -> tensor map (local layer names) as the whole
    model's: every stage's layers gathered under their global names, in
    layer order where the stage's stood, the other entries (replicated
    over the stages) this rank's.  A collective over the pipeline group;
    ``named`` itself without a stage."""
    if stage is None:
        return named
    out: Dict[str, torch.Tensor] = {}
    layered = [k for k in named if _LAYER.match(k)]
    parts = {k: gather(named[k], stage.group) for k in layered}
    for key, value in named.items():
        if key not in parts:
            out[key] = value
        elif key == layered[0]:
            for p in range(stage.count):
                theirs = dataclasses.replace(stage, index=p)
                for k in layered:
                    out[global_name(k, theirs)] = parts[k][p]
    return out


def stage_named(named: Dict[str, Any], stage: Optional[Stage]
                ) -> Dict[str, Any]:
    """The whole model's name -> value map cut to this stage: its layers
    under their local names, the other entries kept (the inverse of
    ``whole_named``); ``named`` itself without a stage."""
    if stage is None:
        return named
    out = {}
    for key, value in named.items():
        m = _LAYER.match(key)
        if m is None:
            out[key] = value
            continue
        local = int(m.group(1)) - stage.offset
        if 0 <= local < stage.layers:
            out[f"layers.{local}.{m.group(2)}"] = value
    return out


def _marked_span(stages: Sequence[Optional[Stage]]):
    """(start, end, stage) of the contiguous run of entries that belong
    to a stage's layers, or None."""
    marked = [i for i, s in enumerate(stages) if s is not None]
    if not marked:
        return None
    start, end = marked[0], marked[-1] + 1
    if end - start != len(marked):
        raise ValueError("a stage's layer entries are not contiguous")
    return start, end, stages[start]


def whole_list(items: List[Any], stages: Sequence[Optional[Stage]]
               ) -> List[Any]:
    """A list in parameter order whose entries ``stages`` marks as a
    stage's layers (an optimizer's moments) as the whole model's list:
    every stage's layer entries, stage by stage, where this stage's
    stood.  A collective over the pipeline group; ``items`` itself when
    nothing is marked."""
    span = _marked_span(stages)
    if span is None:
        return items
    start, end, stage = span
    parts = [gather(items[i], stage.group) for i in range(start, end)]
    layers = [part[p] for p in range(stage.count) for part in parts]
    return items[:start] + layers + items[end:]


def stage_list(saved: List[Any], stages: Sequence[Optional[Stage]]
               ) -> List[Any]:
    """The whole model's list cut to this stage (the inverse of
    ``whole_list``): the entries before and after the layers, and this
    stage's share of them; ``saved`` itself when nothing is marked."""
    span = _marked_span(stages)
    if span is None:
        return saved
    start, end, stage = span
    k = end - start
    tail = len(stages) - end
    if len(saved) != start + stage.count * k + tail:
        raise ValueError(f"saved list of {len(saved)} entries does not hold "
                         f"{stage.count} stages of {k}")
    mine = saved[start + stage.index * k:start + (stage.index + 1) * k]
    return saved[:start] + mine + saved[len(saved) - tail:]
