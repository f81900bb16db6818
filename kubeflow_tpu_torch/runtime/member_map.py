"""The member map: a loss mapped with ``torch.func.vmap`` over members
stacked on a leading axis (runtime/hfta.py's fused step), and the two
things that have to leave the map.

The fused trainer stacks N same-architecture models' parameters on a
leading member axis and maps one member's loss over it, as the JAX
package's ``jax.vmap(member_step)``.  Two things do not work inside the
map:

  - a checkpointed region.  Non-reentrant ``torch.utils.checkpoint``
    recomputes in the backward, outside the map, on the stacked tensors
    and on the module's own parameters, and fails its metadata check
    (``torch.func.grad`` refuses its saved-tensor hooks outright).
    Under the map, :func:`checkpoint` runs the region as
    ``checkpoint(vmap(region))`` over the stacked tensors instead: the
    checkpointed region wraps the map, and the region takes its module's
    parameters as explicit inputs, so its recompute maps them again;
  - a draw from a generator.  vmap refuses randomness by default, and a
    member's draws must come from its own generator, in its solo run's
    order.  :class:`MemberGenerators` draws each member's tensor from its
    own generator outside the map and hands the stack in.

Both leave the map through :class:`_Unmapped`, an autograd function
whose ``vmap`` rule is all it runs: the rule receives the stacked tensors
with their mapped dims, and what it computes there, ordinary autograd
records on the stacked tensors, through which the fused step's one
``backward()`` then runs.  Outside the map :func:`checkpoint` is
``torch.utils.checkpoint.checkpoint`` and nothing else changes.

A collective is a third thing: c10d runs on plain tensors, not on a
member's view of a stack.  Under a mesh the global loss and the MoE
layer's statistics are summed over the ranks from inside the map;
parallel/p2p.py's collectives hand a :func:`mapped` tensor to
:func:`on_stack`, which runs them once on the ``[members, ...]`` stack,
never once a member.  The autograd functions of the model axes (the
tensor-parallel pairs and the vocab-parallel CE, parallel/tensor.py; ring
attention, parallel/ring.py) have ``vmap`` rules that apply them once to
the stack, and the GPipe schedule leaves the map through
:func:`over_members`: its hops and broadcasts carry the stack, and each
stage maps its layers over the members' parameters.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap
from torch.utils import checkpoint as _ckpt
from torch.utils._pytree import tree_flatten, tree_unflatten

# The member count while a fused step maps its loss, else 0.
_MEMBERS: contextvars.ContextVar[int] = contextvars.ContextVar(
    "kft_member_map", default=0)


@contextlib.contextmanager
def mapping(members: int) -> Iterator[None]:
    """Mark the code inside as mapped over ``members`` stacked members:
    :func:`checkpoint` then runs its regions around the map."""
    token = _MEMBERS.set(members)
    try:
        yield
    finally:
        _MEMBERS.reset(token)


# Stands for a region's tensor output in its recorded output form.
_MAPPED = object()


def _plain(members: int) -> Dict[str, Any]:
    del members
    return {"use_reentrant": False}


class _Unmapped(torch.autograd.Function):
    """``apply(fn, *tensors)`` inside a vmap calls ``fn(members, dims,
    *stacked)`` on the stacked tensors (``dims`` their mapped dims, None
    for an unmapped one) and maps its outputs, each stacked on dim 0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(fn, *tensors):
        raise RuntimeError("member_map: no input of this call is mapped; it "
                           "runs only inside the member map")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, *tensors):
        outs = tuple(fn(info.batch_size, tuple(in_dims[1:]), *tensors))
        return outs, (0,) * len(outs)


def mapped(t: torch.Tensor) -> bool:
    """Whether ``t`` is a member's view of a stack inside the member
    map."""
    return bool(_MEMBERS.get()) and torch._C._functorch.is_batchedtensor(t)


def on_stack(fn: Callable[[torch.Tensor], torch.Tensor],
             t: torch.Tensor) -> torch.Tensor:
    """``fn`` of the ``[members, ...]`` stack behind the mapped ``t``,
    mapped again: each member gets its row of the result."""
    def outside(n, dims, stacked):
        del n
        return (fn(stacked.movedim(dims[0], 0)),)

    return _Unmapped.apply(outside, t)[0]


def over_members(fn: Callable, module: nn.Module, *tensors
                 ) -> Sequence[torch.Tensor]:
    """``fn(each, *stacks)`` run once outside the member map on the
    ``[members, ...]`` stacks behind ``tensors`` (an unmapped one
    expanded to every member); its outputs, each a stack on dim 0, are
    mapped again.  ``each(g, *xs)`` maps ``g(*xs)`` over the members'
    rows of the stacks ``xs`` with each member's parameters of ``module``
    in place (``torch.func.vmap`` of ``functional_call``): the per-member
    work inside ``fn``, whose collectives and transfers then carry the
    whole stack (the GPipe schedule, parallel/pipeline.py)."""
    named = list(module.named_parameters())
    names = [n for n, _ in named]
    k = len(names)

    def outside(n, dims, *stacked):
        params, param_dims = tuple(stacked[:k]), tuple(dims[:k])
        rest = [t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
                for t, d in zip(stacked[k:], dims[k:])]

        def each(g: Callable, *xs):
            def member(p, *a):
                return call(module, dict(zip(names, p)),
                            lambda _, *b: g(*b), *a)

            return vmap(member, in_dims=(param_dims,) + (0,) * len(xs))(
                params, *xs)

        return tuple(fn(each, *rest))

    return _Unmapped.apply(outside, *[p for _, p in named], *tensors)


class _Bound(nn.Module):
    """``fn(module, *args)`` as a forward, so that ``functional_call``
    swaps ``module``'s parameters around a call that is not its
    forward."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def call(module: nn.Module, params: Dict[str, torch.Tensor], fn: Callable,
         *args) -> Any:
    """``fn(module, *args)`` with the module's parameters taken from
    ``params`` (names as ``module.named_parameters()`` gives them)."""
    return functional_call(_Bound(module, fn),
                           {f"module.{k}": v for k, v in params.items()},
                           args)


def checkpoint(fn: Callable, *args, module: Optional[nn.Module] = None,
               policy: Callable[[int], Dict[str, Any]] = _plain) -> Any:
    """``torch.utils.checkpoint.checkpoint(fn, *args, **policy(1))``, or,
    inside the member map, the region around the map:
    ``checkpoint(vmap(fn), **policy(members))`` over the stacked tensors.

    ``module``: the module whose parameters ``fn`` reads (a bound method's
    owner), taken as explicit inputs under the map.  ``policy(members)``
    gives the checkpoint's keyword arguments; under the map the region's
    ops are the stacked ones, so a policy that tells ops apart by their
    batch dims learns the member count."""
    members = _MEMBERS.get()
    if not members:
        return _ckpt.checkpoint(fn, *args, **policy(1))
    named = list(module.named_parameters()) if module is not None else []
    names = [n for n, _ in named]
    leaves, spec = tree_flatten(args)
    slots = [i for i, a in enumerate(leaves) if isinstance(a, torch.Tensor)]
    out_form: list = []

    def member(*xs):
        given = list(leaves)
        for i, x in zip(slots, xs[len(names):]):
            given[i] = x
        call_args = tree_unflatten(given, spec)
        if module is None:
            out = fn(*call_args)
        else:
            out = call(module, dict(zip(names, xs[:len(names)])),
                       lambda _, *a: fn(*a), *call_args)
        flat, out_spec = tree_flatten(out)
        if not out_form:
            out_form.extend([out_spec, [_MAPPED if isinstance(t, torch.Tensor)
                                        else t for t in flat]])
        return tuple(t for t in flat if isinstance(t, torch.Tensor))

    def outside(n, dims, *stacked):
        def run(*s):
            return vmap(member, in_dims=dims)(*s)

        return _ckpt.checkpoint(run, *stacked, **policy(n))

    outs = iter(_Unmapped.apply(
        outside, *[p for _, p in named], *(leaves[i] for i in slots)))
    out_spec, constants = out_form
    return tree_unflatten([next(outs) if c is _MAPPED else c
                           for c in constants], out_spec)


class MemberGenerators:
    """The ``rng`` a task's loss receives inside the member map: each
    member's own ``torch.Generator`` (``generators``, in member order)
    and ``index``, the mapped member index (an ``arange`` mapped on dim
    0).  ``per_member(draw)`` runs ``draw(generator)`` for every member,
    outside the map, and returns each member its own draw, so a member
    draws what its solo run would from the same generator state
    (models/transformer.py ``dropout_mask`` takes this path)."""

    def __init__(self, generators: Sequence[torch.Generator],
                 index: torch.Tensor):
        self.generators = list(generators)
        self.index = index

    def per_member(self, draw: Callable[[torch.Generator], torch.Tensor]
                   ) -> torch.Tensor:
        gens = self.generators

        def outside(n, dims, index):
            del n, dims, index
            return (torch.stack([draw(g) for g in gens]),)

        return _Unmapped.apply(outside, self.index)[0]
